"""Serving-side AMQ users (the port of ``repro.serve``'s prefix cache)."""
