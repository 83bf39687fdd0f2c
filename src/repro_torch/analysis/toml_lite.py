"""TOML loading that works on py3.10 (no stdlib ``tomllib``).

A copy of ``repro.analysis.toml_lite``: importing that module would run
the JAX package's ``__init__``.

Uses ``tomllib`` when available; otherwise a fallback parser covering
the subset this repo's config files actually use: ``[section]`` /
``[[array-of-tables]]`` headers (dotted and quoted keys), string / int /
float / bool scalars, and (possibly multi-line) arrays of scalars.
Inline tables and date-times are out of scope and raise.
"""

from __future__ import annotations

from typing import Any

try:  # py >= 3.11
    import tomllib as _tomllib
except ImportError:  # pragma: no cover - exercised on the py3.10 CI leg
    _tomllib = None


class TomlError(ValueError):
    pass


def load_path(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    if _tomllib is not None:
        return _tomllib.loads(data.decode("utf-8"))
    return loads(data.decode("utf-8"))


def loads(text: str) -> dict:
    if _tomllib is not None:
        return _tomllib.loads(text)
    return _loads_fallback(text)


def _strip_comment(line: str) -> str:
    out = []
    quote = None
    for ch in line:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            break
        out.append(ch)
    return "".join(out).strip()


def _split_key(raw: str) -> list[str]:
    """Split a (possibly dotted, possibly quoted) TOML key."""
    parts: list[str] = []
    buf: list[str] = []
    quote = None
    for ch in raw:
        if quote:
            if ch == quote:
                quote = None
            else:
                buf.append(ch)
        elif ch in "\"'":
            quote = ch
        elif ch == ".":
            parts.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf).strip())
    if quote or any(not p for p in parts):
        raise TomlError(f"malformed key: {raw!r}")
    return parts


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if not tok:
        raise TomlError("empty value")
    if tok[0] in "\"'":
        if len(tok) < 2 or tok[-1] != tok[0]:
            raise TomlError(f"unterminated string: {tok!r}")
        body = tok[1:-1]
        if tok[0] == '"':
            body = (
                body.replace("\\\\", "\0")
                .replace('\\"', '"')
                .replace("\\n", "\n")
                .replace("\\t", "\t")
                .replace("\0", "\\")
            )
        return body
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok, 0)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise TomlError(f"unsupported value: {tok!r}") from None


def _split_array_items(body: str) -> list[str]:
    items: list[str] = []
    buf: list[str] = []
    quote = None
    depth = 0
    for ch in body:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch == "[":
            depth += 1
            buf.append(ch)
        elif ch == "]":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            items.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if "".join(buf).strip():
        items.append("".join(buf))
    return [it.strip() for it in items if it.strip()]


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]"):
            raise TomlError(f"unterminated array: {tok!r}")
        return [_parse_value(item) for item in _split_array_items(tok[1:-1])]
    if tok.startswith("{"):
        raise TomlError("inline tables are not supported by the fallback parser")
    return _parse_scalar(tok)


def _descend(root: dict, parts: list[str], *, array_tail: bool) -> dict:
    cur = root
    for p in parts[:-1]:
        nxt = cur.setdefault(p, {})
        if isinstance(nxt, list):
            nxt = nxt[-1]
        cur = nxt
    last = parts[-1]
    if array_tail:
        arr = cur.setdefault(last, [])
        if not isinstance(arr, list):
            raise TomlError(f"{'.'.join(parts)} is not an array of tables")
        arr.append({})
        return arr[-1]
    nxt = cur.setdefault(last, {})
    if isinstance(nxt, list):
        nxt = nxt[-1]
    return nxt


def _loads_fallback(text: str) -> dict:
    root: dict = {}
    table = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i])
        i += 1
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise TomlError(f"malformed table header: {line!r}")
            table = _descend(root, _split_key(line[2:-2]), array_tail=True)
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise TomlError(f"malformed table header: {line!r}")
            table = _descend(root, _split_key(line[1:-1]), array_tail=False)
            continue
        if "=" not in line:
            raise TomlError(f"expected key = value: {line!r}")
        key_raw, val_raw = line.split("=", 1)
        # multi-line array: accumulate until brackets balance outside strings
        while _bracket_depth(val_raw) > 0:
            if i >= len(lines):
                raise TomlError(f"unterminated array for key {key_raw.strip()!r}")
            val_raw += " " + _strip_comment(lines[i])
            i += 1
        keys = _split_key(key_raw.strip())
        target = table
        for p in keys[:-1]:
            nxt = target.setdefault(p, {})
            if isinstance(nxt, list):
                nxt = nxt[-1]
            target = nxt
        target[keys[-1]] = _parse_value(val_raw.strip())
    return root


def _bracket_depth(s: str) -> int:
    depth = 0
    quote = None
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
    return depth
