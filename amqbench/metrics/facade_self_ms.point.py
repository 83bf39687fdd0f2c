"""Host milliseconds a point read spends in the façade's own code: the
self time of the port's ``filters.contains`` span (its duration less the
kernel wrappers' spans inside it), a call."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('filters.contains',)


def read(run):
    return per_call_ms(run, "probe", SPANS, Program.self_s)
