"""Host milliseconds an insert call spends inside the port's
``host_read.*`` spans: each deliberate read of a device value on an
insert path (``cascade._collapse_target``'s target level), the host
waiting there for the card to finish the work queued before it."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('host_read',)


def read(run):
    return per_call_ms(run, "insert", SPANS, Program.host_s)
