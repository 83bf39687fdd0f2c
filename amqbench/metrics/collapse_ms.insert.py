"""Device milliseconds an insert call launches under the port's
``cascade.collapse.L<i>`` spans: a cascade's merges of Q0 and the
levels above ``i`` into level ``i`` (``cascade._collapse_into``), every
target level summed."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('cascade.collapse',)


def read(run):
    return per_call_ms(run, "insert", SPANS, Program.device_s)
