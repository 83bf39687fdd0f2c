"""Device milliseconds a probe call launches under the port's
``kernels.unpack`` and ``cascade.combine`` spans: the fused cascade
probe's bit mask unpacked to one answer a level
(``kernels.ops.cascade_lookup``) and those answers or'ed
(``cascade.contains``)."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('kernels.unpack', 'cascade.combine')


def read(run):
    return per_call_ms(run, "probe", SPANS, Program.device_s)
