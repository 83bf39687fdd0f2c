"""Device milliseconds an insert call launches under the port's
``qf.build`` spans: the rebuild of a quotient filter's planes from
sorted fingerprints (``kernels.ops.build_sorted``: the ``qf_positions``
scan and the ``qf_build_planes`` scatter; the plain ``build_sorted``)."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('qf.build',)


def read(run):
    return per_call_ms(run, "insert", SPANS, Program.device_s)
