"""Device milliseconds an insert call launches under the port's
``qf.extract`` spans, at any depth: the decode of a quotient filter's
planes back to its sorted fingerprints (``core/quotient_filter.py::
extract``), the flat filter's whole table every call, a cascade's Q0
every call and each level a merge consumes."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('qf.extract',)


def read(run):
    return per_call_ms(run, "insert", SPANS, Program.device_s)
