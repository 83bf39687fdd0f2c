"""Device milliseconds an insert call launches under the port's
``qf.sort`` spans: the batch's sort (``qf_filter.insert_fingerprints``)
and the sort of the table's fingerprints with the batch's
(``quotient_filter.merge_sorted_with``)."""

from amqbench.harness.scopes import Program, per_call_ms

SPANS = ('qf.sort',)


def read(run):
    return per_call_ms(run, "insert", SPANS, Program.device_s)
