"""The BGe determinant pairs (#2, every ``bge_pairs_*`` kernel): their
least time by the frozen count of the pairs' parent counts k, which the
program counts (``bge_pairs.parents``, a histogram of k, with
``bge_pairs.graphs`` and ``bge_pairs.calls``), over their device time, in
percent."""
from portbench import spans


def read(trace, cell):
    counts = spans.counters()
    ops = trace.matching("bge_pairs_")
    if counts is None or not ops:
        return None
    bound = spans.bge_pairs_bound_s(counts)
    return None if bound is None else 100.0 * bound / trace.seconds(ops)
