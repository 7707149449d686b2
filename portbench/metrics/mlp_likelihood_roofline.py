"""The MLP likelihood (``models/nonlinear_gaussian.py`` through
``inference/estimators.py``): the least time of a step's scored (particle,
sample) pairs, which the program counts (``mlp_lik.pairs``: 2 P M a step,
the soft and the hard samples), by the frozen count of #8's work at the
configuration's P, N, d and first hidden width, over the device time of
the kernels whose innermost span is ``dibs.likelihood.score`` or
``dibs.likelihood.grad``, in percent. The same work whatever computes
it: #8, or the generic estimators' autograd."""
from portbench import spans, workcount

SPANS = {"dibs.likelihood.score", "dibs.likelihood.grad"}


def read(trace, cell):
    counts, log = spans.counters(), spans.log()
    if counts is None or log is None or not counts.get("mlp_lik.pairs"):
        return None
    ms = spans.ms_in(trace, log, SPANS)
    if ms is None:
        return None
    cfg = cell.config
    p = cfg["n_particles"]
    m = counts["mlp_lik.pairs"] / (2 * p * trace.steps)
    bound = workcount.bound_s(*workcount.kernel_cost(
        "fused_nonlinear", p=p, m=m, n=cfg["n_observations"],
        d=cfg["n_vars"], h1=cfg["hidden_layers"][0]))
    return 100.0 * bound / (ms / 1e3)
