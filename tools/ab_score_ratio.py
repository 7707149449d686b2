"""The REINFORCE ratio of the ``score`` estimator at config 6's shape (P =
100, M = 64, d = k = 128), the per-sample chain against the route by
linearity, timed in turns on one CUDA card.

    python tools/ab_score_ratio.py

* the per-sample chain: ``grad_latent_log_prob_batch`` (the ``[P, M, d,
  k, 2]`` gradients) and ``stable_ratio_grad``'s signed logsumexp, as the
  ``score`` estimator computed it before kernel #10;
* the route: the ``[P, M]`` weights, kernel #10 (``gpu_kernels.
  score_ratio``) and the two ``[P, d, d] @ [P, d, k]`` products, as the
  estimator computes it now;
* the einsum route: the same with #10's residual from one float32
  ``einsum`` over the graphs (``score_rb``'s route for its per-node
  weights), ``(sum_m w_m) p`` and the diagonal in PyTorch.

Both at ``c`` = 0 and 0.5, on hard graphs from the sampler (#1) at
``alpha`` = 3 and log-probabilities spread over tens of nats. Prints the
card, each route's median CUDA-event time in the order (chain, route,
einsum, einsum, route, chain) twice, #10's time in turns with the
einsum residual's, the device time of each from ``torch.profiler``,
#10's bound and its plain twin's time, the largest difference of each
route against ``max(1, max|chain|)``, and the peak memory each route
allocates.
"""
import math
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from dibs_tpu_torch.accounting import bound_ms, kernel_cost  # noqa: E402
from dibs_tpu_torch.inference.estimators import (  # noqa: E402
    _ratio_log_weights,
    _ratio_weights,
    _scores_to_z,
    stable_ratio_grad,
)
from dibs_tpu_torch.ops import gpu_kernels as gk  # noqa: E402
from dibs_tpu_torch.ops.edges import (  # noqa: E402
    edge_probs,
    edge_scores,
    grad_latent_log_prob_batch,
)
from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs  # noqa: E402
from dibs_tpu_torch.utils.func import expand_by, zero_diagonal  # noqa: E402

P, M, D, K, ALPHA = 100, 64, 128, 128, 3.0


def chain(zs, g, logprobs, baselines, c):
    grad_z = grad_latent_log_prob_batch(g, zs, ALPHA)
    log_w, sign_w, centred = _ratio_log_weights(logprobs, baselines, c)
    return stable_ratio_grad(log_w, centred, expand_by(sign_w, 3) * grad_z)


def route(zs, g, logprobs, baselines, c):
    w = _ratio_weights(logprobs, baselines, c)
    resid = gk.score_ratio(g, w, edge_probs(zs, ALPHA), ALPHA)
    return _scores_to_z(resid, zs)


def einsum_resid(g, w, prob):
    acc = torch.einsum("pmij,pm->pij", g, w)
    return zero_diagonal(ALPHA * (acc - w.sum(1)[:, None, None] * prob))


def einsum_route(zs, g, logprobs, baselines, c):
    w = _ratio_weights(logprobs, baselines, c)
    return _scores_to_z(einsum_resid(g, w, edge_probs(zs, ALPHA)), zs)


def median_ms(fn, reps=50):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def peak_gb(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def device_ms(fn, name=None, n=50):
    """Device time a call of ``fn``: its kernels named ``name``, or all."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(evt.time_range.elapsed_us() for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and (name is None or name in evt.name)) / 1e3 / n


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gk.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    zs = torch.randn((P, D, K, 2), generator=gen, device=dev) / math.sqrt(K)
    g = sample_hard_graphs(edge_scores(zs), 11, 0, ALPHA, M)
    logprobs = -40.0 * torch.rand((P, M), generator=gen, device=dev)
    baselines = logprobs.mean(1) - 2.0
    for c in (0.0, 0.5):
        fns = {"chain": lambda: chain(zs, g, logprobs, baselines, c),
               "route": lambda: route(zs, g, logprobs, baselines, c),
               "einsum": lambda: einsum_route(zs, g, logprobs, baselines, c)}
        want = fns["chain"]()
        errs = {name: float((fns[name]() - want).abs().max())
                / max(1.0, float(want.abs().max()))
                for name in ("route", "einsum")}
        order = ["chain", "route", "einsum", "einsum", "route", "chain"] * 2
        times = [median_ms(fns[name]) for name in order]
        print(f"c={c}: in turns ({' '.join(order)}): "
              + ", ".join(f"{t:.4f}" for t in times) + " ms (events); "
              "max err / max(1, max|chain|) "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + "; peak GB allocated "
              + ", ".join(f"{n} {peak_gb(fn):.3f}" for n, fn in fns.items()),
              flush=True)
    w = torch.softmax(logprobs, 1)
    prob = edge_probs(zs, ALPHA)
    call = lambda: gk.score_ratio(g, w, prob, ALPHA)  # noqa: E731
    lib = lambda: einsum_resid(g, w, prob)  # noqa: E731
    twin = gk.score_ratio_plain(g, w, prob, ALPHA)
    lib_err = float((lib() - twin).abs().max())
    lib_bitwise = torch.equal(lib(), lib())
    bound = bound_ms(*kernel_cost("score_ratio", p=P, m=M, d=D))
    turns = [median_ms(fn, 200) for fn in (call, lib, lib, call)]
    print(f"#10 at [{P}, {M}, {D}, {D}]: in turns (#10, einsum, einsum, "
          f"#10): " + ", ".join(f"{t:.4f}" for t in turns) + " ms (events); "
          f"{device_ms(call, 'score_ratio_kernel'):.4f} / "
          f"{device_ms(lib):.4f} ms (device time of #10 / of the einsum "
          f"residual's kernels); bound "
          f"{bound[0]:.5f} ms ({bound[1]}); plain twin "
          f"{median_ms(lambda: gk.score_ratio_plain(g, w, prob, ALPHA), 20):.4f}"
          f" ms; einsum residual: max err {lib_err:.3e} against the twin, "
          f"two calls bitwise equal {lib_bitwise}", flush=True)


if __name__ == "__main__":
    main()
