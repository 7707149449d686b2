"""Kernel #8's cluster build (``fused_nl_kernel<..., true>``,
``csrc/fused_nonlinear.cu``) at config 7's shape under each cluster size,
timed on one CUDA card.

    python tools/nl_cluster_sizes.py

At P=1000, d=50, N=100, h1=5, M=32, relu, in-kernel noise on one shared
stream (the engine's), for clusters of 2, 4 and 8 ranks
(``chip_smoke.cluster_plan_at``) in turns, twice:
two calls bitwise equal, the outputs against the first size's within 1e-4
max(1, max|ref|), the median of CUDA-event-timed calls and the device time
of the call's kernels (reference, cluster kernel, merge) and of the cluster
kernel alone from ``torch.profiler``. Then the plain version's time and its
agreement with the rule's plan, and the bound (``accounting.kernel_cost`` +
``bound_ms``). Prints the card's name and power limit first.
"""
import json
import os
import subprocess
import sys

# the sibling scripts' timing (this script's directory is sys.path[0])
from ab_sampler_bge import device_ms
from ab_wide_pass2 import median_ms, problem

P, D, N, H1, M = 1000, 50, 100, 5, 32


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from dibs_tpu_torch.accounting import bound_ms, kernel_cost
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gk.build()
    rng = np.random.default_rng(7)
    scores, _, x, w = problem(np, torch, rng, dev, P, D, N, 0)
    model = DenseNonlinearGaussian(n_vars=D, hidden_layers=(H1,))
    theta = model.sample_parameters(
        generator=torch.Generator().manual_seed(7), n_vars=D, n_particles=P,
        device=dev)
    args = (scores, *fnl.kernel_layout(theta, model), x, w)
    kw = dict(seed=19, streams=(6, 6), alpha=1.5, tau=1.0, n_samples=M,
              model=model)
    rule = fnl.fused_nonlinear_plan(D, H1, N)
    plans = {r: chip_smoke.cluster_plan_at(fnl, D, H1, N, r)
             for r in (2, 4, 8)}
    chosen = fnl.fused_nonlinear_plan

    def call():
        return fnl.fused_nonlinear(*args, **kw)

    first, rows = None, {r: [] for r in plans}
    for turn in range(2):
        for r in (plans if turn == 0 else reversed(list(plans))):
            fnl.fused_nonlinear_plan = \
                lambda d, h1, n, plan=plans[r]: plan
            out, again = call(), call()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
            if first is None:
                first = out
            err = max(float((a - b).abs().max())
                      / (1e-4 * max(1.0, float(b.abs().max())))
                      for a, b in zip(out, first))
            rows[r].append(dict(
                ms=median_ms(torch, call, 30),
                call_device_ms=device_ms(torch, call, "fused_nl", 10),
                kernel_ms=device_ms(torch, call, "fused_nl_kernel", 10),
                bitwise=bitwise, err_of_bar=err))
            print(f"ranks={r} {plans[r]} " + json.dumps(rows[r][-1]),
                  flush=True)
    fnl.fused_nonlinear_plan = chosen
    out = call()
    plain = fnl.fused_nonlinear_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max())
              / (1e-4 * max(1.0, float(b.abs().max())))
              for a, b in zip(out, plain))
    t_plain = median_ms(torch, lambda: fnl.fused_nonlinear_plain(*args, **kw),
                        3)
    flops, n_bytes = kernel_cost("fused_nonlinear", p=P, m=M, n=N, d=D, h1=H1)
    b_ms, b_by = bound_ms(flops, n_bytes)
    print(f"rule {rule}; plain {t_plain:.3f} ms, rule vs plain "
          f"{err:.4f} of the bar; bound {b_ms:.4f} ms ({b_by}, "
          f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)", flush=True)
    for r, arms in rows.items():
        print(f"ranks={r}: events " + ", ".join(f"{a['ms']:.4f}" for a in arms)
              + " ms; call device " + ", ".join(
                  f"{a['call_device_ms']:.4f}" for a in arms)
              + " ms; cluster kernel " + ", ".join(
                  f"{a['kernel_ms']:.4f}" for a in arms)
              + f" ms; {100 * b_ms / min(a['call_device_ms'] for a in arms):.2f}"
              "% of the bound", flush=True)


if __name__ == "__main__":
    main()
