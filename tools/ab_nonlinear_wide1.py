"""Kernel #8 (``csrc/fused_nonlinear.cu``) and wide pass 1 (kernel #6 past
d = 70, ``csrc/fused_linear.cu``) of several source trees, timed in turns
on one CUDA card.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ab_nonlinear_wide1.py _tree_check/parent .   # parent first

runs (parent, change, change, parent) twice, each arm a process of its own
(``--tree TREE TAG``) that imports ``dibs_tpu_torch`` from its tree, builds
it, makes the same inputs from numpy seeds and times #8 at config 3's shape
(P=30, d=20, N=100, h1=5, M=128), at d=30, N=600 (P=20, 5
interventional blocks of 100 rows) and at config 7's (P=1000, d=50, N=100,
h1=5, M=32: clusters of 4 blocks), and wide pass 1 at config 5's shape
(P=1000, d=128, N=100, M=32), with in-kernel noise on one shared stream
(the engine's): the median of CUDA-event-timed calls after a warm-up, and
the kernels' own device time from ``torch.profiler``. Each arm checks that
two calls are bitwise equal; the trees' outputs are then compared bitwise
with the first tree's. The arms' outputs go to ``_tree_check/ab_out/``.
"""
import json
import os
import subprocess
import sys

# the sibling scripts' timing (this script's directory is sys.path[0])
from ab_sampler_bge import device_ms
from ab_wide_pass2 import median_ms, problem

OUT = "_tree_check/ab_out/ab_nonlinear_wide1"  # each tree's first arm
CASES = {"nl_config3": (30, 20, 100, 0, 128, 31),
         "nl_d30_n600": (20, 30, 600, 5, 128, 32),
         "nl_config7": (1000, 50, 100, 0, 32, 34),
         "wide1_config5": (1000, 128, 100, 0, 32, 33)}


def arm(tree, tag):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian, LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk

    assert fl.__file__.startswith(os.path.abspath(tree)), fl.__file__
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gk.build()
    res, saved = {}, {}
    for label, (p, d, n, blocks, m, seed) in CASES.items():
        rng = np.random.default_rng(seed)
        scores, thetas, x, w = problem(np, torch, rng, dev, p, d, n, blocks)
        if label.startswith("nl"):
            model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(5,))
            theta = model.sample_parameters(
                generator=torch.Generator().manual_seed(seed), n_vars=d,
                n_particles=p, device=dev)
            args = (scores, *fnl.kernel_layout(theta, model), x, w)
            kw = dict(seed=19, streams=(6, 6), alpha=1.5, tau=1.0,
                      n_samples=m, model=model)

            def call():
                return fnl.fused_nonlinear(*args, **kw)
            # #8's pass, not its reference or merge: fused_nl_kernel<...>
            # (a tree that built its clusters as a kernel of their own
            # names that one fused_nl_cluster_kernel<...>)
            name = "_kernel<"
        else:
            kw = dict(seed=19, streams=(6, 6), alpha=1.5, tau=1.0,
                      n_samples=m, model=LinearGaussian(n_vars=d))

            def call():
                return fl.fused_linear_pass1(scores, thetas, x, w, **kw)
            name = "fused_linear_wide_pass1_kernel"
        out, again = call(), call()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        big = p >= 1000
        res[label] = dict(ms=median_ms(torch, call, 50 if big else 400),
                          kernel_ms=device_ms(torch, call, name,
                                              20 if big else 200),
                          bitwise=bitwise)
        saved[label] = [t.cpu() for t in out]
    torch.save(saved, f"{OUT}_{tag}.pt")
    print("ARM " + json.dumps(dict(tag=tag, **res)), flush=True)


def main():
    trees = sys.argv[1:]  # the first is the parent
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    order = 2 * (list(range(len(trees))) + list(range(len(trees)))[::-1])
    rows = {k: [] for k in range(len(trees))}
    for turn, k in enumerate(order):
        proc = subprocess.run([sys.executable, __file__, "--tree", trees[k],
                               f"{k}_{turn}"], capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("ARM ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-6000:], flush=True)
            raise SystemExit(f"arm {trees[k]} failed")
        rows[k].append(json.loads(line[0][4:]))
        print(trees[k], line[0], flush=True)
    import torch
    outs = {k: torch.load(f"{OUT}_{k}_{order.index(k)}.pt")
            for k in range(len(trees))}
    for label in CASES:
        for k in range(1, len(trees)):
            same = all(torch.equal(a, b) for a, b in
                       zip(outs[0][label], outs[k][label]))
            print(f"{label}: {trees[k]} vs {trees[0]}: outputs bitwise "
                  f"equal {same}", flush=True)
        arms = [rows[k][order[:t].count(k)][label]
                for t, k in enumerate(order)]
        print(f"{label} in turns ({' '.join(trees[k] for k in order)}): "
              + ", ".join(f"{a['ms']:.4f}" for a in arms)
              + " ms (events); kernel device time: "
              + ", ".join(f"{a['kernel_ms']:.4f}" for a in arms) + " ms",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--tree":
        arm(sys.argv[2], sys.argv[3])
    else:
        main()
