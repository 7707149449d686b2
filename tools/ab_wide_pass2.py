"""Wide pass 2 (kernel #7, wide mode 4) of several source trees, timed in
turns on one CUDA card.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ab_wide_pass2.py _tree_check/parent .   # parent first

runs (parent, change, change, parent) twice, each arm a process of its own
(``--tree TREE TAG``) that imports ``dibs_tpu_torch`` from its tree, builds
it, makes the same inputs from numpy seeds and times pass 2 at config 5's
phase-6 shape (P=1000, d=128, N=100, M=32, weights from pass 1) and at
d=75, N=600 (P=20, 5 interventional blocks of 100 rows): the median of
CUDA-event-timed calls after a warm-up, and the kernel's own device time
from ``torch.profiler`` (where the kernel is shorter than the wrapper's
host work, the event time measures the host). It then checks that pass 1
is bitwise equal across the trees and prints pass 2's largest difference
from the first tree. The arms' outputs go to ``_tree_check/ab_out/``.
"""
import json
import math
import os
import statistics
import subprocess
import sys

OUT = "_tree_check/ab_out/ab_pass2"  # [P, d, d] outputs: large, kept out of git


def problem(np, torch, rng, dev, p, d, n, blocks):
    scores = rng.normal(size=(p, d, d)).astype(np.float32)
    thetas = rng.normal(size=(p, d, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.zeros((n, d), np.float32)
    for b in range(blocks):
        nodes = rng.choice(d, size=math.ceil(0.1 * d), replace=False)
        mask[100 * (b + 1):100 * (b + 2), nodes] = 1.0
    return [torch.from_numpy(a).to(dev) for a in (scores, thetas, x,
                                                   1.0 - mask)]


def median_ms(torch, fn, reps):
    for _ in range(max(20, reps)):  # warm-up: clocks settle
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


def arm(tree, tag):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.models import LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk

    assert fl.__file__.startswith(os.path.abspath(tree)), fl.__file__
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gk.build()
    res, saved = {}, {}
    for label, (p, d, n, blocks, m, seed) in {
            "config5": (1000, 128, 100, 0, 32, 9),
            "d75_n600": (20, 75, 600, 5, 32, 10)}.items():
        args = problem(np, torch, np.random.default_rng(seed), dev, p, d, n,
                       blocks)
        kw = dict(seed=17, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=m,
                  model=LinearGaussian(n_vars=d))
        lls = fl.fused_linear_pass1(*args, **kw)
        weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
        kept = int(((weights[0] != 0) | (weights[1] != 0)).sum())
        out = fl.fused_linear_pass2(*args, weights, **kw)
        again = fl.fused_linear_pass2(*args, weights, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        t = median_ms(torch, lambda: fl.fused_linear_pass2(*args, weights,
                                                           **kw),
                      reps=100 if p >= 1000 else 400)
        # the kernel's own device time (the event time includes the
        # wrapper's host work where the kernel is shorter than it)
        from torch.profiler import ProfilerActivity, profile
        n_prof = 50 if p >= 1000 else 200
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                fl.fused_linear_pass2(*args, weights, **kw)
            torch.cuda.synchronize()
        dev_ms = sum(evt.time_range.elapsed_us() for evt in prof.events()
                     if evt.device_type == torch.autograd.DeviceType.CUDA
                     and "fused_linear_wide_kernel" in evt.name) / 1e3 / n_prof
        res[label] = dict(ms=t, kernel_ms=dev_ms, kept=kept, of=p * m,
                          bitwise=bitwise)
        saved[label] = [x.cpu() for x in (*lls, *out)]
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
    for label in outs[0]:
        ref = outs[0][label]
        for k in range(1, len(trees)):
            got = outs[k][label]
            same1 = all(torch.equal(a, b) for a, b in zip(ref[:2], got[:2]))
            diff = [float((a - b).abs().max()) / max(1.0, float(
                a.abs().max())) for a, b in zip(ref[2:], got[2:])]
            print(f"{label}: {trees[k]} vs {trees[0]}: pass 1 bitwise equal "
                  f"{same1}; pass 2 max err / max(1, max|parent|) {diff}",
                  flush=True)
        print(f"{label} in turns ({' '.join(trees[k] for k in order)}): "
              + ", ".join(f"{rows[k][order[:t].count(k)][label]['ms']:.4f}"
                          for t, k in enumerate(order))
              + " ms (events); kernel device time: "
              + ", ".join(
                  f"{rows[k][order[:t].count(k)][label]['kernel_ms']:.4f}"
                  for t, k in enumerate(order))
              + f" ms; replayed {rows[0][0][label]['kept']} of "
              f"{rows[0][0][label]['of']}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--tree":
        arm(sys.argv[2], sys.argv[3])
    else:
        main()
