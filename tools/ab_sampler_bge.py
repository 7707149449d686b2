"""The sampler #1 (``csrc/gumbel.cu``) and the BGe determinant pairs #2
(``csrc/bge_pairs.cu``) of several source trees, timed in turns on one CUDA
card.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ab_sampler_bge.py _tree_check/parent .   # parent first

runs (parent, change, change, parent) twice, each arm a process of its own
(``--tree TREE TAG``) that imports ``dibs_tpu_torch`` from its tree, builds
it, makes the same inputs from numpy seeds and times three calls at the
main paths' shapes: #1 soft at config 5's ``[1000, 8, 128, 128]`` (tau = 1,
in-kernel noise, as the acyclicity prior draws it), #1 hard at the marginal
step's ``[30, 128, 20, 20]``, and #2 at the marginal step's 3,840 graphs of
d = 20 (random masks of density 0.3, as ``chip_smoke.py`` phase 3). Each
time is the median of CUDA-event-timed calls after a warm-up, and the
kernel's own device time from ``torch.profiler`` (below ~0.3 ms the event
time includes the wrapper's host work; read the device time there). Each
arm checks that two calls are bitwise equal. The trees' outputs are then
held to the first tree's: soft within 1e-5 (every 13th element of config
5's 131 M), hard exact, #2 at ``rtol = atol = 1e-4`` (and whether it is
bitwise equal). The arms' outputs go to ``_tree_check/ab_out/``.
"""
import json
import os
import subprocess
import sys

# the sibling script's timing (this script's directory is sys.path[0])
from ab_wide_pass2 import median_ms

OUT = "_tree_check/ab_out/ab_sampler_bge"  # outputs of each tree's first arm


def device_ms(torch, fn, name, calls):
    """Mean device time a call of the kernels whose name holds ``name``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(evt.time_range.elapsed_us() for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and name in evt.name) / 1e3 / calls


def arm(tree, tag, save):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs

    assert gk.__file__.startswith(os.path.abspath(tree)), gk.__file__
    dev = torch.device("cuda:0")
    gk.build()
    rng = np.random.default_rng(13)
    soft_s = torch.from_numpy(rng.normal(size=(1000, 128, 128)).astype(
        np.float32)).to(dev)
    hard_s = torch.from_numpy(rng.normal(size=(30, 20, 20)).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(100, 20)).astype(np.float32)).to(dev)
    r_mats, _ = BGe(n_vars=20, device=dev)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    r_mats = r_mats.contiguous()
    gs = (rng.uniform(size=(3840, 20, 20)) < 0.3).astype(np.float32)
    gs[:, np.arange(20), np.arange(20)] = 0.0
    gs = torch.from_numpy(gs).to(dev)
    cases = {
        "gumbel_soft_config5": (
            lambda: gk.gumbel_graphs(soft_s, 7, 0, 1.0, 1.0, 8, False),
            "gumbel_graphs", 100),
        "gumbel_hard_marginal": (
            lambda: gk.gumbel_graphs(hard_s, 5, 9, 1.0, 1.0, 128, True),
            "gumbel_graphs", 400),
        "bge_marginal": (lambda: bge_logdet_pairs(r_mats, gs), "bge_pairs",
                         200),
    }
    res, saved = {}, {}
    for label, (fn, name, reps) in cases.items():
        out, again = fn(), fn()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        agains = again if isinstance(again, tuple) else (again,)
        bitwise = all(torch.equal(a, b) for a, b in zip(outs, agains))
        if label == "gumbel_soft_config5":
            outs = (out.flatten()[::13],)
        saved[label] = [o.cpu() for o in outs]
        del out, again, outs, agains
        res[label] = dict(ms=median_ms(torch, fn, reps),
                          kernel_ms=device_ms(torch, fn, name, reps // 2),
                          bitwise=bitwise)
    if save:
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
        save = str(int(order.index(k) == turn))
        proc = subprocess.run([sys.executable, __file__, "--tree", trees[k],
                               str(k), save], capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("ARM ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-6000:], flush=True)
            raise SystemExit(f"arm {trees[k]} failed")
        rows[k].append(json.loads(line[0][4:]))
        print(trees[k], line[0], flush=True)
    import torch
    outs = {k: torch.load(f"{OUT}_{k}.pt") for k in range(len(trees))}
    ok = True
    for label in outs[0]:
        for k in range(1, len(trees)):
            ref, got = outs[0][label], outs[k][label]
            err = max(float((a - b).abs().max()) for a, b in zip(ref, got))
            bitwise = all(torch.equal(a, b) for a, b in zip(ref, got))
            if label == "gumbel_soft_config5":
                good = err <= 1e-5
            elif label == "gumbel_hard_marginal":
                good = bitwise
            else:
                good = all(torch.allclose(b, a, rtol=1e-4, atol=1e-4)
                           for a, b in zip(ref, got))
            ok &= good
            print(f"{label}: {trees[k]} vs {trees[0]}: max |diff| {err:.3g}, "
                  f"bitwise equal {bitwise}, within its bar {good}",
                  flush=True)
        print(f"{label} in turns ({' '.join(trees[k] for k in order)}): "
              + ", ".join(f"{rows[k][order[:t].count(k)][label]['ms']:.4f}"
                          for t, k in enumerate(order))
              + " ms (events); kernel device time: "
              + ", ".join(
                  f"{rows[k][order[:t].count(k)][label]['kernel_ms']:.4f}"
                  for t, k in enumerate(order))
              + " ms; two calls bitwise equal in every arm: "
              + str(all(r[label]["bitwise"] for k in rows for r in rows[k])),
              flush=True)
    if not ok:
        raise SystemExit("the trees' outputs disagree")


if __name__ == "__main__":
    if sys.argv[1] == "--tree":
        arm(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
    else:
        main()
