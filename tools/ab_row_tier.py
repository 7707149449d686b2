"""The row tier of the fused linear-Gaussian kernels (#5 single pass, #6
pass 1, #7 pass 2 at d <= 70, ``csrc/fused_linear.cu``) of several source
trees, timed in turns on one CUDA card.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ab_row_tier.py _tree_check/parent .   # parent first
    python tools/ab_row_tier.py --plans                 # this tree's plans

runs (parent, change, change, parent) twice, each arm a process of its own
(``--tree TREE TAG``) that imports ``dibs_tpu_torch`` from its tree, builds
it, makes the same inputs from numpy seeds and times #5, #6 and #7 at config
2's shape (P=30, d=20, N=100, M=128) and config 4's (P=20, d=30, N=600 with
5 x 100 interventional rows, M=128), in-kernel noise on one shared stream
(the engine's), pass 2 with the softmax of the plain pass 1 (the same
weights in every tree): the median of CUDA-event-timed calls after a
warm-up, and the kernels' own device time from ``torch.profiler`` (the
kernel and its merge; below ~0.3 ms the event time includes the wrapper's
host work). Each arm checks that two calls are bitwise equal and counts the
samples pass 2 replays (a non-zero weight). Then the trees are held to the
first: every output within ``1e-4 max(1, max|first|)``, and, with injected
noise, the hard samples bitwise equal: pass 2 with all of a particle's hard
weight on one sample returns ``d Theta = H (dW / sigma^2 + prior)``, whose
zero pattern is that sample's hard graph ``H``.

``--plans`` times #5 in this tree under other launch plans than
``fused_linear_row_plan``'s (groups, tile rows, chunk rows), each in turns
with the plan's own. The arms' outputs go to ``_tree_check/ab_out/``.
"""
import json
import math
import os
import subprocess
import sys

# the sibling scripts' timing (this script's directory is sys.path[0])
from ab_sampler_bge import device_ms
from ab_wide_pass2 import median_ms, problem

OUT = "_tree_check/ab_out/ab_row_tier"  # outputs of each tree's first arm
SHAPES = {"config2": (30, 20, 100, 0, 128, 21),
          "config4": (20, 30, 600, 5, 128, 22)}
HARD_SAMPLES = (0, 5, 77)  # samples whose hard graphs are compared


def setup(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.models import LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk

    assert fl.__file__.startswith(os.path.abspath(tree)), fl.__file__
    torch.set_float32_matmul_precision("highest")
    gk.build()
    return np, torch, fl, LinearGaussian


def inputs(np, torch, fl, LinearGaussian, label):
    p, d, n, blocks, m, seed = SHAPES[label]
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(seed)
    args = problem(np, torch, rng, dev, p, d, n, blocks)
    kw = dict(seed=17, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=m,
              model=LinearGaussian(n_vars=d))
    weights = tuple(torch.softmax(ll, dim=1)
                    for ll in fl.fused_linear_pass1_plain(*args, **kw))
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, size=(2, p, m, d, d))
    eps = torch.from_numpy((np.log(u) - np.log1p(-u)).astype(
        np.float32)).to(dev)
    return args, kw, weights, (eps[0], eps[1])


def arm(tree, tag, save):
    np, torch, fl, LinearGaussian = setup(tree)
    res, saved = {}, {}
    for label in SHAPES:
        args, kw, weights, eps = inputs(np, torch, fl, LinearGaussian, label)
        p, m = weights[0].shape
        calls = {"single": lambda: fl.fused_linear_single(*args, **kw),
                 "pass1": lambda: fl.fused_linear_pass1(*args, **kw),
                 "pass2": lambda: fl.fused_linear_pass2(*args, weights, **kw)}
        out = {}
        for name, fn in calls.items():
            first, again = fn(), fn()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
            reps = 100 if label == "config4" else 400
            res[f"{label}_{name}"] = dict(
                ms=median_ms(torch, fn, reps), bitwise=bitwise,
                kernel_ms=device_ms(torch, fn, "fused_linear_", reps // 2))
            out[name] = [t.cpu() for t in first]
        res[f"{label}_replayed"] = [
            int(((weights[0] != 0) | (weights[1] != 0)).sum()), p * m]
        # injected noise: the outputs, and the hard graphs of HARD_SAMPLES
        ikw = dict(kw, eps=eps)
        out["injected"] = [t.cpu() for t in (
            *fl.fused_linear_single(*args, **ikw),
            *fl.fused_linear_pass2(*args, weights, **ikw))]
        for s in HARD_SAMPLES:
            one_hot = torch.zeros_like(weights[1])
            one_hot[:, s] = 1.0
            _, dtheta = fl.fused_linear_pass2(
                *args, (torch.zeros_like(one_hot), one_hot), **ikw)
            out[f"hard{s}"] = [(dtheta != 0).cpu()]
        saved[label] = out
    if save:
        torch.save(saved, f"{OUT}_{tag}.pt")
    print("ARM " + json.dumps(dict(tag=tag, **res)), flush=True)


def plans():
    """#5 under other plans than the wrapper's, in turns with it."""
    np, torch, fl, LinearGaussian = setup(".")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alt = {"config2": [(100, 4, 32), (100, 4, 100), (100, 2, 64),
                       (52, 4, 52)],
           "config4": [(128, 4, 64), (64, 4, 32), (128, 2, 32),
                       (32, 4, 32), (64, 1, 64)]}
    for label in SHAPES:
        args, kw, _, _ = inputs(np, torch, fl, LinearGaussian, label)
        p, d, n, _, m, _ = SHAPES[label]
        own = fl.fused_linear_row_plan(p, d, n, m, sms)
        for tile, group, sub in alt[label]:
            smem = fl.fused_linear_row_smem_bytes(d, tile, group, sub)
            per_sm = 2 if smem <= 233472 // 2 - 1024 else 1
            chunk = -(-m // max(1, per_sm * sms // p))
            chunk = -(-chunk // group) * group
            other = fl.RowPlan(tile, group, sub, smem, (p, -(-m // chunk)),
                               chunk)
            fns = [lambda pl=pl: fl._launch("fused_linear_single", *args,
                                            eps=None, plan=pl, **kw)
                   for pl in (own, other, other, own)]
            ref, got = fns[0](), fns[1]()
            err = max(float((a - b).abs().max()) / max(1.0, float(
                a.abs().max())) for a, b in zip(ref, got))
            t = [device_ms(torch, fn, "fused_linear_", 200) for fn in fns]
            print(f"{label}: plan {own} {t[0]:.4f} / {t[3]:.4f} ms against "
                  f"{other} {t[1]:.4f} / {t[2]:.4f} ms (kernel device time); "
                  f"max err / max(1, max|own|) {err:.3g}", flush=True)


def main():
    trees = sys.argv[1:]  # the first is the parent
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    if trees == ["--plans"]:
        plans()
        return
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
    for label in SHAPES:
        for k in range(1, len(trees)):
            for what, ref in outs[0][label].items():
                got = outs[k][label][what]
                if what.startswith("hard"):
                    good = all(torch.equal(a, b) for a, b in zip(ref, got))
                    print(f"{label} {what}: {trees[k]} vs {trees[0]}: hard "
                          f"graphs bitwise equal {good}", flush=True)
                else:
                    errs = [float((a - b).abs().max()) / max(1.0, float(
                        a.abs().max())) for a, b in zip(ref, got)]
                    good = all(math.isfinite(e) and e <= 1e-4 for e in errs)
                    print(f"{label} {what}: {trees[k]} vs {trees[0]}: max "
                          f"err / max(1, max|first|) {max(errs):.3g}, within "
                          f"1e-4 {good}", flush=True)
                ok &= good
        for name in ("single", "pass1", "pass2"):
            key = f"{label}_{name}"
            print(f"{key} in turns ({' '.join(trees[k] for k in order)}): "
                  + ", ".join(f"{rows[k][order[:t].count(k)][key]['ms']:.4f}"
                              for t, k in enumerate(order))
                  + " ms (events); kernel device time: "
                  + ", ".join(
                      f"{rows[k][order[:t].count(k)][key]['kernel_ms']:.4f}"
                      for t, k in enumerate(order))
                  + " ms; two calls bitwise equal in every arm: "
                  + str(all(r[key]["bitwise"] for k in rows for r in rows[k])),
                  flush=True)
        kept, total = rows[0][0][f"{label}_replayed"]
        print(f"{label}: pass 2's weights are non-zero for {kept} of {total} "
              f"(particle, sample) pairs", flush=True)
    if not ok:
        raise SystemExit("the trees' outputs disagree")


if __name__ == "__main__":
    if sys.argv[1] == "--tree":
        arm(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
    else:
        main()
