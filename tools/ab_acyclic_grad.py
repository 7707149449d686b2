"""The fused acyclicity gradient #9 (``csrc/acyclic_grad.cu``) of several
source trees, timed in turns on one CUDA card.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ab_acyclic_grad.py _tree_check/parent .   # parent first

runs (parent, change, change, parent) twice, each arm a process of its own
(``--tree TREE TAG``) that imports ``dibs_tpu_torch`` from its tree, builds
it, makes the same scores from numpy seeds and times #9 (Philox noise,
alpha = 0.2) at the microbenchmark's P=1000, d=128, K=8, at d = 64 (the
last d of the 4 x 4 quad tier), at d = 100 (ragged, 8 x 8) and at d = 129
(the strided tier, unchanged: a control for the noise between arms). Each
time is the median of CUDA-event-timed calls after a warm-up, and the
kernel's own device time from ``torch.profiler``. Each arm checks that two
calls are bitwise equal; the first arm of each tree saves its outputs (and
those of one call with injected Logistic noise, P=64, d=128, K=4) to
``_tree_check/ab_out/``, and the trees' outputs are then compared with the
first tree's, bitwise.
"""
import json
import os
import subprocess
import sys

# the sibling scripts' timing (this script's directory is sys.path[0])
from ab_sampler_bge import device_ms
from ab_wide_pass2 import median_ms

OUT = "_tree_check/ab_out/ab_acyclic_grad"  # outputs of each tree's first arm
SHAPES = {"P1000_d128_K8": (1000, 128, 8), "P1000_d64_K8": (1000, 64, 8),
          "P1000_d100_K8": (1000, 100, 8), "P1000_d129_K8": (1000, 129, 8)}
REPS = 20


def arm(tree, tag, save):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from dibs_tpu_torch.ops import gpu_kernels as gk

    assert gk.__file__.startswith(os.path.abspath(tree)), gk.__file__
    dev = torch.device("cuda:0")
    gk.build()
    res, saved = {}, {}
    for label, (p, d, k) in SHAPES.items():
        rng = np.random.default_rng(d)
        scores = torch.from_numpy((0.5 * rng.normal(size=(p, d, d))).astype(
            np.float32)).to(dev)

        def fn(scores=scores, k=k):
            return gk.acyclic_grad(scores, 7, 0.2, k)

        out, again = fn(), fn()
        torch.cuda.synchronize()
        bitwise = torch.equal(out, again)
        saved[label] = out.cpu()
        del out, again
        res[label] = dict(ms=median_ms(torch, fn, REPS),
                          kernel_ms=device_ms(torch, fn, "acyclic_grad",
                                              REPS // 2),
                          bitwise=bitwise)
    rng = np.random.default_rng(5)
    scores = torch.from_numpy((0.5 * rng.normal(size=(64, 128, 128))).astype(
        np.float32)).to(dev)
    eps = torch.from_numpy(rng.logistic(size=(64, 4, 128, 128)).astype(
        np.float32)).to(dev)
    saved["injected_P64_d128_K4"] = gk.acyclic_grad(scores, 0, 0.2, 4,
                                                    eps=eps).cpu()
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
            bitwise = torch.equal(ref, got)
            ok &= bitwise
            print(f"{label}: {trees[k]} vs {trees[0]}: max |diff| "
                  f"{float((ref - got).abs().max()):.3g}, bitwise equal "
                  f"{bitwise}", flush=True)
    for label in SHAPES:
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
        raise SystemExit("the trees' outputs differ")


if __name__ == "__main__":
    if sys.argv[1] == "--tree":
        arm(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
    else:
        main()
