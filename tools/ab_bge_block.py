"""The BGe determinant pairs #2 (``csrc/bge_pairs.cu``) past d = 32 of
several source trees, timed in turns on one CUDA card.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ab_bge_block.py _tree_check/parent .   # parent first

First the first tree makes config 6's inputs (``--samples``): the posterior
matrices R and one step's 6,400 hard graphs of ``MarginalDiBS`` + BGe at
``benchmarks/run_benchmarks.py``'s config 6 (scale-free d=128, N=100,
P=100, M=64, K=8; the step after ``chip_smoke.py`` phase 10's 3 warm-up
steps), saved to ``_tree_check/ab_out/``. Then it runs (parent, change,
change, parent) twice, each arm a process of its own (``--tree TREE TAG``)
that imports ``dibs_tpu_torch`` from its tree, builds it and times #2 on
those graphs and on random masks of phase 3's block-tier sizes, made from
numpy seeds: d=64 (2,048 graphs, density 0.5, k around 32), d=100 (512
graphs, density 0.7) and d=128 (512 graphs, density 0.3). Each time is the
median of CUDA-event-timed calls after a warm-up, and the device time of
the kernels whose name holds ``bge_pairs`` from ``torch.profiler``. Each
arm checks that two calls are bitwise equal; the first arm of each tree
saves its outputs, and the trees' outputs are then compared with the first
tree's, bitwise.
"""
import json
import os
import subprocess
import sys

# the sibling scripts' timing (this script's directory is sys.path[0])
from ab_sampler_bge import device_ms
from ab_wide_pass2 import median_ms

OUT = "_tree_check/ab_out/ab_bge_block"  # outputs of each tree's first arm
SAMPLES = "_tree_check/ab_out/ab_bge_block_config6.pt"
# random-mask cases: d, graphs, mask density
SHAPES = {"d64_B2048_p0.5": (64, 2048, 0.5), "d100_B512_p0.7": (100, 512, 0.7),
          "d128_B512_p0.3": (128, 512, 0.3)}
REPS = 10


def samples(tree):
    """Config 6's R and one step's hard graphs, from ``tree``'s engine."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from dibs_tpu_torch.inference import MarginalDiBS
    from dibs_tpu_torch.models import linear_gaussian as lg
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    dev = torch.device("cuda:0")
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=torch.Generator().manual_seed(123), n_vars=128,
        graph_prior_str="sf", device=dev)
    dibs = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                        n_grad_mc_samples=64, n_acyclicity_mc_samples=8,
                        device=dev)
    step = dibs._make_step(dibs._resolve_latent_std(128))
    state = dibs.init_state(seed=1, n_particles=100)
    for _ in range(3):
        state = step(state)
    captured = []
    pairs = lg.bge_logdet_pairs

    def capture(r_mats, gs):
        captured.append((r_mats.cpu(), gs.to(torch.uint8).cpu()))
        return pairs(r_mats, gs)

    lg.bge_logdet_pairs = capture
    try:
        step(state)
    finally:
        lg.bge_logdet_pairs = pairs
    r_mats, gs = captured[0]
    torch.save(dict(r_mats=r_mats, gs=gs), SAMPLES)
    k = gs.sum(1).float()
    print(f"config 6 samples: {tuple(gs.shape)} graphs, parent counts mean "
          f"{float(k.mean()):.3f} min {int(k.min())} max {int(k.max())}",
          flush=True)


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
    cases = {}
    saved = torch.load(SAMPLES)
    cases["config6_6400x128"] = (saved["r_mats"].to(dev),
                                 saved["gs"].to(dev).float())
    for label, (d, b, density) in SHAPES.items():
        rng = np.random.default_rng(d)
        x = torch.from_numpy(rng.normal(size=(100, d)).astype(np.float32))
        r_mats, _ = BGe(n_vars=d, device="cpu")._posterior_r_mats(
            x, torch.zeros_like(x, dtype=torch.int32))
        gs = (rng.uniform(size=(b, d, d)) < density).astype(np.float32)
        gs[:, np.arange(d), np.arange(d)] = 0.0
        cases[label] = (r_mats.contiguous().to(dev),
                        torch.from_numpy(gs).to(dev))
    res, outs = {}, {}
    for label, (r_mats, gs) in cases.items():
        def fn(r_mats=r_mats, gs=gs):
            return bge_logdet_pairs(r_mats, gs)

        out, again = fn(), fn()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        outs[label] = [o.cpu() for o in out]
        res[label] = dict(ms=median_ms(torch, fn, REPS),
                          kernel_ms=device_ms(torch, fn, "bge_pairs", 5),
                          bitwise=bitwise)
    if save:
        torch.save(outs, f"{OUT}_{tag}.pt")
    print("ARM " + json.dumps(dict(tag=tag, **res)), flush=True)


def main():
    trees = sys.argv[1:]  # the first is the parent
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    proc = subprocess.run([sys.executable, __file__, "--samples", trees[0]],
                          capture_output=True, text=True)
    print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
    if proc.returncode != 0:
        raise SystemExit("making config 6's samples failed")
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
            bitwise = all(torch.equal(a, b)
                          for a, b in zip(outs[0][label], outs[k][label]))
            diff = max(float((a - b).abs().max())
                       for a, b in zip(outs[0][label], outs[k][label]))
            ok &= bitwise
            print(f"{label}: {trees[k]} vs {trees[0]}: max |diff| "
                  f"{diff:.3g}, bitwise equal {bitwise}", flush=True)
    for label in outs[0]:
        print(f"{label} in turns ({' '.join(trees[k] for k in order)}): "
              + ", ".join(f"{rows[k][order[:t].count(k)][label]['ms']:.4f}"
                          for t, k in enumerate(order))
              + " ms (events); device time: "
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
    elif sys.argv[1] == "--samples":
        samples(sys.argv[2])
    else:
        main()
