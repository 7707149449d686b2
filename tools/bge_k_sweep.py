"""#2 (``csrc/bge_pairs.cu``) past d = 32 by parent count, on one CUDA card.

    python tools/bge_k_sweep.py [--d 128] [--graphs 512] [--sass]

For each k of ``K`` it makes ``graphs`` random masks at d in which every
node has exactly k parents (numpy seed k), and times one call of
``bge_logdet_pairs`` on them: the device time of each kernel whose name
holds ``bge_pairs`` (``torch.profiler``, mean of 5 calls), the ns a pair,
the route ``gpu_kernels.bge_pairs_plan`` names, and the call's operation
bound (``dibs_tpu_torch.accounting.kernel_cost``'s 2 (k^3/3 + k^2) float32
operations a pair at the H100 SXM's 67 TFLOP/s) with the time's multiple of
it. Prints the card's ``nvidia-smi`` name and power
limit first. With ``--sass`` it times nothing: it reads the SASS of the
built library (``cuobjdump``) and prints, for each block-route kernel, its
pivot-step loops (a backward branch over one ``BAR.SYNC``, one a phase,
widest first): the instructions of each and how many are the updates' and
multipliers' ``FMUL`` / ``FADD``.
"""
import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import kernel_device_split  # noqa: E402
from dibs_tpu_torch.accounting import bound_ms, kernel_cost  # noqa: E402
from dibs_tpu_torch.models.linear_gaussian import BGe  # noqa: E402
from dibs_tpu_torch.ops import gpu_kernels as gk  # noqa: E402
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs  # noqa: E402

K = (4, 8, 15, 16, 20, 24, 28, 31, 32, 36, 40, 47, 48, 56, 63, 64, 72, 80,
     95, 96, 112, 127)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--graphs", type=int, default=512)
    args = ap.parse_args()
    d, b = args.d, args.graphs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    gk.build()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(100, d))
                         .astype(np.float32)).to(dev)
    r_mats, _ = BGe(n_vars=d, device=dev)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    r_mats = r_mats.contiguous()
    for k in (k for k in K if k < d):
        rng = np.random.default_rng(k)
        # k parents a node: the first k of a random order of the others
        order = np.argsort(rng.uniform(size=(b, d, d)), axis=1)
        gs = np.zeros((b, d, d), np.float32)
        for j in range(d):
            others = order[:, :, j][order[:, :, j] != j].reshape(b, d - 1)
            np.put_along_axis(gs[:, :, j], others[:, :k], 1.0, axis=1)
        gs_t = torch.from_numpy(gs).to(dev)
        split = kernel_device_split(lambda: bge_logdet_pairs(r_mats, gs_t),
                                    "bge_pairs", 5)
        total = sum(split.values())
        bound = bound_ms(kernel_cost("bge_pairs", gs=gs_t)[0], 0)[0]
        plan = gk.bge_pairs_plan(d, k)
        parts = ", ".join(f"{n[n.index('bge_pairs'):].split('(')[0]} {ms:.4f}"
                          for n, ms in sorted(split.items(),
                                              key=lambda kv: -kv[1]))
        print(f"d={d} k={k} graphs={b}: {total:.4f} ms, "
              f"{1e6 * total / (b * d):.2f} ns a pair, route {plan.route} "
              f"{plan.grid} x {plan.tile}; bound {bound:.5f} ms (x"
              f"{total / bound:.1f}); by kernel: {parts}", flush=True)


def sass_step_loops():
    """The block route's pivot-step loops in the built library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(gk._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", gk.build()._name],
                          capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", text):
        name = re.match(r"\S*(bge_pairs_block_kernel\w*?EE)", body)
        if not name:
            continue
        insts = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
        addrs = [int(a, 16) for a, _ in insts]
        loops = []
        for idx, (_, inst) in enumerate(insts):
            m = re.search(r"BRA (0x[0-9a-f]+)", inst)
            if not m or int(m.group(1), 16) >= addrs[idx]:
                continue
            loop = [i for _, i in insts[addrs.index(int(m.group(1), 16)):
                                        idx + 1]]
            if sum("BAR.SYNC" in i for i in loop) != 1:
                continue
            ops = [i.split()[1] if i.startswith("@") else i.split()[0]
                   for i in loop]
            loops.append((len(loop), sum(o.split(".")[0] in ("FMUL", "FADD")
                                         for o in ops)))
        print(f"{name.group(1)} step loops (instructions, FMUL + FADD): "
              f"{loops}", flush=True)


if __name__ == "__main__":
    if "--sass" in sys.argv:
        sass_step_loops()
    else:
        main()
