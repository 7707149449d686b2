#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on the GPU.

Usage (from the repository root, on a machine with one CUDA card)::

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: CUDA present, card name, compute capability, power limit,
   TF32 off;
2. build: compiles the CUDA kernels of ``dibs_tpu_torch/csrc`` (timed),
   with the registers, shared memory and spills ``-Xptxas -v`` reports for
   the kernels of #1, #2 (d <= 32, and past it the bits pass, the warp route
   and the block route's three frames), #3, #4, wide passes 1 and 2, #8
   and both tiers of #9;
3. kernel vs plain twin on the card at the main paths' shapes and more,
   with each kernel's and twin's median time (CUDA events), its bound (the
   least time an H100 SXM could take for the same work) and, where one
   PyTorch call computes the same function, that call's time; #2 bit for
   bit against its twin at every ``SHAPES_BGE`` case (d = 2 to 128, each
   with an empty, a full and a k-edge graph that reaches every route's
   parent-count edge); the fused
   linear-Gaussian kernels at the headline shape and at config 4's
   interventional d=30, N=600, and the fused MLP kernel #8 at config 3's
   shape and at d=30, N=600 (tiled rows), relu and tanh, with its plan, at
   the edges of its gate (``SHAPES_NL_EDGES``), and its cluster tier at
   config 7's shape (P=1000, d=50, N=100, h1=5, M=32, relu), timed beside
   the plain version and its bound, with its one launch and cluster
   counters a call; two calls bitwise equal;
4. in-kernel RNG: sample means of the hard and soft samplers against their
   expectations;
5. end to end, marginal: ``MarginalDiBS`` on a d=20 Erdos-Renyi BGe problem
   (N=100, P=30, k=20, M=128, K=32) with the ``score`` and ``score_rb``
   estimators; launch counts of every kernel, steps/s, AUROC, and the
   first 20 steps teacher-forced, their transport held against the plain
   twins (run on the CPU, which is where the port sends plain tensors);
6. end to end, joint: ``JointDiBS`` with ``LinearGaussian`` at
   ``benchmarks/run_benchmarks.py``'s config 2 (d=20 scale-free, N=100,
   P=30, k=20, M=128, K=32, the reparameterization estimator with shared
   noise) for 1000 steps through the one-pass fused kernel and 1000 through
   the two-pass pair; launch counts, steps/s, mixture AUROC > 0.6, and the
   first 20 one-pass steps teacher-forced against the CPU's plain versions;
   then ``JointDiBS`` with ``DenseNonlinearGaussian`` at config 3 (the same
   sizes, ``hidden_layers=(5,)``) for 2000 steps through kernel #8: exact
   launch counts, steps/s, mixture AUROC >= 0.6, and 20 teacher-forced
   steps against the CPU's plain versions; then config 5: the fused
   transport kernel #4 against its plain version at config 5's ``Z`` and
   ``Theta`` families, the d=20 marginal family and config 3's tree family
   (the port's former ``torch.matmul`` route as the library time), the wide
   fused linear tier at config 5's d=128, N=100, P=1000, M=32 (and d=75,
   N=600; d=602), the sampler #1 in soft mode at config 5's ``[1000, 8,
   128, 128]`` (timed beside its plain version and its bound), the SE
   matrix #3 against its plain version and float64
   from ``[1, 1]`` to config 5's ``[1000, 1000]`` over 32,768, symmetric
   (exactly, diagonal ``scale``) and not, timed at config 5 in turns with
   ``torch.cdist`` (#4 likewise with its former matmul route), and
   ``JointDiBS`` with ``LinearGaussian`` at config 5 (d=128 scale-free,
   N=100, P=1000, k=128, M=32, K=8; nothing cut) for 100 timed steps after
   10 warm-up steps: exact launch counts (the transport kernel, the wide
   fused linear tier, the sampler and the SE matrix only), steps/s, finite
   state, and teacher-forced ``phi`` for 3 steps against the plain versions
   on the card and for 5 steps at P=16 against those on the CPU;
7. profile: ``torch.profiler`` over 50 steady steps of the marginal
   (``score``), the joint linear, the joint nonlinear, the config-5 and the
   config-4 step (``JointDiBS`` + ``LinearGaussian``, scale-free d=30, 100
   observational and 5 x 100 interventional rows, P=20, M=128, K=32; #5
   launched exactly once a step, finite state): wall and device time per
   step, the device's busy share, kernel launches per step, the top
   kernels;
8. the fused acyclicity gradient #9 against its plain version at the
   microbenchmark's P=1000, d=128, K=8 and at its tiers' edges and ragged d
   (``SHAPES9``: 1, 2, 4, 5, 13, 30, 64, 65, 128, 129, 137, 139), Philox
   and injected noise, scores below -88/alpha, each particle within
   ``1e-4 max(1, max|plain[p]|)``, two calls bitwise equal; its time
   beside the plain version's, the engine route's (the library column),
   the cuBLAS chain's alone (``acyclic_constr`` forward on the ``[1000, 8,
   128, 128]`` soft samples) and the bound;
   its entry point ``python -m dibs_tpu_torch.ops.acyclic_kernel`` at its
   defaults, with exact launches and the 64-sample Monte Carlo agreement
   with the engine route; ``acyclicity='spectral'`` in ``MarginalDiBS``
   (bench shape, ``'sampled'``) and ``JointDiBS`` (config 2, ``'mean'``),
   100 steps each with exact launch counts; and a checkpoint round trip on
   the card (50 steps, save, load, 50 more equal 100 straight);
9. BGe past its kernel's range: the per-node scores of 20 graphs at
   d = 130 on the card (``masked_logdet_pd_pair`` over the nodes, no
   kernel launch) against the CPU's at ``rtol = atol = 1e-4``;
10. config 6: ``MarginalDiBS`` + BGe at ``benchmarks/run_benchmarks.py``'s
   config 6 (scale-free d=128, N=100, P=100, M=64, K=8; nothing cut) for
   3 warm-up and 10 timed steps: steps/s, peak device memory, finite state,
   exact launch counts (#2 once a step); then one step's 6,400 hard graphs
   captured: the histogram of parent counts k over its 819,200 (graph,
   node) pairs, #2 on them against its plain twin bit for bit (the twin in
   chunks of 64 graphs) and against float64 ``slogdet``, two calls bitwise
   equal; #2 timed there by CUDA events and profiler device time beside its
   bound, the twin (one chunk, scaled up) and ``torch.linalg.cholesky`` of
   the j-last masked matrices (one chunk, scaled up); then a 10-step
   profile; then the REINFORCE ratio's kernel #10 against its plain twin
   at config 6's ``[100, 64, 128, 128]`` (the sampler's hard graphs) and
   at ``SHAPES_RATIO`` (ragged d = 130 with M = 300, the scalar build at
   d = 13, graphs 4 bytes past a 16-byte boundary), within ``1e-6
   max|plain|``, two calls bitwise equal, timed at config 6's shape beside
   its bound, its twin and the float32 ``einsum`` that computes the same
   residual.

13. the fleet (``dibs_tpu_torch.fleet``): (a) kernels #1-#8 with a
   dataset axis at B = 1, 3, 8 and 32 datasets of the headline and joint
   shapes, against their plain twins with the axis (#1 exact off ties,
   #2 bitwise at d = 20, 32, 33, 64, 128) and their unbatched launches on
   each dataset (#1-#3 bitwise), timed at the fleet sizes beside B
   unbatched launches, the twin, the bound and a batched library call;
   #8's fleet build also at every gate edge of ``SHAPES_NL_EDGES`` with
   B = 1 and 3 and in each of its 16 instantiations (``FLEET_NL_CASES``);
   the wide passes' fleet builds at d = 75 and 128 with B = 1 and 3
   (``FLEET_WIDE_CASES``) and at config 5's shape with B = 2, timed there;
   (b) ``MarginalDiBS`` at the headline config (``score``, ``score_rb``)
   with B = 8 and 32 datasets and ``JointDiBS`` at configs 2 and 3 with
   B = 8, config 2 also with median bandwidths and with joint ``score``
   (baselines 0 and 0.5) and config 3's model with ``hidden_layers=(5,
   5)`` (the generic route): launches a fleet step equal to one dataset's
   step (required), dataset-steps/s over 50 steps after 5 beside B serial
   single runs in turns, peak device memory, a 50-step profile, and at B =
   8 the initial state and #1's step-0 and step-5 samples bitwise single
   engines' seeded ``fleet_seeds``, with 5 teacher-forced steps of each
   dataset's ``phi`` against them; config 5 with B = 2 alike (3
   teacher-forced steps, 10 timed after 3, a 10-step profile).
14. particle sharding (``dibs_tpu_torch.parallel``): (a) #1 per particle
   shard bitwise one launch, a one-rank NCCL world, two ``gloo`` ranks on
   the card running sharded ``MarginalDiBS`` ``score``; (b) #5-#8 per
   shard bitwise one launch, two ranks running ``JointDiBS`` at configs 2,
   3 and 5 and ``fleet_sample(mesh=)``; (c) the ``("p", "mc")`` mesh: #1's
   sample blocks bitwise one launch (headline hard split 2 and 4, config
   5's soft split 2, particle and sample offsets at once), timed in turns
   with the unsharded launch; ``1 x 2`` and ``2 x 2`` ``gloo`` worlds on
   the card running the headline ``score`` and ``score_rb``, joint
   ``score`` and the fused route at config 2 (20 teacher-forced steps
   against the unsharded ``phi`` at ``1e-4 max|phi|``, 50 free steps with
   graphs equal and every rank's final state bitwise the others'), and
   config 6 on ``1 x 2`` (3 teacher-forced steps, peak memory by rank).
15. accounting and warm-up (``dibs_tpu_torch.accounting``,
   ``dibs_tpu_torch.warmup``): ``warmup(20)`` of its three models, timed,
   with the launch counts and RNG states left as they were, every kernel
   of the three paths counted launched and ``sample()``
   bitwise the same before and after it, then timed in a new process; the
   reference's step model of each of phase 7's cells as a roofline row
   against its wall and device time a step (every share at most 105% of
   the H100 SXM's peaks); config 5's device time by the model's phases;
   every kernel time of phases 3, 6, 8 and 10 at or above 1/1.05 of its
   ``kernel_cost`` bound (the bounds of every phase come from
   ``kernel_cost`` and ``bound_ms``).

The second-to-last line is a JSON summary of the kernels, the line before it
the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

P, D, K_LAT, M, K_ACYC, N_OBS, STEPS = 30, 20, 20, 128, 32, 100, 1000
STEPS_NL = 2000  # config 3's quality length (benchmarks/run_benchmarks.py)
# config 5 (benchmarks/run_benchmarks.py:171-185), nothing cut
P5, D5, K5, M5, K_ACYC5, N5, STEPS5 = 1000, 128, 128, 32, 8, 100, 100
# config 4 (benchmarks/run_benchmarks.py:137-168): d=30, 600 rows, P=20
P4, D4 = 20, 30
# config 7 (portbench/configs/joint_nonlinear_sf50.json): #8's cluster tier
P7, D7, N7, H7, M7 = 1000, 50, 100, 5, 32
# the sampler #1's phase-3 cases (B, M, d): injected noise, and Philox noise
# with (alpha, tau, misaligned scores); d = 5 and 13 and misaligned scores
# take the scalar path, 600 x 128 passes 65,535 (B * M), 140,000 samples
# pass gridDim.y's 65,535 groups
SHAPES_GUMBEL = [(30, 128, 20), (30, 32, 20), (4, 8, 5), (4, 8, 13),
                 (4, 8, 128), (600, 128, 5)]
SHAPES_PHILOX = [(P, M, D, 1.0, 1.0, False), (4, 8, 5, 1.0, 1.0, False),
                 (4, 8, 13, 1.7, 1.3, False), (600, 128, 5, 1.0, 1.0, False),
                 (30, 32, 20, 1.0, 0.7, False), (30, 128, 20, 1.0, 1.0, True),
                 (4, 8, 128, 2.0, 1.0, False),
                 (1, 140_000, 2, 1.0, 1.0, False)]
# the BGe pairs #2's phase-3 cases (d, graphs, collinear data): the warp
# tier up to d = 32 (d = 31 and 32 at its lane edges), past it every pair
# routed by its parent count k; every case has an empty, a full (k = d - 1)
# and a k-edge graph (``K_EDGES``, k capped at d - 1)
SHAPES_BGE = [(2, 3840, False), (7, 3840, False), (20, 3840, False),
              (20, 512, True), (31, 512, False), (32, 512, False),
              (33, 256, False), (64, 256, False), (64, 256, True),
              (100, 64, False), (128, 48, False), (128, 48, True)]
# parent counts of the k-edge graph's nodes, in turn: the routes' edges
K_EDGES = (0, 1, 15, 16, 31, 32, 33, 63, 64, 65, 95, 96, 127)
# kernel #9 at its microbenchmark's defaults (benchmarks/bench_acyclic_kernel.py)
P9, D9, K9 = 1000, 128, 8
# (P, d, K): the quad tier's edges (1, 2, 4, 5; 64 | 65, 128) and the
# strided tier's (129, 139), and ragged d
SHAPES9 = [(64, 1, 4), (64, 2, 4), (64, 4, 4), (64, 5, 4), (64, 13, 4),
           (64, 30, 4), (32, 64, 4), (32, 65, 3), (16, 128, 3), (8, 129, 2),
           (32, 137, 2), (8, 139, 2)]
# BGe past its kernel's range (phase 9): d, graphs, observations
D_BGE_LARGE, B_BGE_LARGE, N_BGE_LARGE = 130, 20, 60
# config 6 (benchmarks/run_benchmarks.py:188-211), nothing cut: warm-up and
# timed steps, and the graphs a chunk of the twin and the library call take
P6, D6, M6, K_ACYC6, WARM6, STEPS6, CHUNK6 = 100, 128, 64, 8, 3, 10, 64
# kernel #10's phase-10 cases (P, M, d, misaligned graphs): ragged d and
# M past a staged chunk of weights, the scalar build (d * d odd), and the
# scalar build at an even d with graphs 4 bytes past a 16-byte boundary
SHAPES_RATIO = [(3, 300, 130, False), (5, 13, 13, False), (4, 9, 16, True)]
# phase 11, joint score at config 2: warm-up steps, then the timed window
WARM11, STEPS11 = 10, 200
# steps/s of phase 5 by estimator, for phase 12(d)'s StepTimer check
RATES = {}
# (label, kernel ms, bound ms) of the kernel times phases 3, 6, 8 and 10
# take (``timed``), for the accounting phase's check
TIMED = []
# phase 13, the fleet at the headline marginal config and joint configs 2
# and 3: datasets a fleet (joint: the first), warm-up and timed steps,
# teacher-forced steps (at the first fleet size)
FLEET_B, WARM13, STEPS13, TF13 = (8, 32), 5, 50, 5
# config 5's fleet: datasets, warm-up, timed and teacher-forced steps,
# profiled steps
FLEET_C5_B, WARM13_C5, STEPS13_C5, TF13_C5, PROF13_C5 = 2, 3, 10, 3, 10
# the batched kernels' cases: datasets (1, not a power of two, the fleet
# sizes), and #2 at d on both sides of 32 with every route's k edges
FLEET_KERNEL_B = (1, 3, 8, 32)
FLEET_BGE_D = (20, 32, 33, 64, 128)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_median_ms(fn, reps=50):
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


def bound(kernel, **shape):
    """``(ms, bound_by)``: the least time an H100 SXM could take for one
    call of ``kernel`` at ``shape`` (``dibs_tpu_torch.accounting``'s
    ``kernel_cost`` and ``bound_ms``)."""
    from dibs_tpu_torch.accounting import bound_ms, kernel_cost

    return bound_ms(*kernel_cost(kernel, **shape))


def timed(label, ms, b_ms):
    """Keeps a kernel time of phases 3, 6, 8 and 10 beside its bound for
    the accounting phase's check (no bound past 1.05x its time)."""
    TIMED.append((label, ms, b_ms))


def joint_state_cpu(state):
    """A joint state's ``z``, ``theta`` (a tree) and baseline on the CPU
    (the optimizer states stay: ``phi`` does not read them)."""
    from dibs_tpu_torch.utils.tree import tree_map

    return state._replace(z=state.z.cpu(),
                          theta=tree_map(lambda a: a.cpu(), state.theta),
                          sf_baseline=state.sf_baseline.cpu())


def logistic(rng, shape):
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, size=shape)
    return torch.from_numpy((np.log(u) - np.log1p(-u)).astype(np.float32))


# ---------------------------------------------------------------------------


def phase_env():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    torch.set_float32_matmul_precision("highest")
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cap = torch.cuda.get_device_capability(0)
    log(f"[1 env] device={torch.cuda.get_device_name(0)} capability="
        f"{cap[0]}.{cap[1]} card='{card}' torch={torch.__version__} "
        f"cuda={torch.version.cuda} tf32=off")
    return card


def ptxas_report(text):
    """``-Xptxas -v`` output -> {kernel (its name with the mangled template
    arguments, e.g. ``se_matrix_kernelILi8ELi8ELb1EE`` for ``<8, 8,
    true>``, ``fused_linear_wide_pass1_kernelILi4EE`` for ``<4>``): "N
    registers, S bytes static smem, spill stores / loads"}."""
    out, name, spill = {}, None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            full = m.group(1)
            k = re.search(r"[a-z_]+[0-9]*_kernel(?:I\w*?EE)?", full)
            name, spill = (k.group(0) if k else full), ""
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill stores {m.group(1)} B / loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m:  # no smem figure: dynamic shared memory only
            out[name] = (f"{m.group(1)} registers, {m.group(2) or 0} bytes "
                         f"static smem, {spill or 'no spill line'}")
            name = None
    return out


def kernel_device_split(fn, name, calls):
    """Mean device ms a call of ``fn`` spends in each CUDA kernel whose
    name holds ``name``, from ``torch.profiler``: ``{kernel name: ms}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and name in evt.name:
            split[evt.name] = (split.get(evt.name, 0.0)
                               + evt.time_range.elapsed_us() / 1e3 / calls)
    return split


def in_turns(first, second, reps):
    """Median ms of ``first`` and of ``second`` timed in turns in one
    call (first, second, second, first), each the mean of its two
    medians; returns ``(first_ms, second_ms, [the four medians])``."""
    t = [cuda_median_ms(fn, reps=reps)
         for fn in (first, second, second, first)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def phase_build():
    from dibs_tpu_torch.ops import gpu_kernels

    t0 = time.perf_counter()
    gpu_kernels.build()
    secs = time.perf_counter() - t0
    log_text = gpu_kernels.build_log()
    report = [ln.strip() for ln in log_text.splitlines()
              if "registers" in ln or "spill" in ln]
    log(f"[2 build] nvcc sm_90a build+load {secs:.2f} s; ptxas: "
        + " | ".join(report))
    per_kernel = ptxas_report(log_text)
    for name in ("gumbel_graphs_kernel", "bge_pairs_warp_kernel",
                 "bge_pairs_bits_kernel", "bge_pairs_warp_route_kernel",
                 "bge_pairs_block_kernel",
                 "se_matrix_kernel", "se_reduce_kernel",
                 "transport_phi_kernel", "fused_linear_kernel",
                 "fused_linear_wide_pass1_kernel", "fused_linear_wide_kernel",
                 "fused_nl_kernel", "acyclic_grad_quad_kernel",
                 "acyclic_grad_kernel"):
        found = {k: v for k, v in per_kernel.items() if name in k}
        check(bool(found), f"no ptxas report for {name}")
        for k, v in sorted(found.items()):
            log(f"[2 build] ptxas {k}: {v}")


def k_edge_graph(rng, d):
    """A ``[d, d]`` mask whose node j has ``K_EDGES[j % len(K_EDGES)]``
    parents (at most d - 1), drawn at random from the other nodes."""
    g = np.zeros((d, d), np.float32)
    for j in range(d):
        k = min(K_EDGES[j % len(K_EDGES)], d - 1)
        others = np.delete(np.arange(d), j)
        g[rng.choice(others, size=k, replace=False), j] = 1.0
    return g


def phase_kernels(dev, results):
    from dibs_tpu_torch.accounting import bound_ms, kernel_cost
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.bge_kernel import (
        bge_logdet_pairs,
        bge_logdet_pairs_plain,
    )

    rng = np.random.default_rng(0)

    # --- Gumbel sampler, injected noise ---
    err_g = 0.0
    for (b, m, d) in SHAPES_GUMBEL:
        scores = torch.from_numpy(
            rng.normal(size=(b, d, d)).astype(np.float32)).to(dev)
        eps = logistic(rng, (b, m, d, d)).to(dev)
        alpha, tau = 1.7, 1.3
        for hard in (True, False):
            out = gk.gumbel_graphs(scores, 11, 3, alpha, tau, m, hard, eps)
            ref = gk.gumbel_graphs_plain(scores, 11, 3, alpha, tau, m, hard,
                                         eps)
            diff = (out - ref).abs()
            if hard:
                tie = (eps + alpha * scores[:, None]).abs() < 1e-6
                bad = int(((diff > 0) & ~tie).sum())
                check(bad == 0, f"gumbel hard {b, m, d}: {bad} mismatches")
                err_g = max(err_g, float(diff[~tie].max()))
            else:
                check(float(diff.max()) <= 1e-6,
                      f"gumbel soft {b, m, d}: max err {float(diff.max())}")
                err_g = max(err_g, float(diff.max()))
    # in-kernel Philox vs the twin's Philox (same uniforms; the twin's log
    # form against the kernel's fast form at tau = 1 and its log form
    # otherwise): soft within 1e-5, hard exact off ties, two calls bitwise
    # equal; runs of 4 and the scalar path (d * d % 4 != 0, misaligned
    # scores), B * M > 65,535 and more samples than gridDim.y holds
    philox_err = 0.0
    for (b, m, d, alpha, tau, misaligned) in SHAPES_PHILOX:
        scores = torch.from_numpy(
            (2.0 * rng.normal(size=(b, d, d))).astype(np.float32)).to(dev)
        if misaligned:  # 4 bytes past a 16-byte boundary: the scalar path
            scores = torch.empty(b * d * d + 1, device=dev)[1:].view(
                b, d, d).copy_(scores)
        u = gk.philox_uniform((b, m, d, d), 5, 9, dev)
        logit = torch.log(u) - torch.log1p(-u) + alpha * scores[:, None]
        for hard in (True, False):
            out = gk.gumbel_graphs(scores, 5, 9, alpha, tau, m, hard)
            again = gk.gumbel_graphs(scores, 5, 9, alpha, tau, m, hard)
            ref = gk.gumbel_graphs_plain(scores, 5, 9, alpha, tau, m, hard)
            check(torch.equal(out, again),
                  f"gumbel {b, m, d} hard={hard}: two calls differ")
            diff = (out - ref).abs()
            if hard:
                bad = int(((diff > 0) & (logit.abs() >= 1e-5)).sum())
                check(bad == 0, f"gumbel Philox hard {b, m, d}: {bad} "
                                f"mismatches off ties")
            else:
                err = float(diff.max())
                check(err <= 1e-5, f"gumbel Philox soft {b, m, d} tau={tau}:"
                                   f" max err {err}")
                philox_err = max(philox_err, err)
        del u, logit, out, again, ref, diff
    scores = torch.from_numpy(
        rng.normal(size=(P, D, D)).astype(np.float32)).to(dev)
    t_g = cuda_median_ms(lambda: gk.gumbel_graphs(scores, 5, 9, 1.0, 1.0, M,
                                                  True))
    t_gp = cuda_median_ms(lambda: gk.gumbel_graphs_plain(scores, 5, 9, 1.0,
                                                         1.0, M, True))
    t_gs = cuda_median_ms(lambda: gk.gumbel_graphs(scores, 5, 9, 1.0, 1.0,
                                                   K_ACYC, False))
    t_gsp = cuda_median_ms(lambda: gk.gumbel_graphs_plain(
        scores, 5, 9, 1.0, 1.0, K_ACYC, False))
    log(f"[3 gumbel] injected noise: hard exact off ties, soft atol 1e-6 at "
        f"(B,M,d) in {SHAPES_GUMBEL}: max err {err_g:.3g}; Philox noise at "
        f"(B,M,d,alpha,tau,misaligned) in {SHAPES_PHILOX}: hard exact off "
        f"ties, soft max err {philox_err:.3g} (bar 1e-5), two calls bitwise "
        f"equal; hard [30,128,20,20] "
        f"kernel {t_g:.4f} ms twin {t_gp:.4f} ms; soft [30,32,20,20] "
        f"kernel {t_gs:.4f} ms twin {t_gsp:.4f} ms")
    b_ms, b_by = bound("gumbel_graphs", p=P, m=M, d=D)
    timed(f"#1 hard [{P},{M},{D},{D}]", t_g, b_ms)
    results["gumbel_graphs"] = dict(max_abs_err=max(err_g, philox_err),
                                    ms=t_g, plain_ms=t_gp, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)

    # --- BGe determinant pairs ---
    err_b, err_64 = 0.0, 0.0
    t_b = t_bp = None
    bitwise = []  # d values where the kernel equals the twin bit for bit
    for d, b, collinear in SHAPES_BGE:
        x = rng.normal(size=(N_OBS, d)).astype(np.float32)
        if collinear:
            x[:, 1] = x[:, 0] + 1e-3 * x[:, 1]
        x_t = torch.from_numpy(x).to(dev)
        bge = BGe(n_vars=d, device=dev)
        r_mats, _ = bge._posterior_r_mats(
            x_t, torch.zeros_like(x_t, dtype=torch.int32))
        r_mats = r_mats.contiguous()
        gs = (rng.uniform(size=(b, d, d)) < 0.3).astype(np.float32)
        gs[:, np.arange(d), np.arange(d)] = 0.0
        gs[0] = 0.0  # all-zero masks must give logdet_pa == 0
        gs[1] = 1.0 - np.eye(d)  # full masks: d - 1 parents
        gs[2] = k_edge_graph(rng, d)
        gs_t = torch.from_numpy(gs).to(dev)
        pa, full = bge_logdet_pairs(r_mats, gs_t)
        again = bge_logdet_pairs(r_mats, gs_t)
        pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs_t)
        check(torch.equal(pa, again[0]) and torch.equal(full, again[1]),
              f"bge d={d}: two calls differ")
        check(torch.equal(pa, pa_p) and torch.equal(full, full_p),
              f"bge d={d} collinear={collinear}: not bitwise the twin")
        bitwise.append(f"{d} collinear" if collinear else d)
        for got, ref in ((pa, pa_p), (full, full_p)):
            ok = torch.allclose(got, ref, rtol=1e-4, atol=1e-4)
            check(ok, f"bge d={d} collinear={collinear}: max err "
                      f"{float((got - ref).abs().max())}")
            err_b = max(err_b, float((got - ref).abs().max()))
        check(bool((pa[0] == 0).all()), f"bge d={d}: empty mask logdet != 0")
        # float64 slogdet of the masked submatrices, first 16 graphs
        r64 = r_mats.double()
        g64 = gs_t[:16].double()
        eye = torch.eye(d, dtype=torch.float64, device=dev)
        for j in range(d):
            par = g64[:, :, j]
            for mask, got in ((par, pa[:16, j]), (par + eye[j], full[:16, j])):
                outer = mask[:, :, None] * mask[:, None, :]
                mat = outer * r64[j] + (1 - outer) * eye
                ref = torch.linalg.slogdet(mat)[1]
                err_64 = max(err_64, float(((got.double() - ref).abs()
                                            / (1 + ref.abs())).max()))
        if d == D and not collinear:
            t_b = cuda_median_ms(lambda: bge_logdet_pairs(r_mats, gs_t))
            t_bp = cuda_median_ms(lambda: bge_logdet_pairs_plain(r_mats, gs_t))
            # the same function as one library call: slogdet of the masked
            # [Pa, Pa] and [Pa u j, Pa u j] matrices, masked outside the call
            par = gs_t.transpose(1, 2)  # [B, j, r] parent masks
            eye = torch.eye(d, device=dev)
            masks = torch.cat([par, torch.clamp(par + eye, max=1.0)])
            outer = masks[..., :, None] * masks[..., None, :]
            stacked = (outer * r_mats[None] + (1 - outer) * eye).reshape(
                -1, d, d).contiguous()
            t_lib = cuda_median_ms(lambda: torch.linalg.slogdet(stacked))
            flops_b, bytes_b = kernel_cost("bge_pairs", gs=gs_t)
            b_ms, b_by = bound_ms(flops_b, bytes_b)
            timed(f"#2 [{b} graphs, d={d}]", t_b, b_ms)
    check(err_64 <= 1e-4, f"bge vs float64 slogdet: rel err {err_64}")
    log(f"[3 bge] (d, graphs, collinear) in {SHAPES_BGE}, masks of density "
        f"0.3 with one empty, one full and one k-edge graph (k in {K_EDGES}), "
        f"vs twin (rtol=atol=1e-4) max err "
        f"{err_b:.3g}, bitwise equal to the twin at d in {bitwise}, two "
        f"calls bitwise equal; vs float64 slogdet max |err|/(1+|ref|) "
        f"{err_64:.3g}; [3840 graphs, d=20] kernel {t_b:.4f} ms twin "
        f"{t_bp:.4f} ms slogdet {t_lib:.4f} ms bound {b_ms:.5f} ms ({b_by}; "
        f"operations {bound_ms(flops_b, 0)[0]:.5f} ms for {flops_b:.4g} "
        f"FLOP, bytes {bound_ms(0, bytes_b)[0]:.5f} ms)")
    results["bge_pairs"] = dict(max_abs_err=err_b, ms=t_b, plain_ms=t_bp,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=t_lib)

    # --- SE kernel matrix ---
    err_s = 0.0
    t_s = t_sp = None
    for (a, n) in [(30, 800), (100, 32768)]:
        x = torch.from_numpy((rng.normal(size=(a, n)) / math.sqrt(K_LAT))
                             .astype(np.float32)).to(dev)
        sq_mean = float(2.0 * n / K_LAT)
        for h, scale in ((5.0, 1.0), (sq_mean, 0.7)):
            out = gk.se_matrix(x, x, h, scale)
            ref = gk.se_matrix_plain(x, x, h, scale)
            e = float((out - ref).abs().max())
            check(e <= 1e-5, f"se {a, a, n} h={h}: max err {e}")
            check(bool((torch.diagonal(out) == scale).all()),
                  f"se {a, a, n}: diagonal != scale")
            err_s = max(err_s, e)
        if n == 800:
            t_s = cuda_median_ms(lambda: gk.se_matrix(x, x, 5.0, 1.0))
            t_sp = cuda_median_ms(lambda: gk.se_matrix_plain(x, x, 5.0, 1.0))
            b_ms, b_by = bound("se_matrix", a=a, n=n, triangle=True)
            timed(f"#3 [{a},{a}] over {n}", t_s, b_ms)
    log(f"[3 se] (A,B,n) in (30,30,800),(100,100,32768) atol 1e-5 max err "
        f"{err_s:.3g}, diagonal == scale; [30,30,800] kernel {t_s:.4f} ms "
        f"twin {t_sp:.4f} ms")
    results["se_matrix"] = dict(max_abs_err=err_s, ms=t_s, plain_ms=t_sp,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def fused_problem(rng, dev, p, d, n, interv_blocks):
    """Random fused-linear inputs: scores, Theta, data and the observation
    weights, with ``interv_blocks`` blocks of 100 interventional rows after
    the first 100 (``ceil(0.1 d)`` clamped nodes each, as config 4)."""
    scores = rng.normal(size=(p, d, d)).astype(np.float32)
    thetas = rng.normal(size=(p, d, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.zeros((n, d), np.float32)
    for b in range(interv_blocks):
        nodes = rng.choice(d, size=math.ceil(0.1 * d), replace=False)
        mask[100 * (b + 1):100 * (b + 2), nodes] = 1.0
    return [torch.from_numpy(a).to(dev) for a in (scores, thetas, x,
                                                   1.0 - mask)]


# the row tier's edges (d, N): d from 2 to the gate's 70, N from one row to
# tiled rows (129: one row past a 128-row tile); P=3, M=9 (a partial group)
SHAPES_ROW_EDGES = [(d, n) for d in (2, 7, 20, 30, 69, 70)
                    for n in (1, 100, 128, 129, 600)]


def check_row_edges(fl, dev, rng, err, shapes=SHAPES_ROW_EDGES):
    """Kernels #5-#7 at ``shapes`` (d, N) against their plain versions
    under injected, Philox and shared-stream noise, with interventional
    rows past the first 100; two calls of each bitwise equal. Returns the
    worst error as a share of the bar."""
    from dibs_tpu_torch.models import LinearGaussian

    worst, p, m = 0.0, 3, 9
    for d, n in shapes:
        scores, thetas, x, w = fused_problem(rng, dev, p, d, n,
                                             max(0, (n - 1) // 100))
        args = (scores, thetas, x, w)
        for noise in ("injected", "philox", "philox-shared"):
            kw = dict(seed=23, streams=(6, 6 if noise == "philox-shared"
                                        else 7),
                      alpha=1.3, tau=0.9, n_samples=m,
                      model=LinearGaussian(n_vars=d))
            if noise == "injected":
                kw["eps"] = (logistic(rng, (p, m, d, d)).to(dev),
                             logistic(rng, (p, m, d, d)).to(dev))
            lls_p = fl.fused_linear_pass1_plain(*args, **kw)
            weights = tuple(torch.softmax(ll, dim=1) for ll in lls_p)
            calls = {
                "fused_linear_single": (
                    lambda: fl.fused_linear_single(*args, **kw),
                    fl.fused_linear_single_plain(*args, **kw)),
                "fused_linear_pass1": (
                    lambda: fl.fused_linear_pass1(*args, **kw), lls_p),
                "fused_linear_pass2": (
                    lambda: fl.fused_linear_pass2(*args, weights, **kw),
                    fl.fused_linear_pass2_plain(*args, weights, **kw)),
            }
            for name, (kern, refs) in calls.items():
                got, again = kern(), kern()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{name} d={d} N={n} {noise}: two calls differ")
                for a, b in zip(got, refs):
                    worst = max(worst, err(name, a, b))
    return worst


def phase_fused(dev, results):
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.models import LinearGaussian

    rng = np.random.default_rng(3)
    model = LinearGaussian(n_vars=D)
    errs = {"fused_linear_single": 0.0, "fused_linear_pass1": 0.0,
            "fused_linear_pass2": 0.0}

    def err(name, got, ref):
        e = float((got - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"{name}: max err {e} > {tol}")
        errs[name] = max(errs[name], e)
        return e / tol

    worst = 0.0
    for p, d, n, blocks in [(P, D, N_OBS, 0), (20, 30, 600, 5)]:
        scores, thetas, x, w = fused_problem(rng, dev, p, d, n, blocks)
        for alpha, tau in ((2.0, 1.0), (0.7, 0.8)):
            for noise in ("injected", "philox", "philox-shared"):
                kw = dict(seed=17, streams=(4, 4 if noise == "philox-shared"
                                            else 5),
                          alpha=alpha, tau=tau, n_samples=M, model=model)
                if noise == "injected":
                    kw["eps"] = (logistic(rng, (p, M, d, d)).to(dev),
                                 logistic(rng, (p, M, d, d)).to(dev))
                args = (scores, thetas, x, w)
                single = fl.fused_linear_single(*args, **kw)
                single_p = fl.fused_linear_single_plain(*args, **kw)
                lls = fl.fused_linear_pass1(*args, **kw)
                lls_p = fl.fused_linear_pass1_plain(*args, **kw)
                weights = tuple(torch.softmax(ll, dim=1) for ll in lls_p)
                two = fl.fused_linear_pass2(*args, weights, **kw)
                two_p = fl.fused_linear_pass2_plain(*args, weights, **kw)
                for got, ref in zip(single, single_p):
                    worst = max(worst, err("fused_linear_single", got, ref))
                for got, ref in zip(lls, lls_p):
                    worst = max(worst, err("fused_linear_pass1", got, ref))
                for got, ref in zip(two, two_p):
                    worst = max(worst, err("fused_linear_pass2", got, ref))
                # kernel #5 against kernels #6 + #7 (softmax of #6 between)
                weights_k = tuple(torch.softmax(ll, dim=1) for ll in lls)
                for got, ref in zip(single, fl.fused_linear_pass2(
                        *args, weights_k, **kw)):
                    e = float((got - ref).abs().max())
                    tol = 1e-4 * max(1.0, float(ref.abs().max()))
                    check(e <= tol, f"fused single vs two-pass: {e} > {tol}")
                for name, again in (
                        ("fused_linear_single",
                         fl.fused_linear_single(*args, **kw)),
                        ("fused_linear_pass1",
                         fl.fused_linear_pass1(*args, **kw)),
                        ("fused_linear_pass2",
                         fl.fused_linear_pass2(*args, weights, **kw))):
                    first = {"fused_linear_single": single,
                             "fused_linear_pass1": lls,
                             "fused_linear_pass2": two}[name]
                    check(all(torch.equal(a, b) for a, b in zip(first, again)),
                          f"{name} P={p} d={d} N={n}: two calls differ")
        # times at this shape, in-kernel noise (the main path's mode)
        kw = dict(seed=17, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=M,
                  model=model)
        args = (scores, thetas, x, w)
        lls = fl.fused_linear_pass1(*args, **kw)
        weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
        kept = int(((weights[0] != 0) | (weights[1] != 0)).sum())
        shape = dict(p=p, m=M, n=n, d=d)
        times = {
            "fused_linear_single": (
                lambda: fl.fused_linear_single(*args, **kw),
                lambda: fl.fused_linear_single_plain(*args, **kw), shape),
            "fused_linear_pass1": (
                lambda: fl.fused_linear_pass1(*args, **kw),
                lambda: fl.fused_linear_pass1_plain(*args, **kw), shape),
            "fused_linear_pass2": (
                lambda: fl.fused_linear_pass2(*args, weights, **kw),
                lambda: fl.fused_linear_pass2_plain(*args, weights, **kw),
                dict(shape, replayed=kept)),
        }
        line = []
        for name, (kern, plain, cost) in times.items():
            t_k, t_p = cuda_median_ms(kern, reps=20), cuda_median_ms(plain,
                                                                     reps=5)
            b_ms, b_by = bound(name, **cost)
            timed(f"{name} P={p} d={d} N={n}", t_k, b_ms)
            line.append(f"{name} {t_k:.4f} ms (plain {t_p:.4f}, bound "
                        f"{b_ms:.5f} {b_by})")
            if d == D:  # the headline shape is the one the main path runs
                results[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None)
        plan = fl.fused_linear_row_plan(
            p, d, n, M, torch.cuda.get_device_properties(
                dev).multi_processor_count)
        log(f"[3 fused P={p} d={d} N={n} M={M}] " + "; ".join(line)
            + f"; plan {plan}; pass 2 replays {kept} of {p * M} (particle, "
            f"sample) pairs (the rest have both weights exactly 0)")
    edges = check_row_edges(fl, dev, rng, err)
    log(f"[3 fused edges] #5-#7 at d in (2, 7, 20, 30, 69, 70) x N in (1, "
        f"100, 128, 129, 600), P=3, M=9, injected / Philox / shared-stream "
        f"noise: within 1e-4 max(1, max|ref|), worst {edges:.3f} of the bar; "
        f"two calls bitwise equal")
    for name, e in errs.items():
        results[name]["max_abs_err"] = e
    log(f"[3 fused] kernels vs plain at (P,d,N) in (30,20,100),(20,30,600 "
        f"with interventions), injected / Philox / shared-stream noise, "
        f"single and two-pass, #5 vs #6+#7: within 1e-4 max(1, max|ref|), "
        f"worst {worst:.3f} of the bar")


def nonlinear_problem(rng, dev, p, d, n, h1, interv_blocks):
    """Random #8 inputs in the kernel's layout (scores, W1, L1, b1, W2 || b2,
    data, observation weights), interventional blocks as in
    ``fused_problem``."""
    from dibs_tpu_torch.inference.fused_nonlinear import kernel_layout
    from dibs_tpu_torch.models import DenseNonlinearGaussian

    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
    theta = model.sample_parameters(
        generator=torch.Generator().manual_seed(int(rng.integers(1 << 30))),
        n_vars=d, n_particles=p, device=dev)
    scores, _, x, w = fused_problem(rng, dev, p, d, n, interv_blocks)
    return (scores, *kernel_layout(theta, model), x, w)


# (P, d, N, h1, interventional blocks, M, activation) of #8's gate edges:
# the widest d at h1 = 5 and at h1 = 16, one data row, and h1 = 1 at its
# widest d over tiled rows; h1 = 16, 1 and 7 take the kernels whose hidden
# width is rounded up (16, 4, 8), with sigmoid and leaky relu
SHAPES_NL_EDGES = [(3, 40, 100, 5, 0, 9, "relu"),
                   (2, 22, 100, 16, 0, 7, "sigmoid"),
                   (2, 23, 1, 16, 0, 5, "tanh"),
                   (3, 67, 37, 1, 0, 5, "leakyrelu"),
                   (4, 13, 130, 7, 1, 6, "sigmoid")]
# #8's fleet build (kFleet), as (B, P, d, N, h1, blocks, M, act): the gate
# edges at B = 1 and 3, and each of its 16 instantiations (hidden widths 5,
# 16, 4 and 8, the four activations) at a small shape with B = 3
FLEET_NL_CASES = ([(nb, *c) for c in SHAPES_NL_EDGES for nb in (1, 3)]
                  + [(3, 2, 12, 40, h1, 0, 5, act) for h1 in (5, 16, 1, 7)
                     for act in ("relu", "tanh", "sigmoid", "leakyrelu")])


def cluster_plan_at(fnl, d, h1, n, ranks):
    """#8's plan at ``(d, h1, N)`` forced to ``ranks`` blocks a particle (1,
    or a cluster of 2, 4 or 8; every data row resident where that fits,
    else tiles), or ``None``."""
    for resident in (True, False):
        plan = fnl._block_plan(d, h1, n, ranks, resident)
        if plan is not None:
            return fnl.NonlinearPlan(ranks, *plan)
    return None


def check_fused_nonlinear(fnl, args, kw, label):
    """#8 against its plain version within ``1e-4 max(1, max|ref|)`` and
    two calls bitwise equal; returns ``(worst / bar, max abs err)``."""
    got = fnl.fused_nonlinear(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(
        got, fnl.fused_nonlinear(*args, **kw))),
        f"fused_nonlinear {label}: two calls differ")
    worst, err_max = 0.0, 0.0
    for a, b in zip(got, fnl.fused_nonlinear_plain(*args, **kw)):
        e = float((a - b).abs().max())
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        check(e <= tol, f"fused_nonlinear {label}: max err {e} > {tol}")
        worst, err_max = max(worst, e / tol), max(err_max, e)
    return worst, err_max


def cluster_nonlinear(fnl, dev, rng, results):
    """#8's cluster build at config 7's shape (relu): against its plain
    version with Philox noise on one shared stream (the engine's) and with
    injected noise, one call's launches and cluster counters counted from
    zero, and its time beside the plain version's and its bound."""
    from torch.profiler import ProfilerActivity, profile

    from dibs_tpu_torch import profiling
    from dibs_tpu_torch.accounting import bound_ms, kernel_cost
    from dibs_tpu_torch.models import DenseNonlinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk

    p, d, n, h1, m = P7, D7, N7, H7, M7
    plan = fnl.fused_nonlinear_plan(d, h1, n)
    check(fnl.fused_nonlinear_tile_rows(d, h1, n) is None and plan is not None
          and plan.ranks > 1,
          f"#8 at d={d}, h1={h1}, N={n} is not the cluster build's ({plan})")
    args = nonlinear_problem(rng, dev, p, d, n, h1, 0)
    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
    kw = dict(seed=31, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=m,
              model=model)
    worst, err_max = check_fused_nonlinear(fnl, args, kw,
                                           f"cluster d={d} philox-shared")
    eps = (logistic(rng, (p, m, d, d)).to(dev),
           logistic(rng, (p, m, d, d)).to(dev))
    w, e = check_fused_nonlinear(fnl, args, dict(kw, streams=(4, 5), eps=eps),
                                 f"cluster d={d} injected")
    worst, err_max = max(worst, w), max(err_max, e)
    del eps
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    with profile(activities=[ProfilerActivity.CPU]):
        fnl.fused_nonlinear(*args, **kw)
        torch.cuda.synchronize()
    launches = {k: v for k, v in gk.LAUNCHES.items() if v}
    counts = profiling.counters()
    check(launches == {"fused_nonlinear": 1},
          f"#8's cluster tier: one call launched {launches}")
    check(counts == {"fused_nl_cluster.calls": 1,
                     "fused_nl_cluster.ranks": plan.ranks},
          f"#8's cluster tier: one call counted {counts}, plan {plan}")
    t_k = cuda_median_ms(lambda: fnl.fused_nonlinear(*args, **kw), reps=20)
    t_p = cuda_median_ms(lambda: fnl.fused_nonlinear_plain(*args, **kw),
                         reps=5)
    flops, n_bytes = kernel_cost("fused_nonlinear", p=p, m=m, n=n, d=d, h1=h1)
    b_ms, b_by = bound_ms(flops, n_bytes)
    timed(f"#8 cluster P={p} d={d} N={n} h1={h1}", t_k, b_ms)
    results["fused_nonlinear_cluster"] = dict(
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_abs_err=err_max, launches=launches["fused_nonlinear"])
    log(f"[3 fused_nonlinear cluster P={p} d={d} N={n} h1={h1} M={m} relu "
        f"{plan}] kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}, {flops / 1e9:.3f} GFLOP); one call: "
        f"launches {launches}, counters {counts}; vs plain with Philox noise "
        f"on one shared stream and injected noise: within 1e-4 max(1, "
        f"max|ref|), worst {worst:.3f} of the bar, max abs err "
        f"{err_max:.3g}; two calls bitwise equal")


def phase_fused_nonlinear(dev, results):
    from dibs_tpu_torch.accounting import bound_ms, kernel_cost
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian

    rng = np.random.default_rng(5)
    worst, err_max = 0.0, 0.0

    def run(args, kw, label):
        nonlocal worst, err_max
        w, e = check_fused_nonlinear(fnl, args, kw, label)
        worst, err_max = max(worst, w), max(err_max, e)

    for p, d, n, h1, blocks in [(P, D, N_OBS, 5, 0), (20, 30, 600, 5, 5)]:
        args = nonlinear_problem(rng, dev, p, d, n, h1, blocks)
        plan = fnl.fused_nonlinear_plan(d, h1, n)
        check(plan.ranks == 1, f"#8 at d={d}, h1={h1}, N={n} is not one "
                               f"block's ({plan})")
        for activation in ("relu", "tanh"):
            model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,),
                                           activation=activation)
            for alpha, tau in ((2.0, 1.0), (0.7, 0.8)):
                for noise in ("injected", "philox", "philox-shared"):
                    kw = dict(seed=23, streams=(
                        4, 4 if noise == "philox-shared" else 5),
                        alpha=alpha, tau=tau, n_samples=M, model=model)
                    if noise == "injected":
                        kw["eps"] = (logistic(rng, (p, M, d, d)).to(dev),
                                     logistic(rng, (p, M, d, d)).to(dev))
                    run(args, kw, f"d={d} N={n} {activation} {noise} "
                                  f"alpha={alpha}")
        model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
        kw = dict(seed=23, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=M,
                  model=model)
        t_k = cuda_median_ms(lambda: fnl.fused_nonlinear(*args, **kw),
                             reps=20)
        t_p = cuda_median_ms(lambda: fnl.fused_nonlinear_plain(*args, **kw),
                             reps=5)
        flops, n_bytes = kernel_cost("fused_nonlinear", p=p, m=M, n=n, d=d,
                                     h1=h1)
        b_ms, b_by = bound_ms(flops, n_bytes)
        timed(f"#8 P={p} d={d} N={n} h1={h1}", t_k, b_ms)
        log(f"[3 fused_nonlinear P={p} d={d} N={n} h1={h1} M={M} {plan}]"
            f" kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}, {flops / 1e9:.3f} GFLOP)")
        if d == D:  # the shape config 3's main path runs
            results["fused_nonlinear"] = dict(
                ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
    for p, d, n, h1, blocks, m, activation in SHAPES_NL_EDGES:
        args = nonlinear_problem(rng, dev, p, d, n, h1, blocks)
        model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,),
                                       activation=activation)
        for noise in ("injected", "philox"):
            kw = dict(seed=29, streams=(4, 5), alpha=1.3, tau=0.9,
                      n_samples=m, model=model)
            if noise == "injected":
                kw["eps"] = (logistic(rng, (p, m, d, d)).to(dev),
                             logistic(rng, (p, m, d, d)).to(dev))
            run(args, kw, f"edge d={d} N={n} h1={h1} {activation} {noise}")
    results["fused_nonlinear"]["max_abs_err"] = err_max
    cluster_nonlinear(fnl, dev, rng, results)
    log(f"[3 fused_nonlinear] kernel vs plain at (P,d,N,h1) in (30,20,100,5)"
        f",(20,30,600,5 with interventions, tiled rows), relu and tanh, "
        f"injected / Philox / shared-stream noise, tau 1 and 0.8, and at the "
        f"gate edges (P,d,N,h1,blocks,M,act) {SHAPES_NL_EDGES}: within "
        f"1e-4 max(1, max|ref|), worst {worst:.3f} of the bar; two calls "
        f"bitwise equal at every case")


def transport_problem(gen, dev, p, n, joint):
    """Random inputs of one transport family: SE kernel matrices over random
    particles (dense, entries spread over (0, 1]), scores ``g`` and values
    ``v`` with a common offset (which the centring removes), ``mu``."""
    def kmat():
        x = torch.randn(p, 8, generator=gen, device=dev) / 4.0
        return torch.exp(-torch.cdist(x, x).square())

    k_own = kmat()
    k_other = kmat() if joint else None
    g = torch.randn(p, n, generator=gen, device=dev)
    v = 3.0 + torch.randn(p, n, generator=gen, device=dev)
    return k_own, k_other, g, v, v.mean(dim=0, keepdim=True)


def phase_transport(dev, results):
    """Kernel #4 against its plain version at the families the main paths
    send it: config 5's ``Z`` and ``Theta``, the d=20 marginal ``Z``, config
    3's ``Theta`` tree, and a ragged shape; with the port's former
    ``torch.matmul`` route as the library time."""
    from dibs_tpu_torch.inference.transport import (
        _se_repulsion,
        _weighted_scores,
    )
    from dibs_tpu_torch.ops import transport_kernel as tk

    gen = torch.Generator(device=dev).manual_seed(7)
    worst, err_max, line = 0.0, 0.0, []
    for name, p, n, joint, h in [
            ("config 5 Z", P5, D5 * K5 * 2, True, 5.0),
            ("config 5 Theta", P5, D5 * D5, True, 500.0),
            ("d=20 marginal Z", P, D * K_LAT * 2, False, 5.0),
            ("config 3 Theta tree", P, 2220, True, 500.0),
            ("ragged", 7, 130, True, 5.0), ("ragged", 7, 130, False, 5.0),
            ("ragged", P5, 130, True, 5.0),
            ("misaligned", 8, 256, True, 5.0)]:
        k_own, k_other, g, v, mu = transport_problem(gen, dev, p, n, joint)
        if name == "misaligned":  # aligned shape, pointers off 16 bytes
            g = torch.empty(p * n + 1, device=dev)[1:].view(p, n).copy_(g)
        c = -2.0 / h
        got = tk.transport_phi(k_own, k_other, g, v, c=c, mu=mu)
        want = tk.transport_phi_plain(k_own, k_other, g, v, c=c, mu=mu)
        e = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        check(e <= tol, f"transport_phi {name} P={p} n={n}: {e} > {tol}")
        worst, err_max = max(worst, e / tol), max(err_max, e)
        if name in ("ragged", "misaligned"):
            continue
        k_mat = k_own + k_other if joint else k_own

        def matmul_route():  # the port's former two-matmul route
            return -(_weighted_scores(k_mat, g)
                     + _se_repulsion(k_own, c, v)) / p

        e_lib = float((matmul_route() - want).abs().max())
        check(e_lib <= tol, f"matmul route {name}: {e_lib} > {tol}")
        t_lib, t_k, four = in_turns(
            matmul_route, lambda: tk.transport_phi(k_own, k_other, g, v, c=c,
                                                   mu=mu), 20)
        t_p = cuda_median_ms(lambda: tk.transport_phi_plain(
            k_own, k_other, g, v, c=c, mu=mu), reps=20)
        b_ms, b_by = bound("transport_phi", p=p, n=n,
                           n_mats=2 if joint else 1)
        timed(f"#4 {name} [{p},{n}]", t_k, b_ms)
        aligned = tk.transport_phi_aligned(p, n, k_own, g, v, mu)
        line.append(f"{name} [{p},{n}] {'joint' if joint else 'marginal'} "
                    f"({'aligned' if aligned else 'scalar'} instantiation) "
                    f"kernel {t_k:.4f} ms plain {t_p:.4f} matmul route "
                    f"{t_lib:.4f} (in turns: "
                    + ", ".join(f"{t:.4f}" for t in four)
                    + f") bound {b_ms:.5f} ({b_by})")
        if name == "config 5 Z":  # the main path of this slice
            results["transport_phi"] = dict(ms=t_k, plain_ms=t_p,
                                            bound_ms=b_ms, bound_by=b_by,
                                            library_ms=t_lib)
    results["transport_phi"]["max_abs_err"] = err_max
    log("[6 config 5: transport_phi] " + "; ".join(line))
    log(f"[6 config 5: transport_phi] kernel vs plain within 1e-4 max(1, "
        f"max|ref|) at all shapes (ragged [7,130] joint and marginal, "
        f"[1000,130] and a misaligned [8,256] included), worst "
        f"{worst:.3f} of the bar")


# (P, d, N, interventional blocks, M) of the wide tier's checks: config 5,
# a ragged column tile with tiled, interventional rows, the tier's edge,
# pass 1's edges (one particle, d = 71, M not a multiple of its group of 4,
# N not a multiple of its row quads; a group of 2 over tiled rows), and
# M = 40, past one 32-sample ballot of pass 2's replay list
SHAPES6 = [(P5, D5, N5, 0, M5), (6, 75, 600, 5, 8), (2, 602, 30, 0, 8),
           (1, 71, 37, 0, 5), (3, 200, 300, 2, 7), (2, 100, 200, 1, 40)]


def weight_edges(p, m, dev):
    """Pass 2's weight edges: uniform weights 1/M (every sample replayed)
    and one-hot weights (sample p mod M soft, the next one hard)."""
    uni = torch.full((p, m), 1.0 / m, device=dev)
    hot = torch.zeros(p, m, device=dev)
    hot[torch.arange(p), torch.arange(p) % m] = 1.0
    return {"uniform": (uni, uni), "one-hot": (hot, hot.roll(1, dims=1))}


def phase_config5_kernels(dev, results):
    """The wide fused linear tier against the plain versions at every shape
    of ``SHAPES6`` (pass 2 also with uniform and one-hot weights), two calls
    of each pass bitwise equal at each, and both passes timed at config 5's
    shape (d=128, N=100, P=1000, M=32); pass 1 also with two noise streams,
    which adds one Philox draw an element, pass 2 also with every sample
    replayed."""
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.models import LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk

    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev).manual_seed(9)
    worst, errs = 0.0, {"fused_linear_wide_pass1": 0.0,
                        "fused_linear_wide_pass2": 0.0}

    def err(name, got, ref):
        e = float((got - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"{name}: max err {e} > {tol}")
        if name in errs:
            errs[name] = max(errs[name], e)
        return e / tol

    for p, d, n, blocks, m in SHAPES6:
        scores, thetas, x, w = fused_problem(rng, dev, p, d, n, blocks)
        model = LinearGaussian(n_vars=d)
        for alpha, tau in ((2.0, 1.0), (0.7, 0.8)):
            for noise in ("injected", "philox", "philox-shared"):
                kw = dict(seed=17, streams=(4, 4 if noise == "philox-shared"
                                            else 5),
                          alpha=alpha, tau=tau, n_samples=m, model=model)
                if noise == "injected":
                    kw["eps"] = tuple(torch.logit(torch.rand(
                        (p, m, d, d), generator=gen, device=dev).clamp(
                            1e-6, 1 - 1e-6)) for _ in range(2))
                args = (scores, thetas, x, w)
                lls = fl.fused_linear_pass1(*args, **kw)
                check(all(torch.equal(a, b) for a, b in zip(
                    lls, fl.fused_linear_pass1(*args, **kw))),
                    f"wide pass 1 at (P,d,N,M)={(p, d, n, m)}: two calls "
                    "differ")
                lls_p = fl.fused_linear_pass1_plain(*args, **kw)
                for got, ref in zip(lls, lls_p):
                    worst = max(worst, err("fused_linear_wide_pass1", got,
                                           ref))
                weights = tuple(torch.softmax(ll, dim=1) for ll in lls_p)
                two = fl.fused_linear_pass2(*args, weights, **kw)
                check(all(torch.equal(a, b) for a, b in zip(
                    two, fl.fused_linear_pass2(*args, weights, **kw))),
                    f"wide pass 2 at (P,d,N,M)={(p, d, n, m)}: two calls "
                    "differ")
                two_p = fl.fused_linear_pass2_plain(*args, weights, **kw)
                for got, ref in zip(two, two_p):
                    worst = max(worst, err("fused_linear_wide_pass2", got,
                                           ref))
                # the wide tier's two passes against the one-pass plain
                # version (the estimand of kernel #5)
                weights_k = tuple(torch.softmax(ll, dim=1) for ll in lls)
                for got, ref in zip(fl.fused_linear_pass2(
                        *args, weights_k, **kw),
                        fl.fused_linear_single_plain(*args, **kw)):
                    worst = max(worst, err("wide two-pass vs one-pass plain",
                                           got, ref))
                kw.pop("eps", None)
        for wts in weight_edges(p, m, dev).values():
            for got, ref in zip(fl.fused_linear_pass2(*args, wts, **kw),
                                fl.fused_linear_pass2_plain(*args, wts,
                                                            **kw)):
                worst = max(worst, err("fused_linear_wide_pass2", got, ref))
        if (p, d, n) != (P5, D5, N5):
            continue
        # times at config 5's shape, in-kernel shared noise (the main path)
        kw = dict(seed=17, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=m,
                  model=model)
        lls = fl.fused_linear_pass1(*args, **kw)
        weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
        # pass 2 skips the samples whose two weights are both 0
        kept = int(((weights[0] != 0) | (weights[1] != 0)).sum())
        n_ct = -(-d // 8)
        shape = dict(p=p, m=m, n=n, d=d)
        cases = {
            "fused_linear_wide_pass1": (
                lambda: fl.fused_linear_pass1(*args, **kw),
                lambda: fl.fused_linear_pass1_plain(*args, **kw), shape),
            "fused_linear_wide_pass2": (
                lambda: fl.fused_linear_pass2(*args, weights, **kw),
                lambda: fl.fused_linear_pass2_plain(*args, weights, **kw),
                dict(shape, replayed=kept)),
        }
        # the noise's share: a second stream draws once more per element
        kw2 = {**kw, "streams": (4, 5)}
        t_shared, t_two, _ = in_turns(
            lambda: fl.fused_linear_pass1(*args, **kw),
            lambda: fl.fused_linear_pass1(*args, **kw2), reps=10)
        plan = fl.fused_linear_wide_pass1_plan(p, d, n)
        log(f"[6 config 5: wide pass 1] {plan}; shared stream {t_shared:.4f}"
            f" ms, two streams {t_two:.4f} ms (one more draw an element: "
            f"{t_two - t_shared:.4f} ms for {p * m * d * (d - 1)} draws)")
        # pass 2's cost per replayed sample: these weights against uniform
        # ones (every sample replayed), in turns
        uni = weight_edges(p, m, dev)["uniform"]
        t_kept, t_all, four = in_turns(
            lambda: fl.fused_linear_pass2(*args, weights, **kw),
            lambda: fl.fused_linear_pass2(*args, uni, **kw), reps=10)
        log(f"[6 config 5: wide pass 2] "
            f"{fl.fused_linear_wide_pass2_plan(p, d, n)}; in turns: "
            f"{kept} of {p * m} samples replayed {t_kept:.4f} ms, all "
            f"{p * m} replayed {t_all:.4f} ms ("
            + ", ".join(f"{t:.4f}" for t in four) + ")")
        line = []
        for name, (kern, plain, cost) in cases.items():
            t_k = cuda_median_ms(kern, reps=10)
            t_p = cuda_median_ms(plain, reps=3)
            b_ms, b_by = bound(name, **cost)
            timed(f"{name} P={p} d={d} N={n}", t_k, b_ms)
            line.append(f"{name} {t_k:.4f} ms (plain {t_p:.4f}, bound "
                        f"{b_ms:.5f} {b_by})")
            results[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
        log(f"[6 config 5: fused wide P={p} d={d} N={n} M={m} column tiles="
            f"{n_ct} tile rows={fl.fused_linear_wide_tile_rows(d, n)}] "
            + "; ".join(line) + f"; pass 2 replays {kept} of {p * m} "
            f"samples (the rest have both weights 0)")
    for name, e in errs.items():
        results[name]["max_abs_err"] = e
    # the sampler #1 at config 5's soft shape (the acyclicity prior's K
    # samples): scores read once, [P, K, d, d] graphs written once
    scores = torch.randn(P5, D5, D5, generator=gen, device=dev)
    soft = gk.gumbel_graphs(scores, 7, 0, 1.0, 1.0, K_ACYC5, False)
    e = float((soft - gk.gumbel_graphs_plain(scores, 7, 0, 1.0, 1.0, K_ACYC5,
                                             False)).abs().max())
    check(e <= 1e-5, f"gumbel soft at config 5: max err {e}")
    del soft
    t_k = cuda_median_ms(lambda: gk.gumbel_graphs(scores, 7, 0, 1.0, 1.0,
                                                  K_ACYC5, False), reps=10)
    t_p = cuda_median_ms(lambda: gk.gumbel_graphs_plain(
        scores, 7, 0, 1.0, 1.0, K_ACYC5, False), reps=3)
    b_ms, b_by = bound("gumbel_graphs", p=P5, m=K_ACYC5, d=D5)
    timed(f"#1 soft [{P5},{K_ACYC5},{D5},{D5}]", t_k, b_ms)
    log(f"[6 config 5: gumbel soft [{P5},{K_ACYC5},{D5},{D5}]] kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
        f"{P5 * K_ACYC5 * D5 * (D5 - 1)} Philox draws; kernel vs plain "
        f"(same Philox) max err {e:.3g}")
    log(f"[6 config 5: fused wide] wide tier vs plain at (P,d,N,blocks,M) "
        f"in {SHAPES6} (interventional blocks of 100 rows; tiled rows past "
        f"each pass's tile), injected / Philox / shared-stream noise, "
        f"alpha,tau in (2,1),(0.7,0.8), pass 2 also with uniform and one-hot "
        f"weights, and vs the one-pass plain version: within 1e-4 max(1, "
        f"max|ref|), worst {worst:.3f} of the bar; passes 1 and 2 bitwise "
        f"equal over two calls at every case")



# (A, B, n) of #3's correctness check: the d=20 [30, 30] over 800, config
# 5's [1000, 1000] over the Theta and Z rows, ragged and edge shapes
SHAPES3 = [(1, 1, 1), (7, 7, 130), (30, 30, 800), (129, 129, 2220),
           (P5, P5, D5 * D5), (P5, P5, D5 * K5 * 2), (7, 129, 130)]


def se_float64(x, y, h, scale):
    """``scale exp(-||x_a - y_b||^2 / h)`` in float64 (the Gram form, exact
    enough in float64), the reference beside the plain version."""
    x64, y64 = x.double(), y.double()
    sq = (x64.square().sum(1)[:, None] + y64.square().sum(1)[None]
          - 2.0 * x64 @ y64.T).clamp(min=0.0)
    return scale * torch.exp(-sq / h)


def phase_se_matrix(dev, results):
    """#3 against its plain version (atol 1e-5) and float64 at ``SHAPES3``,
    symmetric (``y is x``: exactly symmetric, diagonal exactly ``scale``)
    and not; then config 5's two shapes timed in turns with
    ``torch.cdist(x, x)``, the nearest single PyTorch call (the distances
    alone, no exp), as the library time."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    gen = torch.Generator(device=dev).manual_seed(3)
    err_p = err_64 = 0.0
    for a, b, n in SHAPES3:
        h, scale = (500.0 if n == D5 * D5 else 5.0), 0.7
        x = torch.randn(a, n, generator=gen, device=dev) * math.sqrt(
            h / (2.0 * n))
        y = torch.randn(b, n, generator=gen, device=dev) * math.sqrt(
            h / (2.0 * n))
        calls = [("non-symmetric", x, y)]
        if a == b:
            calls.append(("symmetric", x, x))
        for kind, xa, yb in calls:
            out = gk.se_matrix(xa, yb, h, scale)
            torch.cuda.synchronize()
            e = float((out - gk.se_matrix_plain(xa, yb, h, scale)).abs().max())
            e64 = float((out.double() - se_float64(xa, yb, h, scale))
                        .abs().max())
            check(e <= 1e-5, f"se {kind} {a, b, n}: max err {e} vs plain")
            check(e64 <= 1e-5, f"se {kind} {a, b, n}: max err {e64} vs "
                  "float64")
            check(bool(torch.isfinite(out).all()), f"se {kind} {a, b, n}: "
                  "not finite")
            if kind == "symmetric":
                check(torch.equal(out, out.T), f"se {a, b, n}: not exactly "
                      "symmetric")
                check(bool((torch.diagonal(out) == scale).all()),
                      f"se {a, b, n}: diagonal != scale")
            err_p, err_64 = max(err_p, e), max(err_64, e64)
    log(f"[6 se] (A,B,n) in {SHAPES3}, symmetric (y is x) and not: vs plain "
        f"max err {err_p:.3g}, vs float64 {err_64:.3g} (atol 1e-5); "
        f"symmetric outputs exactly symmetric, diagonal == scale")

    line = []
    for n, h in ((D5 * K5 * 2, 5.0), (D5 * D5, 500.0)):
        x = torch.randn(P5, n, generator=gen, device=dev) * math.sqrt(
            h / (2.0 * n))
        tiles = gk.se_tile_count(P5, P5, True, gk.se_tile_size(P5, P5))
        t_lib, t_s, four = in_turns(lambda: torch.cdist(x, x),
                                    lambda: gk.se_matrix(x, x, h, 1.0), 20)
        t_p = cuda_median_ms(lambda: gk.se_matrix_plain(x, x, h, 1.0),
                             reps=3)
        # the symmetric call's least work: one triangle with its diagonal
        b_ms, b_by = bound("se_matrix", a=P5, n=n, triangle=True)
        full_ms, _ = bound("se_matrix", a=P5, b=P5, n=n)
        timed(f"#3 [{P5},{P5}] over {n}", t_s, b_ms)
        slots = gk._slots(gk.build(), x.device, gk.se_tile_size(P5, P5))
        line.append(
            f"over n={n}: kernel {t_s:.4f} ms (symmetric, {tiles} tiles x "
            f"{gk.se_split(tiles, n, slots)} feature slices, {slots} "
            f"resident blocks) cdist {t_lib:.4f} ms (in turns: "
            + ", ".join(f"{t:.4f}" for t in four)
            + f") plain {t_p:.4f} ms bound {b_ms:.5f} ({b_by}; the full "
            f"matrix {full_ms:.5f})")
        if n == D5 * K5 * 2:  # config 5's Z family, the main path's largest
            results["se_matrix"] = dict(max_abs_err=err_p, ms=t_s,
                                        plain_ms=t_p, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=t_lib)
    log("[6 config 5: se [1000,1000]] " + "; ".join(line))


def phase_rng(dev):
    from dibs_tpu_torch.ops import gpu_kernels as gk

    rng = np.random.default_rng(1)
    scores = torch.from_numpy(
        rng.uniform(-1.4, 1.4, size=(P, D, D)).astype(np.float32)).to(dev)
    offdiag = ~torch.eye(D, dtype=torch.bool, device=dev)
    hard = gk.gumbel_graphs(scores, 123, 7, 1.0, 1.0, M, True)
    p = torch.sigmoid(scores)
    se = torch.sqrt(p * (1 - p) / M)
    z_hard = ((hard.mean(1) - p).abs() / se)[:, offdiag]
    check(float(z_hard.max()) < 5.0, f"hard mean off by {float(z_hard.max())} SE")

    s2 = scores[:2]
    soft = gk.gumbel_graphs(s2, 123, 8, 1.0, 1.0, M, False)
    ref = gk.gumbel_graphs_plain(s2, 321, 8, 1.0, 1.0, 100_000, False)
    mu, sd = ref.mean(1), ref.std(1)
    z_soft = ((soft.mean(1) - mu).abs() / (sd / math.sqrt(M)))[:, offdiag]
    check(float(z_soft.max()) < 5.0, f"soft mean off by {float(z_soft.max())} SE")
    log(f"[4 rng] hard M=128 means vs sigmoid(alpha s): max {float(z_hard.max()):.2f} "
        f"SE over {z_hard.numel()} entries; soft means vs 1e5-draw twin: "
        f"max {float(z_soft.max()):.2f} SE")


def phase_e2e(dev, card, steps):
    from dibs_tpu_torch.inference import MarginalDiBS
    from dibs_tpu_torch.metrics import threshold_metrics
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=gen, n_vars=D, graph_prior_str="er", n_observations=N_OBS,
        n_ho_observations=N_OBS, device=dev)

    def make(estimator, device, lik):
        return MarginalDiBS(x=data.x.to(device), graph_model=gm,
                            likelihood_model=lik, grad_estimator_z=estimator,
                            n_grad_mc_samples=M,
                            n_acyclicity_mc_samples=K_ACYC, device=device)

    final = {}
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    for estimator in ("score", "score_rb"):
        dibs = make(estimator, dev, lm)
        state = dibs.init_state(seed=1, n_particles=P, n_dim_particles=K_LAT)
        step = dibs._make_step(dibs._resolve_latent_std(K_LAT))
        state = step(state)  # first step outside the timed window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            state = step(state)
        torch.cuda.synchronize()
        rate = (steps - 1) / (time.perf_counter() - t0)
        check(bool(torch.isfinite(state.z).all()), f"{estimator}: z not finite")
        check(bool(torch.isfinite(state.opt_state_z[0].nu).all()),
              f"{estimator}: nu not finite")
        g = dibs.particle_to_g_lim(state.z)
        auc_e = threshold_metrics(dist=dibs.get_empirical(g), g=data.g)["roc_auc"]
        auc_m = threshold_metrics(dist=dibs.get_mixture(g), g=data.g)["roc_auc"]
        final[estimator] = dibs
        RATES[estimator] = rate
        log(f"[5 e2e {estimator}] {steps} steps, {rate:.2f} steps/s on "
            f"'{card}'; AUROC empirical {auc_e:.4f} mixture {auc_m:.4f}")
        if estimator == "score_rb":
            check(auc_e > 0.6, f"score_rb empirical AUROC {auc_e} <= 0.6")
    launches = dict(gk.LAUNCHES)
    for name in ("gumbel_graphs", "bge_pairs", "se_matrix", "score_ratio"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the marginal path")
    check(launches["transport_phi"] == 2 * steps,
          f"transport_phi launched {launches['transport_phi']} times in "
          f"2 x {steps} marginal steps")
    log(f"[5 launches] {launches}")

    # teacher-forced: kernels (card) vs plain twins (CPU), same state+noise,
    # over the first 20 steps. (Late in a run alpha(t) = t multiplies the
    # edge scores, so the last-ulp difference between the card's and the
    # CPU's z-matmul flips hard samples near their threshold; at t ~ 1000
    # that alone reached 1.5x the bar, with the kernels bitwise equal.)
    rng = np.random.default_rng(2)
    for estimator, dibs in final.items():
        state = dibs.init_state(seed=2, n_particles=P, n_dim_particles=K_LAT)
        cpu = make(estimator, "cpu", BGe(n_vars=D, device="cpu"))
        std = dibs._resolve_latent_std(K_LAT)
        phi_gpu, phi_cpu = dibs._make_phi(std), cpu._make_phi(std)
        step = dibs._make_step(std)
        worst = 0.0
        for _ in range(20):
            noise = (logistic(rng, (P, M, D, D)), logistic(rng, (P, K_ACYC, D, D)))
            st_cpu = state._replace(
                z=state.z.cpu(), sf_baseline=state.sf_baseline.cpu(),
                opt_state_z=(state.opt_state_z[0]._replace(
                    nu=state.opt_state_z[0].nu.cpu()),))
            with torch.no_grad():
                a, _ = phi_gpu(state, tuple(e.to(dev) for e in noise))
                b, _ = phi_cpu(st_cpu, noise)
            a = a.cpu()
            err = float((a - b).abs().max())
            tol = 1e-4 * float(b.abs().max())
            worst = max(worst, err / max(tol, 1e-30))
            check(err <= tol, f"{estimator} t={state.t}: phi err {err} > {tol}")
            state = step(state, tuple(e.to(dev) for e in noise))
        log(f"[5 teacher-forced {estimator}] steps t=0..19: "
            f"max |phi_kernel - phi_twin| / (1e-4 max|phi|) = {worst:.3f}")
    return launches


def replayed_share(step, state, steps):
    """``"k of n"``: the (particle, sample) pairs of ``steps`` steps whose
    pass-2 weights are not both exactly 0 (counted on the device, outside
    the launch counts)."""
    from dibs_tpu_torch.inference import fused_linear as fl

    pass2, counts = fl.fused_linear_pass2, []

    def counting(scores, thetas, x, w, weights, **kw):
        counts.append(((weights[0] != 0) | (weights[1] != 0)).sum())
        return pass2(scores, thetas, x, w, weights, **kw)

    fl.fused_linear_pass2 = counting
    try:
        for _ in range(steps):
            state = step(state)
    finally:
        fl.fused_linear_pass2 = pass2
    check(len(counts) == steps, f"pass 2 ran {len(counts)} times in {steps} "
                                "two-pass steps")
    return f"{int(torch.stack(counts).sum())} of {steps * P * M}"


def phase_joint(dev, card, steps):
    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.metrics import threshold_metrics
    from dibs_tpu_torch.models import LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import make_linear_gaussian_model

    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_linear_gaussian_model(
        generator=gen, n_vars=D, n_observations=N_OBS,
        n_ho_observations=N_OBS, device=dev)

    def make(device, lik, single_pass=True):
        return JointDiBS(x=data.x.to(device), graph_model=gm,
                         likelihood_model=lik, n_grad_mc_samples=M,
                         n_acyclicity_mc_samples=K_ACYC,
                         fused_single_pass=single_pass, device=device)

    # the default one-pass route (kernel #5), then the two-pass route
    # (kernels #6 and #7); each route's counts are set to 0 just before it
    total = dict.fromkeys(gk.LAUNCHES, 0)
    for route, single_pass, fused in (
            ("one-pass", True, ("fused_linear_single",)),
            ("two-pass", False, ("fused_linear_pass1",
                                 "fused_linear_pass2"))):
        dibs = make(dev, lm, single_pass)
        std = dibs._resolve_latent_std(K_LAT)
        step = dibs._make_step(std)
        for name in gk.LAUNCHES:
            gk.LAUNCHES[name] = 0
        state = dibs.init_state(seed=1, n_particles=P, n_dim_particles=K_LAT)
        state = step(state)  # first step outside the timed window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            state = step(state)
        torch.cuda.synchronize()
        rate = (steps - 1) / (time.perf_counter() - t0)
        launches = dict(gk.LAUNCHES)
        for tensor, what in ((state.z, "z"), (state.theta, "theta"),
                             (state.opt_state_z[0].nu, "nu_z"),
                             (state.opt_state_theta[0].nu, "nu_theta")):
            check(bool(torch.isfinite(tensor).all()),
                  f"joint {route}: {what} not finite")
        for name in fused:
            check(launches[name] == steps,
                  f"{name} launched {launches[name]} times in {steps} steps")
        check(launches["transport_phi"] == 2 * steps,
              f"transport_phi launched {launches['transport_phi']} times in "
              f"{steps} joint steps")
        for name in ("gumbel_graphs", "se_matrix"):
            check(launches[name] > 0,
                  f"joint {route}: kernel {name} never launched")
        g = dibs.particle_to_g_lim(state.z)
        auc_e = threshold_metrics(dist=dibs.get_empirical(g, state.theta),
                                  g=data.g)["roc_auc"]
        auc_m = threshold_metrics(dist=dibs.get_mixture(g, state.theta),
                                  g=data.g)["roc_auc"]
        log(f"[6 e2e joint {route}] {steps} steps, {rate:.2f} steps/s on "
            f"'{card}'; AUROC empirical {auc_e:.4f} mixture {auc_m:.4f}; "
            f"launches {launches}")
        check(auc_m > 0.6, f"joint {route} mixture AUROC {auc_m} <= 0.6")
        for name, count in launches.items():
            total[name] += count
        if not single_pass:  # pass 2's replayed share, 200 further steps
            log(f"[6 e2e joint two-pass] pass 2 replayed "
                f"{replayed_share(step, state, 200)} (particle, sample) "
                f"pairs over 200 further steps (the rest have both weights "
                f"exactly 0)")

    # teacher-forced: kernels (card) vs plain versions (CPU), same state
    # and noise, over the first 20 steps
    rng = np.random.default_rng(4)
    dibs = make(dev, lm)
    cpu = make("cpu", LinearGaussian(n_vars=D))
    step = dibs._make_step(std)
    phi_gpu, phi_cpu = dibs._make_phi(std), cpu._make_phi(std)
    state = dibs.init_state(seed=2, n_particles=P, n_dim_particles=K_LAT)
    worst = 0.0
    for _ in range(20):
        eps = logistic(rng, (P, M, D, D))  # shared: soft and hard
        noise = (eps, eps, logistic(rng, (P, K_ACYC, D, D)))
        noise_dev = tuple(e.to(dev) for e in noise)
        with torch.no_grad():
            got = phi_gpu(state, noise_dev)
            want = phi_cpu(joint_state_cpu(state), noise)
        for a, b, what in zip(got, want, ("z", "theta")):
            err = float((a.cpu() - b).abs().max())
            tol = 1e-4 * float(b.abs().max())
            worst = max(worst, err / max(tol, 1e-30))
            check(err <= tol, f"joint phi_{what} t={state.t}: {err} > {tol}")
        state = step(state, noise_dev)
    log(f"[6 teacher-forced joint] steps t=0..19: max |phi_kernel - "
        f"phi_plain| / (1e-4 max|phi|) = {worst:.3f} (phi_z and phi_theta)")
    return total


def phase_joint_nonlinear(dev, card, steps):
    """``JointDiBS`` with the MLP likelihood at config 3
    (``benchmarks/run_benchmarks.py:118-134``): d=20 scale-free,
    ``hidden_layers=(5,)``, N=100, P=30, k=20, M=128, K=32, the defaults
    otherwise; ``steps`` steps (config 3's quality length is 2000), then 20
    teacher-forced steps of the card's kernels against the plain versions
    on this machine's CPU."""
    import warnings

    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.metrics import threshold_metrics
    from dibs_tpu_torch.models import DenseNonlinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import make_nonlinear_gaussian_model
    from dibs_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_nonlinear_gaussian_model(
        generator=gen, n_vars=D, n_observations=N_OBS,
        n_ho_observations=N_OBS, device=dev)

    def make(device, lik):
        return JointDiBS(x=data.x.to(device), graph_model=gm,
                         likelihood_model=lik, n_grad_mc_samples=M,
                         n_acyclicity_mc_samples=K_ACYC, device=device)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dibs = make(dev, lm)
    advice = [str(w.message)[:60] for w in caught]
    std = dibs._resolve_latent_std(K_LAT)
    step = dibs._make_step(std)
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    state = dibs.init_state(seed=1, n_particles=P, n_dim_particles=K_LAT)
    state = step(state)  # first step outside the timed window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state = step(state)
    torch.cuda.synchronize()
    rate = (steps - 1) / (time.perf_counter() - t0)
    launches = dict(gk.LAUNCHES)
    for k, tensor in enumerate([state.z, state.opt_state_z[0].nu]
                               + tree_leaves(state.theta)
                               + tree_leaves(state.opt_state_theta[0].nu)):
        check(bool(torch.isfinite(tensor).all()),
              f"joint nonlinear: state tensor {k} not finite")
    want = dict.fromkeys(gk.LAUNCHES, 0)
    want.update(fused_nonlinear=steps, gumbel_graphs=steps,
                se_matrix=2 * steps, transport_phi=2 * steps)
    check(launches == want, f"joint nonlinear launches {launches}, expected "
                            f"{want}")
    g = dibs.particle_to_g_lim(state.z)
    auc_e = threshold_metrics(dist=dibs.get_empirical(g, state.theta),
                              g=data.g)["roc_auc"]
    auc_m = threshold_metrics(dist=dibs.get_mixture(g, state.theta),
                              g=data.g)["roc_auc"]
    log(f"[6 e2e joint nonlinear] {steps} steps, {rate:.2f} steps/s on "
        f"'{card}'; AUROC empirical {auc_e:.4f} mixture {auc_m:.4f}; "
        f"launches {launches}; construction warnings {advice}")
    check(auc_m >= 0.6, f"joint nonlinear mixture AUROC {auc_m} < 0.6")

    # teacher-forced: kernels (card) vs plain versions (CPU), same state
    # and noise, over the first 20 steps, per component (Z, each leaf)
    rng = np.random.default_rng(6)
    cpu = make("cpu", DenseNonlinearGaussian(n_vars=D, hidden_layers=(5,)))
    phi_gpu, phi_cpu = dibs._make_phi(std), cpu._make_phi(std)
    state = dibs.init_state(seed=2, n_particles=P, n_dim_particles=K_LAT)
    worst = 0.0
    for _ in range(20):
        eps = logistic(rng, (P, M, D, D))  # shared: soft and hard
        noise = (eps, eps, logistic(rng, (P, K_ACYC, D, D)))
        noise_dev = tuple(e.to(dev) for e in noise)
        with torch.no_grad():
            got = phi_gpu(state, noise_dev)
            want_phi = phi_cpu(joint_state_cpu(state), noise)
        for k, (a, b) in enumerate(zip(tree_leaves(list(got)),
                                       tree_leaves(list(want_phi)))):
            err = float((a.cpu() - b).abs().max())
            tol = 1e-4 * float(b.abs().max())
            worst = max(worst, err / max(tol, 1e-30))
            check(err <= tol, f"joint nonlinear phi component {k} "
                              f"t={state.t}: {err} > {tol}")
        state = step(state, noise_dev)
    log(f"[6 teacher-forced joint nonlinear] steps t=0..19: max |phi_kernel "
        f"- phi_plain| / (1e-4 max|phi|) = {worst:.3f} (phi_z and every "
        f"phi_theta leaf)")
    return launches


@contextlib.contextmanager
def plain_on_card():
    """Within the block the kill switch is off
    (``config.set_pallas_enabled(False)``): every kernel wrapper sends its
    CUDA tensors to its plain version, so a phi built there runs the plain
    versions on the card."""
    from dibs_tpu_torch import config

    config.set_pallas_enabled(False)
    try:
        yield
    finally:
        config.set_pallas_enabled(None)


def phase_config5(dev, card, steps):
    """``JointDiBS`` + ``LinearGaussian`` at config 5
    (``benchmarks/run_benchmarks.py:171-185``, nothing cut): scale-free
    d=128, N=100, P=1000, k=128, M=32, K=8, the joint defaults. 10 warm-up
    steps, then ``steps`` timed steps with exact launch counts; then
    teacher-forced ``phi`` for 3 steps against the plain versions on the
    card and for 5 steps at P=16 against the plain versions on the CPU."""
    import warnings

    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.models import LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import make_linear_gaussian_model

    gen = torch.Generator().manual_seed(123)
    data, gm, lm = make_linear_gaussian_model(
        generator=gen, n_vars=D5, n_observations=N5, n_ho_observations=N5,
        device=dev)

    def make(device, lik):
        return JointDiBS(x=data.x.to(device), graph_model=gm,
                         likelihood_model=lik, n_grad_mc_samples=M5,
                         n_acyclicity_mc_samples=K_ACYC5, device=device)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dibs = make(dev, lm)
    advice = [str(w.message)[:60] for w in caught]
    check(not any("fused linear-Gaussian kernels disabled" in a
                  for a in advice), f"config 5 warned: {advice}")
    check(getattr(dibs.est.fused_grad_both, "__name__", None)
          == "fused_linear", "config 5 does not take the fused linear route")
    std = dibs._resolve_latent_std(K5)
    step = dibs._make_step(std)
    state = dibs.init_state(seed=1, n_particles=P5, n_dim_particles=K5)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(10):  # warm-up, outside the counted window
        state = step(state)
    torch.cuda.synchronize()
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)
    launches = dict(gk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for tensor, what in ((state.z, "z"), (state.theta, "theta"),
                         (state.opt_state_z[0].nu, "nu_z"),
                         (state.opt_state_theta[0].nu, "nu_theta")):
        check(bool(torch.isfinite(tensor).all()),
              f"config 5: {what} not finite")
    want = dict.fromkeys(gk.LAUNCHES, 0)
    want.update(transport_phi=2 * steps, fused_linear_wide_pass1=steps,
                fused_linear_wide_pass2=steps, gumbel_graphs=steps,
                se_matrix=2 * steps)
    check(launches == want, f"config 5 launches {launches}, expected {want}")
    log(f"[6 config 5: e2e] P={P5} d={D5} k={K5} N={N5} M={M5} "
        f"K={K_ACYC5}: {steps} steps after 10 warm-up, {rate:.3f} steps/s on "
        f"'{card}'; peak device memory {peak_gb:.2f} GB; launches "
        f"{launches}; construction warnings {advice}")

    # teacher-forced, 3 steps: kernels vs plain versions, both on the card
    gen_n = torch.Generator(device=dev).manual_seed(11)

    def logistic_dev(shape):
        u = torch.rand(shape, generator=gen_n, device=dev).clamp(1e-7,
                                                                 1 - 1e-7)
        return torch.log(u) - torch.log1p(-u)

    phi_gpu = dibs._make_phi(std)
    state = dibs.init_state(seed=2, n_particles=P5, n_dim_particles=K5)
    worst_card = 0.0
    for _ in range(3):
        eps = logistic_dev((P5, M5, D5, D5))
        noise = (eps, eps, logistic_dev((P5, K_ACYC5, D5, D5)))
        with torch.no_grad():
            got = phi_gpu(state, noise)
            before = dict(gk.LAUNCHES)
            with plain_on_card():
                want_phi = phi_gpu(state, noise)
            check(gk.LAUNCHES == before, "a kernel launched in the plain phi")
        for a, b, what in zip(got, want_phi, ("z", "theta")):
            e = float((a - b).abs().max())
            tol = 1e-4 * float(b.abs().max())
            worst_card = max(worst_card, e / max(tol, 1e-30))
            check(e <= tol, f"config 5 phi_{what} t={state.t} (card plain):"
                            f" {e} > {tol}")
        state = step(state, noise)
    del eps, noise

    # teacher-forced, 5 steps at P=16: kernels (card) vs plain versions (CPU)
    p_small = 16
    rng = np.random.default_rng(12)
    cpu = make("cpu", LinearGaussian(n_vars=D5))
    phi_cpu = cpu._make_phi(std)
    state = dibs.init_state(seed=3, n_particles=p_small, n_dim_particles=K5)
    worst_cpu = 0.0
    for _ in range(5):
        eps = logistic(rng, (p_small, M5, D5, D5))
        noise = (eps, eps, logistic(rng, (p_small, K_ACYC5, D5, D5)))
        noise_dev = tuple(e.to(dev) for e in noise)
        with torch.no_grad():
            got = phi_gpu(state, noise_dev)
            want_phi = phi_cpu(joint_state_cpu(state), noise)
        for a, b, what in zip(got, want_phi, ("z", "theta")):
            e = float((a.cpu() - b).abs().max())
            tol = 1e-4 * float(b.abs().max())
            worst_cpu = max(worst_cpu, e / max(tol, 1e-30))
            check(e <= tol, f"config 5 phi_{what} t={state.t} (CPU plain, "
                            f"P=16): {e} > {tol}")
        state = step(state, noise_dev)
    log(f"[6 config 5: teacher-forced] max |phi_kernel - phi_plain| / "
        f"(1e-4 max|phi|): {worst_card:.3f} over steps t=0..2 at P=1000 "
        f"(plain versions on the card), {worst_cpu:.3f} over t=0..4 at P=16 "
        f"(plain versions on the CPU); phi_z and phi_theta")
    return launches


def profile_steps(step, state, n_steps=50):
    """``torch.profiler`` over ``n_steps`` steady steps (after 10 warm-up
    steps): wall ms per step, device kernel ms per step, the device busy
    share (kernels run on one stream, so their times add), kernel launches
    per step, each kernel's device ms per step (``kernels``) and the five
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        state = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    kernels, launches = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
        elif evt.name in ("cudaLaunchKernel", "cuLaunchKernel",
                          "cudaLaunchKernelExC"):
            launches += 1
    device_ms = sum(kernels.values()) / n_steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy=device_ms / wall_ms, launches=launches / n_steps,
                kernels={name: ms / n_steps for name, ms in kernels.items()},
                top=[(name[:40], ms / n_steps) for name, ms in top],
                state=state)


def config4_joint(dev):
    """``JointDiBS`` + ``LinearGaussian`` at config 4
    (``benchmarks/run_benchmarks.py:137-168``): scale-free d=30, 100
    observational rows and the first 5 of the interventional sets, 100 rows
    each with ``ceil(0.1 d)`` nodes clamped, the joint defaults (M=128,
    K=32)."""
    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.ops.ancestral import interv_to_vectors
    from dibs_tpu_torch.target import make_linear_gaussian_model

    data, gm, lm = make_linear_gaussian_model(
        generator=torch.Generator().manual_seed(123), n_vars=D4,
        graph_prior_str="sf", device=dev)
    xs = [data.x]
    masks = [torch.zeros_like(data.x, dtype=torch.int32)]
    for interv, x_int in data.x_interv[:5]:
        mask_vec, _ = interv_to_vectors(interv, data.n_vars, device=dev)
        xs.append(x_int)
        masks.append(mask_vec.to(torch.int32).expand_as(x_int))
    return JointDiBS(x=torch.cat(xs), interv_mask=torch.cat(masks),
                     graph_model=gm, likelihood_model=lm,
                     n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                     device=dev)


def phase_profile(dev, card):
    """Phase 7; returns each cell's profile (without its state) by name."""
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import (
        make_linear_gaussian_equivalent_model,
        make_linear_gaussian_model,
        make_nonlinear_gaussian_model,
    )

    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=gen, n_vars=D, graph_prior_str="er", n_observations=N_OBS,
        device=dev)
    marginal = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                            n_grad_mc_samples=M,
                            n_acyclicity_mc_samples=K_ACYC, device=dev)
    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_linear_gaussian_model(
        generator=gen, n_vars=D, n_observations=N_OBS, device=dev)
    joint = JointDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                      n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                      device=dev)
    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_nonlinear_gaussian_model(
        generator=gen, n_vars=D, n_observations=N_OBS, device=dev)
    joint_nl = JointDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                         n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                         device=dev)
    gen = torch.Generator().manual_seed(123)
    data, gm, lm = make_linear_gaussian_model(
        generator=gen, n_vars=D5, n_observations=N5, device=dev)
    joint5 = JointDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                       n_grad_mc_samples=M5, n_acyclicity_mc_samples=K_ACYC5,
                       device=dev)
    joint4 = config4_joint(dev)
    check(tuple(joint4.x.shape) == (600, D4)
          and int(joint4.interv_mask.sum()) == 5 * 100 * math.ceil(0.1 * D4),
          "config 4's data is not 100 + 5 x 100 rows with 3 clamped nodes")
    profiles = {}
    for name, dibs, p, k in (("marginal score", marginal, P, K_LAT),
                             ("joint", joint, P, K_LAT),
                             ("joint nonlinear", joint_nl, P, K_LAT),
                             ("joint config 5", joint5, P5, K5),
                             ("joint config 4", joint4, P4, D4)):
        step = dibs._make_step(dibs._resolve_latent_std(k))
        for kern in gk.LAUNCHES:
            gk.LAUNCHES[kern] = 0
        prof = profile_steps(step, dibs.init_state(
            seed=3, n_particles=p, n_dim_particles=k))
        if dibs is joint4:  # 10 warm-up and 50 profiled steps
            check(gk.LAUNCHES["fused_linear_single"] == 60,
                  f"config 4: #5 launched {gk.LAUNCHES['fused_linear_single']}"
                  " times in 60 steps")
            state = prof["state"]
            for tensor, what in ((state.z, "z"), (state.theta, "theta")):
                check(bool(torch.isfinite(tensor).all()),
                      f"config 4: {what} not finite")
        top = ", ".join(f"{k} {v:.4f} ms" for k, v in prof["top"])
        log(f"[7 profile {name}] on '{card}', 50 steps: wall "
            f"{prof['wall_ms']:.3f} ms/step, device kernels "
            f"{prof['device_ms']:.3f} ms/step, busy share "
            f"{prof['busy']:.3f}, kernel launches/step "
            f"{prof['launches']:.1f}; top: {top}")
        profiles[name] = {k: v for k, v in prof.items() if k != "state"}
    return profiles


def phase_acyclic(dev, card, results):
    """Kernel #9 against its plain version (P=1000, d=128, K=8 and
    ``SHAPES9``; Philox and injected noise; scores below -88/alpha; each
    particle within ``1e-4 max(1, max|plain[p]|)``; two calls bitwise
    equal), its times beside the engine route's, the cuBLAS chain's alone
    and the bound, then its entry point ``python -m
    dibs_tpu_torch.ops.acyclic_kernel`` at its defaults as the path it
    serves, with exact launch counts (counts set to 0 just before it).
    Returns that path's launch counts."""
    from dibs_tpu_torch.ops import acyclic_kernel as ak
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.acyclic import acyclic_constr

    gen = torch.Generator(device=dev).manual_seed(21)
    worst, err_main, alpha = 0.0, 0.0, 0.2
    # Philox at the main shape; then ragged d, alternately injected noise
    # and scores reaching below -88/alpha (exp(-alpha s) overflows float32)
    shapes = [(P9, D9, K9, False, False)] + [
        (p, d, k, i % 2 == 1, i % 2 == 0) for i, (p, d, k) in
        enumerate(SHAPES9)]
    for p, d, k, injected, deep in shapes:
        scores = 0.5 * torch.randn((p, d, d), generator=gen, device=dev)
        if deep:
            scores[: p // 2, :, : d // 2] = -100.0 / alpha
        eps = (torch.randn((p, k, d, d), generator=gen, device=dev)
               if injected else None)
        got = gk.acyclic_grad(scores, 7, alpha, k, eps=eps)
        again = gk.acyclic_grad(scores, 7, alpha, k, eps=eps)
        torch.cuda.synchronize()
        want = gk.acyclic_grad_plain(scores, 7, alpha, k, eps=eps)
        check(bool(torch.isfinite(got).all()), f"#9 at {p, d, k}: not finite")
        check(torch.equal(got, again), f"#9 at {p, d, k}: two calls differ")
        # the bar is each particle's own: a deep particle's values are ~1e8
        # below the widest particle's at d = 128
        err = (got - want).abs().amax(dim=(1, 2))
        tol = 1e-4 * want.abs().amax(dim=(1, 2)).clamp(min=1.0)
        share = float((err / tol).max())
        check(share <= 1.0, f"#9 at {(p, d, k, injected, deep)}: err "
                            f"{share} of the per-particle bar")
        worst = max(worst, share)
        if (p, d, k) == (P9, D9, K9):
            err_main = float(err.max())
    p, d, k = P9, D9, K9
    scores = 0.5 * torch.randn((p, d, d), generator=gen, device=dev)
    t_k = cuda_median_ms(lambda: gk.acyclic_grad(scores, 7, alpha, k), reps=10)
    t_p = cuda_median_ms(lambda: gk.acyclic_grad_plain(scores, 7, alpha, k),
                         reps=3)
    t_e = cuda_median_ms(lambda: ak.engine_acyclic_grad(
        scores, 7, alpha, n_vars=d, kmc=k), reps=10)
    soft = gk.gumbel_graphs(scores, 7, 0, alpha, 1.0, k, False)
    with torch.no_grad():
        t_c = cuda_median_ms(lambda: acyclic_constr(soft), reps=10)
    del soft
    b_ms, b_by = bound("acyclic_grad", p=p, d=d, k=k)
    timed(f"#9 P={p} d={d} K={k}", t_k, b_ms)
    results["acyclic_grad"] = dict(max_abs_err=err_main, ms=t_k, plain_ms=t_p,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=t_e)
    log(f"[8 acyclic_grad #9] kernel vs plain at (P,d,K) in "
        f"{[(P9, D9, K9)] + SHAPES9}, Philox and injected noise, scores below "
        f"-88/alpha: finite, within 1e-4 max(1, max|plain[p]|) per "
        f"particle p, worst "
        f"{worst:.4f} of the bar, two calls bitwise equal; at P={p} d={d} "
        f"K={k} ({gk.acyclic_grad_plan(d)}) on "
        f"'{card}': kernel {t_k:.4f} ms, plain {t_p:.4f} ms, engine route "
        f"{t_e:.4f} ms, the cuBLAS chain alone (acyclic_constr forward on "
        f"[{p}, {k}, {d}, {d}] soft samples) {t_c:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")

    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    out = ak.main(["--p", str(P9), "--d", str(D9), "--kmc", str(K9),
                   "--device", str(dev)])
    launches = dict(gk.LAUNCHES)
    # one warm-up and the timed calls per route, then one 64-sample call each
    expect = dict.fromkeys(gk.LAUNCHES, 0)
    expect.update(acyclic_grad=ak.TIMED_CALLS + 2,
                  gumbel_graphs=ak.TIMED_CALLS + 2)
    check(launches == expect,
          f"acyclic entry point: launches {launches}, expected {expect}")
    check(out["mc_disagreement"] < ak.MC_AGREEMENT_BAR,
          f"#9 vs the engine route over 64 samples: "
          f"{out['mc_disagreement']} >= {ak.MC_AGREEMENT_BAR}")
    log(f"[8 acyclic entry point] python -m dibs_tpu_torch.ops.acyclic_kernel"
        f" (P={P9}, d={D9}, K={K9}): fused {out['fused_ms']:.4f} ms, engine "
        f"route {out['engine_ms']:.4f} ms, 64-sample MC disagreement "
        f"{out['mc_disagreement']:.4f} (bar {ak.MC_AGREEMENT_BAR}); "
        f"launches {launches}")
    return launches


def phase_bge_large(dev, card):
    """BGe past its kernel's range: the per-node scores of
    ``B_BGE_LARGE`` graphs (density 0.3) at d = ``D_BGE_LARGE`` on the card
    against the CPU's, ``rtol = atol = 1e-4`` (float32 Cholesky factors of
    ~40 x 40 parent blocks, logs summed in another order); the path
    launches no kernel."""
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk

    d, b, n = D_BGE_LARGE, B_BGE_LARGE, N_BGE_LARGE
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    interv = torch.zeros((n, d), dtype=torch.int32)
    gs = (rng.uniform(size=(b, d, d)) < 0.3).astype(np.float32)
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    gs = torch.from_numpy(gs)
    want = BGe(n_vars=d, device="cpu").batched_node_log_marginal_likelihoods(
        gs=gs, x=x, interv_targets=interv)
    model = BGe(n_vars=d, device=dev)
    args = dict(gs=gs.to(dev), x=x.to(dev), interv_targets=interv.to(dev))
    before = dict(gk.LAUNCHES)
    got = model.batched_node_log_marginal_likelihoods(**args)
    torch.cuda.synchronize()
    check(dict(gk.LAUNCHES) == before, "BGe at d=130 launched a kernel")
    check(got.shape == (b, d) and bool(torch.isfinite(got).all()),
          "BGe at d=130: not finite or wrong shape")
    err = float((got.cpu() - want).abs().max())
    check(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4),
          f"BGe at d=130: card vs CPU max |diff| {err}")
    t = cuda_median_ms(
        lambda: model.batched_node_log_marginal_likelihoods(**args), reps=5)
    log(f"[9 BGe d={d}] {b} graphs, N={n}, past the kernel's range "
        f"(masked_logdet_pd_pair over the nodes, no kernel launch): card vs "
        f"CPU max |diff| {err:.3g} (rtol = atol = 1e-4), {t:.3f} ms on "
        f"'{card}'")


def j_last_masked(r_mats, gs):
    """The masked matrices of ``torch.linalg.cholesky``'s route to the
    pairs (``ops/logdet.py``'s d > 64 tier): per (graph, node j) the mask
    Pa u j with node j permuted last, ``[B, d, d, d]``."""
    b, d, _ = gs.shape
    dev = gs.device
    perm = torch.stack([torch.cat([torch.arange(j, device=dev),
                                   torch.arange(j + 1, d, device=dev),
                                   torch.tensor([j], device=dev)])
                        for j in range(d)])  # [j, d]: node j last
    jj = torch.arange(d, device=dev)
    r_p = r_mats[jj[:, None, None], perm[:, :, None], perm[:, None, :]]
    eye = torch.eye(d, device=dev)
    mask = torch.clamp(gs.transpose(1, 2) + eye, max=1.0)  # [B, j, r]
    mask_p = torch.gather(mask, 2, perm[None].expand(b, d, d))
    outer = mask_p[..., :, None] * mask_p[..., None, :]
    return outer * r_p[None] + (1.0 - outer) * eye


def phase_config6(dev, card, results):
    """``MarginalDiBS`` + BGe at config 6 (``benchmarks/run_benchmarks.py
    :188-211``, nothing cut): scale-free d=128, N=100, P=100, M=64, K=8,
    the marginal defaults (``score``, rmsprop 0.005, SE h=5). ``WARM6``
    warm-up and ``STEPS6`` timed steps with exact launch counts and a finite
    state; then one step's hard graphs, captured where the BGe score hands
    them to #2: the parent counts' histogram, #2 against its twin bit for
    bit over all of them, its times beside the bound, the twin's and the
    library's; then a 10-step profile. Returns the timed steps' launch
    counts; adds the timings to ``results["bge_pairs"]["block_tier"]``."""
    from dibs_tpu_torch.accounting import bound_ms, kernel_cost
    from dibs_tpu_torch.inference import MarginalDiBS
    from dibs_tpu_torch.models import linear_gaussian as lg
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.bge_kernel import (
        bge_logdet_pairs,
        bge_logdet_pairs_plain,
    )
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    d, steps = D6, STEPS6
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=torch.Generator().manual_seed(123), n_vars=d,
        graph_prior_str="sf", device=dev)
    dibs = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                        n_grad_mc_samples=M6,
                        n_acyclicity_mc_samples=K_ACYC6, device=dev)
    step = dibs._make_step(dibs._resolve_latent_std(d))
    state = dibs.init_state(seed=1, n_particles=P6)
    # reckoned: the hard graphs alone are P M d^2 floats, the soft graphs
    # and each power of the acyclicity chain P K d^2
    hard_gb = 4 * P6 * M6 * d * d / 1e9
    soft_gb = 4 * P6 * K_ACYC6 * d * d / 1e9
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARM6):
        state = step(state)
    torch.cuda.synchronize()
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)
    launches = dict(gk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for tensor, what in ((state.z, "z"), (state.opt_state_z[0].nu, "nu"),
                         (state.sf_baseline, "sf_baseline")):
        check(bool(torch.isfinite(tensor).all()),
              f"config 6: {what} not finite")
    want = dict.fromkeys(gk.LAUNCHES, 0)
    want.update(gumbel_graphs=2 * steps, bge_pairs=steps, se_matrix=steps,
                transport_phi=steps, score_ratio=steps)
    check(launches == want, f"config 6 launches {launches}, expected {want}")
    log(f"[10 config 6: e2e] MarginalDiBS + BGe, sf d={d} N={data.x.shape[0]}"
        f" P={P6} M={M6} K={K_ACYC6}: {steps} steps after {WARM6} warm-up, "
        f"{rate:.4f} steps/s on '{card}'; peak device memory {peak_gb:.3f} GB "
        f"(reckoned: hard graphs {hard_gb:.3f} GB, soft graphs "
        f"{soft_gb:.3f} GB); launches {launches}")

    # one step's hard graphs, as the BGe score hands them to #2
    captured = []
    pairs = lg.bge_logdet_pairs

    def capture(r_mats, gs):
        captured.append((r_mats, gs))
        return pairs(r_mats, gs)

    lg.bge_logdet_pairs = capture
    try:
        state = step(state)
    finally:
        lg.bge_logdet_pairs = pairs
    check(len(captured) == 1, f"config 6: {len(captured)} #2 calls a step")
    r_mats, gs = captured[0]
    b = gs.shape[0]
    check(tuple(gs.shape) == (P6 * M6, d, d), f"config 6: graphs "
                                              f"{tuple(gs.shape)}")
    k = gs.sum(1)  # [B, j]: node j's parent count
    qs = torch.quantile(k.flatten().float(), torch.tensor(
        [0.0, 0.25, 0.5, 0.75, 1.0], device=dev)).tolist()
    hist = torch.bincount(k.flatten().long(), minlength=d + 1).cpu()
    edges = [0, 16, 32, 48, 64, 96, d + 1]  # the routes' k ranges
    split = {f"{lo}-{hi - 1}": int(hist[lo:hi].sum())
             for lo, hi in zip(edges, edges[1:])}
    log(f"[10 config 6: k] parent counts over {b} graphs x {d} nodes = "
        f"{b * d} pairs: min {qs[0]:.0f} quartiles {qs[1]:.0f} / {qs[2]:.0f} "
        f"/ {qs[3]:.0f} max {qs[4]:.0f}; mean {float(k.float().mean()):.3f};"
        f" pairs by k {split}")

    pa, full = bge_logdet_pairs(r_mats, gs)
    again = bge_logdet_pairs(r_mats, gs)
    check(torch.equal(pa, again[0]) and torch.equal(full, again[1]),
          "config 6: two calls of #2 differ")
    mismatch, err = 0, 0.0
    for c0 in range(0, b, CHUNK6):
        pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs[c0:c0 + CHUNK6])
        for got, ref in ((pa[c0:c0 + CHUNK6], pa_p),
                         (full[c0:c0 + CHUNK6], full_p)):
            mismatch += int((got != ref).sum())
            err = max(err, float((got - ref).abs().max()))
        del pa_p, full_p
    check(mismatch == 0, f"config 6: #2 differs from its twin at {mismatch} "
                         f"of {2 * b * d} values (max |diff| {err})")
    # float64 slogdet of the masked matrices, the first 2 graphs
    r64, eye = r_mats.double(), torch.eye(d, dtype=torch.float64, device=dev)
    err_64 = 0.0
    for g in range(2):
        for mask, got in ((gs[g].t().double(), pa[g]),
                          (gs[g].t().double() + eye, full[g])):
            outer = mask[:, :, None] * mask[:, None, :]  # [j, r, c]
            ref = torch.linalg.slogdet(outer * r64 + (1 - outer) * eye)[1]
            err_64 = max(err_64, float(((got.double() - ref).abs()
                                        / (1 + ref.abs())).max()))
    check(err_64 <= 1e-4, f"config 6: #2 vs float64 slogdet {err_64}")

    t_k = cuda_median_ms(lambda: bge_logdet_pairs(r_mats, gs), reps=10)
    split = kernel_device_split(lambda: bge_logdet_pairs(r_mats, gs),
                                "bge_pairs", 5)
    t_dev = sum(split.values())
    chunk = gs[:CHUNK6]
    t_plain = cuda_median_ms(lambda: bge_logdet_pairs_plain(r_mats, chunk),
                             reps=3) * b / CHUNK6
    mats = j_last_masked(r_mats, chunk)
    chol = torch.linalg.cholesky(mats)
    logd = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).double()
    lib_err = max(float((logd[..., :-1].sum(-1).float() - pa[:CHUNK6]).abs()
                        .max()),
                  float((logd.sum(-1).float() - full[:CHUNK6]).abs().max()))
    t_lib = cuda_median_ms(lambda: torch.linalg.cholesky(mats),
                           reps=3) * b / CHUNK6
    del mats, chol, logd
    flops, n_bytes = kernel_cost("bge_pairs", gs=gs)
    b_ms, b_by = bound_ms(flops, n_bytes)
    timed(f"#2 config 6 [{b} graphs, d={d}] events", t_k, b_ms)
    timed(f"#2 config 6 [{b} graphs, d={d}] device", t_dev, b_ms)
    log(f"[10 config 6: #2] on one step's {b} hard graphs at d={d}: bitwise "
        f"equal to the twin at all {2 * b * d} values (twin in chunks of "
        f"{CHUNK6} graphs), two calls bitwise equal, vs float64 slogdet "
        f"max |err|/(1+|ref|) {err_64:.3g} (2 graphs); kernel {t_k:.4f} ms "
        f"(events), {t_dev:.4f} ms (profiler device time); twin {t_plain:.2f}"
        f" ms (one chunk of {CHUNK6} graphs x {b // CHUNK6}); library "
        f"torch.linalg.cholesky of the j-last masked [{d}, {d}] matrices "
        f"{t_lib:.2f} ms (one chunk of {CHUNK6 * d} matrices x "
        f"{b // CHUNK6}; its logdets within {lib_err:.3g} of the kernel's); "
        f"bound {b_ms:.4f} ms ({b_by}; operations "
        f"{bound_ms(flops, 0)[0]:.4f} ms for {flops:.4g} FLOP, bytes "
        f"{bound_ms(0, n_bytes)[0]:.4f} ms) on '{card}'")
    short = {re.search(r"bge_pairs\w*(<[^>]*>)?", n).group(0): ms
             for n, ms in split.items()}
    log("[10 config 6: #2 by kernel] device ms a call: " + ", ".join(
        f"{n} {ms:.4f}" for n, ms in sorted(short.items(),
                                            key=lambda kv: -kv[1])))
    results["bge_pairs"]["block_tier"] = dict(
        shape=f"config 6: {b} graphs, d={d}", launches=launches["bge_pairs"],
        max_abs_err=err, ms=t_k, device_ms=t_dev, plain_ms=t_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
        library_chunk_graphs=CHUNK6, k_quartiles=qs)

    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    prof = profile_steps(step, state, n_steps=10)
    check(bool(torch.isfinite(prof["state"].z).all()),
          "config 6: z not finite after the profile")
    top = ", ".join(f"{n} {v:.4f} ms" for n, v in prof["top"])
    log(f"[10 config 6: profile] on '{card}', 10 steps after 10 warm-up: wall "
        f"{prof['wall_ms']:.3f} ms/step, device kernels "
        f"{prof['device_ms']:.3f} ms/step, busy share {prof['busy']:.3f}, "
        f"kernel launches/step {prof['launches']:.1f}; top: {top}")
    return launches


def ratio_einsum(g, w, prob, alpha):
    """Kernel #10's residual as PyTorch computes it in float32: one
    batched ``einsum`` over the graphs (the route ``score_rb`` takes for
    its per-node weights), then ``(sum_m w_m) prob`` and the diagonal."""
    from dibs_tpu_torch.utils.func import zero_diagonal

    acc = torch.einsum("pmij,pm->pij", g, w)
    return zero_diagonal(alpha * (acc - w.sum(1)[:, None, None] * prob))


def phase_score_ratio(dev, card, results):
    """Kernel #10 against its plain twin (float64) on the card: at config
    6's shape on the sampler's hard graphs with the ratio's signed weights
    (``c = 0.5``), then at ``SHAPES_RATIO``; within ``1e-6 max|plain|``, a
    zero diagonal, two calls bitwise equal, one launch a call. Times #10 at
    config 6's shape beside its bound, its twin and :func:`ratio_einsum`
    (the library column) in turns, and keeps them in
    ``results["score_ratio"]``."""
    from dibs_tpu_torch.inference.estimators import _ratio_weights
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.edges import edge_probs, edge_scores
    from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs

    alpha = 3.0
    gen = torch.Generator(device=dev).manual_seed(26)
    worst, err_main = 0.0, 0.0
    first = None
    for p, m, d, misaligned in [(P6, M6, D6, False)] + SHAPES_RATIO:
        zs = torch.randn((p, d, d, 2), generator=gen,
                         device=dev) / math.sqrt(d)
        if (p, m, d) == (P6, M6, D6):
            g = sample_hard_graphs(edge_scores(zs), 11, 0, alpha, m)
        else:
            g = (torch.rand((p, m, d, d), generator=gen, device=dev)
                 < 0.4).float() * (1 - torch.eye(d, device=dev))
        if misaligned:
            flat = torch.empty(g.numel() + 1, device=dev)
            flat[1:] = g.reshape(-1)
            g = flat[1:].view(p, m, d, d)
        logprobs = -40.0 * torch.rand((p, m), generator=gen, device=dev)
        w = _ratio_weights(logprobs, logprobs.mean(1) - 2.0, 0.5)
        prob = edge_probs(zs, alpha).contiguous()
        before = gk.LAUNCHES["score_ratio"]
        got = gk.score_ratio(g, w, prob, alpha)
        again = gk.score_ratio(g, w, prob, alpha)
        torch.cuda.synchronize()
        check(gk.LAUNCHES["score_ratio"] == before + 2,
              f"#10 at {p, m, d}: {gk.LAUNCHES['score_ratio'] - before} "
              f"launches for two calls")
        want = gk.score_ratio_plain(g, w, prob, alpha)
        check(bool(torch.isfinite(got).all()), f"#10 at {p, m, d}: not "
                                               f"finite")
        check(torch.equal(got, again), f"#10 at {p, m, d}: two calls differ")
        check(not bool(torch.diagonal(got, dim1=-2, dim2=-1).any()),
              f"#10 at {p, m, d}: a diagonal entry is not 0")
        err = float((got - want).abs().max())
        share = err / (1e-6 * float(want.abs().max()))
        check(share <= 1.0, f"#10 at {(p, m, d, misaligned)}: err {err}, "
                            f"{share} of 1e-6 max|plain|")
        worst = max(worst, share)
        if first is None:
            first, err_main = (g, w, prob), err
    g, w, prob = first
    lib_err = float((ratio_einsum(g, w, prob, alpha) - gk.score_ratio_plain(
        g, w, prob, alpha)).abs().max())
    t_k, t_e, turns = in_turns(lambda: gk.score_ratio(g, w, prob, alpha),
                               lambda: ratio_einsum(g, w, prob, alpha), 100)
    t_p = cuda_median_ms(lambda: gk.score_ratio_plain(g, w, prob, alpha),
                         reps=5)
    b_ms, b_by = bound("score_ratio", p=P6, m=M6, d=D6)
    timed(f"#10 P={P6} M={M6} d={D6}", t_k, b_ms)
    results["score_ratio"] = dict(max_abs_err=err_main, ms=t_k, plain_ms=t_p,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=t_e)
    log(f"[10 score_ratio #10] kernel vs plain (float64) at (P, M, d) "
        f"{(P6, M6, D6)} (#1's hard graphs) and {SHAPES_RATIO} "
        f"(misaligned graphs last): finite, zero diagonal, within 1e-6 "
        f"max|plain|, worst {worst:.4f} of the bar, two calls bitwise "
        f"equal, one launch a call; at {(P6, M6, D6)} on '{card}' in turns "
        f"(kernel, einsum, einsum, kernel: "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms): kernel {t_k:.4f} ms, "
        f"float32 einsum route {t_e:.4f} ms (its max err {lib_err:.3e} "
        f"against the twin, the kernel's {err_main:.3e}), plain twin "
        f"{t_p:.4f} ms, bound {b_ms:.5f} ms ({b_by})")


def phase_spectral_checkpoint(dev, card, steps):
    """``acyclicity='spectral'``: ``MarginalDiBS`` at the ``bench.py`` shape
    (``'sampled'``) and ``JointDiBS`` at config 2 (``'mean'``), ``steps``
    steps each with exact launch counts and a finite state; then a
    checkpoint round trip: ``steps // 2`` marginal steps, save, load,
    ``steps // 2`` more, equal to ``steps`` straight. Returns the launch
    counts of the spectral runs."""
    import tempfile

    from dibs_tpu_torch.checkpoint import load_state, save_state
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import (
        make_linear_gaussian_equivalent_model,
        make_linear_gaussian_model,
    )

    gen = torch.Generator().manual_seed(0)
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=gen, n_vars=D, graph_prior_str="er", n_observations=N_OBS,
        device=dev)
    marginal = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                            n_grad_mc_samples=M,
                            n_acyclicity_mc_samples=K_ACYC,
                            acyclicity="spectral", device=dev)
    gen = torch.Generator().manual_seed(0)
    data_j, gm_j, lm_j = make_linear_gaussian_model(
        generator=gen, n_vars=D, n_observations=N_OBS, device=dev)
    joint = JointDiBS(x=data_j.x, graph_model=gm_j, likelihood_model=lm_j,
                      n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                      acyclicity="spectral", acyclicity_constraint="mean",
                      device=dev)
    total = dict.fromkeys(gk.LAUNCHES, 0)
    for name, dibs, want in (
            ("marginal 'sampled'", marginal,
             dict(gumbel_graphs=2 * steps, bge_pairs=steps, se_matrix=steps,
                  transport_phi=steps, score_ratio=steps)),
            ("joint 'mean'", joint,
             dict(fused_linear_single=steps, se_matrix=2 * steps,
                  transport_phi=2 * steps))):
        state = dibs.init_state(seed=1, n_particles=P, n_dim_particles=K_LAT)
        step = dibs._make_step(dibs._resolve_latent_std(K_LAT))
        torch.cuda.synchronize()
        for key in gk.LAUNCHES:
            gk.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state)
        torch.cuda.synchronize()
        rate = steps / (time.perf_counter() - t0)
        launches = dict(gk.LAUNCHES)
        expect = dict.fromkeys(gk.LAUNCHES, 0)
        expect.update(want)
        check(launches == expect,
              f"spectral {name}: launches {launches}, expected {expect}")
        check(bool(torch.isfinite(state.z).all()),
              f"spectral {name}: z not finite")
        for key, count in launches.items():
            total[key] += count
        log(f"[8 spectral {name}] {steps} steps, {rate:.2f} steps/s on "
            f"'{card}' (first step included); finite state; launches "
            f"{launches}")

    init = marginal.init_state(seed=4, n_particles=P, n_dim_particles=K_LAT)
    straight = marginal.resume(init, steps=steps, return_state=True)[-1]
    half = marginal.resume(init, steps=steps // 2, return_state=True)[-1]
    with tempfile.TemporaryDirectory() as where:
        loaded = load_state(save_state(half, f"{where}/marginal"), device=dev)
    resumed = marginal.resume(loaded, steps=steps - steps // 2,
                              return_state=True)[-1]
    check(resumed.t == straight.t == steps, "checkpoint: wrong step count")
    same = all(torch.equal(a, b) for a, b in (
        (resumed.z, straight.z),
        (resumed.opt_state_z[0].nu, straight.opt_state_z[0].nu),
        (resumed.sf_baseline, straight.sf_baseline)))
    diff = float((resumed.z - straight.z).abs().max())
    check(same, f"checkpoint: resumed run differs from the straight one "
                f"(max |dz| {diff})")
    log(f"[8 checkpoint] {steps // 2} spectral marginal steps, save, load "
        f"(weights_only), {steps - steps // 2} more: z, nu and sf_baseline "
        f"equal {steps} straight steps bitwise on '{card}'")
    return total


def joint_score_problem(dev):
    """Config 2's data and priors (``benchmarks/run_benchmarks.py:99-116``)
    and a builder of ``JointDiBS(grad_estimator_z='score')`` on it."""
    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.target import make_linear_gaussian_model

    data, gm, lm = make_linear_gaussian_model(
        generator=torch.Generator().manual_seed(0), n_vars=D,
        n_observations=N_OBS, n_ho_observations=N_OBS, device=dev)

    def make(device, lik, baseline):
        return JointDiBS(x=data.x.to(device), graph_model=gm,
                         likelihood_model=lik, n_grad_mc_samples=M,
                         n_acyclicity_mc_samples=K_ACYC,
                         grad_estimator_z="score",
                         score_function_baseline=baseline, device=device)

    return data, lm, make


def joint_noise(rng, dev=None):
    """Injected Logistic noise of one joint step: the Z estimator's hard
    samples, the Theta estimator's, the acyclicity samples."""
    noise = (logistic(rng, (P, M, D, D)), logistic(rng, (P, M, D, D)),
             logistic(rng, (P, K_ACYC, D, D)))
    return noise if dev is None else tuple(e.to(dev) for e in noise)


def phase_joint_score(dev, card):
    """Phase 11: ``JointDiBS`` + ``LinearGaussian`` with
    ``grad_estimator_z='score'`` at config 2's full width, without and with
    the EMA baseline: ``WARM11`` + ``STEPS11`` steps with exact launches
    (#1 three times a step: the Z and Theta estimators' hard samples and
    the acyclicity samples), steps/s over the window, peak memory; 20
    teacher-forced steps against the CPU's plain versions; one step's hard
    graphs, as the estimators drew them through #1, bitwise those of the
    plain twin on the same noise (injected, and #1's own Philox noise)."""
    from dibs_tpu_torch.inference import estimators
    from dibs_tpu_torch.metrics import threshold_metrics
    from dibs_tpu_torch.models import LinearGaussian
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.edges import edge_scores

    data, lm, make = joint_score_problem(dev)
    total = dict.fromkeys(gk.LAUNCHES, 0)
    steps = WARM11 + STEPS11
    for baseline in (0.0, 0.5):
        dibs = make(dev, lm, baseline)
        std = dibs._resolve_latent_std(K_LAT)
        step = dibs._make_step(std)
        for name in gk.LAUNCHES:
            gk.LAUNCHES[name] = 0
        state = dibs.init_state(seed=1, n_particles=P, n_dim_particles=K_LAT)
        for _ in range(WARM11):
            state = step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(STEPS11):
            state = step(state)
        torch.cuda.synchronize()
        rate = STEPS11 / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 1e6
        launches = dict(gk.LAUNCHES)
        want = dict.fromkeys(gk.LAUNCHES, 0)
        want.update(gumbel_graphs=3 * steps, se_matrix=2 * steps,
                    transport_phi=2 * steps, score_ratio=steps)
        check(launches == want, f"joint score c={baseline}: launches "
                                f"{launches}, expected {want}")
        for tensor, what in ((state.z, "z"), (state.theta, "theta"),
                             (state.sf_baseline, "sf_baseline")):
            check(bool(torch.isfinite(tensor).all()),
                  f"joint score c={baseline}: {what} not finite")
        for name, count in launches.items():
            total[name] += count
        g = dibs.particle_to_g_lim(state.z)
        auc = threshold_metrics(dist=dibs.get_mixture(g, state.theta),
                                g=data.g)["roc_auc"]
        log(f"[11 joint score c={baseline}] {WARM11} + {STEPS11} steps, "
            f"{rate:.2f} steps/s over the last {STEPS11} on '{card}'; peak "
            f"device memory {peak:.1f} MB; #1 launches/step "
            f"{launches['gumbel_graphs'] / steps:g} (hard: Z score, Theta; "
            f"soft: acyclicity); launches {launches}; mixture AUROC "
            f"{auc:.4f} after {steps} steps (no floor: the score estimator "
            f"at this length)")
        prof = profile_steps(step, state)
        top = ", ".join(f"{k} {v:.4f} ms" for k, v in prof["top"])
        log(f"[11 profile joint score c={baseline}] on '{card}', 50 steps: "
            f"wall {prof['wall_ms']:.3f} ms/step, device kernels "
            f"{prof['device_ms']:.3f} ms/step, busy share "
            f"{prof['busy']:.3f}, kernel launches/step "
            f"{prof['launches']:.1f}; top: {top}")

        # teacher-forced: kernels (card) vs plain versions (CPU)
        rng = np.random.default_rng(5)
        cpu = make("cpu", LinearGaussian(n_vars=D), baseline)
        tr_gpu, tr_cpu = dibs._make_transport(std), cpu._make_transport(std)
        state = dibs.init_state(seed=2, n_particles=P, n_dim_particles=K_LAT)
        worst, worst_b = 0.0, 0.0
        for _ in range(20):
            noise = joint_noise(rng)
            noise_dev = tuple(e.to(dev) for e in noise)
            with torch.no_grad():
                got = tr_gpu(state, noise_dev)
                want_phi = tr_cpu(joint_state_cpu(state), noise)
            for a, b, what in zip(got[:2], want_phi[:2], ("z", "theta")):
                err = float((a.cpu() - b).abs().max())
                tol = 1e-4 * float(b.abs().max())
                worst = max(worst, err / max(tol, 1e-30))
                check(err <= tol, f"joint score c={baseline} phi_{what} "
                                  f"t={state.t}: {err} > {tol}")
            b_err = float((got[2].cpu() - want_phi[2]).abs().max())
            b_tol = 1e-5 * max(1.0, float(want_phi[2].abs().max()))
            worst_b = max(worst_b, b_err / b_tol)
            check(b_err <= b_tol, f"joint score c={baseline} baseline "
                                  f"t={state.t}: {b_err} > {b_tol}")
            state = step(state, noise_dev)
        log(f"[11 teacher-forced joint score c={baseline}] steps t=0..19: "
            f"max |phi_kernel - phi_plain| / (1e-4 max|phi|) = {worst:.3f} "
            f"(phi_z and phi_theta); baseline / (1e-5 max(1, |b|)) = "
            f"{worst_b:.3f}")

    # #1's hard graphs, as the estimators drew them, against the twin
    drawn = []
    sampler = estimators.sample_hard_graphs

    def capture(scores, seed, stream, alpha, n_samples, eps=None,
                particle_offset=0, sample_offset=0):
        drawn.append((scores, seed, stream, alpha, eps))
        return sampler(scores, seed, stream, alpha, n_samples, eps=eps,
                       particle_offset=particle_offset,
                       sample_offset=sample_offset)

    noise_dev = joint_noise(rng, dev)
    estimators.sample_hard_graphs = capture
    try:
        with torch.no_grad():
            tr_gpu(state, noise_dev)
    finally:
        estimators.sample_hard_graphs = sampler
    check(len(drawn) == 2, f"{len(drawn)} hard draws in one step, not 2")
    for scores, seed, stream, alpha, eps in drawn:
        for e in (eps, None):  # the injected noise, then #1's Philox noise
            a = gk.gumbel_graphs(scores, seed, stream, alpha, 1.0, M,
                                 hard=True, eps=e)
            b = gk.gumbel_graphs_plain(scores, seed, stream, alpha, 1.0, M,
                                       hard=True, eps=e)
            check(torch.equal(a, b), f"#1 hard graphs differ from the twin "
                                     f"(stream {stream}, injected "
                                     f"{e is not None})")
    check(torch.equal(drawn[1][0], edge_scores(state.z)),
          "the Z estimator drew from other scores")
    log(f"[11 #1 hard graphs] one step's 2 x {P * M} graphs (Z score, "
        f"Theta) bitwise the plain twin's on the injected noise and on "
        f"#1's own Philox noise")
    return total


def phase_switches(dev, card):
    """Phase 12: (a) the kill switch, (b) the default precision, (c) the
    acyclicity chain at 'highest' and 'high', (d) ``StepTimer``, (e)
    ``trace()``."""
    import tempfile

    from dibs_tpu_torch import config, profiling
    from dibs_tpu_torch.inference import MarginalDiBS, transport
    from dibs_tpu_torch.models import linear_gaussian, nonlinear_gaussian
    from dibs_tpu_torch.ops import acyclic
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    data, gm, bge = make_linear_gaussian_equivalent_model(
        generator=torch.Generator().manual_seed(0), n_vars=D,
        graph_prior_str="er", n_observations=N_OBS, device=dev)
    marginal = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=bge,
                            n_grad_mc_samples=M,
                            n_acyclicity_mc_samples=K_ACYC, device=dev)
    _, lm, make = joint_score_problem(dev)
    joint = make(dev, lm, 0.0)
    rng = np.random.default_rng(7)
    std = marginal._resolve_latent_std(K_LAT)

    # (a) the kill switch: no launch, the kernels' phi, launches resume
    for name, dibs, noise in (
            ("marginal", marginal, (logistic(rng, (P, M, D, D)),
                                    logistic(rng, (P, K_ACYC, D, D)))),
            ("joint score", joint, joint_noise(rng))):
        noise = tuple(e.to(dev) for e in noise)
        phi, step = dibs._make_phi(std), dibs._make_step(std)
        state = step(dibs.init_state(seed=4, n_particles=P,
                                     n_dim_particles=K_LAT))
        with torch.no_grad():
            want = phi(state, noise)
        before = dict(gk.LAUNCHES)
        with plain_on_card():
            with torch.no_grad():
                got = phi(state, noise)
            step(state)
        check(gk.LAUNCHES == before, f"12a {name}: a kernel launched with "
                                     "the kill switch off")
        worst = 0.0
        for a, b in zip(got[:1] if name == "marginal" else got,
                        want[:1] if name == "marginal" else want):
            err = float((a - b).abs().max())
            tol = 1e-4 * float(b.abs().max())
            worst = max(worst, err / max(tol, 1e-30))
            check(err <= tol, f"12a {name}: plain phi {err} > {tol}")
        step(state)
        resumed = {k: gk.LAUNCHES[k] - before[k] for k in gk.LAUNCHES
                   if gk.LAUNCHES[k] != before[k]}
        check("gumbel_graphs" in resumed and "transport_phi" in resumed,
              f"12a {name}: launches did not resume: {resumed}")
        log(f"[12a kill switch {name}] switch off: one step and one phi, 0 "
            f"launches; |phi_plain - phi_kernel| / (1e-4 max|phi|) = "
            f"{worst:.3f}; switch None: one step launched {resumed}")

    # (b) the default precision leaves phase 11's phi bitwise unchanged
    phi, step = joint._make_phi(std), joint._make_step(std)
    state = step(joint.init_state(seed=5, n_particles=P,
                                  n_dim_particles=K_LAT))
    noise = joint_noise(rng, dev)
    with torch.no_grad():
        first, again = phi(state, noise), phi(state, noise)
    holders = (linear_gaussian, nonlinear_gaussian, transport, acyclic)
    saved = [mod.matmul_precision for mod in holders]
    for mod in holders:
        mod.matmul_precision = lambda p: contextlib.nullcontext()
    try:
        with torch.no_grad():
            bare = phi(state, noise)
    finally:
        for mod, ctx in zip(holders, saved):
            mod.matmul_precision = ctx
    for a, b, c in zip(first, again, bare):
        check(torch.equal(a, b) and torch.equal(a, c),
              "12b: the default precision changed phase 11's phi")
    config.set_likelihood_matmul_precision("high")
    try:
        with torch.no_grad():
            tf32 = phi(state, noise)
    finally:
        config.set_likelihood_matmul_precision("highest")
    check(torch.get_float32_matmul_precision() == "highest",
          "12b: the global precision was not restored")
    moved = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(tf32, first)]
    log(f"[12b default precision] phase 11's phi bitwise equal with and "
        f"without the precision contexts (phi_z, phi_theta); likelihood "
        f"'high' (TF32) moves them by {moved[0]:.3e} and {moved[1]:.3e} of "
        f"max|phi| (information only)")

    # (c) the acyclicity chain at 'highest' and 'high' (TF32), config 5's
    # soft shape [P5 * K_ACYC5, D5, D5]
    scores = torch.randn((P5, D5, D5), generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    g = gk.gumbel_graphs(scores, 9, 0, 1.0, 1.0, K_ACYC5, hard=False
                         ).reshape(P5 * K_ACYC5, D5, D5)

    def fwd_bwd(precision):
        g_req = g.detach().requires_grad_(True)
        h = acyclic.acyclic_constr(g_req, precision=precision)
        (grad,) = torch.autograd.grad(h, g_req, torch.ones_like(h))
        return h, grad

    h_hi, grad_hi = fwd_bwd("highest")
    h_lo, grad_lo = fwd_bwd("high")
    check(bool(torch.isfinite(h_lo).all() & torch.isfinite(grad_lo).all()),
          "12c: 'high' gave non-finite values")
    h_lo, h_hi = h_lo.detach(), h_hi.detach()
    rel_h = float(((h_lo - h_hi).abs() / h_hi.abs()).max())
    rel_g = float((grad_lo - grad_hi).abs().max() / grad_hi.abs().max())
    ms_hi, ms_lo, turns = in_turns(lambda: fwd_bwd("highest"),
                                   lambda: fwd_bwd("high"), reps=5)
    check(torch.get_float32_matmul_precision() == "highest",
          "12c: the global precision was not restored")
    log(f"[12c acyclicity precision] acyclic_constr forward + backward at "
        f"[{P5 * K_ACYC5}, {D5}, {D5}] on '{card}': 'highest' {ms_hi:.4f} "
        f"ms, 'high' (TF32) {ms_lo:.4f} ms (in turns: "
        f"{', '.join(f'{t:.4f}' for t in turns)}); 'high' against "
        f"'highest': max |dh| / |h| {rel_h:.3e}, max |d grad| / max|grad| "
        f"{rel_g:.3e} (no engine path uses 'high')")
    del g, h_hi, grad_hi, h_lo, grad_lo

    # (d) StepTimer over 3 chunks of the marginal path
    chunk = 100
    timer = profiling.StepTimer()
    marginal.sample(seed=6, n_particles=P, steps=4 * chunk,
                    n_dim_particles=K_LAT, callback=timer,
                    callback_every=chunk)
    summary = timer.summary()
    check(summary["chunks"] == 3, f"12d: {summary['chunks']} chunks")
    ratio = summary["steps_per_sec"] / RATES["score"]
    check(0.5 <= ratio <= 2.0, f"12d: StepTimer {summary} against phase "
                               f"5's {RATES['score']:.2f} steps/s")
    log(f"[12d StepTimer] marginal score, 3 chunks of {chunk} steps: "
        f"{summary['steps_per_sec']:.2f} steps/s over the last 2 "
        f"(phase 5: {RATES['score']:.2f}; ratio {ratio:.3f})")

    # (e) trace(): one marginal and one joint score step
    names = ("gumbel_graphs_kernel", "bge_pairs_warp_kernel")
    with tempfile.TemporaryDirectory() as where:
        with profiling.trace(where):
            marginal._make_step(std)(marginal.init_state(
                seed=8, n_particles=P, n_dim_particles=K_LAT))
            joint._make_step(std)(joint.init_state(
                seed=8, n_particles=P, n_dim_particles=K_LAT))
        with open(f"{where}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    seen = {n: sum(n in str(e.get("name", "")) for e in events)
            for n in names}
    check(all(seen.values()), f"12e: trace events by name {seen}")
    log(f"[12e trace] {len(events)} events; kernel events by name {seen}")


def fleet_kernels(dev):
    """13(a): kernels #1-#4 with the dataset axis at the fleet's shapes
    (``FLEET_KERNEL_B`` datasets of the headline config), each against its
    plain twin with the axis (#1 hard exact off ties, soft within 1e-5;
    #2 bitwise at every d of ``FLEET_BGE_D``; #3 atol 1e-5; #4 within 1e-4
    max(1, max|ref|)) and against its unbatched launch on each dataset
    (#1-#3 bitwise, #4 within its bar); at the fleet sizes the batched
    launch timed beside B unbatched launches, the twin, the bound and, for
    #3 and #4, a batched library call. Returns the printed lines."""
    from dibs_tpu_torch.fleet import fleet_seeds
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops import transport_kernel as tk
    from dibs_tpu_torch.ops.bge_kernel import (
        bge_logdet_pairs,
        bge_logdet_pairs_plain,
    )

    rng = np.random.default_rng(13)
    lines, worst4 = [], 0.0
    n_z = D * K_LAT * 2
    for nb in FLEET_KERNEL_B:
        keys = fleet_seeds(nb, nb).to(dev)
        seeds = keys.tolist()
        scores = torch.from_numpy((2.0 * rng.normal(size=(nb * P, D, D)))
                                  .astype(np.float32)).to(dev)
        # --- #1 ---
        for hard, m in ((True, M), (False, K_ACYC)):
            out = gk.gumbel_graphs(scores, keys, 7, 1.0, 1.0, m, hard)
            ref = gk.gumbel_graphs_plain(scores, keys, 7, 1.0, 1.0, m, hard)
            if hard:
                u = gk.philox_uniform((nb * P, m, D, D), keys, 7, dev)
                logit = torch.log(u) - torch.log1p(-u) + scores[:, None]
                bad = int((((out - ref).abs() > 0)
                           & (logit.abs() >= 1e-5)).sum())
                check(bad == 0, f"fleet #1 hard B={nb}: {bad} mismatches "
                                "with the twin off ties")
            else:
                err = float((out - ref).abs().max())
                check(err <= 1e-5, f"fleet #1 soft B={nb}: {err} > 1e-5")
            for i, seed in enumerate(seeds):
                one = gk.gumbel_graphs(scores[i * P:(i + 1) * P], seed, 7,
                                       1.0, 1.0, m, hard)
                check(torch.equal(one, out[i * P:(i + 1) * P]),
                      f"fleet #1 hard={hard} B={nb}: dataset {i} differs "
                      "from its unbatched launch")
        # --- #2 ---
        for d in FLEET_BGE_D:
            n_g = 256 if d <= 32 else 16 if d <= 64 else 4
            x = torch.from_numpy(rng.normal(size=(nb, N_OBS, d))
                                 .astype(np.float32)).to(dev)
            r_mats, _ = BGe(n_vars=d, device=dev)._posterior_r_mats(
                x, torch.zeros_like(x, dtype=torch.int32))
            r_mats = r_mats.contiguous()
            gs = (rng.uniform(size=(nb * n_g, d, d)) < 0.3).astype(
                np.float32)
            gs[:, np.arange(d), np.arange(d)] = 0.0
            for i in range(nb):
                gs[i * n_g] = k_edge_graph(rng, d)
                gs[i * n_g + 1] = 1.0 - np.eye(d)
            gs_t = torch.from_numpy(gs).to(dev)
            pa, full = bge_logdet_pairs(r_mats, gs_t)
            pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs_t)
            check(torch.equal(pa, pa_p) and torch.equal(full, full_p),
                  f"fleet #2 B={nb} d={d}: not bitwise the twin")
            for i in range(nb):
                sl = slice(i * n_g, (i + 1) * n_g)
                one = bge_logdet_pairs(r_mats[i], gs_t[sl])
                check(torch.equal(one[0], pa[sl])
                      and torch.equal(one[1], full[sl]),
                      f"fleet #2 B={nb} d={d}: dataset {i} differs from its "
                      "unbatched launch")
        # --- #3 and #4 ---
        z = torch.from_numpy((rng.normal(size=(nb, P, n_z))
                              / math.sqrt(K_LAT)).astype(np.float32)).to(dev)
        k_mat = gk.se_matrix(z, z, 5.0, 1.0)
        err3 = float((k_mat - gk.se_matrix_plain(z, z, 5.0, 1.0)).abs().max())
        check(err3 <= 1e-5, f"fleet #3 B={nb}: {err3} > 1e-5")
        g = torch.from_numpy(rng.normal(size=(nb, P, n_z)).astype(
            np.float32)).to(dev)
        mu = z.mean(dim=1, keepdim=True)
        phi = tk.transport_phi(k_mat, None, g, z, c=-0.4, mu=mu)
        want = tk.transport_phi_plain(k_mat, None, g, z, c=-0.4, mu=mu)
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        err4 = float((phi - want).abs().max())
        check(err4 <= tol, f"fleet #4 B={nb}: {err4} > {tol}")
        worst4 = max(worst4, err4 / tol)
        same4 = True
        for i in range(nb):
            zi = z[i].contiguous()
            one = gk.se_matrix(zi, zi, 5.0, 1.0)
            check(torch.equal(one, k_mat[i]),
                  f"fleet #3 B={nb}: dataset {i} differs from its unbatched "
                  "launch")
            one4 = tk.transport_phi(k_mat[i].contiguous(), None,
                                    g[i].contiguous(), zi, c=-0.4,
                                    mu=mu[i].contiguous())
            e = float((one4 - phi[i]).abs().max())
            check(e <= tol, f"fleet #4 B={nb}: dataset {i}: {e} > {tol} "
                            "from its unbatched launch")
            same4 = same4 and e == 0.0
        line = (f"B={nb}: #1 hard/soft and #2 (d in {FLEET_BGE_D}) bitwise "
                f"their unbatched launches, #2 bitwise its twin; #3 err "
                f"{err3:.3g}, bitwise its unbatched launches; #4 err "
                f"{err4:.3g}, {'bitwise' if same4 else 'within the bar of'} "
                f"its unbatched launches")
        if nb in FLEET_B:
            line += "; " + fleet_kernel_times(dev, nb, keys, scores, z, g,
                                              k_mat, mu, rng)
        lines.append(line)
    return lines, worst4


def fleet_times(nb, name, batched, serial, plain, kernel, shape,
                library=None):
    """One timing line of 13(a): median ms of the batched launch, of ``nb``
    unbatched launches, of the plain version and of a library call, beside
    the bound of ``kernel`` at ``shape``."""
    t_b = cuda_median_ms(batched, reps=20)
    t_s = cuda_median_ms(serial, reps=10)
    t_p = cuda_median_ms(plain, reps=2)
    t_l = cuda_median_ms(library, reps=20) if library is not None else None
    b_ms, b_by = bound(kernel, **shape)
    return (f"{name} B={nb}: batched {t_b:.4f} ms, {nb} unbatched {t_s:.4f}"
            f" ms, plain {t_p:.4f} ms, bound {b_ms:.5f} ({b_by})"
            + ("" if t_l is None else f", library {t_l:.4f} ms"))


def bge_masked_stack(r_mats, gs, nb):
    """The input of #2's library yardstick (phase 3's, with a dataset
    axis): for every graph of ``gs [nb per, d, d]`` and node j, the masked
    ``[Pa, Pa]`` and ``[Pa u j, Pa u j]`` matrices of its dataset's
    ``r_mats[b, j]`` (identity outside the mask), stacked for one
    ``slogdet`` call; filled a dataset at a time."""
    g, d = gs.shape[0], gs.shape[-1]
    per = g // nb
    eye = torch.eye(d, device=gs.device)
    out = torch.empty((2, g, d, d, d), device=gs.device)
    for b in range(nb):
        par = gs[b * per:(b + 1) * per].transpose(1, 2)  # [per, j, r]
        for half, masks in enumerate((par, torch.clamp(par + eye, max=1.0))):
            outer = masks[..., :, None] * masks[..., None, :]
            out[half, b * per:(b + 1) * per] = (outer * r_mats[b]
                                                + (1 - outer) * eye)
    return out.reshape(-1, d, d)


def fleet_kernel_times(dev, nb, keys, scores, z, g, k_mat, mu, rng):
    """Median ms of #1 (hard, M), #2 (P M graphs a dataset, d=20), #3 and
    #4 at a fleet of ``nb`` datasets: the batched launch, ``nb`` unbatched
    launches, the twin, the bound and the batched library call (#2:
    ``slogdet`` of the stacked masked matrices, as phase 3's)."""
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops import transport_kernel as tk
    from dibs_tpu_torch.ops.bge_kernel import (
        bge_logdet_pairs,
        bge_logdet_pairs_plain,
    )

    seeds = keys.tolist()
    bp, n = nb * P, z.shape[-1]
    out = []

    def row(*args, **kw):
        out.append(fleet_times(nb, *args, **kw))

    row("#1 hard", lambda: gk.gumbel_graphs(scores, keys, 7, 1.0, 1.0, M,
                                            True),
        lambda: [gk.gumbel_graphs(scores[i * P:(i + 1) * P], s, 7, 1.0, 1.0,
                                  M, True) for i, s in enumerate(seeds)],
        lambda: gk.gumbel_graphs_plain(scores, keys, 7, 1.0, 1.0, M, True),
        "gumbel_graphs", dict(p=bp, m=M, d=D))
    x = torch.from_numpy(rng.normal(size=(nb, N_OBS, D)).astype(
        np.float32)).to(dev)
    r_mats, _ = BGe(n_vars=D, device=dev)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    r_mats = r_mats.contiguous()
    gs = gk.gumbel_graphs(scores, keys, 3, 1.0, 1.0, M, True).reshape(
        -1, D, D)
    per = P * M
    stacked = bge_masked_stack(r_mats, gs, nb)
    row("#2", lambda: bge_logdet_pairs(r_mats, gs),
        lambda: [bge_logdet_pairs(r_mats[i], gs[i * per:(i + 1) * per])
                 for i in range(nb)],
        lambda: bge_logdet_pairs_plain(r_mats, gs),
        "bge_pairs", dict(gs=gs, datasets=nb),
        lambda: torch.linalg.slogdet(stacked))
    del stacked
    row("#3", lambda: gk.se_matrix(z, z, 5.0, 1.0),
        lambda: [gk.se_matrix(z[i], z[i], 5.0, 1.0) for i in range(nb)],
        lambda: gk.se_matrix_plain(z, z, 5.0, 1.0),
        "se_matrix", dict(a=P, n=n, batch=nb, triangle=True),
        lambda: torch.cdist(z, z))
    row("#4", lambda: tk.transport_phi(k_mat, None, g, z, c=-0.4, mu=mu),
        lambda: [tk.transport_phi(k_mat[i], None, g[i], z[i], c=-0.4,
                                  mu=mu[i]) for i in range(nb)],
        lambda: tk.transport_phi_plain(k_mat, None, g, z, c=-0.4, mu=mu),
        "transport_phi", dict(p=P, n=n, batch=nb),
        lambda: -(k_mat.transpose(-1, -2) @ g - 0.4 * (
            k_mat.transpose(-1, -2) @ (z - mu)
            - k_mat.sum(dim=1)[..., None] * (z - mu))) / P)
    return "; ".join(out)


def cell13(cell):
    """``(factory, its kwargs, engine class, engine kwargs, sizes)`` of a
    phase-13 cell: the headline marginal (``make_linear_gaussian_
    equivalent_model``, ER d=20; ``score`` or ``score_rb``), joint config 2
    (``make_linear_gaussian_model``, sf d=20; also with ``h_latent =
    h_theta = "median"``, and joint ``score`` at baselines 0 and 0.5),
    config 3 (``make_nonlinear_gaussian_model``, ``hidden_layers=(5,)``;
    also ``(5, 5)``, the generic route) and config 5 (sf d=128, P=1000,
    M=32, K=8). ``sizes``: d, N, particles, latent dim, M, K and the steps
    (warm-up, timed, teacher-forced, profiled)."""
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.target import (
        make_linear_gaussian_equivalent_model,
        make_linear_gaussian_model,
        make_nonlinear_gaussian_model,
    )

    d20 = dict(d=D, n=N_OBS, p=P, k=K_LAT, m=M, k_acyc=K_ACYC, warm=WARM13,
               steps=STEPS13, tf=TF13, prof=50)
    if cell in ("score", "score_rb"):
        return (make_linear_gaussian_equivalent_model,
                dict(graph_prior_str="er"), MarginalDiBS,
                dict(grad_estimator_z=cell), d20)
    if cell.startswith("config 3"):
        hidden = (5, 5) if cell == "config 3 (5, 5)" else (5,)
        return (make_nonlinear_gaussian_model, dict(hidden_layers=hidden),
                JointDiBS, {}, d20)
    if cell == "config 5":
        return (make_linear_gaussian_model, {}, JointDiBS, {}, dict(
            d=D5, n=N5, p=P5, k=K5, m=M5, k_acyc=K_ACYC5, warm=WARM13_C5,
            steps=STEPS13_C5, tf=TF13_C5, prof=PROF13_C5))
    engine = {"config 2": {},
              "config 2 median": dict(kernel_param=dict(
                  h_latent="median", h_theta="median")),
              "config 2 score": dict(grad_estimator_z="score"),
              "config 2 score baseline": dict(grad_estimator_z="score",
                                              score_function_baseline=0.5),
              }[cell]
    return make_linear_gaussian_model, {}, JointDiBS, engine, d20


def fleet_problem(dev, nb, cell):
    """``nb`` datasets of a phase-13 cell (:func:`cell13`; generators
    seeded 0..nb-1), the fleet's engine on the first and one engine a
    dataset."""
    factory, data_kw, engine, engine_kw, sz = cell13(cell)
    xs, gm, lm = [], None, None
    for b in range(nb):
        data, gm, lm = factory(generator=torch.Generator().manual_seed(b),
                               n_vars=sz["d"], n_observations=sz["n"],
                               device=dev, **data_kw)
        xs.append(data.x)

    def make(x):
        return engine(x=x, graph_model=gm, likelihood_model=lm,
                      n_grad_mc_samples=sz["m"],
                      n_acyclicity_mc_samples=sz["k_acyc"], device=dev,
                      **engine_kw)

    xs = torch.stack(xs)
    return xs, make(xs[0]), [make(x) for x in xs]


def phase_fleet(dev, card):
    """13: ``dibs_tpu_torch.fleet`` on the card. (a) the batched kernels
    #1-#4 (:func:`fleet_kernels`) and #5-#8 (:func:`fleet_fused_kernels`,
    :func:`fleet_nonlinear_edges`, :func:`fleet_wide`);
    (b) the headline marginal config (``bench.py``: ER d=20, N=100, P=30,
    k=20, M=128, K=32, BGe), ``score`` and ``score_rb``, with ``FLEET_B``
    datasets; joint configs 2 and 3 (``benchmarks/run_benchmarks.py:
    99-134``) with the first fleet size, and so config 2 with median
    bandwidths and with joint ``score`` (baselines 0 and 0.5) and config
    3's model with ``hidden_layers=(5, 5)`` (the generic route); config 5
    (``:171-185``) with ``FLEET_C5_B`` datasets; each a cell of
    :func:`fleet_cell`. Returns the launches of the fleets' own steps."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    lines, worst4 = fleet_kernels(dev)
    for ln in lines:
        log(f"[13a fleet kernels] {ln}")
    log(f"[13a fleet kernels] #4 worst {worst4:.3f} of its bar")
    for ln in fleet_fused_kernels(dev):
        log(f"[13a fleet fused kernels] {ln}")
    log(f"[13a fleet fused kernels] {fleet_nonlinear_edges(dev)}")
    for ln in fleet_wide(dev):
        log(f"[13a fleet wide passes] {ln}")

    total = dict.fromkeys(gk.LAUNCHES, 0)

    def counted(fn):
        for name in gk.LAUNCHES:
            gk.LAUNCHES[name] = 0
        out = fn()
        for name in total:
            total[name] += gk.LAUNCHES[name]
        return out

    cells = [(c, nb) for c in ("score", "score_rb") for nb in FLEET_B]
    cells += [(c, FLEET_B[0]) for c in (
        "config 2", "config 3", "config 2 median", "config 2 score",
        "config 2 score baseline", "config 3 (5, 5)")]
    cells += [("config 5", FLEET_C5_B)]
    for cell, nb in cells:
        fleet_cell(dev, card, cell, nb, counted)
    return total


def fleet_cell(dev, card, cell, nb, counted):
    """One cell of 13(b) (sizes from :func:`cell13`): launches per fleet
    step equal to one dataset's step; at the first fleet size (config 5:
    at ``FLEET_C5_B``) the parity checks of :func:`fleet_parity`;
    dataset-steps/s over the cell's timed steps after its warm-up, the
    fleet and ``nb`` serial single runs on the same datasets in turns
    (fleet, serial, serial, fleet); the fleet's peak device memory;
    ``torch.profiler`` over the cell's profiled fleet steps."""
    from dibs_tpu_torch.fleet import fleet_init_state, fleet_seeds
    from dibs_tpu_torch.fleet import fleet_step as make_fleet_step
    from dibs_tpu_torch.ops import gpu_kernels as gk

    xs, dibs, singles = fleet_problem(dev, nb, cell)
    sz = cell13(cell)[-1]
    std = dibs._resolve_latent_std(sz["k"])
    seeds = fleet_seeds(nb, nb)
    fleet_step = make_fleet_step(dibs, xs)
    steps = [e._make_step(std) for e in singles]

    def fleet_init():
        return fleet_init_state(dibs, seeds, sz["p"])

    def single_init(i):
        return singles[i].init_state(seed=int(seeds[i]),
                                     n_particles=sz["p"])

    state = fleet_init()
    counted(lambda: fleet_step(state))
    one_fleet = dict(gk.LAUNCHES)
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    steps[0](single_init(0))
    one_single = dict(gk.LAUNCHES)
    check(one_fleet == one_single and sum(one_fleet.values()) > 0,
          f"fleet {cell} B={nb}: a fleet step launched {one_fleet}, a "
          f"single step {one_single}")
    if nb <= FLEET_B[0]:
        fleet_parity(dev, dibs, singles, seeds, fleet_step, std, cell,
                     counted, sz)

    def fleet_turn():
        st = fleet_init()
        for _ in range(sz["warm"]):
            st = fleet_step(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sz["steps"]):
            st = fleet_step(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(bool(torch.isfinite(st.z).all()),
              f"fleet {cell} B={nb}: z not finite")
        return nb * sz["steps"] / secs

    def serial_turn():
        secs = 0.0
        for i in range(nb):
            st = single_init(i)
            for _ in range(sz["warm"]):
                st = steps[i](st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(sz["steps"]):
                st = steps[i](st)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
        return nb * sz["steps"] / secs

    torch.cuda.reset_peak_memory_stats()
    f1 = counted(fleet_turn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s1, s2 = serial_turn(), serial_turn()
    f2 = counted(fleet_turn)
    prof = counted(lambda: profile_steps(fleet_step, fleet_init(),
                                         n_steps=sz["prof"]))
    top = ", ".join(f"{k} {v:.4f} ms" for k, v in prof["top"])
    launched = {k: v for k, v in one_fleet.items() if v}
    log(f"[13b fleet {cell} B={nb}] on '{card}': dataset-steps/s fleet "
        f"{(f1 + f2) / 2:.2f} (turns {f1:.2f}, {f2:.2f}), {nb} serial single "
        f"runs {(s1 + s2) / 2:.2f} (turns {s1:.2f}, {s2:.2f}), ratio "
        f"{(f1 + f2) / (s1 + s2):.3f}; launches a step {launched} (equal to "
        f"one dataset's step); peak device memory {peak_gb:.4f} GB; "
        f"profiled {sz['prof']} steps: wall {prof['wall_ms']:.3f} ms/step, "
        f"device {prof['device_ms']:.3f} ms/step, busy {prof['busy']:.3f}, "
        f"launches/step {prof['launches']:.1f}; top: {top}")


def fleet_parity(dev, dibs, singles, seeds, fleet_step, std, cell, counted,
                 sz):
    """13(b) at the first fleet size: the fleet's initial particles (and
    parameters) bitwise single engines' from ``seeds``; the samples #1
    draws at step 0 and step ``sz["tf"]`` (marginal: the hard graphs,
    stream 2t; joint: the acyclicity soft graphs, stream 3t + 2) bitwise
    theirs; ``sz["tf"]`` teacher-forced steps of each dataset's ``phi``
    (Philox noise, the fleet's state; joint: ``phi_z`` and every
    ``phi_theta`` leaf) against its single engine at ``1e-4 max|phi|``."""
    from dibs_tpu_torch.fleet import fleet_init_state
    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.ops.edges import edge_scores
    from dibs_tpu_torch.ops.soft_graphs import (
        sample_hard_graphs,
        sample_soft_graphs,
    )
    from dibs_tpu_torch.utils.tree import tree_leaves, tree_map

    nb = len(singles)
    joint = isinstance(dibs, JointDiBS)
    keys = seeds.to(dev)
    p, tf = sz["p"], sz["tf"]
    state = fleet_init_state(dibs, seeds, p)
    for i, single in enumerate(singles):
        one = single.init_state(seed=int(seeds[i]), n_particles=p)
        check(torch.equal(one.z, state.z[i]) and all(
            torch.equal(a, b[i]) for a, b in zip(
                tree_leaves(one.theta if joint else []),
                tree_leaves(state.theta if joint else []))),
              f"fleet {cell}: dataset {i}'s initial state differs")
    masks = torch.zeros_like(torch.stack([e.x for e in singles]),
                             dtype=torch.int32)
    xs = torch.stack([e.x for e in singles])
    if joint:
        transport = dibs._make_fleet_transport(xs, masks, std)
        phi_fleet = lambda st: transport(st)[:2]  # noqa: E731
    else:
        phi_fleet = dibs._make_fleet_phi(xs, masks, std)
    phis = [e._make_phi(std) for e in singles]
    worst, graphs = 0.0, 0

    def draw(z, key, t):
        if joint:
            return sample_soft_graphs(edge_scores(z), key, 3 * t + 2,
                                      dibs.alpha(t), dibs.cfg.tau,
                                      sz["k_acyc"])
        return sample_hard_graphs(edge_scores(z), key, 2 * t, dibs.alpha(t),
                                  sz["m"])

    for t in range(tf + 1):
        if t in (0, tf):
            z = state.z.reshape(nb * p, *state.z.shape[2:])
            with torch.no_grad():
                drawn = draw(z, keys, state.t)
                for i in range(nb):
                    check(torch.equal(draw(state.z[i], int(seeds[i]),
                                           state.t),
                                      drawn[i * p:(i + 1) * p]),
                          f"fleet {cell} t={state.t}: dataset {i}'s samples "
                          "differ from its single engine's")
            graphs += drawn.shape[0] * drawn.shape[1]
        if t == tf:
            break
        with torch.no_grad():
            got = counted(lambda: phi_fleet(state))
        for i in range(nb):
            one = state._replace(
                seed=int(seeds[i]), z=state.z[i],
                theta=tree_map(lambda a: a[i], state.theta) if joint
                else None, sf_baseline=state.sf_baseline[i],
                opt_state_z=None, opt_state_theta=None)
            with torch.no_grad():
                want = phis[i](one)
            pairs = ([(got[0][i], want[0])]
                     + ([(a[i], b) for a, b in zip(tree_leaves(got[1]),
                                                   tree_leaves(want[1]))]
                        if joint else []))
            for a, b in pairs:
                # joint score's signed baseline may overflow (its formula):
                # the fleet must overflow where the single engine does
                fin = torch.isfinite(b)
                check(torch.equal(torch.isfinite(a), fin),
                      f"fleet {cell} t={state.t} dataset {i}: phi finite "
                      "elsewhere than the single engine's")
                if not bool(fin.any()):
                    continue
                err = float((a[fin] - b[fin]).abs().max())
                tol = 1e-4 * float(b[fin].abs().max())
                worst = max(worst, err / max(tol, 1e-30))
                check(err <= tol, f"fleet {cell} t={state.t} dataset {i}: "
                                  f"phi err {err} > {tol}")
        state = counted(lambda: fleet_step(state))
    what = ("acyclicity soft samples" if joint else "hard graphs")
    log(f"[13b fleet {cell} B={nb}] initial state bitwise the single "
        f"engines'; Philox {what} at t=0 and t={tf} bitwise ({graphs} "
        f"graphs); teacher-forced phi t=0..{tf - 1} against single engines "
        f"seeded fleet_seeds: worst {worst:.3f} of the 1e-4 max|phi| bar")


def fleet_fused_kernels(dev):
    """13(a), the fused joint kernels with the dataset axis at config 2's
    (#5-#7: P=30, d=20, N=100, M=128) and config 3's (#8, h1=5) shapes for
    ``FLEET_KERNEL_B`` datasets (each its own data and observation weights,
    Philox noise from its key): against the plain versions with the axis
    and against the unbatched launch on each dataset, within 1e-4 max(1,
    max|ref|); at the first fleet size the batched launch timed beside
    ``B`` unbatched launches, the plain version and the bound."""
    from dibs_tpu_torch.fleet import fleet_seeds
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian, LinearGaussian

    rng = np.random.default_rng(31)
    lines = []
    h1 = 5
    for nb in FLEET_KERNEL_B:
        keys = fleet_seeds(nb + 40, nb).to(dev)
        seeds = keys.tolist()
        bp = nb * P
        scores = torch.from_numpy(rng.normal(size=(bp, D, D)).astype(
            np.float32)).to(dev)
        thetas = torch.from_numpy(rng.normal(size=(bp, D, D)).astype(
            np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(nb, N_OBS, D)).astype(
            np.float32)).to(dev)
        w = torch.ones_like(x)
        w[:, 50:, :2] = 0.0  # some intervened entries
        nl_model = DenseNonlinearGaussian(n_vars=D, hidden_layers=(h1,))
        nl_theta = fnl.kernel_layout(nl_model.sample_parameters(
            generator=torch.Generator().manual_seed(nb), n_vars=D,
            n_particles=bp, device=dev), nl_model)
        lls = fl.fused_linear_pass1_plain(
            scores, thetas, x, w, seed=keys, streams=(4, 5), alpha=2.0,
            tau=1.0, n_samples=M, model=LinearGaussian(n_vars=D))
        weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
        calls = {
            "fused_linear_single": (fl.fused_linear_single,
                                    fl.fused_linear_single_plain,
                                    (scores, thetas), (), LinearGaussian(
                                        n_vars=D)),
            "fused_linear_pass1": (fl.fused_linear_pass1,
                                   fl.fused_linear_pass1_plain,
                                   (scores, thetas), (), LinearGaussian(
                                       n_vars=D)),
            "fused_linear_pass2": (fl.fused_linear_pass2,
                                   fl.fused_linear_pass2_plain,
                                   (scores, thetas), (weights,),
                                   LinearGaussian(n_vars=D)),
            "fused_nonlinear": (fnl.fused_nonlinear, fnl.fused_nonlinear_plain,
                                (scores, *nl_theta), (), nl_model),
        }
        worst = {}
        for name, (kern, plain, lead, extra, model) in calls.items():
            kw = dict(seed=keys, streams=(4, 5), alpha=2.0, tau=1.0,
                      n_samples=M, model=model)
            got = kern(*lead, x, w, *extra, **kw)
            want = plain(*lead, x, w, *extra, **kw)
            ratio = 0.0
            for a, b in zip(got, want):
                tol = 1e-4 * max(1.0, float(b.abs().max()))
                e = float((a - b).abs().max())
                check(e <= tol, f"fleet {name} B={nb}: {e} > {tol} from its "
                                "plain version")
                ratio = max(ratio, e / tol)
            for i, seed in enumerate(seeds):
                sl = slice(i * P, (i + 1) * P)
                one = kern(*(t[sl] for t in lead), x[i], w[i],
                           *(tuple(t[sl] for t in e) for e in extra),
                           **dict(kw, seed=seed))
                for a, b in zip(got, one):
                    tol = 1e-4 * max(1.0, float(b.abs().max()))
                    e = float((a[sl] - b).abs().max())
                    check(e <= tol, f"fleet {name} B={nb}: dataset {i}: {e}"
                                    f" > {tol} from its unbatched launch")
            worst[name] = ratio
            if nb != FLEET_B[0]:
                continue

            def serial(kern=kern, lead=lead, extra=extra, kw=kw):
                return [kern(*(t[i * P:(i + 1) * P] for t in lead), x[i],
                             w[i], *(tuple(t[i * P:(i + 1) * P] for t in e)
                                     for e in extra), **dict(kw, seed=s))
                        for i, s in enumerate(seeds)]

            shape = dict(p=bp, m=M, n=N_OBS, d=D, datasets=nb)
            if name == "fused_linear_pass2":
                shape["replayed"] = int(((weights[0] != 0)
                                         | (weights[1] != 0)).sum())
            if name == "fused_nonlinear":
                shape["h1"] = h1
            lines.append(fleet_times(
                nb, name, lambda: kern(*lead, x, w, *extra, **kw), serial,
                lambda: plain(*lead, x, w, *extra, **kw), name, shape))
        lines.append(f"B={nb}: #5-#8 within 1e-4 max(1, max|ref|) of their "
                     f"plain versions (worst " + ", ".join(
                         f"{k} {v:.3f}" for k, v in worst.items())
                     + ") and of their unbatched launches on each dataset")
    return lines


def check_fleet_nonlinear(dev, rng, nb, p, d, n, h1, blocks, m, activation):
    """#8's fleet build (``kFleet``, ``csrc/fused_nonlinear_fleet.cu``) on
    ``nb`` datasets of ``p`` particles at one case of ``SHAPES_NL_EDGES``,
    each dataset its own :func:`nonlinear_problem` and key: against the
    plain version with the dataset axis (two calls bitwise equal) and
    against the unbatched launch on each dataset, within 1e-4 max(1,
    max|ref|). Returns the worst error as a share of the bar."""
    from dibs_tpu_torch.fleet import fleet_seeds
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian

    probs = [nonlinear_problem(rng, dev, p, d, n, h1, blocks)
             for _ in range(nb)]
    lead = tuple(torch.cat([pr[i] for pr in probs]) for i in range(5))
    x, w = (torch.stack([pr[i] for pr in probs]) for i in (5, 6))
    keys = fleet_seeds(d + nb, nb).to(dev)
    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,),
                                   activation=activation)
    kw = dict(seed=keys, streams=(4, 5), alpha=1.3, tau=0.9, n_samples=m,
              model=model)
    label = f"fleet B={nb} d={d} N={n} h1={h1} {activation}"
    worst, _ = check_fused_nonlinear(fnl, (*lead, x, w), kw, label)
    got = fnl.fused_nonlinear(*lead, x, w, **kw)
    for i, seed in enumerate(keys.tolist()):
        sl = slice(i * p, (i + 1) * p)
        one = fnl.fused_nonlinear(*(t[sl] for t in lead), x[i], w[i],
                                  **dict(kw, seed=seed))
        for a, b in zip(got, one):
            tol = 1e-4 * max(1.0, float(b.abs().max()))
            e = float((a[sl] - b).abs().max())
            check(e <= tol, f"{label}: dataset {i}: {e} > {tol} from its "
                            "unbatched launch")
            worst = max(worst, e / tol)
    return worst


# the wide tier's fleet builds (13a; tests/test_torch_cuda_fleet.py):
# (datasets, particles a dataset, d, N, interventional blocks, M): d = 75 at
# N = 600 (the kernel table's smallest wide shape, tiled rows) and d = 128
# at N = 100 (rows resident), B = 1 and 3
FLEET_WIDE_CASES = ([(nb, 20, 75, 600, 5, 32) for nb in (1, 3)]
                    + [(nb, 4, 128, 100, 0, 8) for nb in (1, 3)])
# 13a's config 5 fleet of the wide passes: B, and P, d, N, M a dataset
FLEET_WIDE_C5 = (2, P5, D5, N5, 0, M5)


def fleet_wide_problem(dev, rng, nb, p, d, n, blocks, m, streams):
    """``nb`` datasets of :func:`fused_problem` (each its own data and
    observation weights) with their keys, and pass 2's weights: the
    softmax of the plain pass 1's log-likelihoods. Returns ``(args, x, w,
    weights, kw, seeds)``, ``args`` the particles' ``(scores, thetas)``."""
    from dibs_tpu_torch.fleet import fleet_seeds
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.models import LinearGaussian

    probs = [fused_problem(rng, dev, p, d, n, blocks) for _ in range(nb)]
    args = tuple(torch.cat([pr[i] for pr in probs]) for i in range(2))
    x, w = (torch.stack([pr[i] for pr in probs]) for i in (2, 3))
    keys = fleet_seeds(d + nb, nb).to(dev)
    kw = dict(seed=keys, streams=streams, alpha=1.7, tau=1.0, n_samples=m,
              model=LinearGaussian(n_vars=d))
    lls = fl.fused_linear_pass1_plain(*args, x, w, **kw)
    weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
    return args, x, w, weights, kw, keys.tolist()


def check_fleet_wide(dev, rng, nb, p, d, n, blocks, m, streams=(4, 5)):
    """Wide passes 1 and 2's fleet builds (``kFleet``, ``csrc/
    fused_linear.cu``) on ``nb`` datasets of ``p`` particles
    (:func:`fleet_wide_problem`, Philox noise from each dataset's key):
    each pass against its plain version with the dataset axis and against
    its unbatched launch on each dataset, within 1e-4 max(1, max|ref|), and
    two calls bitwise equal. Returns the worst error as a share of the
    bar."""
    from dibs_tpu_torch.inference import fused_linear as fl

    args, x, w, weights, kw, seeds = fleet_wide_problem(
        dev, rng, nb, p, d, n, blocks, m, streams)
    label = f"wide fleet B={nb} P={p} d={d} N={n} M={m}"
    worst = 0.0
    for name, kern, plain, extra in (
            ("pass 1", fl.fused_linear_pass1, fl.fused_linear_pass1_plain,
             ()),
            ("pass 2", fl.fused_linear_pass2, fl.fused_linear_pass2_plain,
             (weights,))):
        got = kern(*args, x, w, *extra, **kw)
        check(all(torch.equal(a, b) for a, b in zip(
            got, kern(*args, x, w, *extra, **kw))),
            f"{label} {name}: two calls differ")
        refs = [(plain(*args, x, w, *extra, **kw), "its plain version",
                 slice(None))]
        for i, seed in enumerate(seeds):
            sl = slice(i * p, (i + 1) * p)
            refs.append((kern(*(t[sl] for t in args), x[i], w[i],
                              *(tuple(t[sl] for t in e) for e in extra),
                              **dict(kw, seed=seed)),
                         f"dataset {i}'s unbatched launch", sl))
        for ref, what, sl in refs:
            for a, b in zip(got, ref):
                tol = 1e-4 * max(1.0, float(b.abs().max()))
                e = float((a[sl] - b).abs().max())
                check(e <= tol, f"{label} {name}: {e} > {tol} from {what}")
                worst = max(worst, e / tol)
    return worst


def fleet_wide(dev):
    """13(a), the wide passes' fleet builds at ``FLEET_WIDE_CASES`` and at
    config 5's shape with ``FLEET_WIDE_C5``'s B datasets (the engine's one
    shared noise stream; :func:`check_fleet_wide`), and at config 5 both
    passes' batched launch timed beside B unbatched launches, the plain
    version and the bound. Returns the printed lines."""
    from dibs_tpu_torch.inference import fused_linear as fl

    rng = np.random.default_rng(39)
    worst = max(check_fleet_wide(dev, rng, *case)
                for case in FLEET_WIDE_CASES)
    worst5 = check_fleet_wide(dev, rng, *FLEET_WIDE_C5, streams=(4, 4))
    lines = [f"wide passes 1 and 2, fleet builds, (B,P,d,N,blocks,M) "
             f"{FLEET_WIDE_CASES} and config 5's {FLEET_WIDE_C5}: within "
             f"1e-4 max(1, max|ref|) of the plain versions and of the "
             f"unbatched launches on each dataset, worst {worst:.3f} "
             f"({worst5:.3f} at config 5) of the bar; two calls bitwise "
             f"equal"]
    nb, p, d, n, blocks, m = FLEET_WIDE_C5
    args, x, w, weights, kw, seeds = fleet_wide_problem(
        dev, rng, nb, p, d, n, blocks, m, (4, 4))
    shape = dict(p=nb * p, m=m, n=n, d=d, datasets=nb)
    kept = int(((weights[0] != 0) | (weights[1] != 0)).sum())
    for name, kern, plain, extra, cost in (
            ("fused_linear_wide_pass1", fl.fused_linear_pass1,
             fl.fused_linear_pass1_plain, (), shape),
            ("fused_linear_wide_pass2", fl.fused_linear_pass2,
             fl.fused_linear_pass2_plain, (weights,),
             dict(shape, replayed=kept))):

        def serial(kern=kern, extra=extra):
            return [kern(*(t[i * p:(i + 1) * p] for t in args), x[i], w[i],
                         *(tuple(t[i * p:(i + 1) * p] for t in e)
                           for e in extra), **dict(kw, seed=s))
                    for i, s in enumerate(seeds)]

        lines.append(fleet_times(
            nb, f"{name} (config 5)",
            lambda kern=kern, extra=extra: kern(*args, x, w, *extra, **kw),
            serial, lambda plain=plain, extra=extra: plain(
                *args, x, w, *extra, **kw), name, cost))
    return lines


def fleet_nonlinear_edges(dev):
    """13(a), #8's fleet build at every case of ``FLEET_NL_CASES`` (the
    gate edges; all 16 instantiations) (:func:`check_fleet_nonlinear`)."""
    rng = np.random.default_rng(37)
    worst = 0.0
    for case in FLEET_NL_CASES:
        worst = max(worst, check_fleet_nonlinear(dev, rng, *case))
    return (f"#8's fleet build at the gate edges (P,d,N,h1,blocks,M,act) "
            f"{SHAPES_NL_EDGES} with B = 1 and 3, and each of its 16 "
            f"instantiations (h1 = 5, 16, 1, 7 x relu, tanh, sigmoid, leaky "
            f"relu; P=2, d=12, N=40, M=5, B = 3): within 1e-4 max(1, "
            f"max|ref|) of the plain version and of the unbatched launch on "
            f"each dataset, worst {worst:.3f} of the bar; two calls bitwise "
            f"equal")


# ---------------------------------------------------------------------------
# phase 14: particle sharding (dibs_tpu_torch.parallel)
# ---------------------------------------------------------------------------

# teacher-forced and free steps of the sharded runs (config 5: teacher-
# forced only), the fleet over a datasets mesh (datasets, steps), and the
# longest the two-rank world may take
TF14, FREE14, TF14_C5, FLEET14_B, FLEET14_STEPS = 20, 50, 3, 8, 20
WORLD14_TIMEOUT = 600
# 14c, the ("p", "mc") mesh: the worlds as (ranks, n_mc), #1's sample
# splits at the headline's hard shape, config 6's teacher-forced steps
MC14_WORLDS = ((2, 2), (4, 2))
MC14_SPLITS = (2, 4)
TF14_C6 = 3
# the sizes the ranks take from the parent (a rehearsal may shrink them)
SIZES14 = ("P", "D", "K_LAT", "M", "K_ACYC", "N_OBS", "P5", "D5", "K5", "M5",
           "K_ACYC5", "N5", "TF14", "FREE14", "TF14_C5", "FLEET14_B",
           "FLEET14_STEPS", "P6", "D6", "M6", "K_ACYC6", "TF14_C6")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shards_bitwise(label, launch, p, splits):
    """``launch(rows, offset)`` (a tuple of outputs) on ``k`` equal shards
    of ``p`` particles, each at its first particle's offset, concatenated,
    against one launch over all of them: bitwise, for each ``k`` in
    ``splits``. Returns the one launch's outputs."""
    whole = launch(slice(0, p), 0)
    for k in splits:
        per = p // k
        parts = [launch(slice(r * per, (r + 1) * per), r * per)
                 for r in range(k)]
        for i, (got, want) in enumerate(zip(zip(*parts), whole)):
            check(torch.equal(torch.cat(got), want),
                  f"[14] {label}: {k} shards differ from one launch "
                  f"(output {i})")
    return whole


def last_shard(p, splits):
    """The rows and offset of the last shard of the finest split."""
    per = p // splits[-1]
    return slice(p - per, p), p - per


def shard_sampler(dev):
    """14a's kernel: #1 per shard, hard at the marginal path's ``[30, 128,
    20, 20]`` (2 and 3 shards) and soft at config 5's ``[1000, 8, 128,
    128]`` (2 and 4), bitwise one launch; the last shard against the twin
    at its offset (hard exact off ties, soft within 1e-5)."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    rng = np.random.default_rng(14)
    for label, p, m, d, hard, splits in (("hard", P, M, D, True, (2, 3)),
                                         ("soft", P5, 8, D5, False, (2, 4))):
        scores = torch.from_numpy((2.0 * rng.normal(size=(p, d, d)))
                                  .astype(np.float32)).to(dev)

        def launch(rows, off):
            return (gk.gumbel_graphs(scores[rows], 5, 9, 1.3, 1.0, m, hard,
                                     particle_offset=off),)

        (whole,) = shards_bitwise(f"#1 {label}", launch, p, splits)
        rows, off = last_shard(p, splits)
        ref = gk.gumbel_graphs_plain(scores[rows], 5, 9, 1.3, 1.0, m, hard,
                                     particle_offset=off)
        diff = (whole[rows] - ref).abs()
        if hard:
            u = gk.philox_uniform(tuple(ref.shape), 5, 9, dev, off)
            logit = (torch.log(u) - torch.log1p(-u)
                     + 1.3 * scores[rows][:, None])
            bad = int(((diff > 0) & (logit.abs() >= 1e-5)).sum())
            check(bad == 0, f"[14a] #1 hard shard at {off}: {bad} "
                            "mismatches with the twin off ties")
            err = 0.0
        else:
            err = float(diff.max())
            check(err <= 1e-5, f"[14a] #1 soft shard at {off}: max err "
                               f"{err} against the twin")
        log(f"[14a kernels] #1 {label} {[p, m, d, d]}: {splits} shards "
            f"bitwise one launch; the shard at particle {off} against the "
            f"twin at its offset: max err {err:.3g}")
        del whole, ref, diff


def mc_sampler(dev):
    """14c's kernel: #1's sample-offset build (``csrc/gumbel.cu``, kMc).
    Launches over the ``"mc"`` blocks of the samples, each at its first
    sample's offset, concatenate bitwise to one launch: hard at the
    headline's ``[30, 128, 20, 20]`` (``MC14_SPLITS`` blocks), soft at
    tau != 1 there, soft at config 5's ``[1000, 8, 128, 128]`` (2 blocks),
    and particle and sample offsets at once (3 x 2 blocks, hard and soft);
    the last block against the twin at its offset. Then the unsharded
    launch (the parent's instantiation) and the two blocks' launches at
    config 5, timed in turns, beside a block's bound."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    rng = np.random.default_rng(20)
    for label, p, m, d, hard, tau, splits in (
            ("hard", P, M, D, True, 1.0, MC14_SPLITS),
            ("soft tau 0.7", P, M, D, False, 0.7, (2,)),
            ("soft", P5, 8, D5, False, 1.0, (2,))):
        scores = torch.from_numpy((2.0 * rng.normal(size=(p, d, d)))
                                  .astype(np.float32)).to(dev)
        args = (5, 9, 1.3, tau)
        whole = gk.gumbel_graphs(scores, *args, m, hard)
        for k in splits:
            n = m // k
            parts = [gk.gumbel_graphs(scores, *args, n, hard,
                                      sample_offset=j * n) for j in range(k)]
            check(torch.equal(torch.cat(parts, dim=1), whole),
                  f"[14c] #1 {label}: {k} sample blocks differ from one "
                  "launch")
            del parts
        # particle and sample offsets at once: 3 x 2 blocks
        per, n = p // 3, m // 2
        for r in range(3):
            rows = slice(r * per, (r + 1) * per)
            for j in range(2):
                got = gk.gumbel_graphs(scores[rows], *args, n, hard,
                                       particle_offset=r * per,
                                       sample_offset=j * n)
                check(torch.equal(got, whole[rows, j * n:(j + 1) * n]),
                      f"[14c] #1 {label}: the block at particle {r * per}, "
                      f"sample {j * n} differs from one launch")
        del got
        n = m // splits[-1]
        first = m - n
        block = whole[:, first:]
        ref = gk.gumbel_graphs_plain(scores, *args, n, hard,
                                     sample_offset=first)
        diff = (block - ref).abs()
        if hard:
            u = gk.philox_uniform(tuple(ref.shape), 5, 9, dev,
                                  sample_offset=first)
            logit = (torch.log(u) - torch.log1p(-u) + 1.3 * scores[:, None])
            bad = int(((diff > 0) & (logit.abs() >= 1e-5)).sum())
            check(bad == 0, f"[14c] #1 hard block at sample {first}: {bad} "
                            "mismatches with the twin off ties")
            err = 0.0
            del u, logit
        else:
            err = float(diff.max())
            check(err <= 1e-5, f"[14c] #1 {label} block at sample {first}: "
                               f"max err {err} against the twin")
        log(f"[14c kernels] #1 {label} {[p, m, d, d]}: {splits} sample "
            f"blocks and 3 x 2 (particle, sample) blocks bitwise one launch; "
            f"the block at sample {first} against the twin at its offset: "
            f"max err {err:.3g}")
        del whole, block, ref, diff
    # timed in turns at config 5's soft shape
    m, n = 8, 4
    scores = torch.from_numpy(rng.normal(size=(P5, D5, D5))
                              .astype(np.float32)).to(dev)
    arms = {"one launch (unsharded build)": lambda: gk.gumbel_graphs(
                scores, 5, 9, 1.3, 1.0, m, False),
            "2 sample blocks (mc build at 4)": lambda: [
                gk.gumbel_graphs(scores, 5, 9, 1.3, 1.0, n, False,
                                 sample_offset=j * n) for j in range(2)]}
    times = {name: [] for name in arms}
    for _ in range(3):
        for name, fn in arms.items():
            times[name].append(cuda_median_ms(fn, reps=20))
    b_ms, b_by = bound("gumbel_graphs", p=P5, m=n, d=D5)
    shown = {name: [round(t, 4) for t in ts] for name, ts in times.items()}
    log(f"[14c kernels] #1 soft [{P5}, {m}, {D5}, {D5}] in turns (ms, three "
        f"medians of 20 events each): {shown}; a block's bound [{P5}, {n}, "
        f"{D5}, {D5}] {b_ms:.4f} ms ({b_by})")


def _bar_err(label, got, refs):
    """Max error of ``got`` against ``refs`` over ``1e-4 max(1,
    max|ref|)``; fails past 1."""
    worst = 0.0
    for a, b in zip(got, refs):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        worst = max(worst, float((a - b).abs().max()) / tol)
    check(worst <= 1.0, f"[14b] {label}: {worst:.3f} x the bar")
    return worst


# #8's shard build (csrc/fused_nonlinear_shard.cu), as (P, d, N, h1,
# blocks, M, act): the gate edges and each of its 16 instantiations
# (hidden widths 5, 16, 4 and 8, the four activations) at a small shape
SHARD_NL_CASES = ([(12, *c[1:]) for c in SHAPES_NL_EDGES]
                  + [(12, 12, 40, h1, 0, 5, act) for h1 in (5, 16, 1, 7)
                     for act in ("relu", "tanh", "sigmoid", "leakyrelu")])
SHARD_SPLITS = (2, 3, 4)


def shard_nonlinear(dev, case, label):
    """#8 on 2, 3 and 4 shards of ``case`` (a ``SHARD_NL_CASES`` entry),
    bitwise one launch; the last shard against the plain version at its
    offset. Returns its error as a share of the bar."""
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian

    p, d, n, h1, blocks, m, act = case
    rng = np.random.default_rng(d * 100 + h1)
    args = nonlinear_problem(rng, dev, p, d, n, h1, blocks)
    kw = dict(seed=9, streams=(2, 3), alpha=0.6, tau=1.0, n_samples=m,
              model=DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,),
                                           activation=act))

    def launch(rows, off, fn=fnl.fused_nonlinear):
        return fn(*(a[rows] for a in args[:5]), *args[5:],
                  particle_offset=off, **kw)

    whole = shards_bitwise(f"#8 {label}", launch, p, SHARD_SPLITS)
    rows, off = last_shard(p, SHARD_SPLITS)
    return _bar_err(f"#8 {label} shard at {off}", [t[rows] for t in whole],
                    launch(rows, off, fnl.fused_nonlinear_plain))


def shard_fused(dev):
    """14b's kernels: #5, #6 + #7 on the row tier at config 2 (2 and 3
    shards), wide passes 1 and 2 at config 5 (2 and 4), #8 at config 3 (2
    and 3), bitwise one launch; the last shard against the plain versions
    at its offset, within ``1e-4 max(1, max|ref|)``."""
    from dibs_tpu_torch.inference import fused_linear as fl
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian, LinearGaussian

    rng = np.random.default_rng(15)
    for label, p, d, n, m, splits in (("row, config 2", P, D, N_OBS, M,
                                       (2, 3)),
                                      ("wide, config 5", P5, D5, N5, M5,
                                       (2, 4))):
        scores, thetas, x, w = fused_problem(rng, dev, p, d, n, 0)
        kw = dict(seed=31, streams=(12, 12), alpha=0.9, tau=1.0,
                  n_samples=m, model=LinearGaussian(n_vars=d))
        lls = fl.fused_linear_pass1(scores, thetas, x, w, **kw)
        wts = tuple(torch.softmax(ll, dim=1) for ll in lls)
        calls = {"pass1": lambda r, o: fl.fused_linear_pass1(
                     scores[r], thetas[r], x, w, particle_offset=o, **kw),
                 "pass2": lambda r, o: fl.fused_linear_pass2(
                     scores[r], thetas[r], x, w, tuple(t[r] for t in wts),
                     particle_offset=o, **kw)}
        plain = {"pass1": lambda r, o: fl.fused_linear_pass1_plain(
                     scores[r], thetas[r], x, w, particle_offset=o, **kw),
                 "pass2": lambda r, o: fl.fused_linear_pass2_plain(
                     scores[r], thetas[r], x, w, tuple(t[r] for t in wts),
                     particle_offset=o, **kw)}
        if d <= 70:
            calls["single"] = lambda r, o: fl.fused_linear_single(
                scores[r], thetas[r], x, w, particle_offset=o, **kw)
            plain["single"] = lambda r, o: fl.fused_linear_single_plain(
                scores[r], thetas[r], x, w, particle_offset=o, **kw)
        rows, off = last_shard(p, splits)
        worst = 0.0
        for name, launch in calls.items():
            whole = shards_bitwise(f"{name} {label}", launch, p, splits)
            worst = max(worst, _bar_err(
                f"{name} {label} shard at {off}",
                [t[rows] for t in whole], plain[name](rows, off)))
        log(f"[14b kernels] #5-#7 {label} ({', '.join(calls)}): {splits} "
            f"shards bitwise one launch; the shard at particle {off} "
            f"against the plain versions: {worst:.3f} x the bar")
    h1, splits = 5, (2, 3)
    args = nonlinear_problem(rng, dev, P, D, N_OBS, h1, 0)
    kw = dict(seed=41, streams=(3, 3), alpha=0.7, tau=1.0, n_samples=M,
              model=DenseNonlinearGaussian(n_vars=D, hidden_layers=(h1,)))

    def launch(rows, off, fn=fnl.fused_nonlinear):
        return fn(*(a[rows] for a in args[:5]), *args[5:],
                  particle_offset=off, **kw)

    whole = shards_bitwise("#8 config 3", launch, P, splits)
    rows, off = last_shard(P, splits)
    worst = _bar_err(f"#8 config 3 shard at {off}", [t[rows] for t in whole],
                     launch(rows, off, fnl.fused_nonlinear_plain))
    edges = max(shard_nonlinear(dev, case, str(case))
                for case in SHARD_NL_CASES)
    log(f"[14b kernels] #8 config 3: {splits} shards bitwise one launch; "
        f"the shard at particle {off} against the plain version: "
        f"{worst:.3f} x the bar; the shard build at {len(SHARD_NL_CASES)} "
        f"gate edges and instantiations: {SHARD_SPLITS} shards bitwise, "
        f"{edges:.3f} x the bar")


@contextlib.contextmanager
def counted(counts):
    """Adds the kernel launches made inside the block to ``counts``."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    before = dict(gk.LAUNCHES)
    yield
    for name in counts:
        counts[name] += gk.LAUNCHES[name] - before[name]


def state_digest(state):
    """A SHA-256 of every tensor of a state, in tree order (ranks whose
    digests agree hold the same bits)."""
    import hashlib

    from dibs_tpu_torch.utils.tree import tree_leaves

    digest = hashlib.sha256()
    for leaf in tree_leaves(list(state)):
        if isinstance(leaf, torch.Tensor):
            digest.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def peak_gb(dev, fn):
    """``fn()``'s peak device memory in GB above what was allocated before
    it (0 off the card)."""
    if dev.type != "cuda":
        fn()
        return 0.0
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def sharded_vs_whole(make, sharding, counts, *, seed, p, k, tf, free):
    """A sharded engine (``make(sharding)``) against the unsharded one
    (``make(None)``): ``tf`` teacher-forced transports from the unsharded
    run's states (gathered, against ``1e-4 max|phi|``), then ``free``
    free steps of each from one seed (graphs, ``z``). Only the sharded
    engine's launches are counted."""
    from dibs_tpu_torch.parallel import shard_state
    from dibs_tpu_torch.parallel.shard_ops import gather_rows
    from dibs_tpu_torch.utils.tree import tree_leaves

    whole, shard = make(None), make(sharding)
    std = whole._resolve_latent_std(k)
    phi_w, phi_s = whole._make_phi(std), shard._make_phi(std)
    step = whole._make_step(std)
    n_out = 1 if whole.__class__.__name__ == "MarginalDiBS" else 2
    state = whole.init_state(seed=seed, n_particles=p, n_dim_particles=k)
    worst = 0.0
    for _ in range(tf):
        with torch.no_grad():
            want = tree_leaves(list(phi_w(state)[:n_out]))
            with counted(counts):
                got = phi_s(shard_state(state, sharding))[:n_out]
            got = [gather_rows(a, sharding) for a in tree_leaves(list(got))]
        for a, b in zip(got, want):
            worst = max(worst, float((a - b).abs().max())
                        / (1e-4 * float(b.abs().max())))
        state = step(state)
    out = dict(tf_worst=worst)
    if free:
        sync(whole.device)
        t0 = time.perf_counter()
        with counted(counts):
            run_s = shard.sample(seed=seed + 1, n_particles=p, steps=free,
                                 n_dim_particles=k, return_state=True)
        sync(whole.device)
        secs = time.perf_counter() - t0
        run_w = whole.sample(seed=seed + 1, n_particles=p, steps=free,
                             n_dim_particles=k, return_state=True)
        out.update(state_digest=state_digest(run_s[-1]),
                   graphs_equal=bool(torch.equal(run_s[0], run_w[0])),
                   particles_differ=int((run_s[0] != run_w[0]).flatten(1)
                                        .any(1).sum()),
                   z_err=float((run_s[-1].z - run_w[-1].z).abs().max()),
                   steps_per_s=free / secs)
    return out


def case14(name, dev, sharding, counts):
    """One two-rank case of phase 14 on this rank (see ``phase_sharding``)."""
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.target import (
        make_linear_gaussian_equivalent_model,
        make_linear_gaussian_model,
        make_nonlinear_gaussian_model,
    )

    gen = torch.Generator().manual_seed(0)
    if name == "marginal score":
        data, gm, lm = make_linear_gaussian_equivalent_model(
            generator=gen, n_vars=D, graph_prior_str="er",
            n_observations=N_OBS, device=dev)
        return sharded_vs_whole(
            lambda s: MarginalDiBS(
                x=data.x, graph_model=gm, likelihood_model=lm,
                grad_estimator_z="score", n_grad_mc_samples=M,
                n_acyclicity_mc_samples=K_ACYC, sharding=s, device=dev),
            sharding, counts, seed=2, p=P, k=K_LAT, tf=TF14, free=FREE14)
    if name == "marginal score_rb":
        data, gm, lm = make_linear_gaussian_equivalent_model(
            generator=gen, n_vars=D, graph_prior_str="er",
            n_observations=N_OBS, device=dev)
        return sharded_vs_whole(
            lambda s: MarginalDiBS(
                x=data.x, graph_model=gm, likelihood_model=lm,
                grad_estimator_z="score_rb", n_grad_mc_samples=M,
                n_acyclicity_mc_samples=K_ACYC, sharding=s, device=dev),
            sharding, counts, seed=2, p=P, k=K_LAT, tf=TF14, free=FREE14)
    if name == "config 6":
        return config6_mc(dev, sharding, counts)
    if name == "fleet":
        return fleet14(dev, sharding, counts)
    if name == "config 5":
        data, gm, lm = make_linear_gaussian_model(
            generator=torch.Generator().manual_seed(123), n_vars=D5,
            n_observations=N5, device=dev)
        return sharded_vs_whole(
            lambda s: JointDiBS(x=data.x, graph_model=gm,
                                likelihood_model=lm, n_grad_mc_samples=M5,
                                n_acyclicity_mc_samples=K_ACYC5,
                                sharding=s, device=dev),
            sharding, counts, seed=1, p=P5, k=K5, tf=TF14_C5, free=0)
    factory = (make_nonlinear_gaussian_model if name == "config 3"
               else make_linear_gaussian_model)
    data, gm, lm = factory(generator=gen, n_vars=D, n_observations=N_OBS,
                           device=dev)
    kernel_param = ({"h_latent": 5.0, "h_theta": "median"}
                    if name == "config 2, median h_theta" else None)
    steps = ((5, 10) if kernel_param else
             (TF14, FREE14) if sharding.mc_size > 1 else (TF14, TF14))
    estimator = "score" if name == "joint score" else "reparam"
    return sharded_vs_whole(
        lambda s: JointDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                            kernel_param=kernel_param, n_grad_mc_samples=M,
                            n_acyclicity_mc_samples=K_ACYC, sharding=s,
                            grad_estimator_z=estimator, device=dev),
        sharding, counts, seed=2, p=P, k=K_LAT, tf=steps[0], free=steps[1])


def config6_mc(dev, sharding, counts):
    """14c's config 6 (``MarginalDiBS`` + BGe, sf d=128, N=100, P=100,
    M=64, K=8) on the ``("p", "mc")`` mesh: ``TF14_C6`` teacher-forced
    transports against the unsharded engine's, and this rank's peak
    device memory for one transport beside the unsharded engine's."""
    from dibs_tpu_torch.inference import MarginalDiBS
    from dibs_tpu_torch.parallel import shard_state
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=torch.Generator().manual_seed(123), n_vars=D6,
        graph_prior_str="sf", device=dev)

    def make(s):
        return MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                            n_grad_mc_samples=M6,
                            n_acyclicity_mc_samples=K_ACYC6, sharding=s,
                            device=dev)

    whole, shard = make(None), make(sharding)
    std = whole._resolve_latent_std(D6)
    state = whole.init_state(seed=1, n_particles=P6)
    with torch.no_grad():
        peak_w = peak_gb(dev, lambda: whole._make_phi(std)(state))
        local = shard_state(state, sharding)
        with counted(counts):
            peak_s = peak_gb(dev, lambda: shard._make_phi(std)(local))
    del local
    out = sharded_vs_whole(make, sharding, counts, seed=1, p=P6, k=D6,
                           tf=TF14_C6, free=0)
    out.update(peak_gb_sharded=peak_s, peak_gb_unsharded=peak_w)
    return out


def fleet14(dev, sharding, counts):
    """``fleet_sample(mesh=)`` with ``FLEET14_B`` datasets over the ranks'
    ``datasets`` axis, against the meshless fleet on each rank."""
    from torch.distributed.device_mesh import DeviceMesh

    from dibs_tpu_torch.fleet import fleet_sample

    xs, dibs, _ = fleet_problem(dev, FLEET14_B, "score")
    mesh = DeviceMesh("cpu", list(range(sharding.world)),
                      mesh_dim_names=("datasets",))
    kw = dict(xs=xs, seed=4, n_particles=P, steps=FLEET14_STEPS,
              return_states=True)
    sync(dev)
    t0 = time.perf_counter()
    with counted(counts):
        gs, state = fleet_sample(dibs, mesh=mesh, **kw)
    sync(dev)
    secs = time.perf_counter() - t0
    gs_w, state_w = fleet_sample(dibs, **kw)
    return dict(graphs_equal=bool(torch.equal(gs, gs_w)),
                bitwise=bool(torch.equal(state.z, state_w.z)),
                z_err=float((state.z - state_w.z).abs().max()),
                dataset_steps_per_s=FLEET14_B * FLEET14_STEPS / secs)


CASES14 = {"14a": ("marginal score",),
           "14b": ("config 2", "config 3", "config 2, median h_theta",
                   "config 5", "fleet")}


def rank14(rank, world, store, out_dir, names, dev_name, sizes, n_mc=1):
    """A rank of phase 14's ``gloo`` world on the one card (``dev_name``)
    at the parent's ``sizes``, on the mesh ``make_particle_mesh(n_mc=
    n_mc)``: each case of ``names``; writes its results and its sharded
    launches."""
    import datetime
    import os

    import torch.distributed as dist

    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.parallel import make_particle_mesh, particle_sharding

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    globals().update(sizes)
    try:
        dev = torch.device(dev_name)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_float32_matmul_precision("highest")
        if dev.type == "cuda":
            gk.build()
        sharding = particle_sharding(make_particle_mesh(n_mc=n_mc))
        counts = dict.fromkeys(gk.LAUNCHES, 0)
        out = {name: case14(name, dev, sharding, counts) for name in names}
        out["launches"] = counts
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ranks14(names, dev, world=2, n_mc=1):
    """Runs ``rank14`` on ``world`` ``gloo`` ranks sharing the card ``dev``
    (a file store in a fresh temporary directory), on a mesh with
    ``n_mc`` ranks on its ``"mc"`` axis; returns each rank's results."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        sizes = {name: globals()[name] for name in SIZES14}
        ctx = mp.spawn(rank14, args=(world, os.path.join(tmp, "store"), tmp,
                                     names, str(dev), sizes, n_mc),
                       nprocs=world, join=False)
        deadline = time.perf_counter() + WORLD14_TIMEOUT
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"[14] the {world}-rank world took more than "
                     f"{WORLD14_TIMEOUT} s")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def two_ranks(names, dev):
    """``ranks14`` on two ranks of a one-dimensional mesh."""
    return ranks14(names, dev)


def nccl_one_rank(dev, counts):
    """14a: a one-rank NCCL world. Sharded ``MarginalDiBS`` ``score`` at
    the headline config is bitwise the unsharded run for ``TF14`` steps (a
    one-rank mesh shards nothing); the ring transport and #3's row block
    through NCCL's collectives against the unsharded transport and #3."""
    import datetime
    import socket

    import torch.distributed as dist

    from dibs_tpu_torch.inference import MarginalDiBS
    from dibs_tpu_torch.inference.transport import marginal_transport
    from dibs_tpu_torch.kernel import AdditiveFrobeniusSEKernel
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.parallel import make_particle_mesh, particle_sharding
    from dibs_tpu_torch.parallel.ring import ring_marginal_transport
    from dibs_tpu_torch.parallel.shard_ops import sharded_se_matrix
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sharding = particle_sharding(make_particle_mesh())
        data, gm, lm = make_linear_gaussian_equivalent_model(
            generator=torch.Generator().manual_seed(0), n_vars=D,
            graph_prior_str="er", n_observations=N_OBS, device=dev)
        runs = []
        for s in (None, sharding):
            dibs = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                                grad_estimator_z="score",
                                n_grad_mc_samples=M,
                                n_acyclicity_mc_samples=K_ACYC, sharding=s,
                                device=dev)
            with contextlib.ExitStack() as stack:
                if s is not None:
                    stack.enter_context(counted(counts))
                runs.append(dibs.sample(seed=3, n_particles=P, steps=TF14,
                                        n_dim_particles=K_LAT,
                                        return_state=True))
        check(torch.equal(runs[0][0], runs[1][0])
              and torch.equal(runs[0][1].z, runs[1][1].z),
              "[14a] the one-rank NCCL run is not bitwise the unsharded run")
        gen = torch.Generator(device=dev).manual_seed(5)
        z = torch.randn((P, D, K_LAT, 2), generator=gen, device=dev) * 0.3
        dz = torch.randn((P, D, K_LAT, 2), generator=gen, device=dev)
        kernel = AdditiveFrobeniusSEKernel(h=5.0)
        ring = ring_marginal_transport(kernel, z, dz, sharding)
        want = marginal_transport(kernel, z, dz)
        err_r = float((ring - want).abs().max()) / (
            1e-4 * float(want.abs().max()))
        check(err_r <= 1.0, f"[14a] NCCL ring: {err_r} x the bar")
        flat = z.reshape(P, -1).contiguous()
        rows = sharded_se_matrix(flat, flat, 5.0, 1.0, sharding=sharding)
        err_se = float((rows - gk.se_matrix(flat, flat, 5.0, 1.0)).abs()
                       .max())
        check(err_se <= 1e-5, f"[14a] NCCL #3 row block: max err {err_se}")
    finally:
        dist.destroy_process_group()
    log(f"[14a nccl] one rank: sharded MarginalDiBS score {TF14} steps "
        f"bitwise the unsharded run; the ring through NCCL {err_r:.3f} x "
        f"the bar of the unsharded transport; #3's row block max err "
        f"{err_se:.3g}")


def phase_sharding(dev, card):
    """Phase 14, the particle-sharded port: (a) #1 per shard bitwise one
    launch, a one-rank NCCL world, then two ``gloo`` ranks on the one card
    running sharded ``MarginalDiBS`` ``score``; (b) #5-#8 per shard
    bitwise one launch, two ranks running sharded ``JointDiBS`` at configs
    2 and 3 (and config 2 with a median ``h_theta``, the all-gather route),
    config 5 teacher-forced, and ``fleet_sample(mesh=)``. Returns the
    sharded runs' kernel launches (both ranks)."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    t0 = time.perf_counter()
    counts = dict.fromkeys(gk.LAUNCHES, 0)
    shard_sampler(dev)
    nccl_one_rank(dev, counts)
    shard_fused(dev)
    ranks = two_ranks(CASES14["14a"] + CASES14["14b"], dev)
    for step, names in CASES14.items():
        check_ranks(step, names, ranks, card, "two gloo ranks")
    for r in ranks:
        for name in counts:
            counts[name] += r["launches"][name]
    for name in ("gumbel_graphs", "bge_pairs", "fused_linear_single",
                 "fused_nonlinear", "fused_linear_wide_pass1",
                 "fused_linear_wide_pass2", "se_matrix", "score_ratio"):
        check(counts[name] > 0, f"[14] {name} never launched sharded")
    log(f"[14 launches] sharded runs, both ranks: {counts}; 14a-b "
        f"{time.perf_counter() - t0:.1f} s")
    phase_mc(dev, card, counts)
    log(f"[14] phase {time.perf_counter() - t0:.1f} s")
    return counts


def check_ranks(step, names, ranks, card, what):
    """Phase 14's checks of every case of ``names`` on ``ranks``' results:
    the ranks agree (graphs, and the final state bit for bit where a
    digest was taken), teacher-forced transports within the bar, graphs
    equal to the unsharded run's."""
    for name in names:
        res = ranks[0][name]
        for other in ranks[1:]:
            check(other[name].get("graphs_equal", True)
                  == res.get("graphs_equal", True)
                  and other[name].get("state_digest")
                  == res.get("state_digest"),
                  f"[{step}] {name}: the ranks disagree")
        if "tf_worst" in res:
            worst = max(r[name]["tf_worst"] for r in ranks)
            check(worst <= 1.0, f"[{step}] {name}: teacher-forced phi "
                                f"{worst:.3f} x the bar")
        if "graphs_equal" in res:
            check(res["graphs_equal"],
                  f"[{step}] {name}: graphs differ from the unsharded "
                  f"run ({res.get('particles_differ')} particles)")
        shown = {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in res.items() if k != "state_digest"}
        if "peak_gb_sharded" in res:
            shown["peak_gb_sharded_by_rank"] = [
                round(r[name]["peak_gb_sharded"], 4) for r in ranks]
        log(f"[{step} {what}, one card] {name}: {shown} on '{card}' (ranks "
            f"sharing one card, not a multi-GPU rate)")


MC14_CASES = ("marginal score", "marginal score_rb", "joint score",
              "config 2")


def phase_mc(dev, card, counts):
    """14c, the ``("p", "mc")`` mesh: #1's sample blocks (``mc_sampler``),
    then for each of ``MC14_WORLDS`` (``1 x 2`` and ``2 x 2``) ``gloo``
    ranks sharing the card running the headline ``score`` and
    ``score_rb``, joint ``score`` and the fused route at config 2 (each
    ``TF14`` teacher-forced steps against the unsharded engine's ``phi``,
    then ``FREE14`` free steps: graphs equal, every rank's final state
    bitwise the others'), and on ``1 x 2`` config 6 (``TF14_C6``
    teacher-forced steps, peak memory). Adds the worlds' launches to
    ``counts``."""
    t0 = time.perf_counter()
    mc_sampler(dev)
    mc_counts = dict.fromkeys(counts, 0)
    for world, n_mc in MC14_WORLDS:
        names = MC14_CASES + (("config 6",) if world == n_mc else ())
        ranks = ranks14(names, dev, world, n_mc)
        check_ranks("14c", names, ranks, card,
                    f"{world // n_mc} x {n_mc} gloo ranks")
        for r in ranks:
            for name in counts:
                mc_counts[name] += r["launches"][name]
    for name in ("gumbel_graphs", "bge_pairs", "fused_linear_single",
                 "se_matrix", "transport_phi", "score_ratio"):
        check(mc_counts[name] > 0, f"[14c] {name} never launched on the "
                                   "('p', 'mc') mesh")
    for name in counts:
        counts[name] += mc_counts[name]
    log(f"[14c launches] ('p', 'mc') runs, all ranks: {mc_counts}; 14c "
        f"{time.perf_counter() - t0:.1f} s")


# phase 15(c): config 5's profiled kernels by the step model's phases they
# run. The wide passes draw the likelihood samples in their own bodies
# (``sampling_in_kernel``); #1 draws the acyclicity samples, which the model
# counts in ``acyclicity_prior`` with the chain's cuBLAS products.
CONFIG5_PHASES = {
    "fused linear (wide passes 1 and 2, their sampling)": (
        ("fused_linear",),
        ("fused_forward", "fused_backward", "sampling_in_kernel")),
    "transport (#3, #4)": (("se_matrix", "se_reduce", "transport_phi_kernel"),
                           ("kernel_transport",)),
    "acyclicity prior (#1, cuBLAS gemm)": (("gumbel_graphs_kernel", "gemm"),
                                           ("acyclicity_prior",)),
}


# phase 15(a): the kernels the three warm-up paths launch at d = 20, by
# their launch counters (#5, or its two passes)
WARM_LAUNCHES = (("gumbel_graphs",), ("bge_pairs",), ("se_matrix",),
                 ("transport_phi",), ("fused_linear_single",
                                      "fused_linear_pass1"),
                 ("fused_nonlinear",), ("score_ratio",))


class SeenLaunches(dict):
    """A stand-in for ``gpu_kernels.LAUNCHES`` that keeps, in ``seen``,
    every count's increments: a restore of the counts (lower values) adds
    nothing."""

    def __init__(self, counts):
        super().__init__(counts)
        self.seen = dict.fromkeys(counts, 0)

    def __setitem__(self, name, value):
        self.seen[name] += max(value - self.get(name, 0), 0)
        super().__setitem__(name, value)


def warm_runs(dev):
    """Three ``sample()`` steps of each warm-up model in a fresh engine at
    ``warmup(D)``'s shape on seeded data: the outputs, in a flat list."""
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.models import (
        BGe,
        DenseNonlinearGaussian,
        ErdosReniDAGDistribution,
        LinearGaussian,
    )
    from dibs_tpu_torch.utils.tree import tree_leaves

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N_OBS, D)).astype(np.float32)).to(dev)
    kw = dict(x=x, graph_model=ErdosReniDAGDistribution(D),
              n_grad_mc_samples=M, device=dev)
    out = []
    for lik in (LinearGaussian(n_vars=D),
                DenseNonlinearGaussian(n_vars=D, hidden_layers=(5,))):
        g, theta = JointDiBS(likelihood_model=lik, **kw).sample(
            seed=1, n_particles=P, steps=3)
        out += [g, *tree_leaves(theta)]
    out.append(MarginalDiBS(likelihood_model=BGe(n_vars=D, device=dev),
                            **kw).sample(seed=1, n_particles=P, steps=3))
    return out


def cold_warmup():
    """``warmup(D)`` in a new process, whose first kernel call loads the
    library built by phase 2: its stderr lines (load, then each model's
    first step)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", "from dibs_tpu_torch.warmup import warmup; "
         f"warmup({D})"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    check(res.returncode == 0, f"cold warmup failed ({res.returncode}): "
                               f"{res.stderr[-2000:]}")
    lines = [ln for ln in res.stderr.splitlines() if "warmup]" in ln]
    check(sum("first step" in ln for ln in lines) == 3,
          f"cold warmup printed {lines}")
    return lines


def step_models():
    """The reference's step model (``dibs_tpu_torch.accounting``) of each
    of phase 7's cells."""
    from dibs_tpu_torch.accounting import (
        bge_step_cost,
        linear_step_cost,
        nonlinear_step_cost,
    )

    return {
        "marginal score": bge_step_cost(d=D, n_obs=N_OBS, p=P, m=M,
                                        kmc=K_ACYC, k=K_LAT),
        "joint": linear_step_cost(d=D, n_obs=N_OBS, p=P, m=M, kmc=K_ACYC,
                                  k=K_LAT),
        "joint nonlinear": nonlinear_step_cost(
            d=D, n_obs=N_OBS, p=P, m=M, hidden=(5,), kmc=K_ACYC, k=K_LAT,
            fused_kernel=True),
        "joint config 5": linear_step_cost(d=D5, n_obs=N5, p=P5, m=M5,
                                           kmc=K_ACYC5, k=K5),
        "joint config 4": linear_step_cost(d=D4, n_obs=600, p=P4, m=M,
                                           kmc=K_ACYC, k=D4),
    }


def phase_accounting(dev, card, profiles):
    """15. accounting and warm-up: (a) ``dibs_tpu_torch.warmup.warmup(D)``
    for its three models with the launch counts at 0, which it leaves at 0,
    and the RNG states as they were; again with ``SeenLaunches`` counting,
    each group of ``WARM_LAUNCHES`` launched; ``warm_runs`` bitwise before
    and after; then in a new process (:func:`cold_warmup`); (b) ``accounting.roofline`` of each of
    phase 7's cells' step model against its wall and its device time a
    step, every share at or under 105%; (c) ``accounting.phase_roofline``
    of config 5 from phase 7's per-kernel device times; (d) every kernel
    time of phases 3, 6, 8 and 10 at or above 1/1.05 of its
    ``kernel_cost`` bound."""
    import io

    from dibs_tpu_torch.accounting import (
        bge_step_cost,
        phase_roofline,
        roofline,
    )
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.warmup import MODELS, warmup

    # (a) the library is loaded since phase 2: these are the first steps
    before = warm_runs(dev)
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    rng, rng_cuda = torch.get_rng_state(), torch.cuda.get_rng_state(dev)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        warmup(D, device=dev)
    secs = time.perf_counter() - t0
    lines = [ln for ln in err.getvalue().splitlines() if "first step" in ln]
    check(len(lines) == len(MODELS), f"warmup printed {lines}")
    check(not any(gk.LAUNCHES.values()),
          f"warmup left launch counts {gk.LAUNCHES}")
    check(torch.equal(rng, torch.get_rng_state())
          and torch.equal(rng_cuda, torch.cuda.get_rng_state(dev)),
          "warmup moved an RNG state")
    # the restore above hides the launches: a second warm-up records them
    counts = gk.LAUNCHES
    gk.LAUNCHES = seen = SeenLaunches(counts)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            warmup(D, device=dev)
    finally:
        counts.update(seen)
        gk.LAUNCHES = counts
    missing = [names for names in WARM_LAUNCHES
               if not any(seen.seen[n] for n in names)]
    check(not missing, f"warmup launched none of {missing}: {seen.seen}")
    after = warm_runs(dev)
    check(all(torch.equal(a, b) for a, b in zip(before, after)),
          "a sample() after warmup differs from one before it")
    log(f"[15a warmup] warmup({D}) of {MODELS} (N=100, P=30, M=128) on "
        f"'{card}': {secs:.2f} s; launch counts and RNG states as before; "
        f"a second warmup launched {seen.seen}; sample() of the three "
        f"models bitwise as before it; "
        + "; ".join(ln.split("] ", 1)[-1] for ln in lines))
    cold = cold_warmup()
    log(f"[15a warmup, cold process] warmup({D}) in a new process on "
        f"'{card}' (the library built, not loaded): "
        + "; ".join(ln.split("] ", 1)[-1] for ln in cold))

    # (b) each cell's step model against its measured step
    models = step_models()
    for name, cost in models.items():
        prof = profiles[name]
        for clock in ("wall", "device"):
            ms = prof[f"{clock}_ms"]
            row = roofline(cost.flops, cost.bytes_min, cost.transcendentals,
                           ms / 1e3)
            shares = {k: row[k] for k in ("mfu_pct", "hbm_pct",
                                          "transc_pct")}
            check(all(v <= 105.0 for v in shares.values()),
                  f"{name}: a share of the step model past 105% of the "
                  f"card's peak ({shares}): the count exceeds the card")
            log(f"[15b roofline {name}] {clock} {ms:.3f} ms/step on "
                f"'{card}' against the H100 SXM's peaks: {cost.flops:.4g} "
                f"FLOP, {cost.bytes_min:.4g} B, {cost.transcendentals:.4g} "
                f"transcendentals a step: {row}")
    elim = bge_step_cost(d=D6, n_obs=N_OBS, p=P6, m=M6, kmc=K_ACYC6,
                         k=D6).phases["bge_eliminations"]
    log(f"[15b roofline config 6] not printed: bge_step_cost counts a full "
        f"d^3 elimination a (graph, node), {elim:.4g} FLOP a step at d={D6}, "
        f"P={P6}, M={M6}, more than the card can do in the step's device "
        f"time; #2 eliminates over the parents only")

    # (c) config 5 by phase, from phase 7's per-kernel device times
    kernels = profiles["joint config 5"]["kernels"]
    measured, covered = {}, 0.0
    for label, (keys, phases) in CONFIG5_PHASES.items():
        ms = sum(t for n, t in kernels.items()
                 if any(k in n.lower() for k in keys))
        measured[label] = (ms, phases)
        covered += ms
    for row in phase_roofline(models["joint config 5"], measured, D5):
        log(f"[15c config 5 by phase] on '{card}': {row}")
    log(f"[15c config 5 by phase] the rows cover {covered:.3f} of "
        f"{sum(kernels.values()):.3f} device ms a step (the rest: "
        f"elementwise and reduction kernels)")

    # (d) no count past what the card did
    check(bool(TIMED), "no kernel times kept")
    for label, ms, b_ms in TIMED:
        check(b_ms <= 1.05 * ms, f"{label}: bound {b_ms} ms past 1.05 x the "
                                 f"measured {ms} ms")
    label, ms, b_ms = max(TIMED, key=lambda t: t[2] / t[1])
    log(f"[15d bounds] {len(TIMED)} kernel times of phases 3, 6, 8 and 10, "
        f"each at or above 1/1.05 of its kernel_cost bound; the closest: "
        f"{label} {ms:.4f} ms against its bound {b_ms:.5f} ms "
        f"({b_ms / ms:.3f})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    import dibs_tpu_torch  # noqa: F401  (fails here, before any output,
    #                         when the script runs outside the repository)
    from dibs_tpu_torch.config import pallas_override

    if pallas_override() is False:
        print("chip_smoke: DIBS_DISABLE_PALLAS is set: the kernels would "
              "not run", file=sys.stderr)
        return 1

    dev = torch.device("cuda:0")
    seconds = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t0, 1)
        return out

    card = run(phase_env)
    run(phase_build)
    results = {}
    run(phase_kernels, dev, results)
    run(phase_fused, dev, results)
    run(phase_fused_nonlinear, dev, results)
    run(phase_rng, dev)
    launches = run(phase_e2e, dev, card, STEPS)
    # each path's counts are set to 0 just before it runs: the joint
    # path's launches are added to the marginal path's
    for name, count in run(phase_joint, dev, card, STEPS).items():
        launches[name] += count
    for name, count in run(phase_joint_nonlinear, dev, card, STEPS_NL).items():
        launches[name] += count
    run(phase_transport, dev, results)
    run(phase_config5_kernels, dev, results)
    run(phase_se_matrix, dev, results)
    for name, count in run(phase_config5, dev, card, STEPS5).items():
        launches[name] += count
    profiles = run(phase_profile, dev, card)
    for name, count in run(phase_acyclic, dev, card, results).items():
        launches[name] += count
    for name, count in run(phase_spectral_checkpoint, dev, card, 100).items():
        launches[name] += count
    run(phase_bge_large, dev, card)
    for name, count in run(phase_config6, dev, card, results).items():
        launches[name] += count
    run(phase_score_ratio, dev, card, results)
    for name, count in run(phase_joint_score, dev, card).items():
        launches[name] += count
    run(phase_switches, dev, card)
    for name, count in run(phase_fleet, dev, card).items():
        launches[name] += count
    for name, count in run(phase_sharding, dev, card).items():
        launches[name] += count
    run(phase_accounting, dev, card, profiles)
    log(f"[seconds by phase] {seconds}")
    fused = "dibs_tpu/inference/fused_linear.py"
    sources = {
        "gumbel_graphs": ("dibs_tpu_torch/csrc/gumbel.cu",
                          "dibs_tpu/ops/pallas_kernels.py:215"),
        "bge_pairs": ("dibs_tpu_torch/csrc/bge_pairs.cu",
                      "dibs_tpu/ops/bge_kernel.py:191"),
        "se_matrix": ("dibs_tpu_torch/csrc/se_matrix.cu",
                      "dibs_tpu/ops/pallas_kernels.py:116"),
        "transport_phi": ("dibs_tpu_torch/csrc/transport_phi.cu",
                          "dibs_tpu/ops/transport_kernel.py:153"),
        "fused_linear_single": ("dibs_tpu_torch/csrc/fused_linear.cu",
                                f"{fused}:731"),
        "fused_linear_pass1": ("dibs_tpu_torch/csrc/fused_linear.cu",
                               f"{fused}:642"),
        "fused_linear_pass2": ("dibs_tpu_torch/csrc/fused_linear.cu",
                               f"{fused}:692"),
        "fused_linear_wide_pass1": ("dibs_tpu_torch/csrc/fused_linear.cu",
                                    f"{fused}:642"),
        "fused_linear_wide_pass2": ("dibs_tpu_torch/csrc/fused_linear.cu",
                                    f"{fused}:692"),
        "fused_nonlinear": ("dibs_tpu_torch/csrc/fused_nonlinear.cu",
                            "dibs_tpu/inference/fused_nonlinear.py:515"),
        "fused_nonlinear_cluster": ("dibs_tpu_torch/csrc/fused_nonlinear.cu",
                                    "dibs_tpu/inference/fused_nonlinear.py:515"),
        "acyclic_grad": ("dibs_tpu_torch/csrc/acyclic_grad.cu",
                         "benchmarks/bench_acyclic_kernel.py:84"),
        "score_ratio": ("dibs_tpu_torch/csrc/score_ratio.cu", None),
    }
    # #8's cluster tier runs in no end-to-end phase here: its count is one
    # call's, from zero (phase 3)
    launches["fused_nonlinear_cluster"] = results[
        "fused_nonlinear_cluster"].pop("launches")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
