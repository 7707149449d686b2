#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on the GPU.

Usage (from the repository root, on a machine with one CUDA card)::

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: CUDA present, card name, compute capability, power limit,
   TF32 off;
2. build: compiles the CUDA kernels of ``dibs_tpu_torch/csrc`` (timed);
3. kernel vs plain twin on the card at the main paths' shapes and more,
   with each kernel's and twin's median time (CUDA events), its bound (the
   least time an H100 SXM could take for the same work) and, where one
   PyTorch call computes the same function, that call's time; the fused
   linear-Gaussian kernels at the headline shape and at config 4's
   interventional d=30, N=600, and the fused MLP kernel #8 at config 3's
   shape and at d=30, N=600 (tiled rows), relu and tanh;
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
   N=600; d=602), the SE matrix #3 at config 5's ``[1000, 1000]``, and
   ``JointDiBS`` with ``LinearGaussian`` at config 5 (d=128 scale-free,
   N=100, P=1000, k=128, M=32, K=8; nothing cut) for 100 timed steps after
   10 warm-up steps: exact launch counts (the transport kernel, the wide
   fused linear tier, the sampler and the SE matrix only), steps/s, finite
   state, and teacher-forced ``phi`` for 3 steps against the plain versions
   on the card and for 5 steps at P=16 against those on the CPU;
7. profile: ``torch.profiler`` over 50 steady steps of the marginal
   (``score``), the joint linear, the joint nonlinear and the config-5
   step: wall and device time per step, the device's busy share, kernel
   launches per step, the top kernels;
8. the fused acyclicity gradient #9 against its plain version at the
   microbenchmark's P=1000, d=128, K=8 and at ragged d (13, 30, 137, 139),
   Philox and injected noise, scores below -88/alpha, each particle within
   ``1e-4 max(1, max|plain[p]|)``; its time beside the
   plain version's, the engine route's (the library column) and the bound;
   its entry point ``python -m dibs_tpu_torch.ops.acyclic_kernel`` at its
   defaults, with exact launches and the 64-sample Monte Carlo agreement
   with the engine route; ``acyclicity='spectral'`` in ``MarginalDiBS``
   (bench shape, ``'sampled'``) and ``JointDiBS`` (config 2, ``'mean'``),
   100 steps each with exact launch counts; and a checkpoint round trip on
   the card (50 steps, save, load, 50 more equal 100 straight).

The second-to-last line is a JSON summary of the kernels, the line before it
the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
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
# kernel #9 at its microbenchmark's defaults (benchmarks/bench_acyclic_kernel.py)
P9, D9, K9 = 1000, 128, 8
SHAPES9 = [(64, 13, 4), (64, 30, 4), (32, 137, 2), (8, 139, 2), (16, 128, 3)]
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12  # H100 SXM data sheet


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


def bound_ms(flops, n_bytes):
    """Least time on an H100 SXM: the larger of float32 operations at
    67 TFLOP/s and bytes at 3.35 TB/s. Returns ``(ms, bound_by)``."""
    t_ops, t_bytes = flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def phase_build():
    from dibs_tpu_torch.ops import gpu_kernels

    t0 = time.perf_counter()
    gpu_kernels.build()
    secs = time.perf_counter() - t0
    report = [ln.strip() for ln in gpu_kernels.build_log().splitlines()
              if "registers" in ln or "spill" in ln]
    log(f"[2 build] nvcc sm_90a build+load {secs:.2f} s; ptxas: "
        + " | ".join(report))


def phase_kernels(dev, results):
    from dibs_tpu_torch.models.linear_gaussian import BGe
    from dibs_tpu_torch.ops import gpu_kernels as gk
    from dibs_tpu_torch.ops.bge_kernel import (
        bge_logdet_pairs,
        bge_logdet_pairs_plain,
    )

    rng = np.random.default_rng(0)

    # --- Gumbel sampler, injected noise ---
    err_g = 0.0
    for (b, m, d) in [(30, 128, 20), (30, 32, 20), (4, 8, 5), (4, 8, 128)]:
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
    # in-kernel Philox vs the twin's Philox (same stream, same maths)
    scores = torch.from_numpy(
        rng.normal(size=(P, D, D)).astype(np.float32)).to(dev)
    soft_k = gk.gumbel_graphs(scores, 5, 9, 1.0, 1.0, M, False)
    soft_p = gk.gumbel_graphs_plain(scores, 5, 9, 1.0, 1.0, M, False)
    philox_err = float((soft_k - soft_p).abs().max())
    check(philox_err <= 1e-5, f"in-kernel Philox vs twin: {philox_err}")
    t_g = cuda_median_ms(lambda: gk.gumbel_graphs(scores, 5, 9, 1.0, 1.0, M,
                                                  True))
    t_gp = cuda_median_ms(lambda: gk.gumbel_graphs_plain(scores, 5, 9, 1.0,
                                                         1.0, M, True))
    t_gs = cuda_median_ms(lambda: gk.gumbel_graphs(scores, 5, 9, 1.0, 1.0,
                                                   K_ACYC, False))
    t_gsp = cuda_median_ms(lambda: gk.gumbel_graphs_plain(
        scores, 5, 9, 1.0, 1.0, K_ACYC, False))
    log(f"[3 gumbel] hard exact off ties, soft atol 1e-6 at (B,M,d) in "
        f"(30,128,20),(30,32,20),(4,8,5),(4,8,128): max err {err_g:.3g}; "
        f"Philox kernel vs twin {philox_err:.3g}; hard [30,128,20,20] "
        f"kernel {t_g:.4f} ms twin {t_gp:.4f} ms; soft [30,32,20,20] "
        f"kernel {t_gs:.4f} ms twin {t_gsp:.4f} ms")
    # elementwise: scores read once, [P, M, d, d] samples written once
    b_ms, b_by = bound_ms(3 * P * M * D * D, 4 * (P * D * D + P * M * D * D))
    results["gumbel_graphs"] = dict(max_abs_err=max(err_g, philox_err),
                                    ms=t_g, plain_ms=t_gp, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)

    # --- BGe determinant pairs ---
    err_b, err_64 = 0.0, 0.0
    t_b = t_bp = None
    for d, b, collinear in [(2, 3840, False), (7, 3840, False),
                            (20, 3840, False), (20, 512, True),
                            (64, 256, False), (128, 48, False)]:
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
        gs_t = torch.from_numpy(gs).to(dev)
        pa, full = bge_logdet_pairs(r_mats, gs_t)
        pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs_t)
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
            # what this data needs: a k^3/3 elimination plus its k^2 border
            # per (graph, node) with k parents
            k = par.sum(-1).double()
            b_ms, b_by = bound_ms(float((2 * (k ** 3 / 3 + k ** 2)).sum()),
                                  4 * (d ** 3 + b * d * d + 2 * b * d))
    check(err_64 <= 1e-4, f"bge vs float64 slogdet: rel err {err_64}")
    log(f"[3 bge] d in 2,7,20,20(collinear),64,128 vs twin (rtol=atol=1e-4) "
        f"max err {err_b:.3g}; vs float64 slogdet max |err|/(1+|ref|) "
        f"{err_64:.3g}; [3840 graphs, d=20] kernel {t_b:.4f} ms twin "
        f"{t_bp:.4f} ms slogdet {t_lib:.4f} ms bound {b_ms:.5f} ms ({b_by})")
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
            b_ms, b_by = bound_ms(3 * a * a * n, 4 * (2 * a * n + a * a))
    log(f"[3 se] (A,B,n) in (30,30,800),(100,100,32768) atol 1e-5 max err "
        f"{err_s:.3g}, diagonal == scale; [30,30,800] kernel {t_s:.4f} ms "
        f"twin {t_sp:.4f} ms")
    results["se_matrix"] = dict(max_abs_err=err_s, ms=t_s, plain_ms=t_sp,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def fused_linear_flops(kind, p, m, n, d):
    """Float32 operations of one fused-linear call, counted from its
    arithmetic: per sample and branch ``2 N d^2`` for ``delta``, ``4 N d``
    for the log-likelihood terms, ``2 N d`` for the residuals and ``2 N d^2``
    for ``x^T resid``; plus ``2 N d^2`` per particle for ``resid_ref``."""
    per = {"single": 4 * n * d * d + 6 * n * d,
           "pass1": 2 * n * d * d + 4 * n * d,
           "pass2": 4 * n * d * d + 2 * n * d}[kind]
    return 2 * p * m * per + 2 * p * n * d * d


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
        # times at this shape, in-kernel noise (the main path's mode)
        kw = dict(seed=17, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=M,
                  model=model)
        args = (scores, thetas, x, w)
        lls = fl.fused_linear_pass1(*args, **kw)
        weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
        in_bytes = 4 * (2 * p * d * d + 2 * n * d)
        times = {
            "fused_linear_single": (
                lambda: fl.fused_linear_single(*args, **kw),
                lambda: fl.fused_linear_single_plain(*args, **kw),
                fused_linear_flops("single", p, M, n, d),
                in_bytes + 4 * 2 * p * d * d),
            "fused_linear_pass1": (
                lambda: fl.fused_linear_pass1(*args, **kw),
                lambda: fl.fused_linear_pass1_plain(*args, **kw),
                fused_linear_flops("pass1", p, M, n, d),
                in_bytes + 4 * 2 * p * M),
            "fused_linear_pass2": (
                lambda: fl.fused_linear_pass2(*args, weights, **kw),
                lambda: fl.fused_linear_pass2_plain(*args, weights, **kw),
                fused_linear_flops("pass2", p, M, n, d),
                in_bytes + 4 * 2 * p * M + 4 * 2 * p * d * d),
        }
        line = []
        for name, (kern, plain, flops, n_bytes) in times.items():
            t_k, t_p = cuda_median_ms(kern, reps=20), cuda_median_ms(plain,
                                                                     reps=5)
            b_ms, b_by = bound_ms(flops, n_bytes)
            line.append(f"{name} {t_k:.4f} ms (plain {t_p:.4f}, bound "
                        f"{b_ms:.5f} {b_by})")
            if d == D:  # the headline shape is the one the main path runs
                results[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None)
        log(f"[3 fused P={p} d={d} N={n} M={M}] " + "; ".join(line))
    for name, e in errs.items():
        results[name]["max_abs_err"] = e
    log(f"[3 fused] kernels vs plain at (P,d,N) in (30,20,100),(20,30,600 "
        f"with interventions), injected / Philox / shared-stream noise, "
        f"single and two-pass, #5 vs #6+#7: within 1e-4 max(1, max|ref|), "
        f"worst {worst:.3f} of the bar")


def fused_nonlinear_flops(p, m, n, d, h1):
    """Float32 operations of one #8 call, counted from its arithmetic: per
    sample and stream ``2 h1 N d^2`` for the first-layer deltas and
    ``2 h1 N d^2`` for ``x^T u_h``; plus ``2 h1 N d^2`` per particle for the
    reference forward (the ``O(h1 N d)`` elementwise work is not counted)."""
    return 2 * p * m * 4 * h1 * n * d * d + p * 2 * h1 * n * d * d


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


def phase_fused_nonlinear(dev, results):
    from dibs_tpu_torch.inference import fused_nonlinear as fnl
    from dibs_tpu_torch.models import DenseNonlinearGaussian

    rng = np.random.default_rng(5)
    worst, err_max = 0.0, 0.0
    for p, d, n, h1, blocks in [(P, D, N_OBS, 5, 0), (20, 30, 600, 5, 5)]:
        args = nonlinear_problem(rng, dev, p, d, n, h1, blocks)
        tile = fnl.fused_nonlinear_tile_rows(d, h1, n)
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
                    got = fnl.fused_nonlinear(*args, **kw)
                    want = fnl.fused_nonlinear_plain(*args, **kw)
                    for a, b in zip(got, want):
                        e = float((a - b).abs().max())
                        tol = 1e-4 * max(1.0, float(b.abs().max()))
                        check(e <= tol, f"fused_nonlinear d={d} N={n} "
                                        f"{activation} {noise} alpha={alpha}"
                                        f": max err {e} > {tol}")
                        worst, err_max = max(worst, e / tol), max(err_max, e)
        model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
        kw = dict(seed=23, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=M,
                  model=model)
        t_k = cuda_median_ms(lambda: fnl.fused_nonlinear(*args, **kw),
                             reps=20)
        t_p = cuda_median_ms(lambda: fnl.fused_nonlinear_plain(*args, **kw),
                             reps=5)
        # bytes: the kernel-layout inputs read once, the outputs written once
        n_bytes = 4 * (sum(a.numel() for a in args)
                       + p * (d * d + h1 * d * d + (2 * h1 + 1) * d))
        b_ms, b_by = bound_ms(fused_nonlinear_flops(p, M, n, d, h1), n_bytes)
        log(f"[3 fused_nonlinear P={p} d={d} N={n} h1={h1} M={M} tile={tile}]"
            f" kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}, {fused_nonlinear_flops(p, M, n, d, h1) / 1e9:.3f} "
            f"GFLOP)")
        if d == D:  # the shape config 3's main path runs
            results["fused_nonlinear"] = dict(
                ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
    results["fused_nonlinear"]["max_abs_err"] = err_max
    log(f"[3 fused_nonlinear] kernel vs plain at (P,d,N,h1) in (30,20,100,5)"
        f",(20,30,600,5 with interventions, tiled rows), relu and tanh, "
        f"injected / Philox / shared-stream noise, tau 1 and 0.8: within "
        f"1e-4 max(1, max|ref|), worst {worst:.3f} of the bar")


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
            ("ragged", 7, 130, True, 5.0), ("ragged", 7, 130, False, 5.0)]:
        k_own, k_other, g, v, mu = transport_problem(gen, dev, p, n, joint)
        c = -2.0 / h
        got = tk.transport_phi(k_own, k_other, g, v, c=c, mu=mu)
        want = tk.transport_phi_plain(k_own, k_other, g, v, c=c, mu=mu)
        e = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        check(e <= tol, f"transport_phi {name} P={p} n={n}: {e} > {tol}")
        worst, err_max = max(worst, e / tol), max(err_max, e)
        if name == "ragged":
            continue
        k_mat = k_own + k_other if joint else k_own

        def matmul_route():  # the port's former two-matmul route
            return -(_weighted_scores(k_mat, g)
                     + _se_repulsion(k_own, c, v)) / p

        e_lib = float((matmul_route() - want).abs().max())
        check(e_lib <= tol, f"matmul route {name}: {e_lib} > {tol}")
        t_k = cuda_median_ms(lambda: tk.transport_phi(k_own, k_other, g, v,
                                                      c=c, mu=mu), reps=20)
        t_p = cuda_median_ms(lambda: tk.transport_phi_plain(
            k_own, k_other, g, v, c=c, mu=mu), reps=20)
        t_lib = cuda_median_ms(matmul_route, reps=20)
        n_mats = 2 if joint else 1
        b_ms, b_by = bound_ms(2 * n_mats * p * p * n,
                              4 * (3 * p * n + n_mats * p * p + n + p))
        line.append(f"{name} [{p},{n}] {'joint' if joint else 'marginal'} "
                    f"kernel {t_k:.4f} ms plain {t_p:.4f} matmul route "
                    f"{t_lib:.4f} bound {b_ms:.5f} ({b_by})")
        if name == "config 5 Z":  # the main path of this slice
            results["transport_phi"] = dict(ms=t_k, plain_ms=t_p,
                                            bound_ms=b_ms, bound_by=b_by,
                                            library_ms=t_lib)
    results["transport_phi"]["max_abs_err"] = err_max
    log("[6 config 5: transport_phi] " + "; ".join(line))
    log(f"[6 config 5: transport_phi] kernel vs plain within 1e-4 max(1, "
        f"max|ref|) at all shapes (ragged [7,130] joint and marginal included), worst "
        f"{worst:.3f} of the bar")


def phase_config5_kernels(dev, results):
    """The wide fused linear tier against the plain versions at config 5's
    shape (d=128, N=100, P=1000, M=32), a ragged column tile with tiled,
    interventional rows (d=75, N=600) and the tier's edge (d=602); and #3 at
    config 5's ``[1000, 1000]`` over n = 32,768 and 16,384."""
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

    for p, d, n, blocks in [(P5, D5, N5, 0), (6, 75, 600, 5), (2, 602, 30, 0)]:
        scores, thetas, x, w = fused_problem(rng, dev, p, d, n, blocks)
        model = LinearGaussian(n_vars=d)
        m = M5 if d == D5 else 8
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
                lls_p = fl.fused_linear_pass1_plain(*args, **kw)
                for got, ref in zip(lls, lls_p):
                    worst = max(worst, err("fused_linear_wide_pass1", got,
                                           ref))
                weights = tuple(torch.softmax(ll, dim=1) for ll in lls_p)
                two = fl.fused_linear_pass2(*args, weights, **kw)
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
        if d != D5:
            continue
        # times at config 5's shape, in-kernel shared noise (the main path)
        kw = dict(seed=17, streams=(4, 4), alpha=2.0, tau=1.0, n_samples=m,
                  model=model)
        lls = fl.fused_linear_pass1(*args, **kw)
        weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
        # pass 2 skips the samples whose two weights are both 0
        kept = int(((weights[0] != 0) | (weights[1] != 0)).sum())
        in_bytes = 4 * (2 * p * d * d + 2 * n * d)
        n_ct = -(-d // 8)
        per2 = 4 * n * d * d + 2 * n * d
        flops2 = 2 * kept * per2 + 2 * p * n * d * d
        cases = {
            "fused_linear_wide_pass1": (
                lambda: fl.fused_linear_pass1(*args, **kw),
                lambda: fl.fused_linear_pass1_plain(*args, **kw),
                fused_linear_flops("pass1", p, m, n, d),
                in_bytes + 4 * 2 * p * m),
            "fused_linear_wide_pass2": (
                lambda: fl.fused_linear_pass2(*args, weights, **kw),
                lambda: fl.fused_linear_pass2_plain(*args, weights, **kw),
                flops2, in_bytes + 4 * 2 * p * m + 4 * 2 * p * d * d),
        }
        line = []
        for name, (kern, plain, flops, n_bytes) in cases.items():
            t_k = cuda_median_ms(kern, reps=10)
            t_p = cuda_median_ms(plain, reps=3)
            b_ms, b_by = bound_ms(flops, n_bytes)
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
    log(f"[6 config 5: fused wide] wide tier vs plain at (P,d,N) in "
        f"(1000,128,100),(6,75,600 with interventions, tiled rows),(2,602,30, tiled rows), "
        f"injected / Philox / shared-stream noise, alpha,tau in (2,1),"
        f"(0.7,0.8), and vs the one-pass plain version: within 1e-4 max(1, "
        f"max|ref|), worst {worst:.3f} of the bar")

    # --- #3 at config 5's shape: [1000, 1000] over the Z and Theta rows ---
    line = []
    for n, h in ((D5 * K5 * 2, 5.0), (D5 * D5, 500.0)):
        x = torch.randn(P5, n, generator=gen, device=dev) * math.sqrt(
            h / (2.0 * n))
        out = gk.se_matrix(x, x, h, 1.0)
        e_p = float((out - gk.se_matrix_plain(x, x, h, 1.0)).abs().max())
        check(e_p <= 1e-5, f"se [1000,1000] over {n}: max err {e_p} vs plain")
        x64 = x.double()
        sq = (x64.square().sum(1)[:, None] + x64.square().sum(1)[None]
              - 2.0 * x64 @ x64.T).clamp(min=0.0)
        e = float((out.double() - torch.exp(-sq / h)).abs().max())
        check(e <= 1e-5, f"se [1000,1000] over {n}: max err {e} vs float64")
        t_s = cuda_median_ms(lambda: gk.se_matrix(x, x, h, 1.0), reps=20)
        t_p = cuda_median_ms(lambda: gk.se_matrix_plain(x, x, h, 1.0),
                             reps=3)
        b_ms, b_by = bound_ms(3 * P5 * P5 * n, 4 * (2 * P5 * n + P5 * P5))
        line.append(f"over n={n}: kernel {t_s:.4f} ms plain {t_p:.4f} ms "
                    f"bound {b_ms:.5f} ({b_by}), max err vs plain {e_p:.3g}"
                    f", vs float64 {e:.3g}")
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
        log(f"[5 e2e {estimator}] {steps} steps, {rate:.2f} steps/s on "
            f"'{card}'; AUROC empirical {auc_e:.4f} mixture {auc_m:.4f}")
        if estimator == "score_rb":
            check(auc_e > 0.6, f"score_rb empirical AUROC {auc_e} <= 0.6")
    launches = dict(gk.LAUNCHES)
    for name in ("gumbel_graphs", "bge_pairs", "se_matrix"):
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
        st_cpu = state._replace(
            z=state.z.cpu(), theta=state.theta.cpu(),
            sf_baseline=state.sf_baseline.cpu())
        with torch.no_grad():
            got = phi_gpu(state, noise_dev)
            want = phi_cpu(st_cpu, noise)
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
    from dibs_tpu_torch.utils.tree import tree_leaves, tree_map

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
    to_cpu = lambda tree: tree_map(lambda a: a.cpu(), tree)  # noqa: E731
    for _ in range(20):
        eps = logistic(rng, (P, M, D, D))  # shared: soft and hard
        noise = (eps, eps, logistic(rng, (P, K_ACYC, D, D)))
        noise_dev = tuple(e.to(dev) for e in noise)
        st_cpu = state._replace(z=state.z.cpu(), theta=to_cpu(state.theta),
                                sf_baseline=state.sf_baseline.cpu())
        with torch.no_grad():
            got = phi_gpu(state, noise_dev)
            want_phi = phi_cpu(st_cpu, noise)
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


class plain_on_card:
    """Within the block, every kernel wrapper of the joint linear path is
    replaced by its plain version, so a phi built there runs the plain
    versions on the card (where the wrappers would launch the kernels)."""

    def __enter__(self):
        from dibs_tpu_torch import kernel
        from dibs_tpu_torch.inference import fused_linear as fl
        from dibs_tpu_torch.inference import transport
        from dibs_tpu_torch.ops import gpu_kernels as gk
        from dibs_tpu_torch.ops import soft_graphs
        from dibs_tpu_torch.ops import transport_kernel as tk

        self.saved = []
        for mod, name, plain in (
                (soft_graphs, "gumbel_graphs", gk.gumbel_graphs_plain),
                (kernel, "se_matrix", gk.se_matrix_plain),
                (transport, "transport_phi", tk.transport_phi_plain),
                (fl, "fused_linear_single", fl.fused_linear_single_plain),
                (fl, "fused_linear_pass1", fl.fused_linear_pass1_plain),
                (fl, "fused_linear_pass2", fl.fused_linear_pass2_plain)):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


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
        st_cpu = state._replace(z=state.z.cpu(), theta=state.theta.cpu(),
                                sf_baseline=state.sf_baseline.cpu())
        with torch.no_grad():
            got = phi_gpu(state, noise_dev)
            want_phi = phi_cpu(st_cpu, noise)
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
    per step and the three kernels with the most device time."""
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy=device_ms / wall_ms, launches=launches / n_steps,
                top=[(name[:40], ms / n_steps) for name, ms in top])


def phase_profile(dev, card):
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
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
    for name, dibs, p, k in (("marginal score", marginal, P, K_LAT),
                             ("joint", joint, P, K_LAT),
                             ("joint nonlinear", joint_nl, P, K_LAT),
                             ("joint config 5", joint5, P5, K5)):
        step = dibs._make_step(dibs._resolve_latent_std(k))
        prof = profile_steps(step, dibs.init_state(
            seed=3, n_particles=p, n_dim_particles=k))
        top = ", ".join(f"{k} {v:.4f} ms" for k, v in prof["top"])
        log(f"[7 profile {name}] on '{card}', 50 steps: wall "
            f"{prof['wall_ms']:.3f} ms/step, device kernels "
            f"{prof['device_ms']:.3f} ms/step, busy share "
            f"{prof['busy']:.3f}, kernel launches/step "
            f"{prof['launches']:.1f}; top: {top}")


def acyclic_grad_flops(p, d, k):
    """Float32 operations of kernel #9: the ``[d, d]`` products of the
    binary-exponentiation chain ``M^(d-1)`` (the first, I M, is a copy),
    2 d^3 each, per sample; the draw and the accumulation are O(d^2)."""
    n = d - 1
    products = max(n.bit_count() - 1, 0) + max(n.bit_length() - 1, 0)
    return 2 * d ** 3 * products * p * k


def phase_acyclic(dev, card, results):
    """Kernel #9 against its plain version (P=1000, d=128, K=8 and the
    ragged d = 13, 30, 137, 139; Philox and injected noise; scores below
    -88/alpha; each particle within ``1e-4 max(1, max|plain[p]|)``), its
    times beside the engine route's and the bound, then its entry point
    ``python -m dibs_tpu_torch.ops.acyclic_kernel`` at its defaults as the
    path it serves, with exact launch counts (counts set to 0 just before
    it). Returns that path's launch counts."""
    from dibs_tpu_torch.ops import acyclic_kernel as ak
    from dibs_tpu_torch.ops import gpu_kernels as gk

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
        torch.cuda.synchronize()
        want = gk.acyclic_grad_plain(scores, 7, alpha, k, eps=eps)
        check(bool(torch.isfinite(got).all()), f"#9 at {p, d, k}: not finite")
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
    b_ms, b_by = bound_ms(acyclic_grad_flops(p, d, k), 2 * 4 * p * d * d)
    results["acyclic_grad"] = dict(max_abs_err=err_main, ms=t_k, plain_ms=t_p,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=t_e)
    log(f"[8 acyclic_grad #9] kernel vs plain at (P,d,K) in "
        f"{[(P9, D9, K9)] + SHAPES9}, Philox and injected noise, scores below "
        f"-88/alpha: finite, within 1e-4 max(1, max|plain[p]|) per "
        f"particle p, worst "
        f"{worst:.4f} of the bar; at P={p} d={d} K={k} on "
        f"'{card}': kernel {t_k:.4f} ms, plain {t_p:.4f} ms, engine route "
        f"{t_e:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

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
                  transport_phi=steps)),
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    import dibs_tpu_torch  # noqa: F401  (fails here, before any output,
    #                         when the script runs outside the repository)

    dev = torch.device("cuda:0")
    card = phase_env()
    phase_build()
    results = {}
    phase_kernels(dev, results)
    phase_fused(dev, results)
    phase_fused_nonlinear(dev, results)
    phase_rng(dev)
    launches = phase_e2e(dev, card, STEPS)
    # each path's counts are set to 0 just before it runs: the joint
    # path's launches are added to the marginal path's
    for name, count in phase_joint(dev, card, STEPS).items():
        launches[name] += count
    for name, count in phase_joint_nonlinear(dev, card, STEPS_NL).items():
        launches[name] += count
    phase_transport(dev, results)
    phase_config5_kernels(dev, results)
    for name, count in phase_config5(dev, card, STEPS5).items():
        launches[name] += count
    phase_profile(dev, card)
    for name, count in phase_acyclic(dev, card, results).items():
        launches[name] += count
    for name, count in phase_spectral_checkpoint(dev, card, 100).items():
        launches[name] += count
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
        "acyclic_grad": ("dibs_tpu_torch/csrc/acyclic_grad.cu",
                         "benchmarks/bench_acyclic_kernel.py:84"),
    }
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
