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
   interventional d=30, N=600;
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
7. profile: ``torch.profiler`` over 50 steady steps of the marginal
   (``score``) and the joint step: wall and device time per step, the
   device's busy share, kernel launches per step, the top kernels.

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
    for name, dibs in (("marginal score", marginal), ("joint", joint)):
        step = dibs._make_step(dibs._resolve_latent_std(K_LAT))
        prof = profile_steps(step, dibs.init_state(
            seed=3, n_particles=P, n_dim_particles=K_LAT))
        top = ", ".join(f"{k} {v:.4f} ms" for k, v in prof["top"])
        log(f"[7 profile {name}] on '{card}', 50 steps: wall "
            f"{prof['wall_ms']:.3f} ms/step, device kernels "
            f"{prof['device_ms']:.3f} ms/step, busy share "
            f"{prof['busy']:.3f}, kernel launches/step "
            f"{prof['launches']:.1f}; top: {top}")


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
    phase_rng(dev)
    launches = phase_e2e(dev, card, STEPS)
    # each path's counts are set to 0 just before it runs: the joint
    # path's launches are added to the marginal path's
    for name, count in phase_joint(dev, card, STEPS).items():
        launches[name] += count
    phase_profile(dev, card)
    fused = "dibs_tpu/inference/fused_linear.py"
    sources = {
        "gumbel_graphs": ("dibs_tpu_torch/csrc/gumbel.cu",
                          "dibs_tpu/ops/pallas_kernels.py:197"),
        "bge_pairs": ("dibs_tpu_torch/csrc/bge_pairs.cu",
                      "dibs_tpu/ops/bge_kernel.py:223"),
        "se_matrix": ("dibs_tpu_torch/csrc/se_matrix.cu",
                      "dibs_tpu/ops/pallas_kernels.py:237"),
        "fused_linear_single": ("dibs_tpu_torch/csrc/fused_linear.cu",
                                f"{fused}:708"),
        "fused_linear_pass1": ("dibs_tpu_torch/csrc/fused_linear.cu",
                               f"{fused}:617"),
        "fused_linear_pass2": ("dibs_tpu_torch/csrc/fused_linear.cu",
                               f"{fused}:658"),
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
