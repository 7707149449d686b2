"""Hardware cost accounting: per-step FLOPs/bytes models, rooflines and
per-kernel work counts for the card (counterpart of
``dibs_tpu/accounting.py``).

This module provides

* the reference's *analytic* per-SVGD-step cost model of each engine
  configuration (:func:`bge_step_cost`, :func:`linear_step_cost`,
  :func:`nonlinear_step_cost`), carried over with the same arithmetic in
  the same order, so its numbers equal ``dibs_tpu``'s. They count the
  algorithm as the reference implements it; where the port does other work
  their docstrings say so;
* the count of FLOPs PyTorch's own counter reports for a call
  (:func:`torch_cost_analysis`), to cross-check an analytic count;
* a roofline verdict against the card's peaks (:func:`roofline`,
  :func:`phase_roofline`), the ring / all-gather traffic models and the
  multi-card projection;
* the work of each of the port's CUDA kernels at a shape
  (:func:`kernel_cost`) and the least time the card could take for it
  (:func:`bound_ms`).

Peaks are NVIDIA's data-sheet figures for one H100 SXM5 80 GB at its 700 W
limit (dense rates, no sparsity); a card set below 700 W runs slower under
load, so state a share beside the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

__all__ = ["CHIP_PEAKS", "StepCost", "bge_step_cost", "linear_step_cost",
           "nonlinear_step_cost", "roofline", "torch_cost_analysis",
           "ring_comm_model", "allgather_comm_model", "multichip_projection",
           "phase_roofline", "PHASE_CEILINGS", "kernel_cost", "bound_ms"]

CHIP_PEAKS = {
    # NVIDIA H100 SXM5 80 GB, 700 W (NVIDIA H100 Tensor Core GPU data sheet)
    "h100_sxm": {
        # FP32 on the CUDA cores (FFMA): the rate every engine path runs at,
        # since inference/svgd.py::_check_precision refuses TF32
        "fp32_tflops": 67.0,
        # BF16 tensor cores, dense (the data sheet's sparse figure halved):
        # read only by roofline(fp32=False); no engine path runs BF16
        "bf16_tflops": 989.4,
        "hbm_gbps": 3350.0,
        # NVLink 4 through NVSwitch: 900 GB/s bidirectional per GPU, so 450
        # GB/s each way; a ring hop rides one direction
        "link_gbps_dir": 450.0,
        # transcendentals (MUFU): 16 results a clock per SM (CUDA C
        # Programming Guide, arithmetic-instruction throughput, compute
        # capability 9.0) x 132 SMs x 1.98 GHz boost clock
        "sfu_gops": 16 * 132 * 1.98,
    },
    # CPU reference host (rough: 1 core AVX-512 @ ~2 GHz), as dibs_tpu has
    # it, so that tests can give both packages the same peaks
    "cpu_1core": {"bf16_tflops": 0.064, "fp32_tflops": 0.128,
                  "hbm_gbps": 20.0},
}


@dataclasses.dataclass
class StepCost:
    """Analytic per-step cost, split by phase.

    ``flops``: multiply-accumulate-style floating ops, counting one FMA as
    2. ``bytes_min``: the *compulsory* device-memory traffic of the
    algorithm as the reference implements it — each major intermediate
    tensor counted once written + once read (fused consumers counted as
    zero). ``transcendentals``: exp/log/sigmoid/gammaln evaluations.
    """

    flops: float
    bytes_min: float
    transcendentals: float
    phases: Dict[str, float]

    def total_row(self, seconds: float,
                  chip: str = "h100_sxm") -> Dict[str, Any]:
        return roofline(self.flops, self.bytes_min, self.transcendentals,
                        seconds, chip)


def _sampling_cost(p, m, d):
    """Gumbel graph sampling: per sample-entry ~1 PRNG draw + log/sigmoid.
    In-kernel noise: traffic = output only."""
    n = p * m * d * d
    return dict(flops=6.0 * n, bytes=4.0 * n, transc=2.0 * n)


def _kernel_transport_cost(p, d, k, theta_dim=0):
    """[P, P] SE kernel + transport matmuls (Gram formulation)."""
    feat = d * k * 2 + theta_dim
    flops = 2.0 * p * p * feat * 3  # gram + two transport matmuls
    bytes_ = 4.0 * (2 * p * feat + 3 * p * p)
    return dict(flops=flops, bytes=bytes_, transc=p * p)


def _acyclicity_cost(p, kmc, d):
    """E[grad h(G)] via soft samples + log-depth power chain (forward +
    closed-form VJP: ~(log2 d + 2) batched [d, d] matmuls per sample).

    The port's chain (``ops/acyclic.py``) takes ``M^(d-1)`` by binary
    exponentiation: 12 products at d = 128 (13 with its first, identity
    product) against the 9 counted here."""
    n_mm = math.ceil(math.log2(max(d, 2))) + 2
    flops = p * kmc * (2.0 * d * d * d * n_mm)
    bytes_ = 4.0 * p * kmc * d * d * (n_mm + 2)
    samp = _sampling_cost(p, kmc, d)
    return dict(flops=flops + samp["flops"], bytes=bytes_ + samp["bytes"],
                transc=samp["transc"])


def bge_step_cost(*, d, n_obs, p, m, kmc=32, k=None) -> StepCost:
    """MarginalDiBS + BGe with the ``score`` estimator (config 1).

    Hot op: per (particle, MC sample, node) one bordered-GE determinant
    pair over the parent-masked ``[d, d]`` posterior matrix: ~d^3 FLOPs, d
    logs. Sufficient statistics are shared across the whole batch.

    The reference's count: a full ``d^3`` elimination per (graph, node).
    The port's kernel #2 eliminates over the parents only
    (``2 (k^3/3 + k^2)`` for k parents, :func:`kernel_cost`), so at d = 128
    this term exceeds what the card does, and a share of a step read from
    it can pass 1.

    The REINFORCE direction keeps the reference's count too: per-sample
    products, ``4 p m d^2 k`` FLOPs. The port's ``score`` estimator sums
    the graphs first (kernel #10, :func:`kernel_cost` ``"score_ratio"``)
    and makes two ``[P, d, d] @ [P, d, k]`` products, ``m / 2`` times less
    work at ``k = d``, so this term too counts more than the card does.
    """
    k = k or d
    b = p * m * d  # determinant pairs per step
    phases = {}
    # masked-matrix build (d^2 per pair) + elimination sweep (~d^3/2 FMA)
    phases["bge_eliminations"] = b * (d * d * 2.0 + d * d * d)
    elim_transc = b * (d + 1.0)  # log per pivot + schur log
    # gamma/score assembly per node
    phases["bge_gamma_terms"] = 10.0 * p * m * d
    gamma_transc = 3.0 * p * m * d
    samp = _sampling_cost(p, m, d)
    phases["sampling"] = samp["flops"]
    # REINFORCE direction: closed-form batch matmuls (ops/edges.py)
    phases["reinforce_dir"] = 2.0 * p * m * d * d * k * 2
    acy = _acyclicity_cost(p, kmc, d)
    phases["acyclicity_prior"] = acy["flops"]
    ker = _kernel_transport_cost(p, d, k)
    phases["kernel_transport"] = ker["flops"]

    # compulsory traffic: masks in (the pairs kernel reads [B, d] masks,
    # writes 2 scalars) + sampler output + reinforce grads + prior
    bytes_min = (
        4.0 * (b * d + 2 * b)          # det kernel in/out
        + samp["bytes"]                 # graph samples materialized
        + 4.0 * p * m * d * d           # reinforce per-sample reads
        + acy["bytes"] + ker["bytes"]
        + 4.0 * 3 * p * d * k * 2       # z, grads, update
    )
    return StepCost(
        flops=sum(phases.values()),
        bytes_min=bytes_min,
        transcendentals=elim_transc + gamma_transc + samp["transc"]
        + acy["transc"],
        phases=phases,
    )


def linear_step_cost(*, d, n_obs, p, m, kmc=32, k=None) -> StepCost:
    """JointDiBS + LinearGaussian, fused reparam path (configs 2/4/5).

    Fused kernel (ONE pass, online softmax): per (particle, sample) one
    delta matmul ``[N, d] @ [d, d]`` forward and its two backward matmuls,
    sampled once.

    The reference's count charges the per-particle reference matmul of the
    centred scoring 6 passes (its TPU kernel's HIGHEST precision); the
    port's kernels compute it once in float32.
    """
    k = k or d
    phases = {}
    fwd = 2.0 * n_obs * d * d  # means matmul per (p, m)
    # centered scoring: + one reference matmul per particle per pass at
    # HIGHEST precision (6 MXU passes), amortized over the M samples
    ref = 2.0 * 6.0 * fwd
    phases["fused_forward"] = p * (m * (fwd + 4.0 * n_obs * d) + ref)
    phases["fused_backward"] = p * m * (2.0 * fwd + 6.0 * d * d)
    samp = _sampling_cost(p, m, d)
    phases["sampling_in_kernel"] = samp["flops"]
    acy = _acyclicity_cost(p, kmc, d)
    phases["acyclicity_prior"] = acy["flops"]
    ker = _kernel_transport_cost(p, d, k, theta_dim=d * d)
    phases["kernel_transport"] = ker["flops"]

    # fused path: graphs/noise/masked-weights never in HBM; traffic is
    # x (read per tile), dZ/dTheta outputs, prior + transport tensors
    bytes_min = (
        4.0 * (p * m / 8.0) * n_obs * d     # x tile re-reads (8-sample groups)
        + 4.0 * 2 * p * d * d               # dscores + dtheta out
        + acy["bytes"] + ker["bytes"]
        + 4.0 * 3 * p * d * k * 2
    )
    return StepCost(
        flops=sum(phases.values()),
        bytes_min=bytes_min,
        transcendentals=samp["transc"] + acy["transc"] + p * m * n_obs,
        phases=phases,
    )


def nonlinear_step_cost(*, d, n_obs, p, m, hidden=(5,), kmc=32,
                        k=None, shared_sampling=True,
                        fused_kernel=False) -> StepCost:
    """JointDiBS + DenseNonlinearGaussian (config 3).

    ``fused_kernel=False``: the shared-sample autodiff estimators (one soft
    forward + Z-vjp, one hard forward + Theta-vjp). ``fused_kernel=True``:
    the single-pass online-softmax kernel: per sample group, one ``[N, dp]
    @ [dp, bm*dp]`` matmul per hidden unit per stream forward plus one
    backward (``4 h1`` total), at the reference kernel's sublane-padded
    ``dp``; graphs/noise/activations never reach HBM. (The port's #8
    counts its own work without that padding: :func:`kernel_cost`.)
    """
    k = k or d
    dims = (d, *hidden, 1)
    h1 = hidden[0]
    phases = {}
    samp = _sampling_cost(p, m if shared_sampling else 2 * m, d)
    acy = _acyclicity_cost(p, kmc, d)
    theta_dim = sum(dims[i] * dims[i + 1] * d + dims[i + 1] * d
                    for i in range(len(dims) - 1))
    ker = _kernel_transport_cost(p, d, k, theta_dim=theta_dim)

    if fused_kernel:
        dp = ((max(d, 2) + 7) // 8) * 8
        n_pad = ((max(n_obs, 8) + 7) // 8) * 8
        # 4*h1 wide matmuls (soft/hard x fwd/bwd) over the padded shapes +
        # masking/epilogue elementwise
        mm = 4.0 * h1 * 2.0 * n_pad * dp * dp  # per sample
        # centered scoring: + h1 reference matmuls per particle at HIGHEST
        # (6 MXU passes), amortized over the M samples
        ref = 6.0 * h1 * 2.0 * n_pad * dp * dp
        phases["fused_single_pass"] = p * (m * (mm + 10.0 * dp * dp * h1)
                                           + ref)
        phases["in_kernel_sampling"] = samp["flops"]
        bytes_core = 4.0 * (
            p * (dp * dp * (2 + h1) + 3 * h1 * dp)  # params in, grads out
            + (p * m / 16.0) * n_pad * dp            # x tile re-reads
        )
        transc_core = samp["transc"] + 2.0 * p * m * dp
    else:
        fwd = 0.0
        for i in range(len(dims) - 1):
            fwd += 2.0 * n_obs * dims[i] * dims[i + 1] * d
        fwd += d * d * hidden[0]
        phases["soft_forward_plus_zvjp"] = p * m * fwd * 3.0
        phases["hard_forward_plus_tvjp"] = p * m * fwd * 2.5
        phases["sampling"] = samp["flops"]
        bytes_core = (
            samp["bytes"]
            + 4.0 * p * m * d * d * h1 * 2   # masked first-layer weights
            + 4.0 * p * m * d * h1 * n_obs * 2  # layer-1 activations
        )
        transc_core = samp["transc"] + 2.0 * p * m * n_obs * d

    phases["acyclicity_prior"] = acy["flops"]
    phases["kernel_transport"] = ker["flops"]
    bytes_min = (bytes_core + acy["bytes"] + ker["bytes"]
                 + 4.0 * 3 * (p * d * k * 2 + p * theta_dim))
    return StepCost(
        flops=sum(phases.values()),
        bytes_min=bytes_min,
        transcendentals=transc_core + acy["transc"],
        phases=phases,
    )


def roofline(flops, bytes_, transc, seconds, chip="h100_sxm",
             fp32=True) -> Dict[str, Any]:
    """Achieved rates vs chip peaks + which ceiling binds.

    ``mfu`` uses the float32 peak by default (the engine refuses TF32, so
    every product runs as IEEE float32); ``fp32=False`` (the BF16 peak) is
    kept for the reference's signature. The transcendental share is taken
    against the chip's ``sfu_gops`` where it has one, else NaN.
    """
    peaks = CHIP_PEAKS[chip]
    peak_t = peaks["fp32_tflops"] if fp32 else peaks["bf16_tflops"]
    tflops = flops / seconds / 1e12
    gbps = bytes_ / seconds / 1e9
    transc_rate = transc / seconds / 1e9
    mfu = tflops / peak_t
    mem_frac = gbps / peaks["hbm_gbps"]
    transc_frac = (transc_rate / peaks["sfu_gops"] if "sfu_gops" in peaks
                   else float("nan"))
    fracs = {"compute": mfu, "hbm": mem_frac, "transcendental": transc_frac}
    bound = max(fracs,
                key=lambda kk: fracs[kk] if fracs[kk] == fracs[kk] else -1)
    if fracs[bound] == fracs[bound] and fracs[bound] < 0.15:
        # no classical ceiling explains the time: dominated by serialized
        # vector-op chains / kernel-launch & dispatch latency
        bound = "none (op/latency-bound)"
    return {
        "seconds_per_step": seconds,
        "tflops_achieved": round(tflops, 4),
        "hbm_gbps_achieved": round(gbps, 2),
        "transc_gops": round(transc_rate, 3),
        "mfu_pct": round(100 * mfu, 2),
        "hbm_pct": round(100 * mem_frac, 2),
        "transc_pct": round(100 * transc_frac, 2)
        if transc_frac == transc_frac else None,
        "binding_ceiling": bound,
        "headroom_x": round(1.0 / max(fracs.values()), 1)
        if max(fracs.values()) > 0 else None,
    }


def PHASE_CEILINGS(d: int, chip: str = "h100_sxm") -> Dict[str, float]:
    """TFLOP/s ceilings of the step-model phases that do not run at the
    float32 FFMA peak, which :func:`phase_roofline` gives every other phase
    (the fused kernels, BGe, the acyclicity chain on cuBLAS in IEEE float32,
    the transport). Sampling's 6 operations an element
    (:func:`_sampling_cost`) are no FMAs and come with 2 transcendentals:
    the lower of the ALU's rate (half the FFMA peak) and 3 operations per
    SFU result. ``d`` is kept for the reference's signature (its MXU row
    scaling); no ceiling on the card depends on it."""
    peaks = CHIP_PEAKS[chip]
    sampling = peaks["fp32_tflops"] / 2.0
    if "sfu_gops" in peaks:
        sampling = min(sampling, 3.0 * peaks["sfu_gops"] / 1e3)
    return dict.fromkeys(("sampling", "sampling_in_kernel",
                          "in_kernel_sampling"), sampling)


def phase_roofline(cost: "StepCost", measured_ms: Dict[str, float],
                   d: int, chip: str = "h100_sxm"):
    """Per-phase achieved TF/s vs that phase's ceiling.

    ``measured_ms`` maps a measured-time label to (milliseconds, tuple of
    model phase names it covers). Returns a list of row dicts
    (label, ms, gflop, achieved TF/s, ceiling TF/s, pct, gap x).
    """
    ceils = PHASE_CEILINGS(d, chip)
    rows = []
    for label, (ms, phase_names) in measured_ms.items():
        gflop = sum(cost.phases.get(p, 0.0) for p in phase_names) / 1e9
        # FLOP-weighted harmonic ceiling: the minimum time the covered
        # phases could take if each ran at its own ceiling
        t_floor_ms = sum(
            (cost.phases.get(p, 0.0) / 1e9)
            / ceils.get(p, CHIP_PEAKS[chip]["fp32_tflops"])
            for p in phase_names
        )
        ceil = gflop / max(t_floor_ms, 1e-12)
        ach = gflop / max(ms, 1e-9)  # GFLOP / ms == TF/s
        rows.append({
            "phase": label, "ms": round(ms, 3), "gflop": round(gflop, 2),
            "achieved_tfs": round(ach, 2), "ceiling_tfs": round(ceil, 1),
            "pct_of_ceiling": round(100.0 * ach / ceil, 1),
            "gap_x": round(ceil / max(ach, 1e-9), 2),
        })
    return rows


# --------------------------------------------------------------------------
# Multi-card performance model
#
# The only cross-particle coupling in SVGD is the [P, P] kernel/transport;
# everything else is embarrassingly parallel over particles, so the model
# has three terms per card:
#
#   t(N) = t_fixed  +  t_particle_work / N  +  exposed_comm(N)
#
# * ``t_fixed``: per-step time that does not shrink with fewer local
#   particles (launches, the fixed population of small ops).
# * particle work: every estimator phase AND the transport tile compute
#   (each device computes [P/N, P/N] tiles x N ring rounds = P^2/N pairs).
# * comm: the ring rotates the flattened (v, grad) blocks — per device per
#   step, (N-1) rounds x block bytes, each overlapped with the next tile's
#   compute, so the *exposed* comm is max(0, round_comm -
#   round_tile_compute) per round. The all-gather path transfers (N-1)/N *
#   P * n bytes instead. No multi-card latency has been measured for the
#   port, so the per-round latency is the caller's.
# --------------------------------------------------------------------------


def ring_comm_model(*, p, n_dev, z_dim, theta_dim=0, dtype_bytes=4.0
                    ) -> Dict[str, float]:
    """Per-device link traffic of the ring transport for one SVGD step.

    The rotating payload per device is the flattened local ``(v, grad)``
    block pair: ``2 * (P/N) * (z_dim + theta_dim)`` floats (marginal
    engines have ``theta_dim=0``; the joint ring rotates z/dz plus the
    flattened theta/dtheta — ``dibs_tpu_torch/parallel/ring.py``).
    """
    blk = 2.0 * (p / n_dev) * (z_dim + theta_dim) * dtype_bytes
    rounds = max(n_dev - 1, 0)
    return {
        "block_bytes": blk,
        "rounds": rounds,
        "bytes_per_device": rounds * blk,
        "bytes_total": rounds * blk * n_dev,
    }


def allgather_comm_model(*, p, n_dev, z_dim, theta_dim=0, dtype_bytes=4.0
                         ) -> Dict[str, float]:
    """Per-device link traffic of the all-gather transport path (used when
    the kernel needs the global distance matrix, e.g. median-heuristic
    bandwidths): each device receives every other shard of (v, grad)."""
    recv = 2.0 * (n_dev - 1) / max(n_dev, 1) * p * (z_dim + theta_dim) \
        * dtype_bytes
    return {"bytes_per_device": recv, "bytes_total": recv * n_dev}


def multichip_projection(*, seconds_1chip, p, n_dev, z_dim, theta_dim=0,
                         transport_frac, round_latency_s, t_fixed=0.0,
                         weak=False, chip="h100_sxm", link_gbps=None,
                         payload_dtype_bytes=4.0) -> Dict[str, Any]:
    """Projected per-step time and scaling efficiency at ``n_dev`` cards.

    Args:
        seconds_1chip: measured single-card step time at particle count
            ``p``.
        transport_frac: fraction of the *scalable* single-card step spent
            in the [P, P] kernel/transport (from the phase model, or
            measured).
        round_latency_s: one ring round's launch + hop latency, which cannot
            overlap with compute (required: no multi-card latency has been
            measured for the port).
        t_fixed: non-scaling per-step seconds.
        weak: if True, the projection holds the per-card particle count at
            ``p`` (global particles = p * n_dev) instead of splitting
            ``p`` across cards.
        link_gbps: one-way link bandwidth in GB/s; the chip's
            ``link_gbps_dir`` if None.
        payload_dtype_bytes: wire bytes per element of the rotating
            blocks — 4.0 (f32, default) or 2.0 (the bf16 payload,
            :func:`dibs_tpu_torch.config.set_ring_payload_dtype`). Sub-f32
            payloads add a modeled quantize/upcast cost: two memory passes
            over the f32-sized block per round, charged to compute.

    Returns a dict with the per-term breakdown, the overlapped and
    non-overlapped step-time projections, and the efficiency (vs perfect
    linear scaling for strong, vs constant step time for weak).
    """
    peaks = CHIP_PEAKS[chip]
    bw = (link_gbps if link_gbps is not None
          else peaks["link_gbps_dir"]) * 1e9
    t_work = max(seconds_1chip - t_fixed, 0.0)
    t_tr1 = transport_frac * t_work        # single-card transport compute
    t_other1 = t_work - t_tr1              # everything else (particle-par)

    if n_dev == 1:
        t_step = t_fixed + t_work
        return {"n_dev": 1, "t_step": t_step, "t_step_no_overlap": t_step,
                "t_fixed": t_fixed, "t_other": t_other1, "t_transport": t_tr1,
                "t_comm_exposed": 0.0, "comm_bytes_per_device": 0.0,
                "efficiency": 1.0}

    if weak:
        # per-card: other work constant; transport work grows ~linearly
        # (P_total^2 / N = N * p^2 pair-work per device); rotating block
        # stays p * n floats.
        t_other = t_other1
        t_tr = n_dev * t_tr1
        comm = ring_comm_model(p=p * n_dev, n_dev=n_dev, z_dim=z_dim,
                               theta_dim=theta_dim,
                               dtype_bytes=payload_dtype_bytes)
    else:
        t_other = t_other1 / n_dev
        t_tr = t_tr1 / n_dev
        comm = ring_comm_model(p=p, n_dev=n_dev, z_dim=z_dim,
                               theta_dim=theta_dim,
                               dtype_bytes=payload_dtype_bytes)

    rounds = comm["rounds"]
    per_round_comm = comm["block_bytes"] / bw
    per_round_tile = t_tr / max(n_dev, 1)  # N tile steps per ring pass
    exposed = rounds * (max(0.0, per_round_comm - per_round_tile)
                        + round_latency_s)
    t_comm_full = rounds * (per_round_comm + round_latency_s)

    # quantize/upcast passes for sub-f32 payloads (see docstring)
    t_conv = 0.0
    if payload_dtype_bytes < 4.0:
        blk_f32 = comm["block_bytes"] * 4.0 / payload_dtype_bytes
        t_conv = rounds * 2.0 * blk_f32 / (peaks["hbm_gbps"] * 1e9)

    t_step = t_fixed + t_other + t_tr + t_conv + exposed
    t_step_no_overlap = t_fixed + t_other + t_tr + t_conv + t_comm_full
    if weak:
        eff = (t_fixed + t_work) / t_step  # ideal: constant step time
    else:
        eff = (t_fixed + t_work) / (n_dev * t_step)
    return {
        "n_dev": n_dev,
        "t_step": t_step,
        "t_step_no_overlap": t_step_no_overlap,
        "t_fixed": t_fixed,
        "t_other": t_other,
        "t_transport": t_tr,
        "t_comm_exposed": exposed,
        "t_comm_full": t_comm_full,
        "t_conv": t_conv,
        "comm_bytes_per_device": comm["bytes_per_device"],
        "efficiency": eff,
    }


def torch_cost_analysis(fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """FLOPs of ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matmuls,
    convolutions, attention; not elementwise work), with the keys of the
    reference's ``xla_cost_analysis``. ``bytes_accessed`` and
    ``transcendentals`` are NaN: torch counts neither. Runs ``fn`` once;
    returns None where it or the count fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    except (RuntimeError, TypeError, ValueError, NotImplementedError):
        return None
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float("nan"),
            "transcendentals": float("nan")}


# --------------------------------------------------------------------------
# Per-kernel work: the float32 operations each CUDA kernel's arithmetic
# needs at a shape, and the bytes of its inputs read once and its outputs
# written once (float32, 4 bytes). The same work whatever implements it:
# the plain PyTorch twin and a library call are held to the same bound.
# --------------------------------------------------------------------------


def _gumbel_graphs(*, p, m, d):
    """#1: ~3 operations an element; the scores read once, the ``[P, M, d,
    d]`` graphs written once."""
    return 3 * p * m * d * d, 4 * (p * d * d + p * m * d * d)


def _bge_pairs(*, gs, datasets=1):
    """#2 on the masks ``gs [B, d, d]``: a k^3/3 elimination and its k^2
    border per (graph, node) with k parents, ``2 (k^3/3 + k^2)``, over the
    masks' actual parent counts; bytes: each dataset's ``R [d, d, d]``, the
    masks and the two outputs, each once."""
    b, d, _ = gs.shape
    k = gs.sum(1).double()
    return (float((2 * (k ** 3 / 3 + k ** 2)).sum()),
            4 * (datasets * d ** 3 + b * (d * d + 2 * d)))


def _se_matrix(*, a, n, b=None, batch=1, triangle=False):
    """#3, ``[a, b]`` SE matrices over n features, ``batch`` of them: ~3
    operations a (pair, feature). ``b=None`` is the symmetric call (``y is
    x``: x read once, ``[a, a]`` written); ``triangle`` counts one triangle
    with its diagonal, the symmetric call's least work."""
    if b is None:
        pairs = a * (a + 1) // 2 if triangle else a * a
        return 3 * batch * pairs * n, 4 * batch * (a * n + a * a)
    return 3 * batch * a * b * n, 4 * batch * (a * n + b * n + a * b)


def _transport_phi(*, p, n, n_mats=1, batch=1):
    """#4: ``2 P^2 n`` per kernel matrix (the joint form has two); bytes:
    g, v and phi ``[P, n]``, the matrices, mu ``[n]`` and the row sums."""
    return (2 * batch * n_mats * p * p * n,
            4 * batch * (3 * p * n + n_mats * p * p + n + p))


def _fused_linear(kind, *, p, m, n, d, datasets=1, replayed=None):
    """#5-#7, from their arithmetic: per sample and branch ``2 N d^2`` for
    ``delta``, ``4 N d`` for the log-likelihood terms, ``2 N d`` for the
    residuals and ``2 N d^2`` for ``x^T resid``; plus ``2 N d^2`` per
    particle for ``resid_ref``. Pass 2 replays only ``replayed`` (particle,
    sample) pairs (those with a non-zero weight; all ``P M`` by default).
    Bytes: scores and Theta, each dataset's data and observation weights
    in; pass 1's two ``[P, M]`` log-likelihoods out, pass 2's two ``[P,
    M]`` weights in, the two ``[P, d, d]`` gradients out."""
    if kind == "pass2":
        replayed = p * m if replayed is None else replayed
        flops = (2 * replayed * (4 * n * d * d + 2 * n * d)
                 + 2 * p * n * d * d)
    else:
        per = {"single": 4 * n * d * d + 6 * n * d,
               "pass1": 2 * n * d * d + 4 * n * d}[kind]
        flops = 2 * p * m * per + 2 * p * n * d * d
    n_bytes = 4 * (2 * p * d * d + 2 * datasets * n * d)
    if kind != "single":
        n_bytes += 4 * 2 * p * m
    if kind != "pass1":
        n_bytes += 4 * 2 * p * d * d
    return flops, n_bytes


def _fused_nonlinear(*, p, m, n, d, h1, datasets=1):
    """#8, from its arithmetic: per sample and stream ``2 h1 N d^2`` for
    the first-layer deltas and ``2 h1 N d^2`` for ``x^T u_h``; plus ``2 h1
    N d^2`` per particle for the reference forward (the ``O(h1 N d)``
    elementwise work is not counted). Bytes: the kernel-layout inputs
    (scores, W1, its log-prior, b1, W2 || b2, each dataset's data and
    observation weights) read once, ``dscores``, ``dW1`` and the ``2 h1 +
    1`` small rows written once."""
    flops = 2 * p * m * 4 * h1 * n * d * d + p * 2 * h1 * n * d * d
    inputs = p * ((h1 + 2) * d * d + (2 * h1 + 1) * d) + 2 * datasets * n * d
    outputs = p * ((h1 + 1) * d * d + (2 * h1 + 1) * d)
    return flops, 4 * (inputs + outputs)


def _acyclic_grad(*, p, d, k):
    """#9: the ``[d, d]`` products of the binary-exponentiation chain
    ``M^(d-1)`` (the first, I M, is a copy), 2 d^3 each, per sample; the
    draw and the accumulation are O(d^2). Bytes: the scores in, the
    gradient out."""
    n = d - 1
    products = max(n.bit_count() - 1, 0) + max(n.bit_length() - 1, 0)
    return 2 * d ** 3 * products * p * k, 2 * 4 * p * d * d


def _score_ratio(*, p, m, d):
    """#10: a multiply-add a graph element for ``sum_m w_m G_m``. Bytes:
    the graphs ``[P, M, d, d]`` and the weights ``[P, M]`` in, the edge
    probabilities in and ``R`` out (``[P, d, d]`` each)."""
    return 2 * p * m * d * d, 4 * (p * m * d * d + p * m + 2 * p * d * d)


_KERNEL_COSTS = {
    "gumbel_graphs": _gumbel_graphs,
    "bge_pairs": _bge_pairs,
    "se_matrix": _se_matrix,
    "transport_phi": _transport_phi,
    "fused_linear_single": lambda **s: _fused_linear("single", **s),
    "fused_linear_pass1": lambda **s: _fused_linear("pass1", **s),
    "fused_linear_pass2": lambda **s: _fused_linear("pass2", **s),
    "fused_linear_wide_pass1": lambda **s: _fused_linear("pass1", **s),
    "fused_linear_wide_pass2": lambda **s: _fused_linear("pass2", **s),
    "fused_nonlinear": _fused_nonlinear,
    "acyclic_grad": _acyclic_grad,
    "score_ratio": _score_ratio,
}


def kernel_cost(kernel: str, **shape) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call of the CUDA kernel ``kernel`` (a name
    of ``dibs_tpu_torch.ops.gpu_kernels.LAUNCHES``) at ``shape``:

    * ``gumbel_graphs``: ``p, m, d``;
    * ``bge_pairs``: ``gs`` (the ``[B, d, d]`` masks), ``datasets=1``;
    * ``se_matrix``: ``a, n, b=None, batch=1, triangle=False``;
    * ``transport_phi``: ``p, n, n_mats=1, batch=1``;
    * ``fused_linear_*``: ``p, m, n, d, datasets=1`` (pass 2 also
      ``replayed``);
    * ``fused_nonlinear``: ``p, m, n, d, h1, datasets=1``;
    * ``acyclic_grad``: ``p, d, k``;
    * ``score_ratio``: ``p, m, d``.

    With a dataset axis ``p`` counts the particles of all datasets.
    """
    if kernel not in _KERNEL_COSTS:
        raise KeyError(f"unknown kernel {kernel!r}; choose from "
                       f"{sorted(_KERNEL_COSTS)}")
    return _KERNEL_COSTS[kernel](**shape)


def bound_ms(flops, n_bytes, chip="h100_sxm") -> Tuple[float, str]:
    """The least time ``chip`` could take for the work: the larger of
    ``flops`` at its float32 peak and ``n_bytes`` at its memory rate.
    Returns ``(ms, "operations" | "bytes")``."""
    peaks = CHIP_PEAKS[chip]
    t_ops = flops / (peaks["fp32_tflops"] * 1e12)
    t_bytes = n_bytes / (peaks["hbm_gbps"] * 1e9)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
