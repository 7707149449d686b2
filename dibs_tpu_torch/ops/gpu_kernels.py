"""Hand-written Hopper kernels of the SVGD hot path (and the fused
acyclicity gradient #9, which only its microbenchmark calls), their build,
and their plain PyTorch twins.

Counterpart of ``dibs_tpu/ops/pallas_kernels.py``. The CUDA sources live in
``dibs_tpu_torch/csrc``; :func:`build` compiles all of them with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, keyed by a
hash of the sources, under ``dibs_tpu_torch/_build/``, and loads it with
``ctypes``. Nothing is compiled or imported from CUDA when this module is
imported.

Dispatch rule, for every kernel here, in :mod:`dibs_tpu_torch.ops.
bge_kernel`, :mod:`dibs_tpu_torch.ops.transport_kernel`,
:mod:`dibs_tpu_torch.inference.fused_linear` and
:mod:`dibs_tpu_torch.inference.fused_nonlinear`, decided by the one
predicate :func:`use_kernel`: a CPU tensor goes to the plain twin; a CUDA
tensor goes to the kernel, and a build or launch failure raises, unless
the kill switch (:func:`dibs_tpu_torch.config.set_pallas_enabled`,
``DIBS_DISABLE_PALLAS``) was turned off on request, which sends it to the
plain twin on the card. ``LAUNCHES`` counts the wrapper calls
that launched each kernel (twins never count; a call that launches more
than one kernel, as a split ``se_matrix`` call with its reduction, counts
once), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from dibs_tpu_torch.config import pallas_override
from dibs_tpu_torch.utils.func import zero_diagonal

__all__ = [
    "ACYCLIC_GRAD_MAX_D",
    "AcyclicGradPlan",
    "BGE_WARP_MAX_K",
    "BgePairsPlan",
    "LAUNCHES",
    "acyclic_grad",
    "acyclic_grad_plain",
    "acyclic_grad_plan",
    "bge_pairs_plan",
    "bge_route_plans",
    "GumbelPlan",
    "build",
    "gumbel_graphs",
    "gumbel_graphs_plain",
    "gumbel_plan",
    "check_offset",
    "fleet_keys",
    "fleet_particles",
    "philox_uniform",
    "se_matrix",
    "se_matrix_plain",
    "se_split",
    "se_tile_count",
    "se_tile_of",
    "se_tile_size",
    "se_tiles",
    "score_ratio",
    "score_ratio_plain",
    "use_kernel",
]

# Kernel launches on the card by kernel: each wrapper adds one where it
# launches its kernel, and nowhere else. A split ``se_matrix`` call (the
# feature slices and their reduction, two launches) counts once.
LAUNCHES = {"gumbel_graphs": 0, "bge_pairs": 0, "se_matrix": 0,
            "transport_phi": 0, "fused_linear_single": 0,
            "fused_linear_pass1": 0, "fused_linear_pass2": 0,
            "fused_linear_wide_pass1": 0, "fused_linear_wide_pass2": 0,
            "fused_nonlinear": 0, "acyclic_grad": 0, "score_ratio": 0}

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # imported at build only

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not nvcc.exists():
        raise RuntimeError("nvcc not found (no CUDA toolkit): the CUDA "
                           "kernels cannot be built")
    return str(nvcc)


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.h"))


def _run_all(cmds):
    """Runs the commands in parallel; raises with the first failure's
    output. Returns the combined compiler output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(err + out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err + out)
    if failed is not None:
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return "".join(logs)


def build() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the kernel library.

    One ``nvcc`` per source, all started together, then one link. Raises
    ``RuntimeError`` with ``nvcc``'s output if a step fails. The compiler's
    ``-Xptxas=-v`` report (registers, shared memory, spills per kernel) is
    kept beside the library as ``<name>.log``.
    """
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256()
    for path in srcs:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    so = _BUILD / f"libdibs_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        cus = [p for p in srcs if p.suffix == ".cu"]
        objs = [tmp.with_suffix(f".{p.stem}.o") for p in cus]
        log = _run_all([[nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(cus, objs)])
        log += _run_all([[nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *[str(o) for o in objs]]])
        for obj in objs:
            obj.unlink()
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.dibs_gumbel_graphs.argtypes = [vp, vp, vp, i64, i32, i32,
                                       ctypes.c_uint64, vp, i32,
                                       ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_uint32, f32, f32, i32, i32,
                                       i32, i32, vp]
    lib.dibs_gumbel_graphs.restype = i32
    lib.dibs_bge_pairs.argtypes = [vp] * 7 + [i32, i32, i32,
                                              ctypes.POINTER(i32), vp, vp]
    lib.dibs_bge_pairs.restype = i32
    lib.dibs_bge_pairs_smem_bytes.argtypes = [i32, i32]
    lib.dibs_bge_pairs_smem_bytes.restype = i32
    lib.dibs_se_matrix.argtypes = [vp] * 4 + [i32] * 8 + [f32, f32, vp]
    lib.dibs_se_matrix.restype = i32
    lib.dibs_se_matrix_slots.argtypes = [i32, ctypes.POINTER(i32)]
    lib.dibs_se_matrix_slots.restype = i32
    u32, f64 = ctypes.c_uint32, ctypes.c_double
    lib.dibs_fused_linear.argtypes = ([i32] + [vp] * 5 + [i32, u32]
                                      + [vp] * 8 + [i32] * 8
                                      + [ctypes.c_uint64, u32, u32, f32, f32,
                                         f64, f32, f32, vp])
    lib.dibs_fused_linear.restype = i32
    lib.dibs_fused_linear_shard.argtypes = lib.dibs_fused_linear.argtypes
    lib.dibs_fused_linear_shard.restype = i32
    lib.dibs_fused_linear_smem_bytes.argtypes = [i32, i32]
    lib.dibs_fused_linear_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_fused_linear_row_smem_bytes.argtypes = [i32] * 4
    lib.dibs_fused_linear_row_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_fused_linear_row_items.argtypes = [i32, i32]
    lib.dibs_fused_linear_row_items.restype = i32
    lib.dibs_fused_linear_wide.argtypes = ([i32] + [vp] * 13 + [i32] * 5
                                           + [ctypes.c_uint64, u32, u32, u32,
                                              f32, f32, f64, f32, f32, vp,
                                              vp, i32, vp])
    lib.dibs_fused_linear_wide.restype = i32
    lib.dibs_fused_linear_wide_shard.argtypes = \
        lib.dibs_fused_linear_wide.argtypes
    lib.dibs_fused_linear_wide_shard.restype = i32
    lib.dibs_fused_linear_wide_smem_bytes.argtypes = [i32, i32]
    lib.dibs_fused_linear_wide_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_fused_linear_wide_pass1_smem_bytes.argtypes = [i32, i32, i32]
    lib.dibs_fused_linear_wide_pass1_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_fused_linear_wide_pass1_group.argtypes = [i32, i32]
    lib.dibs_fused_linear_wide_pass1_group.restype = i32
    lib.dibs_fused_linear_wide_pass2_smem_bytes.argtypes = [i32, i32]
    lib.dibs_fused_linear_wide_pass2_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_transport_phi.argtypes = [vp] * 7 + [i32, i32, i32, f32, f32,
                                               i32, vp]
    lib.dibs_transport_phi.restype = i32
    lib.dibs_fused_nonlinear.argtypes = ([vp] * 8 + [i32, u32] + [vp] * 7
                                         + [i32] * 11
                                         + [ctypes.c_uint64, u32, u32, f32,
                                            f32, f64, f32, vp])
    lib.dibs_fused_nonlinear.restype = i32
    lib.dibs_fused_nonlinear_fleet.argtypes = lib.dibs_fused_nonlinear.argtypes
    lib.dibs_fused_nonlinear_fleet.restype = i32
    lib.dibs_fused_nonlinear_shard.argtypes = lib.dibs_fused_nonlinear.argtypes
    lib.dibs_fused_nonlinear_shard.restype = i32
    lib.dibs_fused_nonlinear_smem_bytes.argtypes = [i32] * 7
    lib.dibs_fused_nonlinear_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_acyclic_grad.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                      ctypes.c_uint64, f32, i32, i32, vp]
    lib.dibs_acyclic_grad.restype = i32
    lib.dibs_acyclic_grad_smem_bytes.argtypes = [i32]
    lib.dibs_acyclic_grad_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_score_ratio.argtypes = [vp] * 4 + [i32] * 3 + [f64, i32, vp]
    lib.dibs_score_ratio.restype = i32
    lib.dibs_error_string.argtypes = [i32]
    lib.dibs_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def build_log() -> str:
    """The compiler report of the loaded library (``""`` if not built)."""
    if _lib is None:
        return ""
    log = Path(_lib._name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def use_kernel(t: torch.Tensor) -> bool:
    """The dispatch rule of every kernel: ``t`` lies on a CUDA device and
    the kill switch is not off (:func:`dibs_tpu_torch.config.
    pallas_override`)."""
    return t.device.type == "cuda" and pallas_override() is not False


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.dibs_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _check_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# Gumbel graph sampler
# ---------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``a * b`` for a constant ``a < 2^32``
    and int64 ``b`` in ``[0, 2^32)``, without leaving int64."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    low = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (low >> 32), low & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words; the key
    words (ints, or int64 tensors that broadcast against the counters) are
    bumped before every round but the first (Random123's schedule)."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key_words(seed, b: int, device, particle_offset: int = 0):
    """Philox key words ``(k0, k1)`` of a batch of ``b`` particles: ints
    for an int ``seed``; for a fleet's ``[B_ds]`` int64 keys (``b`` a
    multiple of ``B_ds``), ``[b, 1, 1, 1]`` tensors holding each particle's
    dataset key. Also returns the particle counters: ``particle_offset +``
    the index in the batch for an int ``seed`` (a particle shard's global
    indices), the index within the dataset for a fleet."""
    kw = dict(dtype=torch.int64, device=device)
    particle = torch.arange(b, **kw)
    if not isinstance(seed, torch.Tensor):
        return (seed & _MASK32, (seed >> 32) & _MASK32,
                (particle + particle_offset) & _MASK32)
    check_offset(seed, particle_offset, b)
    keys = seed.to(**kw).reshape(-1)
    per = fleet_particles(b, keys.numel())
    ds = particle // per
    key = keys[ds].view(b, 1, 1, 1)
    return key & _MASK32, (key >> 32) & _MASK32, particle - ds * per


def fleet_particles(batch: int, n_keys: int) -> int:
    """Particles a dataset of a fleet's ``batch`` under ``n_keys`` keys;
    raises ``ValueError`` unless ``n_keys`` divides ``batch``."""
    if n_keys < 1 or batch % n_keys:
        raise ValueError(f"a fleet's batch of {batch} particles does not "
                         f"split into {n_keys} datasets")
    return batch // n_keys


def check_offset(seed, particle_offset: int, n_particles: int = 0,
                 sample_offset: int = 0, n_samples: int = 0) -> None:
    """Raises ``ValueError`` for a particle or sample offset with a fleet's
    keys (a fleet's particle counter is the index within its dataset, and
    a fleet has no sample shards), a negative one, or counters past 32
    bits (``particle_offset + n_particles`` or ``sample_offset +
    n_samples`` above ``2^32``)."""
    fleet = isinstance(seed, torch.Tensor)
    if particle_offset < 0 or (particle_offset and fleet):
        raise ValueError(f"particle_offset={particle_offset}: a shard's "
                         "offset is a non-negative int and goes with one "
                         "dataset's int seed, not a fleet's keys")
    if sample_offset < 0 or (sample_offset and fleet):
        raise ValueError(f"sample_offset={sample_offset}: a sample shard's "
                         "offset is a non-negative int and goes with one "
                         "dataset's int seed, not a fleet's keys")
    for what, first, n in (("particle", particle_offset, n_particles),
                           ("sample", sample_offset, n_samples)):
        if first + n > 1 << 32:
            raise ValueError(f"{what} counters {first} .. {first + n - 1} "
                             "pass 32 bits")


def fleet_keys(name: str, seed, batch: int, device):
    """``(keys, per)`` of a kernel launch over ``batch`` particles: a
    fleet's ``[B_ds]`` keys (``seed`` a contiguous int64 tensor on
    ``device``) and its particles a dataset, or ``(None, batch)`` for one
    dataset keyed by an int ``seed``."""
    if not isinstance(seed, torch.Tensor):
        return None, max(1, batch)
    keys = seed.reshape(-1)
    per = fleet_particles(batch, keys.numel())
    if (keys.device != device or keys.dtype != torch.int64
            or not keys.is_contiguous()):
        raise ValueError(f"{name}: a fleet's keys must be a contiguous int64 "
                         "tensor on the kernel's device")
    return keys, per


def philox_uniform(shape, seed, stream: int, device,
                   particle_offset: int = 0,
                   sample_offset: int = 0) -> torch.Tensor:
    """The sampler kernel's uniforms for a ``[B, M, d, d]`` output, in
    PyTorch: Philox4x32-10 with counter (element, sample, particle, stream)
    and key = ``seed``; top 24 bits, half-ulp offset, clamp at 1 - 2^-23.
    Particle ``b`` takes the counter ``particle_offset + b``, so a shard
    holding particles ``o .. o + B - 1`` of a batch draws their uniforms
    with ``particle_offset=o``; sample ``m`` takes ``sample_offset + m``
    alike. ``seed`` may be a fleet's ``[B_ds]`` int64 keys (offsets 0):
    particle ``b`` then takes key ``seed[b // per]`` and counter ``b %
    per`` (``per = B / B_ds``), as the kernel does."""
    b, m, d, _ = shape
    check_offset(seed, particle_offset, b, sample_offset, m)
    k0, k1, particle = _key_words(seed, b, device, particle_offset)
    kw = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(d * d, **kw).view(1, 1, d, d).expand(b, m, d, d)
    c1 = (torch.arange(m, **kw) + sample_offset).view(1, m, 1, 1).expand(
        b, m, d, d)
    c2 = particle.view(b, 1, 1, 1).expand(b, m, d, d)
    c3 = torch.full((b, m, d, d), stream & _MASK32, **kw)
    word0 = philox4x32(c0, c1, c2, c3, k0, k1)[0]
    top = (word0 >> 8).to(torch.float32)
    u = top * (1.0 / (1 << 24)) + 0.5 / (1 << 24)
    return torch.clamp(u, max=1.0 - 2.0 ** -23)


def gumbel_graphs_plain(scores: torch.Tensor, seed, stream: int,
                        alpha: float, tau: float, n_samples: int, hard: bool,
                        eps: torch.Tensor | None = None,
                        particle_offset: int = 0,
                        sample_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of the sampler kernel (same noise, same maths;
    ``seed`` an int or a fleet's ``[B_ds]`` keys; ``particle_offset`` and
    ``sample_offset`` as :func:`philox_uniform`)."""
    b, d, _ = scores.shape
    check_offset(seed, particle_offset, b, sample_offset, n_samples)
    if eps is None:
        u = philox_uniform((b, n_samples, d, d), seed, stream, scores.device,
                           particle_offset, sample_offset)
        eps = torch.log(u) - torch.log1p(-u)
    logits = eps + alpha * scores[:, None]
    if hard:
        g = (logits > 0.0).to(torch.float32)
    else:
        g = torch.sigmoid(tau * logits)
    return zero_diagonal(g)


_GUMBEL_THREADS = 256
# threads a launch should reach before samples stop being split over the
# grid: two waves of a full SM (2,048 resident threads) on every SM
_GUMBEL_WAVES = 2


class GumbelPlan(NamedTuple):
    """Launch plan of the sampler kernel (``csrc/gumbel.cu``)."""
    vec: int  # adjacent elements a thread (4: 16-byte loads and stores)
    threads: int  # threads a block
    group: int  # samples a thread loops over
    grid: tuple  # (blocks over particles x element runs, sample groups)


def gumbel_plan(batch: int, n_samples: int, d: int, aligned: bool,
                sm_count: int) -> GumbelPlan:
    """Runs of 4 elements where ``d * d % 4 == 0`` and the tensors are
    16-byte aligned, else 1; the samples split into as few groups as give
    ``_GUMBEL_WAVES`` full waves of threads on ``sm_count`` SMs (one group,
    all samples a thread, once the element runs alone fill them), at most
    65,535 groups (``gridDim.y``). Every group but the last holds ``group``
    samples."""
    vec = 4 if aligned and d * d % 4 == 0 else 1
    units = batch * (d * d // vec)
    target = _GUMBEL_WAVES * sm_count * 2048
    groups = max(1, min(n_samples, -(-target // max(1, units))))
    group = max(1, -(-n_samples // groups), -(-n_samples // 65535))
    return GumbelPlan(vec, _GUMBEL_THREADS, group,
                      (-(-units // _GUMBEL_THREADS), -(-n_samples // group)))


def gumbel_graphs(scores: torch.Tensor, seed, stream: int, alpha: float,
                  tau: float, n_samples: int, hard: bool,
                  eps: torch.Tensor | None = None,
                  particle_offset: int = 0,
                  sample_offset: int = 0) -> torch.Tensor:
    """``[B, d, d]`` scores -> ``[B, n_samples, d, d]`` Gumbel graph samples.

    ``hard``: ``1[eps + alpha s > 0]`` (Bernoulli(sigmoid(alpha s)));
    otherwise ``sigmoid(tau (eps + alpha s))``. The diagonal is zero. The
    noise is Logistic(0, 1) drawn in the kernel from (``seed``, ``stream``),
    or the injected ``eps [B, n_samples, d, d]``. Any ``d >= 1``. Soft
    samples at ``tau == 1`` with in-kernel noise take the kernel's fast
    form, within a few float32 ulps of the twin's log form. ``seed`` is an
    int, or a fleet's ``[B_ds]`` int64 keys (on the scores' device for the
    kernel) over ``B_ds`` datasets of ``B / B_ds`` particles: each dataset
    then draws what a single batch keyed by its key draws. With an int
    ``seed``, particle ``b`` draws at the counter ``particle_offset + b``:
    launches over the shards of a batch, each with its first particle's
    index as the offset, draw what one launch over the batch draws. Sample
    ``m`` draws at the counter ``sample_offset + m`` alike: a rank holding
    samples ``s .. s + n_samples - 1`` (the ``("p", "mc")`` mesh) draws
    that slice of one launch over all the samples (an injected ``eps`` is
    then the slice's noise).
    """
    check_offset(seed, particle_offset, scores.shape[0], sample_offset,
                 n_samples)
    if not use_kernel(scores):
        return gumbel_graphs_plain(scores, seed, stream, alpha, tau,
                                   n_samples, hard, eps, particle_offset,
                                   sample_offset)
    b, d, d2 = scores.shape
    if d != d2:
        raise ValueError(f"scores must be [B, d, d], got {tuple(scores.shape)}")
    _check_cuda("gumbel_graphs", scores)
    if eps is not None:
        _check_cuda("gumbel_graphs", eps)
        if tuple(eps.shape) != (b, n_samples, d, d):
            raise ValueError(f"eps must be {(b, n_samples, d, d)}, got "
                             f"{tuple(eps.shape)}")
    keys, per = fleet_keys("gumbel_graphs", seed, b, scores.device)
    lib = build()
    out = torch.empty((b, n_samples, d, d), dtype=torch.float32,
                      device=scores.device)
    aligned = scores.data_ptr() % 16 == 0 and (eps is None
                                               or eps.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(scores.device).multi_processor_count
    plan = gumbel_plan(b, n_samples, d, aligned, sms)
    with torch.cuda.device(scores.device):
        rc = lib.dibs_gumbel_graphs(
            scores.data_ptr(), None if eps is None else eps.data_ptr(),
            out.data_ptr(), b, n_samples, d,
            0 if keys is not None else seed & 0xFFFFFFFFFFFFFFFF,
            None if keys is None else keys.data_ptr(), per,
            particle_offset & _MASK32, sample_offset & _MASK32,
            stream & _MASK32,
            float(alpha), float(tau), int(bool(hard)),
            plan.vec, plan.threads, plan.group, _stream(scores.device))
    _check_launch(lib, rc, "gumbel_graphs")
    return out


# ---------------------------------------------------------------------------
# BGe determinant pairs: the routes (csrc/bge_pairs.cu)
# ---------------------------------------------------------------------------

# past d = 32 a pair with at most this many parents takes the warp route
BGE_WARP_MAX_K = 15
# the block route's frames: (largest k, thread rows TR, thread columns TC,
# tile rows AR, tile columns AC); each frame is TR AR = TC AC wide
_BGE_FRAMES = ((31, 4, 8, 8, 4), (47, 4, 8, 12, 6), (63, 8, 8, 8, 8),
               (95, 8, 8, 12, 12), (127, 16, 16, 8, 8))
_BGE_WARPS = 4  # warps a block of the warp routes


class BgePairsPlan(NamedTuple):
    """The route of #2 for one (d, k) (``csrc/bge_pairs.cu``)."""
    route: str  # "warp" (one warp a pair) or "block" (one block a pair)
    threads: int  # threads a block
    grid: tuple  # the block's threads as (rows, columns) of the tile layout
    tile: tuple  # values a thread holds: (rows, columns) of C and v
    smem_bytes: int  # static shared memory a block


def _bge_frame_smem(tr: int, tc: int, ar: int, ac: int) -> int:
    """``sizeof(BlockSmem<TR, TC, AR, AC>)``: the chunk's parent sets,
    float64 log-pivots, two column and two row buffers, pivots,
    reciprocals, border values, mask values, two reciprocals, the parent
    list, the chunk's pair list (int64), its count and its index, 16-byte
    aligned."""
    w, acp, nt = tr * ar, -(-ac // 4) * 4, tr * tc
    raw = (16 * nt + 8 * w + 4 * (2 * w + 2 * tc * acp + 4 * w + 2 + w)
           + 8 * nt + 8)
    return -(-raw // 16) * 16


def bge_pairs_plan(d: int, k: int) -> BgePairsPlan:
    """#2's route for a node with ``k`` parents at ``d``: up to d = 32 the
    warp kernel for every k <= 31 (its mask staged as floats); past it the
    warp route for k <= ``BGE_WARP_MAX_K`` and the block route's frames
    ``_BGE_FRAMES`` above, up to k = 127. Raises ``ValueError`` for what no
    route serves (k = 32 at d = 32, k = 128 at d = 128: a self-loop on every
    node of the mask, with no lane or column for the border; the kernel
    writes NaN there)."""
    if not 2 <= d <= 128 or not 0 <= k <= d:
        raise ValueError(f"bge_pairs serves 2 <= d <= 128 and 0 <= k <= d, "
                         f"got d={d}, k={k}")
    threads = 32 * _BGE_WARPS
    if d <= 32 or k <= BGE_WARP_MAX_K:
        if k > 31:
            raise ValueError(f"no route for k={k} parents at d={d}: the "
                             "warp kernel has no lane for the border")
        rows = next(r for r in (4, 8, 16, 32) if k <= r)
        if d <= 32:  # the [32][33] float mask and 4 parent lists
            smem = 4 * 32 * 33 + 4 * _BGE_WARPS * 32
        else:  # 128 parent sets and int64 pairs, 4 x 128 mask values, 4
            # lists, the count and the chunk's index, 16-byte aligned
            smem = -(-(24 * threads + 4 * _BGE_WARPS * (128 + 32) + 8)
                     // 16) * 16
        return BgePairsPlan("warp", threads, (1, 32), (rows, 1), smem)
    for k_max, tr, tc, ar, ac in _BGE_FRAMES:
        if k <= k_max:
            return BgePairsPlan("block", tr * tc, (tr, tc), (ar, ac),
                                _bge_frame_smem(tr, tc, ar, ac))
    raise ValueError(f"no route for k={k} parents at d={d}: the widest "
                     "frame has no column for the border")


def bge_route_plans():
    """The plans of #2's seven kernels in the launcher's order (the d <= 32
    warp kernel, the warp route, the five frames), which the launcher holds
    to its own."""
    return (bge_pairs_plan(32, 0), bge_pairs_plan(128, 0),
            *(bge_pairs_plan(128, k_max) for k_max, *_ in _BGE_FRAMES))


# ---------------------------------------------------------------------------
# SE kernel matrix
# ---------------------------------------------------------------------------

_PLAIN_SE_FLOATS = 1 << 26


def se_matrix_plain(x: torch.Tensor, y: torch.Tensor, h: float,
                    scale: float) -> torch.Tensor:
    """Plain twin: ``scale * exp(-||x_i - y_j||^2 / h)`` in difference form,
    over row chunks that keep the ``[rows, B, n]`` difference near 2^26
    floats (config 5's ``[1000, 1000]`` over 32,768 would be 122 GiB). A
    fleet's ``[B_ds, A, n]`` and ``[B_ds, B, n]`` give ``[B_ds, A, B]``,
    each dataset's matrix from this twin on its operands alone."""
    if x.dim() == 3:
        return torch.stack([se_matrix_plain(xi, yi, h, scale)
                            for xi, yi in zip(x, y)])
    rows = max(1, _PLAIN_SE_FLOATS // max(1, y.shape[0] * x.shape[1]))
    sq = torch.cat([torch.square(x[i:i + rows, None, :] - y[None]).sum(-1)
                    for i in range(0, x.shape[0], rows)]
                   or [x.new_zeros((0, y.shape[0]))])
    return scale * torch.exp(-sq / h)


# the split over features (csrc/se_matrix.cu): slices of at least this many
# features, at most this many slices
_SE_MIN_SLICE = 2048
_SE_MAX_SPLITS = 8
_se_slots = {}


def se_tile_size(a: int, b: int) -> int:
    """Output rows and columns per block of the SE kernel: 128 when both
    sides have at least 128 rows, else 32 (the d=20 ``[30, 30]``)."""
    return 128 if min(a, b) >= 128 else 32


def se_tile_of(t: int, tiles_b: int, symmetric: bool):
    """Tile ``t`` of the launch order -> ``(row tile, column tile)``, the
    closed form the kernel computes: symmetric calls go over the upper
    triangle column by column (``t = tb (tb + 1) / 2 + ta``, ``ta <= tb``),
    the others row-major over ``tiles_b`` columns."""
    if not symmetric:
        return divmod(t, tiles_b)
    c = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while c > 0 and c * (c + 1) // 2 > t:
        c -= 1
    while (c + 1) * (c + 2) // 2 <= t:
        c += 1
    return t - c * (c + 1) // 2, c


def se_tiles(a: int, b: int, symmetric: bool, tile: int):
    """The ``(row tile, column tile)`` pairs one call launches, in launch
    order: with ``symmetric`` (x is y, so ``a == b``) those with row tile
    <= column tile, each off-diagonal one written to both places."""
    ta, tb = -(-a // tile), -(-b // tile)
    if symmetric:
        return [(i, j) for j in range(tb) for i in range(j + 1)]
    return [(i, j) for i in range(ta) for j in range(tb)]


def se_tile_count(a: int, b: int, symmetric: bool, tile: int) -> int:
    """``len(se_tiles(a, b, symmetric, tile))`` in closed form."""
    ta, tb = -(-a // tile), -(-b // tile)
    return ta * (ta + 1) // 2 if symmetric else ta * tb


def se_split(tiles: int, n: int, slots: int) -> int:
    """Feature slices S of one call: 1 when the tiles alone fill two waves
    of the ``slots`` blocks the card holds at once, or when ``n`` is below
    two slices of ``_SE_MIN_SLICE``; otherwise the S in
    ``1..min(_SE_MAX_SPLITS, n // _SE_MIN_SLICE)`` whose ``tiles * S``
    blocks fill their last wave best (the smallest such S)."""
    cap = min(_SE_MAX_SPLITS, n // _SE_MIN_SLICE)
    if tiles >= 2 * slots or cap <= 1:
        return 1

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // slots) * slots)

    return max(range(1, cap + 1), key=lambda s: (fill(s), -s))


def _slots(lib, device, tile: int) -> int:
    key = (device.index, tile)
    if key not in _se_slots:
        slots = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.dibs_se_matrix_slots(tile, ctypes.byref(slots))
        if rc != 0 or slots.value < 1:
            raise RuntimeError("se_matrix occupancy query failed: "
                               f"{lib.dibs_error_string(rc).decode()}")
        _se_slots[key] = slots.value
    return _se_slots[key]


def se_matrix(x: torch.Tensor, y: torch.Tensor, h: float,
              scale: float) -> torch.Tensor:
    """``[A, n] x [B, n] -> [A, B]`` SE kernel matrix (fixed float ``h``).

    ``y is x`` is the symmetric call: the kernel computes the upper tiles
    only and mirrors them, so the result is exactly symmetric with the
    diagonal exactly ``scale``. Where the tiles fill less than two waves
    the features are split (:func:`se_split`) and summed by a second
    launch, in a fixed order. A fleet's ``[B_ds, A, n]`` and ``[B_ds, B,
    n]`` give ``[B_ds, A, B]`` in one launch (a grid axis over the
    datasets); the tile and the split are chosen from one dataset's shape,
    so each matrix has the bits of the unbatched call on its operands."""
    if (x.dim() not in (2, 3) or y.dim() != x.dim()
            or x.shape[-1] != y.shape[-1]
            or (x.dim() == 3 and x.shape[0] != y.shape[0])):
        raise ValueError(f"se_matrix: bad shapes {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if not use_kernel(x):
        return se_matrix_plain(x, y, h, scale)
    _check_cuda("se_matrix", x, y)
    lib = build()
    sym = y is x
    lead = tuple(x.shape[:-2])
    batch = x.shape[0] if lead else 1
    (a, n), b = x.shape[-2:], y.shape[-2]
    tile = se_tile_size(a, b)
    splits = 1
    if a and b:
        splits = se_split(se_tile_count(a, b, sym, tile), n,
                          _slots(lib, x.device, tile))
    vec = n % 4 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    out = torch.empty((*lead, a, b), dtype=torch.float32, device=x.device)
    part = (torch.empty((batch, splits, a, b), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        rc = lib.dibs_se_matrix(
            x.data_ptr(), y.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), batch, a, b, n, tile,
            splits, int(sym), int(vec), float(h), float(scale),
            _stream(x.device))
    _check_launch(lib, rc, "se_matrix")
    return out


# ---------------------------------------------------------------------------
# Fused acyclicity gradient (kernel #9)
# ---------------------------------------------------------------------------

# the largest d whose three [d, d|1] float32 matrices fit the 232,448 bytes
# of shared memory a block may use (csrc/acyclic_grad.cu)
ACYCLIC_GRAD_MAX_D = 139
# the quad tier's last d: 8 x 8 outputs a thread of 16 x 16 threads
_ACYCLIC_QUAD_MAX_D = 128
_ACYCLIC_THREADS = 256


class AcyclicGradPlan(NamedTuple):
    """Kernel #9's tier for one d (``csrc/acyclic_grad.cu``)."""
    tier: str  # "quad" (row reads, 16-byte fragments) or "strided"
    tile: int  # outputs a thread a side: 4 or 8 (quad), 9 (strided)
    stride: int  # row stride of the three shared matrices, in floats
    smem_bytes: int  # dynamic shared memory a block


def acyclic_grad_plan(d: int) -> AcyclicGradPlan:
    """The quad tier up to d = 64 (4 x 4 outputs a thread, stride 64) and
    up to d = 128 (8 x 8, stride 128), its rows rounded up to a multiple
    of 4; the strided first design (9 x 9, stride ``d | 1``) for 128 < d <=
    ``ACYCLIC_GRAD_MAX_D``. The launcher refuses any other tile or
    stride."""
    if not 1 <= d <= ACYCLIC_GRAD_MAX_D:
        raise ValueError(f"acyclic_grad serves 1 <= d <= "
                         f"{ACYCLIC_GRAD_MAX_D}, got d={d}")
    if d <= _ACYCLIC_QUAD_MAX_D:
        tile = 4 if d <= 64 else 8
        stride = 16 * tile
        return AcyclicGradPlan("quad", tile, stride,
                               4 * 3 * (-(-d // 4) * 4) * stride)
    return AcyclicGradPlan("strided", 9, d | 1, 4 * 3 * d * (d | 1))


def _check_acyclic_args(scores, n_samples, eps):
    if scores.dim() != 3 or scores.shape[1] != scores.shape[2]:
        raise ValueError(f"scores must be [P, d, d], got {tuple(scores.shape)}")
    p, d, _ = scores.shape
    if d > ACYCLIC_GRAD_MAX_D:
        raise ValueError(
            f"acyclic_grad serves d <= {ACYCLIC_GRAD_MAX_D} (got d={d}): the "
            "kernel keeps three [d, d|1] float32 matrices of the power chain "
            "in the 227 KB of shared memory a block may use")
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    if eps is not None and tuple(eps.shape) != (p, n_samples, d, d):
        raise ValueError(f"eps must be {(p, n_samples, d, d)}, got "
                         f"{tuple(eps.shape)}")


def acyclic_grad_plain(scores: torch.Tensor, seed: int, alpha: float,
                       n_samples: int,
                       eps: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel #9: the same Philox uniforms (or the
    injected Logistic ``eps``), the tau = 1 fast form
    ``g = 1 / (1 + (1/u - 1) exp(-alpha s))``, the chain ``(I + g/d)^(d-1)``
    by batched ``torch.matmul``, ``R^T * alpha g (1 - g)`` and the mean
    over the samples."""
    p, d, _ = scores.shape
    s = scores[:, None]
    if eps is None:
        u = philox_uniform((p, n_samples, d, d), seed, 0, scores.device)
        g = 1.0 / (1.0 + (1.0 / u - 1.0) * torch.exp(-alpha * s))
    else:
        g = 1.0 / (1.0 + torch.exp(-(eps + alpha * s)))
    g = zero_diagonal(g)
    eye = torch.eye(d, dtype=scores.dtype, device=scores.device)
    base = eye + g * (1.0 / d)
    result = None  # the identity
    n = d - 1
    while n > 0:
        if n & 1:
            result = base if result is None else result @ base
        n >>= 1
        if n:
            base = base @ base
    if result is None:
        result = eye.expand(g.shape)
    w = (alpha * g) * (1.0 - g)
    return (result.transpose(-1, -2) * w).sum(1) * (1.0 / n_samples)


def acyclic_grad(scores: torch.Tensor, seed: int, alpha: float,
                 n_samples: int,
                 eps: torch.Tensor | None = None) -> torch.Tensor:
    """``[P, d, d]`` scores -> ``[P, d, d]``: the mean over ``n_samples``
    soft graphs ``g = sigmoid(logit(u) + alpha s)`` of ``d h / d scores``,
    ``h(g) = tr[(I + g/d)^d] - d``, i.e. ``(1/K) sum R^T * alpha g (1 -
    g)`` with ``R = (I + g/d)^(d-1)``.

    Uniforms from Philox keyed by ``seed`` (counter (element, sample,
    particle, 0)), or the injected Logistic ``eps [P, n_samples, d, d]``.
    Serves ``d <= ACYCLIC_GRAD_MAX_D`` (raises ``ValueError`` otherwise, on
    any device); on the card through the tier :func:`acyclic_grad_plan`
    names, whose outputs are bitwise those of the strided first design.
    """
    _check_acyclic_args(scores, n_samples, eps)
    if not use_kernel(scores):
        return acyclic_grad_plain(scores, seed, alpha, n_samples, eps)
    _check_cuda("acyclic_grad", scores)
    if eps is not None:
        _check_cuda("acyclic_grad", eps)
    lib = build()
    p, d, _ = scores.shape
    plan = acyclic_grad_plan(d)
    out = torch.empty((p, d, d), dtype=torch.float32, device=scores.device)
    # the quad tier's w = alpha g (1 - g), kept from the draw to the
    # accumulation in the threads' order (coalesced)
    scratch = (torch.empty((p, plan.tile * plan.tile * _ACYCLIC_THREADS),
                           dtype=torch.float32, device=scores.device)
               if plan.tier == "quad" else None)
    with torch.cuda.device(scores.device):
        rc = lib.dibs_acyclic_grad(
            scores.data_ptr(), None if eps is None else eps.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            p, d, n_samples, seed & 0xFFFFFFFFFFFFFFFF, float(alpha),
            plan.tile, plan.stride, _stream(scores.device))
    _check_launch(lib, rc, "acyclic_grad")
    return out


# ---------------------------------------------------------------------------
# The REINFORCE ratio's weighted residual (kernel #10)
# ---------------------------------------------------------------------------


def _check_score_ratio_args(g, w, prob):
    if g.dim() != 4 or g.shape[-1] != g.shape[-2]:
        raise ValueError(f"g must be [P, M, d, d], got {tuple(g.shape)}")
    p, m, d, _ = g.shape
    if tuple(w.shape) != (p, m):
        raise ValueError(f"w must be {(p, m)}, got {tuple(w.shape)}")
    if tuple(prob.shape) != (p, d, d):
        raise ValueError(f"prob must be {(p, d, d)}, got "
                         f"{tuple(prob.shape)}")


def score_ratio_plain(g: torch.Tensor, w: torch.Tensor, prob: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Plain twin of kernel #10: ``alpha (sum_m w_m g_m - (sum_m w_m)
    prob)`` in float64, rounded once to ``prob``'s type, with a zero
    diagonal."""
    _check_score_ratio_args(g, w, prob)
    p, m, d, _ = g.shape
    w64 = w.double()
    acc = (w64[:, None, :] @ g.double().reshape(p, m, d * d)).view(p, d, d)
    r = (alpha * (acc - w64.sum(1)[:, None, None] * prob.double())).to(
        prob.dtype)
    eye = torch.eye(d, dtype=torch.bool, device=g.device)
    return torch.where(eye, torch.zeros_like(r), r)


def score_ratio(g: torch.Tensor, w: torch.Tensor, prob: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """``[P, d, d]`` residual of the REINFORCE ratio: ``R = alpha (sum_m
    w_m g_m - (sum_m w_m) prob)`` with a zero diagonal, for the hard
    graphs ``g [P, M, d, d]``, the ratio's weights ``w [P, M]`` and the
    edge probabilities ``prob [P, d, d]``; ``R @ V`` and ``R^T @ U`` are
    then ``sum_m w_m grad_Z log p(g_m | Z)``. Sums in float64 in a fixed
    order (the same bits every call). Non-finite weights give non-finite
    entries, as the per-sample form does. Any ``P``, ``M`` and ``d``."""
    _check_score_ratio_args(g, w, prob)
    if not use_kernel(g):
        return score_ratio_plain(g, w, prob, alpha)
    _check_cuda("score_ratio", g, w, prob)
    if w.device != g.device or prob.device != g.device:
        raise ValueError("score_ratio: g, w and prob must share a device")
    lib = build()
    p, m, d, _ = g.shape
    out = torch.empty((p, d, d), dtype=torch.float32, device=g.device)
    vec = 4 if (d * d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                       for t in (g, prob, out))) else 1
    with torch.cuda.device(g.device):
        rc = lib.dibs_score_ratio(g.data_ptr(), w.data_ptr(),
                                  prob.data_ptr(), out.data_ptr(), p, m, d,
                                  float(alpha), vec, _stream(g.device))
    _check_launch(lib, rc, "score_ratio")
    return out
