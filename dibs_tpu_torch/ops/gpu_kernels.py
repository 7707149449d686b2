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
:mod:`dibs_tpu_torch.inference.fused_nonlinear`: a CPU
tensor goes to the plain twin; a CUDA tensor goes to the kernel, and a
build or launch failure raises. ``LAUNCHES`` counts the kernel
launches per kernel (twins never count), so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from dibs_tpu_torch.utils.func import zero_diagonal

__all__ = [
    "ACYCLIC_GRAD_MAX_D",
    "LAUNCHES",
    "acyclic_grad",
    "acyclic_grad_plain",
    "build",
    "gumbel_graphs",
    "gumbel_graphs_plain",
    "philox_uniform",
    "se_matrix",
    "se_matrix_plain",
]

LAUNCHES = {"gumbel_graphs": 0, "bge_pairs": 0, "se_matrix": 0,
            "transport_phi": 0, "fused_linear_single": 0,
            "fused_linear_pass1": 0, "fused_linear_pass2": 0,
            "fused_linear_wide_pass1": 0, "fused_linear_wide_pass2": 0,
            "fused_nonlinear": 0, "acyclic_grad": 0}

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
                                       ctypes.c_uint64, ctypes.c_uint32, f32,
                                       f32, i32, vp]
    lib.dibs_gumbel_graphs.restype = i32
    lib.dibs_bge_pairs.argtypes = [vp, vp, vp, vp, i32, i32, vp]
    lib.dibs_bge_pairs.restype = i32
    lib.dibs_se_matrix.argtypes = [vp, vp, vp, i32, i32, i32, f32, f32, vp]
    lib.dibs_se_matrix.restype = i32
    u32, f64 = ctypes.c_uint32, ctypes.c_double
    lib.dibs_fused_linear.argtypes = ([i32] + [vp] * 12 + [i32] * 6
                                      + [ctypes.c_uint64, u32, u32, f32, f32,
                                         f64, f32, f32, vp])
    lib.dibs_fused_linear.restype = i32
    lib.dibs_fused_linear_smem_bytes.argtypes = [i32, i32]
    lib.dibs_fused_linear_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_fused_linear_wide.argtypes = ([i32] + [vp] * 13 + [i32] * 5
                                           + [ctypes.c_uint64, u32, u32, f32,
                                              f32, f64, f32, f32, vp])
    lib.dibs_fused_linear_wide.restype = i32
    lib.dibs_fused_linear_wide_smem_bytes.argtypes = [i32, i32]
    lib.dibs_fused_linear_wide_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_transport_phi.argtypes = [vp] * 7 + [i32, i32, f32, vp]
    lib.dibs_transport_phi.restype = i32
    lib.dibs_fused_nonlinear.argtypes = ([vp] * 14 + [i32] * 8
                                         + [ctypes.c_uint64, u32, u32, f32,
                                            f32, f64, f32, vp])
    lib.dibs_fused_nonlinear.restype = i32
    lib.dibs_fused_nonlinear_smem_bytes.argtypes = [i32, i32, i32]
    lib.dibs_fused_nonlinear_smem_bytes.restype = ctypes.c_size_t
    lib.dibs_acyclic_grad.argtypes = [vp, vp, vp, i32, i32, i32,
                                      ctypes.c_uint64, f32, vp]
    lib.dibs_acyclic_grad.restype = i32
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


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words; the key
    is bumped before every round but the first (Random123's schedule)."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(shape, seed: int, stream: int, device) -> torch.Tensor:
    """The sampler kernel's uniforms for a ``[B, M, d, d]`` output, in
    PyTorch: Philox4x32-10 with counter (element, sample, particle, stream)
    and key = ``seed``; top 24 bits, half-ulp offset, clamp at 1 - 2^-23."""
    b, m, d, _ = shape
    kw = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(d * d, **kw).view(1, 1, d, d).expand(b, m, d, d)
    c1 = torch.arange(m, **kw).view(1, m, 1, 1).expand(b, m, d, d)
    c2 = torch.arange(b, **kw).view(b, 1, 1, 1).expand(b, m, d, d)
    c3 = torch.full((b, m, d, d), stream & _MASK32, **kw)
    word0 = philox4x32(c0, c1, c2, c3, seed & _MASK32,
                       (seed >> 32) & _MASK32)[0]
    top = (word0 >> 8).to(torch.float32)
    u = top * (1.0 / (1 << 24)) + 0.5 / (1 << 24)
    return torch.clamp(u, max=1.0 - 2.0 ** -23)


def gumbel_graphs_plain(scores: torch.Tensor, seed: int, stream: int,
                        alpha: float, tau: float, n_samples: int, hard: bool,
                        eps: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the sampler kernel (same noise, same maths)."""
    b, d, _ = scores.shape
    if eps is None:
        u = philox_uniform((b, n_samples, d, d), seed, stream, scores.device)
        eps = torch.log(u) - torch.log1p(-u)
    logits = eps + alpha * scores[:, None]
    if hard:
        g = (logits > 0.0).to(torch.float32)
    else:
        g = torch.sigmoid(tau * logits)
    return zero_diagonal(g)


def gumbel_graphs(scores: torch.Tensor, seed: int, stream: int, alpha: float,
                  tau: float, n_samples: int, hard: bool,
                  eps: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, d, d]`` scores -> ``[B, n_samples, d, d]`` Gumbel graph samples.

    ``hard``: ``1[eps + alpha s > 0]`` (Bernoulli(sigmoid(alpha s)));
    otherwise ``sigmoid(tau (eps + alpha s))``. The diagonal is zero. The
    noise is Logistic(0, 1) drawn in the kernel from (``seed``, ``stream``),
    or the injected ``eps [B, n_samples, d, d]``. Any ``d >= 1``.
    """
    if scores.device.type == "cpu":
        return gumbel_graphs_plain(scores, seed, stream, alpha, tau,
                                   n_samples, hard, eps)
    b, d, d2 = scores.shape
    if d != d2:
        raise ValueError(f"scores must be [B, d, d], got {tuple(scores.shape)}")
    _check_cuda("gumbel_graphs", scores)
    if eps is not None:
        _check_cuda("gumbel_graphs", eps)
        if tuple(eps.shape) != (b, n_samples, d, d):
            raise ValueError(f"eps must be {(b, n_samples, d, d)}, got "
                             f"{tuple(eps.shape)}")
    lib = build()
    out = torch.empty((b, n_samples, d, d), dtype=torch.float32,
                      device=scores.device)
    with torch.cuda.device(scores.device):
        rc = lib.dibs_gumbel_graphs(
            scores.data_ptr(), None if eps is None else eps.data_ptr(),
            out.data_ptr(), b, n_samples, d, seed & 0xFFFFFFFFFFFFFFFF,
            stream & _MASK32, float(alpha), float(tau), int(bool(hard)),
            _stream(scores.device))
    _check_launch(lib, rc, "gumbel_graphs")
    return out


# ---------------------------------------------------------------------------
# SE kernel matrix
# ---------------------------------------------------------------------------

_PLAIN_SE_FLOATS = 1 << 26


def se_matrix_plain(x: torch.Tensor, y: torch.Tensor, h: float,
                    scale: float) -> torch.Tensor:
    """Plain twin: ``scale * exp(-||x_i - y_j||^2 / h)`` in difference form,
    over row chunks that keep the ``[rows, B, n]`` difference near 2^26
    floats (config 5's ``[1000, 1000]`` over 32,768 would be 122 GiB)."""
    rows = max(1, _PLAIN_SE_FLOATS // max(1, y.shape[0] * x.shape[1]))
    sq = torch.cat([torch.square(x[i:i + rows, None, :] - y[None]).sum(-1)
                    for i in range(0, x.shape[0], rows)]
                   or [x.new_zeros((0, y.shape[0]))])
    return scale * torch.exp(-sq / h)


def se_matrix(x: torch.Tensor, y: torch.Tensor, h: float,
              scale: float) -> torch.Tensor:
    """``[A, n] x [B, n] -> [A, B]`` SE kernel matrix (fixed float ``h``)."""
    if x.device.type == "cpu":
        return se_matrix_plain(x, y, h, scale)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"se_matrix: bad shapes {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    _check_cuda("se_matrix", x, y)
    lib = build()
    a, n = x.shape
    out = torch.empty((a, y.shape[0]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.dibs_se_matrix(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                a, y.shape[0], n, float(h), float(scale),
                                _stream(x.device))
    _check_launch(lib, rc, "se_matrix")
    return out


# ---------------------------------------------------------------------------
# Fused acyclicity gradient (kernel #9)
# ---------------------------------------------------------------------------

# the largest d whose three [d, d|1] float32 matrices fit the 232,448 bytes
# of shared memory a block may use (csrc/acyclic_grad.cu)
ACYCLIC_GRAD_MAX_D = 139


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
    any device).
    """
    _check_acyclic_args(scores, n_samples, eps)
    if scores.device.type == "cpu":
        return acyclic_grad_plain(scores, seed, alpha, n_samples, eps)
    _check_cuda("acyclic_grad", scores)
    if eps is not None:
        _check_cuda("acyclic_grad", eps)
    lib = build()
    p, d, _ = scores.shape
    out = torch.empty((p, d, d), dtype=torch.float32, device=scores.device)
    with torch.cuda.device(scores.device):
        rc = lib.dibs_acyclic_grad(
            scores.data_ptr(), None if eps is None else eps.data_ptr(),
            out.data_ptr(), p, d, n_samples, seed & 0xFFFFFFFFFFFFFFFF,
            float(alpha), _stream(scores.device))
    _check_launch(lib, rc, "acyclic_grad")
    return out
