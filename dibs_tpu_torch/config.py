"""Device, precision and kernel policy of the port (counterpart of
``dibs_tpu/config.py``).

**Device.** Every public entry point takes ``device="cuda"`` by default: the
port runs on the card unless the caller asks for the CPU. Where CUDA is
absent and the caller did not pass ``device="cpu"``, :func:`resolve_device`
raises instead of carrying on with the plain PyTorch twins on the CPU.

**Matmul precision.** Two knobs with the reference's names and values,
``'default' | 'high' | 'highest'``: :func:`set_likelihood_matmul_precision`
(the linear SEM's ``[N, d] @ [d, d]`` likelihood matmul) and
:func:`set_transport_matmul_precision` (the SVGD transport's ``[P, P] @ [P,
n]`` matmuls where they run in cuBLAS: the median-bandwidth route and the
plain version of kernel #4). On the card ``'highest'`` is IEEE float32 and
``'high'`` and ``'default'`` are TF32 (10 mantissa bits, about 2^-11
relative): coarser than the TPU's bf16x3 ``'high'`` (about 2^-17), which is
what the reference's settings were validated with. Each family applies its
setting only around its own matmuls (:func:`matmul_precision` sets and then
restores torch's global float32 matmul precision); the caller's global state
is never changed, and the engines still refuse to step with TF32 enabled
globally. The hand-written kernels compute in float32 and read neither knob.
Both defaults are ``'highest'``: for the transport that departs from the
reference's ``'high'``, validated for bf16x3 and not for TF32.

**Ring payload.** :func:`set_ring_payload_dtype` picks the wire dtype of
the ring transport's rotating blocks (:mod:`dibs_tpu_torch.parallel.ring`):
float32 by default, bfloat16 on request.

**Kernel kill switch.** :func:`set_pallas_enabled` and the environment
variable ``DIBS_DISABLE_PALLAS`` keep the reference's names and meaning:
``set_pallas_enabled(False)`` (or ``DIBS_DISABLE_PALLAS=1``) sends CUDA
tensors to the plain PyTorch twins of the kernels, on request only;
``None`` restores the default, the kernels. A build or launch failure still
raises: the switch is not a fallback. The one predicate every dispatch point
asks is :func:`dibs_tpu_torch.ops.gpu_kernels.use_kernel`.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "matmul_precision",
           "set_likelihood_matmul_precision", "likelihood_matmul_precision",
           "set_transport_matmul_precision", "transport_matmul_precision",
           "set_ring_payload_dtype", "ring_payload_dtype",
           "set_pallas_enabled", "pallas_override"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` for a
    CUDA device when ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


# --- matmul precision -------------------------------------------------------

# the reference's names -> torch's float32 matmul precision ('high': TF32)
_PRECISIONS = {"default": "high", "high": "high", "highest": "highest"}


def _checked(p) -> str:
    if not isinstance(p, str) or p not in _PRECISIONS:
        raise ValueError(f"matmul precision must be one of "
                         f"{sorted(_PRECISIONS)}; got {p!r}")
    return p


@contextlib.contextmanager
def matmul_precision(p):
    """Runs the block with torch's float32 matmul precision at the
    reference's ``p`` (``'highest'``: IEEE float32; ``'high'`` and
    ``'default'``: TF32) and restores the caller's setting after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_PRECISIONS[_checked(p)])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


_likelihood_matmul_precision = "highest"


def set_likelihood_matmul_precision(p) -> None:
    """Sets the precision of the likelihood-scoring matmuls
    (``LinearGaussian``'s ``x @ (G * Theta)``): ``'default' | 'high' |
    'highest'``. On the card ``'high'`` and ``'default'`` are TF32 (about
    2^-11 relative), coarser than the TPU's bf16x3 ``'high'`` (about
    2^-17). Default ``'highest'`` (IEEE float32), as the reference."""
    global _likelihood_matmul_precision
    _likelihood_matmul_precision = _checked(p)


def likelihood_matmul_precision() -> str:
    return _likelihood_matmul_precision


_transport_matmul_precision = "highest"


def set_transport_matmul_precision(p) -> None:
    """Sets the precision of the SVGD transport's ``[P, P] @ [P, n]``
    driver and repulsion matmuls where cuBLAS runs them (the
    median-bandwidth route, the plain version of kernel #4):
    ``'default' | 'high' | 'highest'``. The kernel matrix and kernel #4
    itself stay float32. On the card ``'high'`` and ``'default'`` are TF32
    (about 2^-11 relative), coarser than the TPU's bf16x3 ``'high'``
    (about 2^-17). Default ``'highest'``: the reference's default is
    ``'high'``, validated for bf16x3 and not for TF32."""
    global _transport_matmul_precision
    _transport_matmul_precision = _checked(p)


def transport_matmul_precision() -> str:
    return _transport_matmul_precision


# --- ring payload ---------------------------------------------------------

_ring_payload_dtype = torch.float32


def set_ring_payload_dtype(dtype) -> None:
    """Sets the wire dtype of the ring transport's rotating ``(v, grad)``
    blocks: ``'float32'`` (default) or ``'bfloat16'`` (or the torch
    dtypes). With bfloat16 the payload halves; only the rotating copies
    are quantized (cast once, before the first send, then forwarded as
    received), so each rank's own tile and every accumulator stay float32
    and the error does not compound around the ring. It perturbs the
    kernel tiles by about 2^-9 relative. Takes effect at the next step."""
    global _ring_payload_dtype
    if isinstance(dtype, str):
        names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if dtype not in names:
            raise ValueError(f"ring payload dtype must be float32 or "
                             f"bfloat16; got {dtype!r}")
        dtype = names[dtype]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ring payload dtype must be float32 or bfloat16; "
                         f"got {dtype}")
    _ring_payload_dtype = dtype


def ring_payload_dtype() -> torch.dtype:
    return _ring_payload_dtype


# --- kernel kill switch -----------------------------------------------------

_pallas_override = None


def set_pallas_enabled(on) -> None:
    """``False`` sends CUDA tensors to the plain twins of the kernels;
    ``None`` restores the default (the kernels). ``True`` is the default's
    meaning on the card; a CPU tensor always takes the plain twin."""
    global _pallas_override
    _pallas_override = on


def pallas_override():
    """The forced setting (``True`` / ``False``), or ``None`` for the
    default; ``DIBS_DISABLE_PALLAS`` set to anything but ``''`` or ``'0'``
    reads as ``False``."""
    if os.environ.get("DIBS_DISABLE_PALLAS", "") not in ("", "0"):
        return False
    return _pallas_override
