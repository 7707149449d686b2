"""Device policy of the port.

Every public entry point takes ``device="cuda"`` by default: the port runs on
the card unless the caller asks for the CPU. Where CUDA is absent and the
caller did not pass ``device="cpu"``, :func:`resolve_device` raises instead
of carrying on with the plain PyTorch twins on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

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
