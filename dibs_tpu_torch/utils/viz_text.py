"""Text rendering of adjacency matrices (the port's copy of
``dibs_tpu/utils/viz_text.py``). Takes numpy arrays or tensors."""
from __future__ import annotations

import numpy as onp

__all__ = ["adjmat_to_str"]


def adjmat_to_str(mat, max_len: int = 40) -> str:
    """Human-readable edge list: ``u->v`` for directed, ``u--v`` for
    mutual pairs (printed once)."""
    mat = onp.asarray(mat.detach().cpu() if hasattr(mat, "detach") else mat)
    rows, cols = onp.where(mat == 1)
    undir_seen = set()
    parts = []
    for u, v in zip(rows.tolist(), cols.tolist()):
        if mat[v, u] == 1:
            if (u, v) not in undir_seen:
                undir_seen.add((v, u))
                parts.append(f"{u}--{v}")
        else:
            parts.append(f"{u}->{v}")
    s = "  ".join(parts)
    if len(s) > max_len:
        return s[:max_len] + " ... "
    if not s:
        return "<empty graph>"
    return s
