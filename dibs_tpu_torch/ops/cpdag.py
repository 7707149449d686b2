"""DAG -> CPDAG conversion and equivalence-class (PDAG) metrics (the port's
own numpy copy of ``dibs_tpu/ops/cpdag.py``).

From purely observational Gaussian data the BGe posterior is identifiable
only up to the Markov equivalence class (MEC), so structure-recovery error
is scored between *CPDAGs*, the canonical partially-directed representation
of the MEC, rather than between member DAGs: plain SHD charges a particle
for edge orientations the data cannot resolve.

``dag_to_cpdag`` implements Chickering's label-edges algorithm
(Chickering, "A transformational characterization of equivalent Bayesian
network structures", UAI 1995; restated in JMLR 2002 Fig. 4-5): order the
edges, then propagate compelled/reversible labels in one ordered sweep.
Compelled edges stay directed in the CPDAG; reversible edges become
undirected (both adjacency entries set).

Host-side numpy, on the evaluation path only. Inputs may be numpy arrays
or CPU/CUDA tensors (converted with ``numpy.asarray`` after ``.cpu()``).

Encoding: a CPDAG/PDAG is an int adjacency matrix where a directed edge
``i->j`` has ``a[i, j] = 1, a[j, i] = 0`` and an undirected edge has
``a[i, j] = a[j, i] = 1``.
"""
from __future__ import annotations

import numpy as onp


def _host(a) -> onp.ndarray:
    """numpy view of an array or a (CPU or CUDA) tensor."""
    return onp.asarray(a.detach().cpu() if hasattr(a, "detach") else a)

__all__ = ["dag_to_cpdag", "eltwise_dag_to_cpdag", "pdag_shd"]


def _topological_order(a: onp.ndarray) -> onp.ndarray:
    """Kahn toposort. Raises ``ValueError`` on a cyclic input."""
    d = a.shape[0]
    a = a.astype(bool)
    indeg = a.sum(axis=0)
    order = []
    ready = sorted(onp.flatnonzero(indeg == 0).tolist())
    while ready:
        u = ready.pop(0)
        order.append(u)
        for v in onp.flatnonzero(a[u]):
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(int(v))
        ready.sort()
    if len(order) != d:
        raise ValueError("dag_to_cpdag: input graph is cyclic")
    return onp.asarray(order, dtype=onp.int64)


def _order_edges(a: onp.ndarray, topo: onp.ndarray):
    """Chickering's total order on edges: process sink nodes ``y`` lowest
    topological order first; within a node, incoming edges ``x→y`` with
    *higher*-ordered ``x`` first."""
    rank = onp.empty_like(topo)
    rank[topo] = onp.arange(len(topo))
    edges = []
    for y in topo:
        parents = onp.flatnonzero(a[:, y])
        for x in sorted(parents, key=lambda p: -rank[p]):
            edges.append((int(x), int(y)))
    return edges


def dag_to_cpdag(a) -> onp.ndarray:
    """CPDAG (completed PDAG) of the Markov equivalence class of DAG ``a``.

    Args:
        a: ``[d, d]`` 0/1 adjacency of a DAG (``a[i, j] = 1`` iff ``i→j``)

    Returns:
        ``[d, d]`` int8 PDAG adjacency: compelled edges directed,
        reversible edges undirected (both entries 1).
    """
    a = _host(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected a square adjacency, got {a.shape}")
    adj = (a != 0).astype(onp.int8)
    topo = _topological_order(adj)
    edges = _order_edges(adj, topo)

    UNKNOWN, COMPELLED, REVERSIBLE = 0, 1, 2
    label = {e: UNKNOWN for e in edges}
    parents = [onp.flatnonzero(adj[:, j]).tolist() for j in range(adj.shape[0])]

    for x, y in edges:  # lowest-ordered first
        if label[(x, y)] != UNKNOWN:
            continue
        done = False
        # every compelled edge w→x
        for w in parents[x]:
            if label[(w, x)] != COMPELLED:
                continue
            if adj[w, y] == 0:  # w not a parent of y
                # x→y and every edge into y become compelled
                for p in parents[y]:
                    label[(p, y)] = COMPELLED
                done = True
                break
            label[(w, y)] = COMPELLED
        if done:
            continue
        # z→y with z ≠ x and z not a parent of x ⇒ compelled
        if any(z != x and adj[z, x] == 0 for z in parents[y]):
            for p in parents[y]:
                if label[(p, y)] == UNKNOWN:
                    label[(p, y)] = COMPELLED
        else:
            for p in parents[y]:
                if label[(p, y)] == UNKNOWN:
                    label[(p, y)] = REVERSIBLE

    out = onp.zeros_like(adj)
    for (x, y), lab in label.items():
        out[x, y] = 1
        if lab == REVERSIBLE:
            out[y, x] = 1
    return out


def eltwise_dag_to_cpdag(gs) -> onp.ndarray:
    """Batched :func:`dag_to_cpdag` over ``[N, d, d]`` DAGs (host loop)."""
    gs = _host(gs)
    return onp.stack([dag_to_cpdag(g) for g in gs])


def pdag_shd(x, y) -> onp.ndarray:
    """Structural Hamming distance between two (batched) PDAGs.

    One point per node pair whose edge status differs — missing vs
    present, or present with a different orientation class (``i→j`` vs
    ``j→i`` vs undirected each count as distinct). This is the standard
    CPDAG-SHD of the structure-learning literature (e.g. Tsamardinos et
    al. 2006, MMHC).

    Args:
        x: ``[..., d, d]`` PDAG adjacency (see module encoding)
        y: ``[..., d, d]`` PDAG adjacency, broadcastable against ``x``

    Returns:
        ``[...]`` integer SHD array (scalar for single matrices).
    """
    x = _host(x).astype(onp.int64)
    y = _host(y).astype(onp.int64)
    # the DAG-SHD formula (metrics.pairwise_structural_hamming_distance:
    # symmetrize |diff|, clip, halve) extends verbatim to the PDAG encoding:
    # per unordered pair, reversal 1, directed vs undirected 1, missing vs
    # (un)directed 1, match 0
    diff = onp.abs(x - y)
    diff = diff + onp.swapaxes(diff, -1, -2)
    return onp.minimum(diff, 1).sum(axis=(-2, -1)) // 2
