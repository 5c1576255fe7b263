"""Fill-reducing orderings for the supernodal direct solver: the port of
``tpu_sparse/direct/ordering.py``, host numpy and scipy, kept line for line
so that both packages give the same permutation and row map.

Nested dissection by recursive BFS bisection: split the graph at the
median of a pseudo-peripheral breadth-first order, take the boundary of
the first half as the separator, recurse on the halves, and emit parts
in post-order (left, right, separator). For mesh-like graphs (any
PDE/FVM/FEM matrix) the elimination DAG of the resulting LU factor has
depth ~tree height instead of ~n/block, so a level-scheduled triangular
solve runs in tens of dependent steps (direct/supernodal.py).
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp


def nested_dissection(A, leaf: int = 448):
    """Compute an ND permutation of a square sparse matrix's graph.

    Returns ``(perm, part_sizes)``: ``perm`` concatenates the parts in
    post-order (A_perm = A[perm][:, perm]); ``part_sizes`` are the part
    lengths in emission order (leaves and separators interleaved). Parts
    are mutually structured: entries of the permuted matrix never
    connect two different leaves, and a separator connects only its
    subtree — the property block-aligned packing relies on.
    """
    from scipy.sparse.csgraph import breadth_first_order

    A = A.tocsr()
    n = A.shape[0]
    # structure-only symmetric adjacency (values may be negative/complex)
    S0 = sp.csr_matrix(
        (np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr), shape=A.shape)
    S0 = ((S0 + S0.T) > 0).astype(np.int8).tocsr()
    parts: list = []

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 10000))
    try:
        def rec(idx):
            m = len(idx)
            if m <= leaf:
                parts.append(idx)
                return
            S = S0[idx][:, idx].tocsr()
            o1, _ = breadth_first_order(S, 0, directed=False)
            start = int(o1[-1])  # pseudo-peripheral-ish vertex
            order, _ = breadth_first_order(S, start, directed=False)
            if len(order) < m:  # disconnected: split off the component
                seen = np.zeros(m, bool)
                seen[order] = True
                rec(idx[order])
                rec(idx[~seen])
                return
            rank = np.empty(m, np.int64)
            rank[order] = np.arange(m)
            in_a = rank < m // 2
            # separator = A-side vertices adjacent to the B side
            touches_b = S @ (~in_a).astype(np.int32)
            sep = in_a & (touches_b > 0)
            a_ids = idx[in_a & ~sep]
            b_ids = idx[~in_a]
            s_ids = idx[sep]
            if len(a_ids) == 0 or len(b_ids) == 0:
                parts.append(idx)
                return
            rec(a_ids)
            rec(b_ids)
            if len(s_ids):
                parts.append(s_ids)

        rec(np.arange(n))
    finally:
        sys.setrecursionlimit(limit)
    perm = np.concatenate(parts)
    return perm, np.array([len(p) for p in parts], dtype=np.int64)


def aligned_row_map(part_sizes, block: int):
    """Map ND-ordered rows to block-aligned padded slots.

    Consecutive parts are accumulated until the run reaches
    ``block // 2`` rows, then the run is emitted padded to a multiple of
    ``block``. Alignment is what keeps independent parts out of shared
    blocks — a block spanning two leaves would serialize every leaf
    through the block dependency DAG (depth 1021 unaligned vs 43
    aligned on the 512x512 Poisson factor).

    Returns ``(row_map, n_pad)`` with ``row_map[i]`` the padded slot of
    ND row ``i``; slots not hit are identity padding.
    """
    n = int(np.sum(part_sizes))
    row_map = np.empty(n, np.int64)
    pos = 0
    start = 0
    acc = 0
    for psz in part_sizes:
        acc += int(psz)
        if acc >= block // 2:
            row_map[start:start + acc] = pos + np.arange(acc)
            pos += ((acc + block - 1) // block) * block
            start += acc
            acc = 0
    if acc:
        row_map[start:start + acc] = pos + np.arange(acc)
        pos += ((acc + block - 1) // block) * block
    return row_map, pos
