"""Vertex reordering for graph problems.

The DIA-hybrid cross-coupling apply (ops/graph_ops.dia_split) turns gathers into shifted adds when cross-endpoints
concentrate at a few vertex-id offsets — a property of the NUMBERING, not
the mesh. Meshes loaded from files often come with low-locality numbering;
reverse Cuthill-McKee (RCM) renumbering concentrates neighbors into a
narrow band and recovers most of the DIA coverage.

Usage (before binding the problem):

    perm = rcm_order(v0, v1, N)
    verts, cons = permute_vertices(perm, verts, cons)   # all vertex arrays
    v0, v1 = remap_edges(perm, v0, v1)                  # all edge slots
    ... solve ... results come back in the new order; invert with
    inverse_permutation(perm) if the original order is needed.
"""

from __future__ import annotations

import numpy as np


def rcm_order(v0, v1, num_vertices: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the vertex graph given edge
    endpoint lists. Returns ``perm`` with ``perm[new_id] = old_id``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    v0 = np.asarray(v0)
    v1 = np.asarray(v1)
    a = coo_matrix(
        (np.ones(len(v0), np.float32), (v0, v1)),
        shape=(num_vertices, num_vertices),
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(a, symmetric_mode=False), dtype=np.int64
    )


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def permute_vertices(perm: np.ndarray, *arrays):
    """Reorder per-vertex arrays into the new numbering (axis 0)."""
    out = tuple(np.asarray(a)[perm] for a in arrays)
    return out if len(out) != 1 else out[0]


def remap_edges(perm: np.ndarray, *index_arrays):
    """Rewrite edge endpoint indices from old ids to new ids."""
    inv = inverse_permutation(perm)
    out = tuple(inv[np.asarray(i)].astype(np.int32) for i in index_arrays)
    return out if len(out) != 1 else out[0]


def grid_embed_order(
    v0,
    v1,
    num_vertices: int,
    width: int = 256,
    smooth_iters: int = 12,
    refine_iters: int = 40,
) -> np.ndarray:
    """2-D grid-embedding ordering for surface-like graphs.

    RCM produces a 1-D band: cross-endpoints sit within the bandwidth but
    at per-vertex-varying offsets, so DIA coverage saturates low (measured
    31% at 16 offsets on the reference's subdivided armadillo ARAP mesh,
    /root/reference/examples/data/small_armadillo.ply). Surface meshes are
    2-manifolds, so a 2-D layout concentrates neighbors much harder: embed
    vertices in the plane with two Laplacian eigenvectors, smooth, slice
    into rows of exactly ``width`` vertices, then iteratively re-rank each
    row by the mean column of each vertex's graph neighbors (barycentric
    refinement). Measured on the same mesh: 52% at 16 offsets, 68% at 32,
    85% at 64 — the CG loop's irregular-remainder gather shrinks 2-3x vs
    RCM (ops/graph_ops.dia_split consumes the resulting numbering).

    Falls back to RCM when the spectral solve fails (e.g. heavily
    disconnected graphs). Returns ``perm`` with ``perm[new_id] = old_id``,
    same contract as :func:`rcm_order`.
    """
    from scipy.sparse import coo_matrix

    v0 = np.asarray(v0, np.int64)
    v1 = np.asarray(v1, np.int64)
    n = int(num_vertices)
    ones = np.ones(len(v0), np.float64)
    A = coo_matrix((ones, (v0, v1)), shape=(n, n)).tocsr()
    A = ((A + A.T) > 0).astype(np.float64)
    deg = np.maximum(np.asarray(A.sum(1)).ravel(), 1.0)
    try:
        from scipy.sparse.linalg import eigsh

        L = (
            coo_matrix(
                (deg, (np.arange(n), np.arange(n))), shape=(n, n)
            ).tocsr()
            - A
        )
        _vals, vecs = eigsh(L, k=3, sigma=-1e-6, which="LM")
        xs, ys = vecs[:, 1].copy(), vecs[:, 2].copy()
    except Exception:
        return rcm_order(v0, v1, n)
    # joint smoothing settles the continuous embedding before slicing
    for _ in range(smooth_iters):
        xs = 0.5 * xs + 0.5 * (A @ xs) / deg
        sd = xs.std()
        xs = (xs - xs.mean()) / (sd if sd > 0 else 1.0)
        ys = 0.5 * ys + 0.5 * (A @ ys) / deg
        sd = ys.std()
        ys = (ys - ys.mean()) / (sd if sd > 0 else 1.0)
    W = max(2, min(int(width), n))
    H = -(-n // W)
    order_y = np.argsort(ys, kind="stable")
    strips = [order_y[r * W : (r + 1) * W] for r in range(H)]
    col = np.empty(n, np.float64)
    for vs in strips:
        col[vs] = np.argsort(np.argsort(xs[vs], kind="stable"))
    # barycentric column refinement: re-rank each row by the mean column
    # of graph neighbors, so cross-row edges align vertically
    for _ in range(refine_iters):
        target = (A @ col) / deg
        for vs in strips:
            col[vs] = np.argsort(np.argsort(target[vs], kind="stable"))
    newid = np.empty(n, np.int64)
    for r, vs in enumerate(strips):
        newid[vs] = r * W + col[vs].astype(np.int64)
    # every strip but the (short) last has exactly W vertices and in-row
    # ranks are dense, so newid is a bijection onto [0, n); invert it into
    # the perm[new_id] = old_id contract
    return np.argsort(newid, kind="stable").astype(np.int64)


def dia_coverage(v0, v1, num_vertices: int, max_offsets: int = 8) -> float:
    """Fraction of cross-coupling incidences the top offsets would cover
    under the current numbering — a quick diagnostic for whether
    renumbering is worthwhile (>=0.5 activates the DIA path)."""
    from ..ops.graph_ops import combined_cross_table, dia_split

    cross = combined_cross_table(
        [np.asarray(v0), np.asarray(v1)], num_vertices
    )
    out = dia_split(cross, num_vertices, max_offsets=max_offsets, min_coverage=0.0)
    if out is None:
        return 0.0
    _offsets, masks, _rp, _rc = out
    valid = int((cross < num_vertices).sum())
    return float(masks.sum()) / max(valid, 1)
