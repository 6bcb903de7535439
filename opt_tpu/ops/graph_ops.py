"""Hypergraph gather/scatter primitives.

Replacement for the reference's per-edge CUDA kernels with ``atomicAdd``
scatters into unknown-shaped arrays (reference: API/src/o.t:558-567
``atomicAddChannel``; o.t:2092-2126 ``createjtjgraph``). JAX exposes no
global-memory atomics at this level; instead an edge-wise gather is ``jnp.take`` and the scatter-add is ``jax.ops.segment_sum``-style
``.at[].add`` which XLA lowers to an efficient sorted scatter. Under autodiff,
``take``'s transpose is exactly the scatter-add, so JᵀF / JᵀJp scatters come
out of ``jax.vjp``/``jax.linear_transpose`` for free.
"""

from __future__ import annotations

import jax.numpy as jnp


def edge_gather(img: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather per-vertex values at edge endpoints: out[e] = img[idx[e]].

    ``img``: [N, C] vertex array (1-d index space only, like the reference's
    graph vertex slots — o.t:818-834). ``idx``: [E] int32.
    """
    return jnp.take(img, idx, axis=0)


def edge_scatter_add(
    values: jnp.ndarray, idx: jnp.ndarray, num_vertices: int
) -> jnp.ndarray:
    """Scatter-add per-edge values into a [num_vertices, C] vertex array."""
    out = jnp.zeros((num_vertices,) + values.shape[1:], values.dtype)
    return out.at[idx].add(values)


def bucket_size(n: int, minimum: int = 1) -> int:
    """Next power-of-two bucket ≥ n (≥ minimum).

    Dynamic-topology padding target: the reference passes the edge count as
    a RUNTIME kernel parameter (util.t:728 ``getValidGraphElement`` guards
    ``idx < N`` at launch), so per-frame topology changes never recompile.
    Here shapes are static under jit, so the edge axis (and the incidence
    widths derived from it) are padded to power-of-two buckets: topologies
    in the same bucket share one trace/compile.
    """
    n = max(int(n), 1)
    return max(int(minimum), 1 << (n - 1).bit_length())


def pad_table_width(table, width: int, sentinel: int):
    """Pad a [N, D] incidence-style table to D=width columns of sentinel."""
    import numpy as np

    table = np.asarray(table)
    n, d = table.shape
    if d >= width:
        return table
    out = np.full((n, width), sentinel, table.dtype)
    out[:, :d] = table
    return out


def slot_groups(gdecl, dim_sizes):
    """Group a graph's endpoint slots by the index space they point into.

    Returns [(group_key, [slot names, sorted], num_vertices)]. Slots of one
    group share vertices, so their accumulation packs into one combined
    incidence gather; slots into other spaces (e.g. a data-point slot next to
    a parameter slot, tests/minimal_graph_only curveFitting.t) go in separate
    groups.
    """
    import numpy as np

    by_ispace = {}
    for slot in sorted(gdecl.slots):
        isp = gdecl.slots[slot]
        by_ispace.setdefault(isp, []).append(slot)
    out = []
    for isp, names in by_ispace.items():
        n = int(np.prod(isp.shape(dim_sizes)))
        out.append(("__inc__" + "|".join(names), names, n))
    return out


def combined_incidence_table(idx_list, num_vertices: int):
    """Combined transpose of several edge->vertex index lists over ONE vertex
    space: [N, D_total] table of row ids into the stacked per-slot edge-row
    matrix (slot k's edge e ↦ row k*E + e), sentinel-padded with
    n_slots*E. One gather through this table accumulates every slot's
    contributions at once; gather cost is per row, so slots (and unknown
    channels) are packed into shared rows.
    """
    import numpy as np

    E = idx_list[0].shape[0]
    all_idx = np.concatenate([np.asarray(i) for i in idx_list])
    rows = np.concatenate(
        [k * E + np.arange(E, dtype=np.int64) for k in range(len(idx_list))]
    )
    order = np.argsort(all_idx, kind="stable")
    sorted_v = all_idx[order]
    counts = np.bincount(all_idx, minlength=num_vertices)
    d_max = int(counts.max()) if len(all_idx) else 1
    table = np.full((num_vertices, max(1, d_max)), len(idx_list) * E, np.int32)
    starts = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(all_idx)) - starts[sorted_v]
    table[sorted_v, pos] = rows[order]
    return table


def combined_cross_table(idx_list, num_vertices: int, inc=None):
    """[N, D_tot, m-1] cross-endpoint vertex ids for the combined-incidence
    table over m same-space slots: where ``inc[v, d]`` holds slot k's edge e
    (row k*E+e), entry ``j`` is ``idx_{(k+1+j) mod m}[e]`` — the vertices
    whose p-values feed the cross coupling blocks, in fixed rotation order
    (the stacked block array uses the same rotation). Sentinel entries map
    to ``num_vertices`` (a zero row in the extended p array).

    One gather through this table replaces the m·(m-1) per-ordered-slot-pair
    ELL gathers: all cross endpoints of a vertex's incidences share rows.
    """
    import numpy as np

    m = len(idx_list)
    if inc is None:
        inc = combined_incidence_table(idx_list, num_vertices)
    if m == 1:
        return np.zeros(inc.shape + (0,), np.int32)
    E = idx_list[0].shape[0]
    idx_arr = np.stack([np.asarray(i) for i in idx_list])  # [m, E]
    k = inc // E  # sentinel (m*E) -> m
    e = inc % E
    out = np.empty(inc.shape + (m - 1,), np.int32)
    for j in range(m - 1):
        kk = (k + 1 + j) % m
        out[:, :, j] = np.where(k >= m, num_vertices, idx_arr[kk, e])
    return out


def dia_split(
    cross,
    num_vertices: int,
    max_offsets: int = 16,
    min_coverage: float = 0.2,
    min_offset_share: float = 0.01,
):
    """Split the combined cross table into DIA offsets + a gather remainder.

    The CG-loop cross-coupling p-read is a per-row gather (latency-bound,
    ~85% of a graph CG iteration at 36k vertices). For meshes whose vertex
    numbering has locality (grids row-major, irregular meshes after RCM-ish
    ordering), most cross-endpoints sit at a few fixed vertex-id offsets
    δ = u − v; those incidences can read p by a SHIFT of the packed vertex
    array — no gather — leaving a small irregular remainder.

    Every covered incidence strictly removes gather rows at the cost of one
    cheap shifted multiply-add, so partial coverage still pays: offsets are
    kept while each covers at least ``min_offset_share`` of incidences (up
    to ``max_offsets``), and the split activates when they jointly cover
    ``min_coverage``. Returns (offsets, masks, rem_pos, rem_cross) or None:

    * offsets: list of int δ.
    * masks: [len(offsets), N, D, m-1] float32 — incidence (v, d, j)
      assigned to offset k (each incidence assigned at most once).
    * rem_pos: [N, D_rem] int32 positions into the flattened (d, j) axis
      (sentinel D·(m-1)) for unassigned incidences.
    * rem_cross: [N, D_rem] int32 cross vertex ids (sentinel N).
    """
    import numpy as np

    cross = np.asarray(cross)
    n, d_tot, mm1 = cross.shape
    if mm1 == 0 or n == 0:
        return None
    v_ids = np.arange(n, dtype=np.int64)[:, None, None]
    valid = cross < num_vertices
    delta = cross.astype(np.int64) - v_ids
    total = int(valid.sum())
    if total == 0:
        return None
    vals, counts = np.unique(delta[valid], return_counts=True)
    order = np.argsort(-counts)
    offsets, masks = [], []
    covered = np.zeros_like(valid)
    cov_count = 0
    for i in order[:max_offsets]:
        if counts[i] < min_offset_share * total:
            break
        δ = int(vals[i])
        m = valid & (delta == δ) & ~covered
        covered |= m
        cov_count += int(m.sum())
        offsets.append(δ)
        masks.append(m.astype(np.float32))
    if not offsets or cov_count < min_coverage * total:
        return None
    rem = valid & ~covered
    flat = rem.reshape(n, -1)
    d_rem = int(flat.sum(1).max()) if flat.any() else 0
    if d_rem:
        take = np.argsort(~flat, axis=1, kind="stable")[:, :d_rem]
        have = np.take_along_axis(flat, take, axis=1)
        rem_pos = np.where(have, take, d_tot * mm1).astype(np.int32)
        rem_cross = np.where(
            have,
            np.take_along_axis(cross.reshape(n, -1), take, axis=1),
            num_vertices,
        ).astype(np.int32)
    else:
        rem_pos = np.zeros((n, 0), np.int32)
        rem_cross = np.zeros((n, 0), np.int32)
    return offsets, np.stack(masks), rem_pos, rem_cross


def dedup_reads(pos, cross, num_vertices: int, pos_sentinel: int):
    """Merge duplicate (vertex, cross-endpoint) reads of a remainder table.

    The CG-loop cross apply gathers one packed-p row per (v, d) entry of
    ``cross`` — a latency-bound per-row cost. Multi-slot graphs read the
    same endpoint several times per vertex (an ARAP mesh's combined table
    holds every neighbor u of v TWICE: once from the (v,u) edge where v is
    the center slot and once from the (u,v) edge where v is the neighbor
    slot — reference kernels scatter per edge instead and pay atomics,
    solverGPUGaussNewton.t:684-706). Merging those reads halves the gather
    rows; the coupling blocks of merged entries pre-sum at assembly time
    through the returned position table.

    ``pos``: [N, D] int32 flat positions (sentinel ``pos_sentinel``).
    ``cross``: [N, D] int32 endpoint ids (sentinel ``num_vertices``).
    Returns ``(pos_k [N, Dm, K], cross2 [N, Dm])`` with position sentinel
    preserved, or ``None`` when no row contains duplicates (the merged
    table would be the input with a trailing K=1 axis).
    """
    import numpy as np

    pos = np.asarray(pos)
    cross = np.asarray(cross)
    n, d = cross.shape
    if d == 0 or n == 0:
        return None
    order = np.argsort(cross, axis=1, kind="stable")  # sentinels sort last
    sc = np.take_along_axis(cross, order, 1)
    sp = np.take_along_axis(pos, order, 1)
    valid = sc < num_vertices
    new_grp = np.ones((n, d), bool)
    new_grp[:, 1:] = sc[:, 1:] != sc[:, :-1]
    i_idx = np.broadcast_to(np.arange(d), (n, d))
    run_start = np.maximum.accumulate(np.where(new_grp, i_idx, 0), axis=1)
    k_idx = i_idx - run_start
    if not (valid & (k_idx > 0)).any():
        return None
    grp = np.cumsum(new_grp & valid, axis=1) - 1  # group index within row
    d_m = int((new_grp & valid).sum(1).max())
    k_max = int(k_idx[valid].max()) + 1
    pos_k = np.full((n, d_m, k_max), pos_sentinel, np.int32)
    cross2 = np.full((n, d_m), num_vertices, np.int32)
    rr, cc = np.nonzero(valid)
    pos_k[rr, grp[valid], k_idx[valid]] = sp[valid]
    cross2[rr, grp[valid]] = sc[valid]
    return pos_k, cross2


def ell_tables(idx_by_slot, num_vertices_by_slot, width_bucket=None):
    """ELL-format tables for gather-only JᵀJ application.

    For each slot k: ``inc[k]`` = [N_k, D_k] edge ids incident to each vertex
    (sentinel E). For each ordered slot pair (k_out, k_in):
    ``ell[(k_out, k_in)][v, d] = idx_k_in[inc_k_out[v, d]]`` (sentinel
    N_k_in) — the vertex whose p-value feeds row (v, d). Same-slot pairs are
    omitted: ``idx_k[inc_k[v, d]] == v`` identically, so their apply is a
    broadcast of p[v], no gather at all. This turns the accumulation side of
    the per-edge JᵀJ into plain reshapes + reductions; only cross-slot
    couplings gather, and they gather from the small [N, C] vertex array
    instead of the [E, C] edge array.
    """
    import numpy as np

    inc = {
        k: incidence_table(np.asarray(i), num_vertices_by_slot[k])
        for k, i in idx_by_slot.items()
    }
    if width_bucket is not None:
        # dynamic topology: bucket the incidence width so topologies with
        # nearby max-degree share one trace; sentinel rows (edge id E) flow
        # through the ell derivation below to the vertex sentinel N_ki
        inc = {
            k: pad_table_width(
                t,
                width_bucket(t.shape[1]),
                np.asarray(idx_by_slot[k]).shape[0],
            )
            for k, t in inc.items()
        }
    ell = {}
    for ko, tko in inc.items():
        E = np.asarray(idx_by_slot[ko]).shape[0]
        for ki, iki in idx_by_slot.items():
            if ki == ko:
                continue
            idx_ext = np.concatenate(
                [np.asarray(iki), [num_vertices_by_slot[ki]]]
            ).astype(np.int32)
            ell[(ko, ki)] = idx_ext[np.minimum(tko, E)]
    return inc, ell


def incidence_table(idx, num_vertices: int):
    """Transpose of an edge->vertex index list: [N, D_max] table of edge ids
    incident to each vertex, padded with the sentinel E (= len(idx)).

    Host-side preprocessing of the static graph that converts the solver's
    per-edge scatter-adds into gathers (out[v] = Σ_d contrib[inc[v, d]]) —
    the atomics-free analogue of the reference's atomicAdd accumulation
    (o.t:2092-2126); not yet measured against atomics on the H100
    (ROADMAP design item 3). The reference's
    CSR converter createGraphFromNeighborLists (OptGraph.h:64-75) does the
    inverse transform on the CPU for the same reason: structure is static.
    """
    import numpy as np

    idx = np.asarray(idx)
    E = idx.shape[0]
    order = np.argsort(idx, kind="stable")
    sorted_v = idx[order]
    counts = np.bincount(idx, minlength=num_vertices)
    d_max = int(counts.max()) if E else 1
    table = np.full((num_vertices, max(1, d_max)), E, np.int32)
    starts = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # position of each sorted edge within its vertex's run
    pos = np.arange(E) - starts[sorted_v]
    table[sorted_v, pos] = order
    return table
