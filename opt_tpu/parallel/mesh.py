"""Multi-chip sharding: device meshes and sharding rules for solver state.

The reference is single-GPU, single-stream (SURVEY.md §2.4) — this module is
new design with no reference counterpart. Strategy (BASELINE.json north_star):

* grid index spaces shard by spatial tiles over a 2-D ('gx','gy') mesh; the
  zero-padded shift ops in ops/shift.py lower to XLA SPMD halo exchanges over
  collective permutes automatically, so stencil JᵀJp needs no hand-written
  communication.
* graph index spaces shard hyperedges over the flattened mesh; vertex arrays
  (unknowns) shard by contiguous owner blocks along axis 0, and the ELL/
  incidence tables (problem.Plan._augment_incidence) shard by the same
  blocks — each device owns a vertex range plus the accumulation rows that
  produce it. Every irregular cross-device read — the CG-loop
  cross-endpoint p reads, the per-GN-step assembly/JᵀF edge-row gathers,
  and the residual/probe per-edge vertex reads — rides a bind-time
  precomputed all_to_all exchange (halo_gather / halo_gather_parts /
  slot_halo_gather below) whose volume is the partition boundary, so the
  compiled graph solve contains no all-gather. Odd sizes fall back to
  replication (perf, not correctness).
* CG dot products / costs are plain jnp.sum — XLA inserts the psum.

Everything runs through ``jax.jit`` with sharding constraints; there is no
shard_map requirement, so single-device plans are the mesh=None special case
of the same code path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

GRID_AXES = ("gx", "gy")


def make_mesh(
    devices=None, shape: Optional[Tuple[int, int]] = None, axis_names=GRID_AXES
) -> Mesh:
    """Build a 2-D tiling mesh over the given (or all) devices.

    shape defaults to the most-square factorization of the device count so
    halo surface is minimized for 2-D grids.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names)


class ShardingRules:
    """Maps problem tensors to NamedShardings over a mesh."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def _spec_for_image(
        self, ispace_ndim: int, shape=None, channels_axis: bool = True
    ) -> P:
        if self.mesh is None:
            return P()
        ax = list(self.mesh.axis_names)
        if ispace_ndim >= 2:
            spec = [ax[0], ax[1]] + [None] * (ispace_ndim - 2)
            # NamedSharding requires dims divisible by their mesh axis; for
            # odd problem sizes replicate along the offending axis instead of
            # failing (perf, not correctness, is at stake).
            if shape is not None:
                for d in (0, 1):
                    axis = spec[d]
                    if axis is not None:
                        size = self.mesh.shape[axis]
                        if shape[d] % size != 0:
                            spec[d] = None
        else:
            # 1-D (graph vertex) spaces: owner-block sharding over the
            # flattened mesh; replicate when the count doesn't divide
            spec = [tuple(ax)] + [None] * (ispace_ndim - 1)
            if shape is not None and shape[0] % self.mesh.size != 0:
                spec[0] = None
        if channels_axis:
            spec = spec + [None]
        return P(*spec)

    def _spec_for_edges(self) -> P:
        if self.mesh is None:
            return P()
        # shard hyperedges over the whole mesh (flattened)
        return P(tuple(self.mesh.axis_names))

    def image_sharding(self, ispace_ndim: int, shape=None) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self._spec_for_image(ispace_ndim, shape))

    def edge_sharding(self) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self._spec_for_edges())

    # -- application -------------------------------------------------------
    def place_inputs(self, compiled, unknowns, consts, graphs):
        """device_put inputs with their target shardings (host->device once,
        like the reference's cudaMalloc+memcpy at init, o.t:593-632)."""
        if self.mesh is None:
            return unknowns, consts, graphs
        u2, c2, g2 = {}, {}, {}
        for name, arr in unknowns.items():
            nd = compiled.registry.images[name].ispace.ndim
            u2[name] = jax.device_put(arr, self.image_sharding(nd, arr.shape))
        for name, arr in consts.items():
            nd = compiled.registry.images[name].ispace.ndim
            c2[name] = jax.device_put(arr, self.image_sharding(nd, arr.shape))
        for gname, slots in graphs.items():
            g2[gname] = {}
            for s, i in slots.items():
                if s.startswith("__"):
                    # vertex-shaped incidence/ELL tables ([N, D]) shard by
                    # the same owner blocks as the vertex arrays they
                    # accumulate into; replicate odd counts
                    if i.shape[0] % self.mesh.size == 0:
                        es = NamedSharding(
                            self.mesh, P(tuple(self.mesh.axis_names), None)
                        )
                    else:
                        es = NamedSharding(self.mesh, P())
                else:
                    es = self.edge_sharding()
                    if i.shape[0] % self.mesh.size != 0:
                        es = NamedSharding(self.mesh, P())  # replicate odd counts
                g2[gname][s] = jax.device_put(i, es)
        return u2, c2, g2

    def constrain_unknowns(self, compiled, X: Dict[str, jnp.ndarray]):
        """with_sharding_constraint on the unknown pytree inside jit, so the
        whole solver state inherits tile sharding."""
        if self.mesh is None:
            return X
        out = {}
        for name, arr in X.items():
            nd = compiled.registry.images[name].ispace.ndim
            out[name] = jax.lax.with_sharding_constraint(
                arr, self.image_sharding(nd, arr.shape)
            )
        return out


# ---------------------------------------------------------------------------
# Owner-block neighbor exchange for graph cross-endpoint reads
# ---------------------------------------------------------------------------
#
# The assembled graph JᵀJ·p reads p at cross-endpoint vertex ids through an
# irregular table (assembly.py remainder/full-cross branches). Under owner-
# block sharding a global ``jnp.take`` makes XLA SPMD all-gather the whole
# packed p every CG iteration — O(N) collective volume. These helpers
# replace it with a neighbor exchange whose volume is the BOUNDARY size:
# each device sends exactly the p-rows other devices reference
# (deduplicated, precomputed at bind time) through one ``all_to_all``, then
# gathers locally from [own block | received halo]. DIA-covered offsets
# already lower to shifts (collective-permute of block edges); this finishes
# the irregular remainder. No reference counterpart (single-GPU reference;
# BASELINE.json north_star).


def build_halo_tables(cross, num_vertices: int, ndev: int, m_bucket=None):
    """Precompute the exchange schedule for an id table (host-side, numpy).

    cross: int array [R, ...] of global SOURCE-row ids, sentinel =
    num_vertices. The requester rows (axis 0, R of them) and the source
    rows (num_vertices of them) may live in different block-sharded spaces
    — e.g. vertex-owner rows requesting edge-block rows for the
    per-GN-step assembly gathers; for the CG-loop p reads the two spaces
    coincide (R == num_vertices).
    Returns dict(send [ndev, ndev, M] int32 sender-local indices (sentinel
    B), loc [R, ...] localized ids into [own source block (B) | halo
    (ndev*M) | zero row], M) — or None when R or num_vertices doesn't
    divide ndev (those configs replicate, see
    ShardingRules._spec_for_image).
    """
    cross = np.asarray(cross)
    n = num_vertices
    R = cross.shape[0]
    if ndev <= 1 or n % ndev != 0 or R % ndev != 0:
        return None
    B = n // ndev  # source block size
    Br = R // ndev  # requester block size
    owner = np.clip(cross // B, 0, ndev - 1)
    row_dev = (np.arange(R) // Br).reshape(
        (-1,) + (1,) * (cross.ndim - 1)
    )
    valid = cross < n
    remote = valid & (owner != row_dev)

    # Fully vectorized (id loops over boundary entries cost O(boundary)
    # Python-time at large graphs/device counts): the unique (requester d,
    # source s, global id g) triples are one np.unique over a packed key
    # sorted by (d, s, g), so each (d, s) group is contiguous with ids
    # ascending, matching the per-group np.unique of the loop formulation
    # bit for bit.
    d_all = np.broadcast_to(row_dev, cross.shape)[remote].astype(np.int64)
    g_all = cross[remote].astype(np.int64)
    s_all = g_all // B
    key = (d_all * ndev + s_all) * n + g_all
    uk = np.unique(key)
    grp = uk // n  # = d * ndev + s
    g_u = uk % n
    counts = np.bincount(grp, minlength=ndev * ndev)
    M = int(counts.max()) if len(uk) else 0
    Mp = max(1, M)
    if m_bucket is not None:
        # dynamic topology: bucket the per-pair exchange width so
        # topologies in the same bucket share one trace (sentinel rows
        # send the zero row); M is the ONLY topology-varying shape here —
        # loc inherits cross's (already bucketed) shape
        Mp = int(m_bucket(Mp))

    starts = np.zeros(ndev * ndev + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(uk)) - starts[grp]  # index within each (d,s) group
    d_u = grp // ndev
    s_u = grp % ndev

    send = np.full((ndev, ndev, Mp), B, np.int32)
    send[s_u, d_u, slot] = (g_u - s_u * B).astype(np.int32)
    halo_index = (B + s_u * Mp + slot).astype(np.int32)

    # localization: own-block reads index the local block, remote reads
    # look up their (d, s, g) triple in uk (every remote entry is present
    # by construction), sentinels hit the zero row past the halo
    sentinel_loc = B + ndev * Mp
    loc = np.full(cross.shape, sentinel_loc, np.int32)
    own = valid & (owner == row_dev)
    loc[own] = (cross[own] - np.broadcast_to(row_dev, cross.shape)[own] * B
                ).astype(np.int32)
    if len(uk):
        dq = np.broadcast_to(row_dev, cross.shape)[remote].astype(np.int64)
        gq = cross[remote].astype(np.int64)
        q = (dq * ndev + gq // B) * n + gq
        loc[remote] = halo_index[np.searchsorted(uk, q)]
    return {"send": send, "loc": loc, "M": Mp}


_FLAT_MESH_CACHE: dict = {}


def _flat_mesh(mesh: Mesh) -> Mesh:
    """1-axis view of the mesh in row-major device order — the same
    placement as P((ax0, ax1)) block sharding, so resharding into the
    shard_map is a no-op."""
    key = tuple(d.id for d in mesh.devices.flat)
    got = _FLAT_MESH_CACHE.get(key)
    if got is None:
        got = Mesh(mesh.devices.reshape(-1), ("gv",))
        _FLAT_MESH_CACHE[key] = got
    return got


def map_stacked_rows_device_major(inc, E: int, m: int, ndev: int):
    """Re-index a combined-incidence table (ids k·E+e into m slot-major
    stacked edge-row blocks, sentinel m·E — ops/graph_ops.py
    combined_incidence_table) into DEVICE-major row order, so that
    contiguous owner blocks match what each device assembles locally from
    its own edge shards: device d's source block is [slot-0 rows of its
    edges | slot-1 rows | …], i.e. row (k, e) ↦ d·(m·E_b) + k·E_b +
    (e mod E_b) with d = e // E_b, E_b = E/ndev. Sentinel preserved.
    Returns the mapped table, or None when E doesn't divide ndev."""
    inc = np.asarray(inc)
    if ndev <= 1 or E % ndev != 0:
        return None
    Eb = E // ndev
    k = inc // E
    e = inc % E
    mapped = (e // Eb) * (m * Eb) + k * Eb + (e % Eb)
    return np.where(inc >= m * E, m * E, mapped).astype(np.int64)


def halo_gather_parts(mesh: Mesh, parts, send: jnp.ndarray,
                      loc: jnp.ndarray) -> jnp.ndarray:
    """Row-read through a localized id table with one all_to_all exchange.

    parts: list of [Rows_i, C] block-sharded arrays whose PER-DEVICE shards,
    concatenated in list order, form each device's local source block —
    for a single vertex array that is just [pp]; for the per-GN-step
    assembly gathers the parts are the m per-slot edge-row matrices and
    ``loc`` comes from :func:`build_halo_tables` applied to the
    device-major-mapped incidence table
    (:func:`map_stacked_rows_device_major`).
    send/loc: tables from :func:`build_halo_tables` (device-resident).
    Returns [*loc.shape, C].
    Collective volume = ndev²·M·C ≈ total boundary size, independent of
    the source row count.
    """
    try:
        from jax import shard_map  # jax >= 0.8
        _rep_kw = {"check_vma": False}
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map
        _rep_kw = {"check_rep": False}
    from jax.sharding import PartitionSpec

    fm = _flat_mesh(mesh)
    C = parts[0].shape[-1]

    def body(*args):
        send_me, loc_blk = args[-2:]
        blk = (
            jnp.concatenate(args[:-2], axis=0)
            if len(args) > 3
            else args[0]
        )
        pp_ext = jnp.concatenate(
            [blk, jnp.zeros((1, C), blk.dtype)], axis=0
        )
        # what I owe each requester: [ndev, M, C]
        out_buf = jnp.take(pp_ext, send_me[0], axis=0)
        recv = jax.lax.all_to_all(
            out_buf, "gv", split_axis=0, concat_axis=0, tiled=False
        )  # [ndev, M, C]: recv[s] = values of my requests owned by s
        p_full = jnp.concatenate(
            [blk, recv.reshape(-1, C), jnp.zeros((1, C), blk.dtype)],
            axis=0,
        )
        flat = jnp.take(p_full, loc_blk.reshape(-1), axis=0)
        return flat.reshape(loc_blk.shape + (C,))

    P_ = PartitionSpec
    return shard_map(
        body,
        mesh=fm,
        in_specs=(P_("gv"),) * (len(parts) + 2),
        out_specs=P_("gv"),
        **_rep_kw,
    )(*parts, send, loc)


def slot_halo_gather(mesh, arr, g_dict, slot):
    """Per-edge vertex-array read X[idx] through the bind-time per-slot
    exchange tables ("__halo_send____slot_<s>" / "__halo_loc____slot_<s>",
    problem.Plan._augment_incidence), or None when the tables are absent
    (odd sizes replicate) or ``arr`` is not a plain [N, C] vertex array
    (e.g. batched solves). Replaces the residual/probe evaluation's
    ``jnp.take`` — which XLA SPMD lowers to an all-gather of the whole
    vertex array per evaluation — with a boundary-sized all_to_all. Its
    jvp is the same exchange on tangents and its linear transpose is the
    reverse exchange (the scatter-add back to owners), so JᵀF / JᵀJ·p
    derived by jax.linearize/linear_transpose ride the exchange too."""
    if mesh is None or getattr(mesh, "size", 1) <= 1 or arr.ndim != 2:
        return None
    send = g_dict.get("__halo_send____slot_" + slot)
    loc = g_dict.get("__halo_loc____slot_" + slot)
    if send is None or loc is None:
        return None
    return halo_gather(mesh, arr, send, loc)[:, 0, :]


def grouped_slot_halo_gather(mesh, items, g_dict, slot):
    """Serve several [N, C_i] vertex arrays' per-edge reads at ONE
    (graph, slot) with one exchange by channel-stacking: collective
    latency is per-op, and e.g. ARAP reads three arrays (Offset,
    Angle, UrShape) at each endpoint slot. ``items`` = [(name, arr)].
    Returns {name: [E, C_i]} or None when the tables are absent / an
    array is not a plain [N, C] (callers fall back to per-array takes).
    Arrays of different dtypes stack per dtype group."""
    if mesh is None or getattr(mesh, "size", 1) <= 1:
        return None
    send = g_dict.get("__halo_send____slot_" + slot)
    loc = g_dict.get("__halo_loc____slot_" + slot)
    if send is None or loc is None:
        return None
    groups = {}
    for name, arr in items:
        if arr.ndim != 2:
            return None
        groups.setdefault(jnp.dtype(arr.dtype).name, []).append((name, arr))
    out = {}
    for grp in groups.values():
        cat = (
            grp[0][1]
            if len(grp) == 1
            else jnp.concatenate([a for _, a in grp], axis=-1)
        )
        got = halo_gather(mesh, cat, send, loc)[:, 0, :]
        off = 0
        for name, a in grp:
            out[name] = got[:, off : off + a.shape[-1]]
            off += a.shape[-1]
    return out


def slot_halo_scatter_add(mesh, ct, num_rows: int, g_dict, slot):
    """Transpose of :func:`slot_halo_gather`: accumulate per-edge values
    ct [E, C] into a [num_rows, C] vertex array (out[idx[e]] += ct[e])
    through the reverse exchange. Returns None when the tables are absent."""
    if mesh is None or getattr(mesh, "size", 1) <= 1:
        return None
    send = g_dict.get("__halo_send____slot_" + slot)
    loc = g_dict.get("__halo_loc____slot_" + slot)
    if send is None or loc is None:
        return None
    import jax as _jax

    f = lambda x: halo_gather(mesh, x, send, loc)
    t = _jax.linear_transpose(
        f, _jax.ShapeDtypeStruct((num_rows, ct.shape[-1]), ct.dtype)
    )
    return t(ct[:, None, :])[0]


def halo_gather(mesh: Mesh, pp: jnp.ndarray, send: jnp.ndarray,
                loc: jnp.ndarray) -> jnp.ndarray:
    """p-read through a localized id table with one all_to_all exchange.

    pp: [N, C] owner-block-sharded packed vertex values.
    send/loc: tables from :func:`build_halo_tables` (device-resident).
    Returns [*loc.shape, C].
    Collective volume = ndev²·M·C ≈ total boundary size, independent of N.
    """
    return halo_gather_parts(mesh, [pp], send, loc)
