"""User-facing Problem / Plan lifecycle.

Mirrors the reference C API surface (API/release/include/Opt.h:35-71:
Opt_ProblemDefine / Opt_ProblemPlan / Opt_ProblemInit / Opt_ProblemStep /
Opt_ProblemSolve / Opt_ProblemCurrentCost / Opt_SetSolverParameter) as a
pythonic object API. ``opt_tpu.api`` provides the literal function-style
wrappers on top of this.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .compile import CompiledProblem, compile_spec
from .spec import SpecError
from .solver.gauss_newton import GaussNewtonSolver
from .solver.params import InitializationParameters, normalize_solver_params

_KIND_ALIASES = {
    "gaussnewtongpu": False,
    "gauss_newton": False,
    "gn": False,
    "lmgpu": True,
    "lm": True,
    "levenberg_marquardt": True,
}


def _uses_lambda(kind: str) -> bool:
    k = kind.lower()
    if k not in _KIND_ALIASES:
        raise ValueError(
            f"unknown solver kind {kind!r}; expected gaussNewtonGPU or LMGPU "
            "(reference o.t:122)"
        )
    return _KIND_ALIASES[k]


@dataclasses.dataclass
class BatchedSolveResult:
    """Results of a batched solve: every field has a leading batch axis."""

    unknowns: Dict[str, jnp.ndarray]
    final_costs: np.ndarray  # [B]
    costs: np.ndarray  # [B, nIterations] (NaN-padded past each instance's exit)
    num_iterations: np.ndarray  # [B]
    num_linear_iterations: np.ndarray  # [B]
    wall_time_s: float = 0.0


@dataclasses.dataclass
class SolveResult:
    unknowns: Dict[str, jnp.ndarray]
    final_cost: float
    costs: List[float]  # cost after each nonlinear iteration
    num_iterations: int
    wall_time_s: float
    num_linear_iterations: int = 0  # PCG iterations actually executed


class Problem:
    """A problem definition: a spec function (Opt_ProblemDefine analogue)."""

    def __init__(self, spec_fn, kind: str = "gaussNewtonGPU", name: Optional[str] = None):
        self.spec_fn = spec_fn
        self.kind = kind
        self.name = name or getattr(spec_fn, "__name__", "problem")

    def plan(
        self,
        dims: Dict[str, int],
        kind: Optional[str] = None,
        double_precision: bool = False,
        init_params: Optional[InitializationParameters] = None,
        mesh=None,
        dynamic_topology: Optional[bool] = None,
        **solver_params,
    ) -> "Plan":
        """Compile for concrete grid sizes (Opt_ProblemPlan, o.t:861-882).

        Unlike the reference — which re-runs DSL parsing + symbolic autodiff +
        Terra->PTX per size — this only re-traces Python; XLA compilation is
        deferred to first execution and cached per shape."""
        dtype = jnp.float64 if double_precision else jnp.float32
        if double_precision and not jax.config.read("jax_enable_x64"):
            raise RuntimeError(
                "double_precision=True requires jax x64; call "
                "opt_tpu.enable_double_precision() before creating arrays"
            )
        compiled = compile_spec(self.spec_fn, dims, dtype)
        if dynamic_topology is not None:
            init_params = dataclasses.replace(
                init_params or InitializationParameters(),
                dynamic_topology=bool(dynamic_topology),
            )
        return Plan(self, compiled, kind or self.kind, init_params, solver_params, mesh)


_HLO_DUMP_COUNTER = 0  # verbosity>=3 dump files, numbered per plan


class Plan:
    def __init__(
        self, problem, compiled: CompiledProblem, kind, init_params, solver_params,
        mesh=None,
    ):
        from .parallel.mesh import ShardingRules

        self.problem = problem
        self.compiled = compiled
        self.kind = kind
        self.uses_lambda = _uses_lambda(kind)
        self.rules = ShardingRules(mesh) if mesh is not None else None
        self.solver = GaussNewtonSolver(
            compiled, self.uses_lambda, init_params, sharding_rules=self.rules
        )
        self.solver_params = normalize_solver_params(solver_params)
        self.dynamic_topology = bool(
            getattr(self.solver.ip, "dynamic_topology", False)
        )
        er = getattr(self.solver.ip, "edge_reorder", False)
        if er not in (False, None, "owner"):
            raise ValueError(
                f"edge_reorder={er!r}: the only implemented mode is "
                "\"owner\" (or False to disable)"
            )
        self._state = None
        self._bound = None  # (consts, graphs, params)
        self._fused_validated = False
        # None while the assembled operator is in use; "validation" after
        # _validate_fused dropped this plan to the composed path
        self.fused_fallback = None

    @property
    def cg_path(self):
        """The CG apply the last traced solve ran: "triton" (the stencil
        kernel, ops/stencil_kernel.py), "interpret" (the same kernel
        through the Pallas interpreter) or "xla"; None before any solve.
        ``cg_path_reason`` says why the kernel did not run."""
        return self.solver.cg_path

    @property
    def cg_path_reason(self):
        return self.solver.cg_path_reason

    def _validate_fused(self, unknowns, consts, graphs, params) -> None:
        """First-bind safety net for the assembled JᵀJ: compare
        one random-vector apply of the assembled operator against the
        composed Jᵀ(J·p) at the real inputs; on mismatch drop to the
        composed path for this plan. Must run before the first traced
        solve/step so the jit caches trace the surviving path."""
        if self._fused_validated or self.solver._stencil_plan is None:
            return
        self._fused_validated = True
        if not getattr(self.solver.ip, "validate_fused_jtj", True):
            return
        if not self.solver.validate_assembly(unknowns, consts, graphs, params):
            from .utils.logging import log_solver

            log_solver(
                "fused JtJ failed real-inputs validation (probe-pruned "
                "coupling, or a contraction at reduced precision?); "
                "plan.fused_fallback='validation': falling back to the "
                "composed operator"
            )
            self.solver._stencil_plan = None
            # surfaced so harnesses/benches can detect the (much slower)
            # composed fallback instead of mis-attributing the perf
            self.fused_fallback = "validation"

    def _note_unknown_sentinels(self, inputs) -> None:
        """Record +-inf invalid-markers in unknown inputs so results can
        restore them. Reference apps mark invalid entries with +-inf (SFS
        invalid depths); normalize_inputs clamps them to finite sentinels
        for NaN-free autodiff, and since Exclude-frozen rows never update
        (solverGPUGaussNewton.t:371 exclude gating), the markers are
        restored verbatim on output — matching the reference, whose kernels
        simply never touch those pixels."""
        import numpy as _np

        # memo holds the keyed input object itself (not its id()): a dead
        # object's id can be reused by a fresh array, which would return a
        # stale inf-mask (the id-reuse class fixed for the scheduled-solve
        # cache in solve_scheduled). One held leaf per unknown name.
        memo = self.__dict__.setdefault("_sentinel_memo", {})
        found = {}
        for name in self.compiled.unknown_names:
            v = inputs.get(name)
            if v is None:
                continue
            hit = memo.get(name)
            if hit is not None and hit[0] is v:
                if hit[1] is not None:
                    found[name] = hit[1]
                continue
            if isinstance(v, jax.Array):
                # device-resident leaf (e.g. the harness writing result
                # unknowns back between outer solves): np.asarray would pull
                # the full array to host on every bind — scan device-side
                # and sync one scalar instead.
                a = v
                has_inf = jnp.issubdtype(v.dtype, jnp.floating) and bool(
                    jnp.isinf(v).any()
                )
            else:
                a = _np.asarray(v)
                has_inf = a.dtype.kind == "f" and bool(_np.isinf(a).any())
            orig = None
            if has_inf:
                if a.ndim == self.compiled.registry.images[name].ispace.ndim:
                    a = a[..., None]
                orig = jnp.asarray(a, self.compiled.dtype)
                found[name] = orig
            memo[name] = (v, orig)
        self._unk_sentinels = found

    def _restore_sentinels(self, X):
        masks = self.__dict__.get("_unk_sentinels") or {}
        if not masks:
            return X
        out = dict(X)
        for name, orig in masks.items():
            out[name] = jnp.where(jnp.isinf(orig), orig, out[name])
        return out

    def _normalize_and_place(self, inputs):
        """Convert + augment + place inputs, cached PER LEAF by object
        identity. Each host->device conversion pays a dispatch round-trip,
        and the common patterns
        (repeated benchmark solves; pyramid/annealing loops that swap only
        a few arrays between solves) leave most leaves untouched, so only
        changed leaves re-convert. Callers that mutate an input array IN
        PLACE (same object, new contents) must pass a fresh array instead
        — the normal JAX contract."""
        self._note_unknown_sentinels(inputs)
        cache = self.__dict__.get("_leaf_cache")
        buckets = self.__dict__.get("_leaf_buckets")
        if cache is None or set(cache) != set(inputs):
            unknowns, consts, graphs, params = self.compiled.normalize_inputs(
                inputs
            )
            graphs = self._augment_incidence(graphs)
            if self.rules is not None:
                unknowns, consts, graphs = self.rules.place_inputs(
                    self.compiled, unknowns, consts, graphs
                )
            self._leaf_cache = dict(inputs)
            self._leaf_buckets = (unknowns, consts, graphs, params)
            return (dict(unknowns), dict(consts), dict(graphs), dict(params))
        changed = {k: v for k, v in inputs.items() if cache[k] is not v}
        if changed:
            u, c, g, p = self.compiled.normalize_inputs(changed, partial=True)
            if g:
                g = self._augment_incidence(g)
            if self.rules is not None:
                u, c, g = self.rules.place_inputs(self.compiled, u, c, g)
            buckets[0].update(u)
            buckets[1].update(c)
            buckets[2].update(g)
            buckets[3].update(p)
            cache.update(changed)
        return tuple(dict(b) for b in buckets)

    def _pad_dynamic(self, graphs):
        """Pad graph edge axes to power-of-two buckets (dynamic_topology).

        Padded edges get round-robin in-bounds vertex ids and a zero entry
        in the (always-present) ``valid`` mask, so they contribute nothing
        to J, JᵀF, the diagonal, the assembled blocks or the cost — the
        exact edge-mask semantics (compile.graph_term_scales, tested by
        tests/test_edge_mask.py). Round-robin ids spread the padded edges'
        incidences across vertices so no single vertex's incidence width
        inflates. The mask is injected even at exact bucket sizes so the
        trace signature (pytree structure) is identical across frames.
        Reference analogue: runtime edge count, util.t:728."""
        from .ops.graph_ops import bucket_size

        if not graphs:
            return graphs
        out = {}
        for gname, slots in graphs.items():
            if any(k.startswith("__") for k in slots):
                out[gname] = slots
                continue
            gdecl = self.compiled.registry.graphs[gname]
            slot_names = [s for s in slots if s != "valid"]
            if not slot_names:
                out[gname] = slots
                continue
            E = int(slots[slot_names[0]].shape[0])
            Eb = bucket_size(E, minimum=8)
            gd = {}
            for s in slot_names:
                idx = np.asarray(slots[s])
                if Eb > E:
                    n = int(
                        np.prod(
                            gdecl.slots[s].shape(self.compiled.dim_sizes)
                        )
                    )
                    pad = (np.arange(Eb - E, dtype=np.int64) % n).astype(
                        idx.dtype
                    )
                    idx = np.concatenate([idx, pad])
                gd[s] = jnp.asarray(idx, jnp.int32)
            v = slots.get("valid")
            if v is None:
                vv = np.ones((E, 1), np.float64)
            else:
                vv = np.asarray(v, np.float64)
                if vv.ndim == 1:
                    vv = vv[:, None]
            if Eb > E:
                vv = np.concatenate(
                    [vv, np.zeros((Eb - E, vv.shape[1]), vv.dtype)]
                )
            gd["valid"] = jnp.asarray(vv, self.compiled.dtype)
            out[gname] = gd
        return out

    def _reorder_edges(self, graphs):
        """Bind-time edge renumbering for mesh locality (opt-in,
        InitializationParameters(edge_reorder="owner")): stable-sort each
        graph's edges by the device owner of their FIRST endpoint slot, so
        a device's edge shard mostly consists of edges whose accumulation
        target it owns. The per-GN-step device-major edge-row exchange
        (parallel/mesh.py) has collective volume set by edge-numbering
        alignment, not boundary size; owner sorting collapses it toward
        the true partition boundary. The energy is a sum over edges, so
        the solution is order-independent; only the float reduction order
        (and dumpJ's per-edge row order) changes — hence opt-in."""
        ndev = self.rules.mesh.size
        out = {}
        for gname, slots in graphs.items():
            if any(k.startswith("__") for k in slots):
                out[gname] = slots
                continue
            gdecl = self.compiled.registry.graphs[gname]
            slot_names = [s for s in sorted(slots) if s != "valid"]
            if not slot_names:
                out[gname] = slots
                continue
            first = slot_names[0]
            idx0 = np.asarray(slots[first])
            n0 = int(
                np.prod(gdecl.slots[first].shape(self.compiled.dim_sizes))
            )
            if n0 % ndev or idx0.shape[0] % ndev:
                out[gname] = slots  # replicated configs: nothing to align
                continue
            owner = idx0.astype(np.int64) // (n0 // ndev)
            perm = np.argsort(owner, kind="stable")
            out[gname] = {
                s: jnp.asarray(np.asarray(v)[perm]) for s, v in slots.items()
            }
        return out

    def _augment_incidence(self, graphs):
        """Attach the host-precomputed combined incidence table ("__inc__")
        so the assembled JᵀJ applies graph couplings as ONE channel-packed
        gather per graph instead of scatters (ops/graph_ops.py
        combined_incidence_table; gather cost is per row, so slots and
        unknown channels pack into the same rows). Cached by index data."""
        import hashlib

        from .ops.graph_ops import (
            combined_cross_table,
            combined_incidence_table,
            dia_split,
            ell_tables,
            slot_groups,
        )

        if not graphs:
            return graphs
        if self.dynamic_topology:
            graphs = self._pad_dynamic(graphs)
        if (
            self.rules is not None
            and self.rules.mesh is not None
            and self.rules.mesh.size > 1
            and getattr(self.solver.ip, "edge_reorder", False)
        ):
            graphs = self._reorder_edges(graphs)
        if not hasattr(self, "_inc_cache"):
            self._inc_cache = {}
        # dynamic topology: bucket the halo tables' per-pair width M too —
        # with the edge axis, incidence widths and M all bucketed, sharded
        # per-frame topologies share one trace as well
        from .ops.graph_ops import bucket_size as _bs_fn

        _mb = _bs_fn if self.dynamic_topology else None
        out = {}
        for gname, slots in graphs.items():
            gdecl = self.compiled.registry.graphs[gname]
            out[gname] = dict(slots)
            if any(k.startswith("__") for k in slots):
                continue  # caller already augmented
            all_names = sorted(gdecl.slots)
            if any(s not in slots for s in all_names):
                continue
            idxs = {s: np.asarray(slots[s]) for s in all_names}
            ckey = (
                gname,
                hashlib.sha1(
                    b"".join(idxs[s].tobytes() for s in all_names)
                ).hexdigest(),
            )
            cached = self._inc_cache.pop(ckey, None)
            if cached is not None:
                self._inc_cache[ckey] = cached  # LRU: re-insert at the end
            if cached is None:
                cached = {}
                # combined per-(vertex-space) tables: the incidence table
                # (JᵀF path + JᵀJ accumulation) and the cross-endpoint
                # vertex table (JᵀJ cross-coupling p reads)
                for group_key, names, n in slot_groups(
                    gdecl, self.compiled.dim_sizes
                ):
                    inc = combined_incidence_table(
                        [idxs[s] for s in names], n
                    )
                    if self.dynamic_topology:
                        # bucket the incidence width (sentinel m*E rows are
                        # zero in the stacked block array); the cross table
                        # below inherits the padded shape and maps the
                        # sentinels to the zero p row (vertex id n)
                        from .ops.graph_ops import pad_table_width

                        inc = pad_table_width(
                            inc,
                            _bs_fn(inc.shape[1]),
                            len(names) * int(idxs[names[0]].shape[0]),
                        )
                    suffix = group_key[len("__inc__"):]
                    cross = combined_cross_table(
                        [idxs[s] for s in names], n, inc=inc
                    )
                    cached[group_key] = jnp.asarray(inc)
                    cached["__ellx__" + suffix] = jnp.asarray(cross)
                    # incidence-aligned assembly tables (assembly.py aligned
                    # branch): edge ids + anchor-slot one-hots per incidence
                    # row, so the per-GN-step assembly gathers the NARROW raw
                    # probe columns ([N, D, r·P] elements) instead of wide
                    # stacked coefficient rows ([m·E, m·Ct²]); opt-in, not
                    # yet measured on the H100. Derived from inc, so
                    # sentinel rows map to edge id E (a zero row) with
                    # all-zero anchors.
                    if getattr(
                        self.solver.ip, "aligned_graph_assembly", False
                    ):
                        m_g = len(names)
                        E_g = int(idxs[names[0]].shape[0])
                        inc_np = np.asarray(inc)
                        sent = inc_np >= m_g * E_g
                        edge_t = np.where(sent, E_g, inc_np % E_g)
                        anchor = np.zeros(inc_np.shape + (m_g,), np.float32)
                        kk = np.where(sent, 0, inc_np // E_g)
                        np.put_along_axis(
                            anchor,
                            kk[..., None],
                            (~sent)[..., None].astype(np.float32),
                            axis=-1,
                        )
                        cached["__edge__" + suffix] = jnp.asarray(
                            edge_t.astype(np.int32)
                        )
                        cached["__anchor__" + suffix] = jnp.asarray(anchor)
                    # DIA split: dominant vertex-id offsets become shifted
                    # adds in the CG loop instead of gathers. Skipped under
                    # dynamic topology: the offset VALUES and the remainder
                    # widths are topology-specialized (they name input keys
                    # and fix shapes), so they would retrace per frame.
                    from .ops.graph_ops import dedup_reads

                    nn_c, dd, mm1 = np.asarray(cross).shape
                    # 32 offsets: on the armadillo-class meshes the
                    # coverage curve saturates ~57% around 20 offsets
                    # (each extra offset is one cheap shifted add; the
                    # remainder shrinks 90k -> 79k reads)
                    dia = (
                        None
                        if self.dynamic_topology
                        else dia_split(cross, n, max_offsets=32)
                    )
                    rem_store = None  # (pos [N,Dm,K], cross2 [N,Dm])
                    if dia is not None:
                        offsets, masks, rem_pos, rem_cross = dia
                        for k, off in enumerate(offsets):
                            cached[f"__diamask__{suffix}__{off}"] = (
                                jnp.asarray(masks[k])
                            )
                        rem_store = (rem_pos[..., None], rem_cross)
                    elif not self.dynamic_topology and cross.shape[1]:
                        # no DIA offsets: the whole cross table is the
                        # "remainder" — stored only when dedup shrinks it
                        flat_c = np.asarray(cross).reshape(nn_c, dd * mm1)
                        flat_p = np.where(
                            flat_c < n,
                            np.broadcast_to(
                                np.arange(dd * mm1, dtype=np.int32),
                                (nn_c, dd * mm1),
                            ),
                            dd * mm1,
                        ).astype(np.int32)
                        rem_store = (flat_p[..., None], flat_c)
                    rem_tables = None
                    if rem_store is not None:
                        rem_pos_k, rem_cross = rem_store
                        # merge duplicate (v, u) reads: the merged entries'
                        # coupling blocks pre-sum at assembly through the
                        # K-position table (ops/graph_ops.dedup_reads)
                        ded = dedup_reads(
                            rem_pos_k[:, :, 0], rem_cross, n, dd * mm1
                        )
                        if ded is not None:
                            rem_pos_k, rem_cross = ded
                        if dia is not None or ded is not None:
                            rem_tables = (rem_pos_k, rem_cross)
                            cached[f"__diarem__{suffix}"] = jnp.asarray(
                                rem_pos_k
                            )
                            cached[f"__diaremcross__{suffix}"] = jnp.asarray(
                                rem_cross
                            )
                    # owner-block neighbor exchange: precompute the
                    # all_to_all schedule + localized id tables for the
                    # irregular cross-endpoint p reads, so the CG loop's
                    # collective volume is the boundary size instead of an
                    # all-gather of p (parallel/mesh.py halo_gather)
                    if (
                        self.rules is not None
                        and self.rules.mesh is not None
                        and self.rules.mesh.size > 1
                    ):
                        from .parallel.mesh import (
                            build_halo_tables,
                            map_stacked_rows_device_major,
                        )

                        halo_targets = [("__ellx__" + suffix, cross)]
                        if rem_tables is not None:
                            halo_targets.append(
                                (f"__diaremcross__{suffix}", rem_tables[1])
                            )
                        for tkey, tbl in halo_targets:
                            tbl = np.asarray(tbl)
                            if tbl.size == 0:
                                continue
                            halo = build_halo_tables(
                                tbl, n, self.rules.mesh.size,
                                m_bucket=_mb,
                            )
                            if halo is not None:
                                cached["__halo_send__" + tkey] = jnp.asarray(
                                    halo["send"]
                                )
                                cached["__halo_loc__" + tkey] = jnp.asarray(
                                    halo["loc"]
                                )
                        # per-GN-step assembly + JᵀF gathers: the combined
                        # incidence table reads EDGE-block rows from
                        # vertex-owner rows — under SPMD a plain take
                        # all-gathers the whole stacked block array (the
                        # dominant per-step collective, O(m·E·Ct²)). The
                        # same exchange machinery covers it after mapping
                        # the slot-major row ids to device-major order
                        # (each device serves its own edges' rows).
                        ndev = self.rules.mesh.size
                        E_g = idxs[names[0]].shape[0]
                        mapped = map_stacked_rows_device_major(
                            inc, E_g, len(names), ndev
                        )
                        if mapped is not None:
                            halo = build_halo_tables(
                                mapped, len(names) * E_g, ndev,
                                m_bucket=_mb,
                            )
                            if halo is not None:
                                cached["__halo_send__" + group_key] = (
                                    jnp.asarray(halo["send"])
                                )
                                cached["__halo_loc__" + group_key] = (
                                    jnp.asarray(halo["loc"])
                                )
                # ELL tables for the gather-only JᵀJ apply
                nvert = {
                    s: int(
                        np.prod(gdecl.slots[s].shape(self.compiled.dim_sizes))
                    )
                    for s in all_names
                }
                if (
                    self.rules is not None
                    and self.rules.mesh is not None
                    and self.rules.mesh.size > 1
                ):
                    # per-slot edge→vertex exchange tables: residual/probe
                    # evaluation reads vertex arrays per edge (X[idx[e]]);
                    # under owner-block sharding a plain take all-gathers
                    # the vertex array per evaluation. These tables let
                    # spec._access_image_graph / compile.gather_slot_values
                    # ride a boundary-sized all_to_all instead
                    # (parallel/mesh.py slot_halo_gather); loc is stored
                    # [E, 1] so place_inputs' 2-axis owner-block spec fits.
                    from .parallel.mesh import build_halo_tables

                    ndev_s = self.rules.mesh.size
                    for s in all_names:
                        halo = build_halo_tables(
                            idxs[s][:, None], nvert[s], ndev_s,
                            m_bucket=_mb,
                        )
                        if halo is not None:
                            cached["__halo_send____slot_" + s] = jnp.asarray(
                                halo["send"]
                            )
                            cached["__halo_loc____slot_" + s] = jnp.asarray(
                                halo["loc"]
                            )
                inc, ell = ell_tables(
                    idxs,
                    nvert,
                    width_bucket=_mb,
                )
                for s, t in inc.items():
                    cached[f"__ell_inc_{s}"] = jnp.asarray(t)
                for (ko, ki), t in ell.items():
                    cached[f"__ell_{ko}__{ki}"] = jnp.asarray(t)
                self._inc_cache[ckey] = cached
                if self.dynamic_topology and len(self._inc_cache) > 32:
                    # per-frame topologies would otherwise grow the table
                    # cache without bound; evict least-recently-used
                    self._inc_cache.pop(next(iter(self._inc_cache)))
            out[gname].update(cached)
        return out

    # -- parameters (Opt_SetSolverParameter, solverGPUGaussNewton.t:1205-1221) --
    def set_solver_parameter(self, name: str, value) -> None:
        self.solver_params = normalize_solver_params(
            {**self.solver_params, name: value}
        )

    def set_solver_parameters(self, params: Dict[str, Any]) -> None:
        for k, v in params.items():
            self.set_solver_parameter(k, v)

    # -- stepwise API (Opt_ProblemInit / Opt_ProblemStep, Opt.h:59-66) ----------
    def init(self, inputs: Dict[str, Any]) -> None:
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        self._bound = (consts, graphs, params)
        self._state = self.solver.init(
            unknowns, consts, graphs, params, self.solver_params
        )

    def step(self) -> bool:
        """One nonlinear iteration; returns True while solving continues
        (Opt_ProblemStep's 0/1 return, solverGPUGaussNewton.t:1016-1177)."""
        from .utils.logging import log_solver

        if self._state is None:
            raise RuntimeError("call init() first")
        consts, graphs, params = self._bound
        before = int(self._state["n_iter"])
        self._state = self.solver.step(
            self._state, consts, graphs, params, self.solver_params
        )
        st = self._state
        if int(st["n_iter"]) != before:
            # reference logSolver cost-per-iteration line
            # (solverGPUGaussNewton.t:1160)
            log_solver(
                "iteration %d, cost=%g", int(st["n_iter"]), float(st["prev_cost"])
            )
        cont = (not bool(st["done"])) and int(st["n_iter"]) < int(
            self.solver_params["nIterations"]
        )
        return cont and int(st["n_iter"]) != before

    def current_cost(self) -> float:
        """Opt_ProblemCurrentCost (Opt.h:69; returns the solver's prevCost,
        solverGPUGaussNewton.t:1179-1182)."""
        if self._state is None:
            raise RuntimeError("call init() first")
        return float(self._state["prev_cost"])

    def dump_hlo(self, inputs, path=None, **solver_param_overrides) -> str:
        """Compiled-HLO text of the fused solve program — the analogue
        of the reference's verbosity≥3 generated-code dumps (PTX print at
        util.t:4 `_opt_verbosity > 3`; kernel schedule dump to log.txt,
        o.t:1618-1622). Also emitted automatically once per plan by
        ``solve()`` when ``set_verbosity(3)`` is active."""
        sp = normalize_solver_params(
            {**self.solver_params, **solver_param_overrides}
        )
        u, c, g, p = self._normalize_and_place(inputs)
        tsp = self.solver._traced_sp(sp)
        txt = (
            jax.jit(
                lambda X, cs, gs, ps: self.solver._solve_core(
                    X, cs, gs, ps, tsp, int(sp["nIterations"])
                )
            )
            .lower(u, c, g, p)
            .compile()
            .as_text()
        )
        if path is not None:
            with open(path, "w") as f:
                f.write(txt)
        return txt

    @property
    def unknowns(self) -> Dict[str, jnp.ndarray]:
        if self._state is None:
            raise RuntimeError("call init() first")
        return self._restore_sentinels(self._state["X"])

    def free(self) -> None:
        """Release solver state (Opt_PlanFree analogue)."""
        self._state = None
        self._bound = None
        self._leaf_cache = None
        self._leaf_buckets = None
        # drop the sentinel memo with the leaf cache: its entries hold the
        # keyed input leaves alive, and keeping masks for freed bindings
        # would leak them past the plan's release point
        self.__dict__.pop("_sentinel_memo", None)
        self._unk_sentinels = {}

    def solve_scheduled(
        self,
        inputs: Dict[str, Any],
        schedule,
        num_outer: int,
        **solver_param_overrides,
    ) -> SolveResult:
        """Run ``num_outer`` chained solves with a device-side input
        schedule, all inside ONE jitted program.

        ``schedule(consts, i)`` is a traced function receiving the bound
        constant images and the outer iteration index (int32 scalar) and
        returning updated constants — the device-side equivalent of the
        reference apps' host hooks that swap inputs between outer solves
        (constraint annealing, image_warping CombinedSolver.h:150-152
        setConstraintImage; arap CombinedSolver.h:83). The host-driven loop
        pays a dispatch + transfer round-trip per outer solve; this pays
        one for the whole schedule.

        Note: ``schedule`` sees SANITIZED constants (±inf clamped to finite
        sentinels at bind); any arrays it closes over should use finite
        sentinels too, and schedules must preserve shapes/dtypes.
        """
        import jax

        sp = normalize_solver_params(
            {**self.solver_params, **solver_param_overrides}
        )
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        max_iters = int(sp["nIterations"])
        dtype = self.compiled.dtype
        def get_fn():
            # cache holds a strong reference to the schedule object:
            # identity comparison is only safe while the object is alive (a
            # dead object's id() can be reused by a different closure)
            cache = self.__dict__.setdefault("_sched_cache", {})
            entry = cache.get((num_outer, max_iters))
            fn = (
                entry[1]
                if entry is not None and entry[0] is schedule
                else None
            )
            if fn is None:

                def run(X0, consts, graphs_a, params, sp_t):
                    finals0 = jnp.full((num_outer,), jnp.nan, dtype)

                    def body(i, carry):
                        X, lin_tot, finals = carry
                        c_i = schedule(consts, i)
                        state, _ = self.solver._solve_core(
                            X, c_i, graphs_a, params, sp_t, max_iters
                        )
                        finals = finals.at[i].set(state["prev_cost"])
                        return (
                            state["X"],
                            lin_tot + state["lin_iters"],
                            finals,
                        )

                    return jax.lax.fori_loop(
                        0,
                        num_outer,
                        body,
                        (X0, jnp.zeros((), jnp.int32), finals0),
                    )

                fn = jax.jit(run)
                cache[(num_outer, max_iters)] = (schedule, fn)
            return fn

        t0 = time.perf_counter()
        X, lin_tot, finals = get_fn()(
            unknowns, consts, graphs, params, self.solver._traced_sp(sp)
        )
        finals_h = jax.device_get(finals)
        wall = time.perf_counter() - t0
        self._state = None
        return SolveResult(
            unknowns=self._restore_sentinels(X),
            final_cost=float(finals_h[-1]),
            costs=[float(c) for c in finals_h],
            num_iterations=num_outer * max_iters,
            wall_time_s=wall,
            num_linear_iterations=int(lin_tot),
        )

    def solve_batched(
        self, inputs: Dict[str, Any], **solver_param_overrides
    ) -> BatchedSolveResult:
        """Solve a BATCH of problem instances in one XLA program.

        Image and scalar-parameter inputs carry a leading batch axis (or
        their unbatched shape, in which case they broadcast); graph index
        arrays are shared topology across the batch. This is new capability
        over the reference (which solves instances serially): a batch of
        small solves fills the device and amortizes dispatch.
        """
        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        reg = self.compiled.registry

        # determine batch size from any batched input
        B = None
        for name, val in inputs.items():
            if name in reg.images and reg.images[name].alias is None:
                d = reg.images[name]
                arr = np.asarray(val) if not hasattr(val, "shape") else val
                extra = arr.ndim - d.ispace.ndim
                if extra == 2 or (extra == 1 and arr.shape[-1] != d.channels):
                    B = int(arr.shape[0])
                    break
        if B is None:
            raise SpecError(
                "solve_batched: could not infer batch size; pass at least one "
                "image with a leading batch axis"
            )

        # vectorized normalization: batched leaves keep their leading axis,
        # unbatched leaves are passed through with vmap in_axes=None (no
        # broadcast materialization, no per-instance host loop)
        from .spec import UNKNOWN

        dtype = self.compiled.dtype
        unknowns, consts, graphs_in, params = {}, {}, {}, {}
        u_axes, c_axes, p_axes = {}, {}, {}
        for name, val in inputs.items():
            if name in reg.graphs:
                graphs_in[name] = {
                    s: jnp.asarray(i, jnp.int32)
                    for s, i in (
                        val if isinstance(val, dict)
                        else {s: getattr(val, s) for s in reg.graphs[name].slots}
                    ).items()
                }
                continue
            if name in reg.params:
                arr = jnp.asarray(val, dtype)
                params[name] = arr
                p_axes[name] = 0 if arr.ndim >= 1 else None
                continue
            if name not in reg.images:
                raise SpecError(f"unknown input {name!r}")
            d = reg.images[name]
            if d.alias is not None:
                continue
            arr = jnp.asarray(val)
            if arr.dtype != jnp.int32 and jnp.issubdtype(arr.dtype, jnp.floating):
                arr = arr.astype(dtype)
            nd = d.ispace.ndim
            batched = arr.ndim == nd + 2 or (
                arr.ndim == nd + 1 and arr.shape[-1] != d.channels
            )
            if arr.ndim == nd or (batched and arr.ndim == nd + 1):
                arr = arr[..., None]
            expect = d.ispace.shape(self.compiled.dim_sizes) + (d.channels,)
            got = tuple(arr.shape[1:]) if batched else tuple(arr.shape)
            if got != expect:
                raise SpecError(
                    f"image {name!r}: expected shape {expect} "
                    f"(optionally with a leading batch axis), got {tuple(arr.shape)}"
                )
            inf_restore = getattr(self, "_batched_inf_restore", None)
            if inf_restore is None:
                inf_restore = self._batched_inf_restore = {}
            if jnp.issubdtype(arr.dtype, jnp.floating):
                # +-inf invalid markers: clamp for NaN-free autodiff and
                # (for unknowns) restore on output, matching solve()
                if d.kind == UNKNOWN and bool(jnp.any(jnp.isinf(arr))):
                    inf_restore[name] = arr
                else:
                    inf_restore.pop(name, None)
                arr = self.compiled._sanitize_sentinels(arr)
            if d.kind == UNKNOWN:
                if not batched:
                    arr = jnp.broadcast_to(arr, (B,) + expect)
                unknowns[name] = arr
            else:
                consts[name] = arr
                c_axes[name] = 0 if batched else None
        missing = [
            n for n, d in reg.images.items()
            if d.alias is None and n not in inputs
        ] + [n for n in reg.graphs if n not in inputs]
        if missing:
            raise SpecError(f"missing inputs: {missing}")
        for pn in reg.params:
            if pn not in params:
                params[pn] = jnp.zeros((), dtype)
                p_axes[pn] = None
        graphs = self._augment_incidence(graphs_in)

        if not self._fused_validated and self.solver._stencil_plan is not None:
            # validate the assembled operator on the batch's first instance
            u0 = {k: v[0] for k, v in unknowns.items()}
            c0 = {k: (v[0] if c_axes[k] == 0 else v) for k, v in consts.items()}
            p0 = {k: (v[0] if p_axes[k] == 0 else v) for k, v in params.items()}
            self._validate_fused(u0, c0, graphs, p0)

        t0 = time.perf_counter()
        state, costs = self.solver._solve_fused_batched(
            unknowns, consts, graphs, params,
            self.solver._traced_sp(sp), int(sp["nIterations"]),
            tuple(sorted(c_axes.items())), tuple(sorted(p_axes.items())),
        )
        n, lin, final, costs_h = jax.device_get(
            (state["n_iter"], state["lin_iters"], state["prev_cost"], costs)
        )
        wall = time.perf_counter() - t0
        out_X = dict(state["X"])
        for name, orig in (getattr(self, "_batched_inf_restore", None) or {}).items():
            out_X[name] = jnp.where(
                jnp.isinf(orig), orig, out_X[name]
            )
        return BatchedSolveResult(
            unknowns=out_X,
            final_costs=np.asarray(final),
            costs=np.asarray(costs_h),
            num_iterations=np.asarray(n),
            num_linear_iterations=np.asarray(lin),
            wall_time_s=wall,
        )

    def dump_jacobian(self, inputs: Dict[str, Any], dense: bool = False):
        """Export J at the given inputs as COO triplets (or dense for small
        problems) — the reference's dumpJ/saveJToCRS debugging surface
        (o.t:2318-2344, solverGPUGaussNewton.t:252-304)."""
        from .jacobian import dump_jacobian, dump_jacobian_dense

        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        fn = dump_jacobian_dense if dense else dump_jacobian
        return fn(self.compiled, unknowns, consts, graphs, params)

    # -- fused solve (Opt_ProblemSolve, o.t:2548-2551) --------------------------
    def solve(
        self,
        inputs: Dict[str, Any],
        *,
        stepwise: bool = False,
        **solver_param_overrides,
    ) -> SolveResult:
        # stepwise is keyword-only: a positional dict of solver params here
        # would otherwise be silently truthy and switch execution paths
        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        t0 = time.perf_counter()
        if stepwise:

            def run_stepwise():
                self._bound = (consts, graphs, params)
                self._state = self.solver.init(
                    unknowns, consts, graphs, params, sp
                )
                costs = []
                while True:
                    before = int(self._state["n_iter"])
                    self._state = self.solver.step(
                        self._state, consts, graphs, params, sp
                    )
                    if int(self._state["n_iter"]) == before:
                        break
                    costs.append(float(self._state["prev_cost"]))
                    if bool(self._state["done"]):
                        break
                return self._state, costs

            state, cost_arr = run_stepwise()
        else:

            def run_full():
                state, costs = self.solver.solve(
                    unknowns, consts, graphs, params, sp
                )
                # single host round-trip for all scalar results (the
                # reference pays one D2H per outer iteration —
                # OptUtils.h:47-64; we pay one per solve)
                n, lin, final, costs_h = jax.device_get(
                    (
                        state["n_iter"],
                        state["lin_iters"],
                        state["prev_cost"],
                        costs,
                    )
                )
                return state, [float(c) for c in costs_h[: int(n)]], n, lin, final

            state, cost_arr, n, lin, final = run_full()
        wall = time.perf_counter() - t0
        self._state = state
        self._bound = (consts, graphs, params)
        if stepwise:
            n, final = int(state["n_iter"]), float(state["prev_cost"])
            lin = state["lin_iters"]
        result = SolveResult(
            unknowns=self._restore_sentinels(state["X"]),
            final_cost=float(final),
            costs=cost_arr,
            num_iterations=int(n),
            wall_time_s=wall,
            num_linear_iterations=int(lin),
        )
        if self.solver.ip.collect_per_kernel_timing:
            # Opt.h collectPerKernelTimingInfo: per-solve timing table +
            # TIMING / Per-iter lines (util.t:469-508)
            from .utils.timer import report_solve_timing

            report_solve_timing(self, result)
        from .utils.logging import log_debug, verbosity

        if verbosity() >= 3 and not getattr(self, "_hlo_dumped", False):
            # verbosity>=3 generated-code dump, once per plan (the
            # reference prints PTX at _opt_verbosity > 3, util.t:4, and
            # dumps the kernel schedule to log.txt, o.t:1618-1622).
            # Numbered per plan so multi-plan sessions (pyramids, benches)
            # don't overwrite each other's dumps. Costs a second lowering/
            # compile of the solve program — debug-level only.
            self._hlo_dumped = True
            global _HLO_DUMP_COUNTER
            path = f"opt_tpu_solve_hlo_{_HLO_DUMP_COUNTER}.txt"
            _HLO_DUMP_COUNTER += 1
            self.dump_hlo(inputs, path=path, **solver_param_overrides)
            log_debug(f"compiled solve HLO written to {path}")
        return result
