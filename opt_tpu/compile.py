"""Problem compilation: spec tracing, residual classification, masking.

Equivalent of the reference problem compiler (API/src/o.t):

* residual classification into centered (stencil) vs graph domains —
  reference ``classifyexpression`` (o.t:1895-1990); here derived by backward
  dependence slicing of the jaxpr of the slot-form residual function, which is
  the same conservative "visit every subexpression" rule the reference's
  ``exp:visit`` uses.
* automatic zeroing of residuals that read out of bounds — reference
  ``bboxforexpression`` + ``ad.select(bbox,exp,0)`` (o.t:985-1005,
  o.t:1930-1933), including the rule that any explicit ``InBounds`` use in a
  term disables the automatic bbox.
* there is no equivalent of the reference's dummy-energy injection for
  graph-only unknown index spaces (o.t:1938-1982): PCG bookkeeping here is a
  dense pytree over all unknowns, so every unknown participates automatically.

The expensive part of the reference compile — symbolic JᵀJ/JᵀF derivation and
Terra->PTX codegen (seconds per problem size, o.t:872) — is replaced by JAX
tracing + XLA compilation, cached per shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dims import IndexSpace
from .ops.shift import bbox_mask
from .spec import (
    ARRAY,
    UNKNOWN,
    EnergyTerm,
    SpecBuilder,
    SpecError,
    SpecRegistry,
)


# ---------------------------------------------------------------------------
# jaxpr backward dependence slicing
# ---------------------------------------------------------------------------


def _jaxpr_output_deps(closed_jaxpr) -> List[frozenset]:
    """For each jaxpr output, the set of input indices it (syntactically)
    depends on. Equations are treated atomically (any-in -> all-out), which is
    conservative in exactly the way the reference's expression visitor is."""
    from jax.extend.core import Literal

    jaxpr = closed_jaxpr.jaxpr
    env: Dict[Any, frozenset] = {}
    for i, v in enumerate(jaxpr.invars):
        env[v] = frozenset([i])
    for v in jaxpr.constvars:
        env[v] = frozenset()
    for eqn in jaxpr.eqns:
        dep = frozenset()
        for iv in eqn.invars:
            if not isinstance(iv, Literal):
                dep = dep | env.get(iv, frozenset())
        for ov in eqn.outvars:
            env[ov] = dep
    outs = []
    for ov in jaxpr.outvars:
        if isinstance(ov, Literal):
            outs.append(frozenset())
        else:
            outs.append(env.get(ov, frozenset()))
    return outs


# ---------------------------------------------------------------------------
# Compiled problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledProblem:
    spec_fn: Callable
    registry: SpecRegistry
    dim_sizes: Dict[str, int]
    dtype: Any

    @property
    def use_preconditioner(self) -> bool:
        return self.registry.use_preconditioner

    @property
    def unknown_names(self) -> List[str]:
        return self.registry.unknown_names

    @property
    def terms(self) -> List[EnergyTerm]:
        return self.registry.energy_terms

    # ---- shape helpers ----------------------------------------------------
    def unknown_shape(self, name: str) -> Tuple[int, ...]:
        d = self.registry.images[name]
        return d.ispace.shape(self.dim_sizes) + (d.channels,)

    def normalize_inputs(self, inputs: Dict[str, Any], partial: bool = False):
        """Split a flat name->value dict into (unknowns, consts, graphs, params).

        The reference binds problem data positionally through a ``void**``
        list (util.t:664-692, NamedParameters.h); we bind by name.
        ``partial=True`` converts only the given subset (no missing-input
        check, no parameter defaulting) — used by the per-leaf input cache
        in problem.Plan."""
        unknowns, consts, graphs, params = {}, {}, {}, {}
        for name, val in inputs.items():
            if name in self.registry.images:
                decl = self.registry.images[name]
                if decl.alias is not None:
                    continue  # const views read the unknown's buffer
                arr = jnp.asarray(val)
                if arr.dtype != jnp.int32 and jnp.issubdtype(arr.dtype, jnp.floating):
                    arr = arr.astype(self.dtype)
                if arr.ndim == decl.ispace.ndim:
                    arr = arr[..., None]
                expect = decl.ispace.shape(self.dim_sizes) + (decl.channels,)
                if tuple(arr.shape) != expect:
                    raise SpecError(
                        f"image {name!r}: expected shape {expect}, got {tuple(arr.shape)}"
                    )
                if jnp.issubdtype(arr.dtype, jnp.floating):
                    # clamp +-inf sentinels in consts AND unknowns: reference
                    # apps mark invalid entries with +-inf (e.g. SFS invalid
                    # depths are -inf in both targetDepth and the initial
                    # unknown). The reference's condition blocks never
                    # evaluate gated-out branches (o.t:1634-1650); with
                    # jnp.where both branches run, and even though values
                    # are guarded, VJP cotangents multiply zero cotangents
                    # by inf primal intermediates -> NaN at valid neighbors
                    # of invalid pixels. Finite sentinels keep every
                    # intermediate finite; Exclude rows never update, and
                    # Plan restores the +-inf markers on output.
                    arr = self._sanitize_sentinels(arr)
                (unknowns if decl.kind == UNKNOWN else consts)[name] = arr
            elif name in self.registry.graphs:
                g = val if isinstance(val, dict) else {
                    s: getattr(val, s) for s in self.registry.graphs[name].slots
                }
                gd = {}
                for s, i in g.items():
                    if s == "valid":
                        # optional per-edge 0/1 validity mask (runtime
                        # input): deactivated edges contribute nothing —
                        # the analogue of the reference's runtime edge
                        # count (util.t:728 guards idx < N at launch). A
                        # mask change never retraces or rebuilds tables.
                        m = jnp.asarray(i, self.dtype)
                        if m.ndim == 1:
                            m = m[:, None]
                        gd[s] = m
                    else:
                        gd[s] = jnp.asarray(i, jnp.int32)
                if "valid" in gd:
                    slot_lens = [
                        int(v.shape[0])
                        for s, v in gd.items()
                        if s != "valid" and not s.startswith("__")
                    ]
                    if slot_lens and int(gd["valid"].shape[0]) != slot_lens[0]:
                        raise SpecError(
                            f"graph {name!r}: valid mask has "
                            f"{int(gd['valid'].shape[0])} entries, edges "
                            f"have {slot_lens[0]}"
                        )
                graphs[name] = gd
            elif name in self.registry.params:
                params[name] = jnp.asarray(val, self.dtype)
            else:
                raise SpecError(f"unknown input {name!r}")
        if not partial:
            required = [
                n for n, d in self.registry.images.items() if d.alias is None
            ] + list(self.registry.graphs)
            missing = [n for n in required if n not in inputs]
            if missing:
                raise SpecError(f"missing inputs: {missing}")
            for p in self.registry.params:
                params.setdefault(p, jnp.zeros((), self.dtype))
        return unknowns, consts, graphs, params

    def _sanitize_sentinels(self, arr):
        """Clamp ±inf entries of constant arrays to a large finite sentinel.

        Reference apps mark invalid entries with ±inf (e.g. arap
        CombinedSolver.h:83 fills unconstrained vertices with -inf) and gate
        on finite thresholds (``greatereq(C, -999999.9)``); the reference
        compiles Select into condition blocks, so the infinities are never
        *evaluated* (o.t:1634-1650). Under trace-based AD every branch is
        evaluated, and an inf inside an untaken branch turns 0·inf into NaN
        in the vjp of any nonlinear op. Clamping at bind time keeps the inf
        out of arithmetic entirely — the trace-level analogue of never
        executing the branch. The magnitude stays above every comparison
        threshold traced from the spec (so all validity tests keep their
        truth value) yet small enough that squares/products of sentinels
        stay finite in float32. Semantics differ from the reference only if
        a residual *consumes* an inf through a taken branch — which yields
        an inf/NaN cost there too."""
        s = getattr(self, "_sentinel_mag", None)
        if s is None:
            s = 2.0e6
            try:
                thresholds = self._traced_comparison_thresholds()
                if thresholds:
                    s = max(s, 8.0 * max(abs(t) for t in thresholds))
            except Exception:  # pragma: no cover - tracing is best-effort
                pass
            self._sentinel_mag = s
        # verbosity>=1: surface that the semantic rewrite actually fired —
        # a spec whose *taken* branch consumes the sentinel silently changes
        # answer, so clamping should never be invisible.
        # Counting costs one reduction per bound array; skipped at
        # verbosity 0 and under tracing.
        import jax.core as _jcore

        from .utils.logging import log_solver, verbosity

        if verbosity() >= 1 and not isinstance(arr, _jcore.Tracer):
            n_inf = int(jnp.isinf(arr).sum())
            if n_inf:
                log_solver(
                    "opt_tpu: clamped %d ±inf sentinel value(s) to "
                    "magnitude %g at bind time (finite-sentinel rewrite; "
                    "see Plan docs)",
                    n_inf,
                    s,
                )
        return jnp.where(
            arr == jnp.inf, jnp.asarray(s, arr.dtype),
            jnp.where(arr == -jnp.inf, jnp.asarray(-s, arr.dtype), arr),
        )

    def _traced_comparison_thresholds(self):
        """Scalar comparison-operand literals in the residual jaxpr (shared
        machinery with assembly's threshold-aware probes)."""
        cached = getattr(self, "_cmp_thresholds", None)
        if cached is not None:
            return cached
        from .assembly import _comparison_constants

        zeros_u = {
            n: jnp.zeros(self.unknown_shape(n), self.dtype)
            for n in self.unknown_names
        }
        zeros_c = {
            n: jnp.zeros(d.ispace.shape(self.dim_sizes) + (d.channels,), self.dtype)
            for n, d in self.registry.images.items()
            if d.kind != UNKNOWN and d.alias is None
        }
        zeros_g = {
            g: {s: jnp.zeros((2,), jnp.int32) for s in d.slots}
            for g, d in self.registry.graphs.items()
        }
        zeros_p = {p: jnp.zeros((), self.dtype) for p in self.registry.params}
        out = _comparison_constants(self, zeros_u, zeros_c, zeros_g, zeros_p)
        self._cmp_thresholds = out
        return out

    # ---- field-mode runs ----------------------------------------------------
    def _run(
        self, mode, unknowns, consts, graphs, params, slot_values=None,
        computed_subs=None, mesh=None,
    ):
        builder = SpecBuilder(
            mode,
            self.dim_sizes,
            self.dtype,
            registry=self.registry,
            bindings={
                "unknowns": unknowns,
                "consts": consts,
                "graphs": graphs,
                "params": params,
                "computed_subs": computed_subs,
                # device mesh (or None): field-mode graph reads ride the
                # per-slot neighbor exchange instead of an all-gathering
                # take (spec._access_image_graph, parallel/mesh.py)
                "mesh": mesh,
            },
            slot_values=slot_values,
        )
        with builder:
            self.spec_fn(builder)
        return builder

    def _normalize_term(self, val, term: EnergyTerm):
        """Give every residual term an explicit trailing channel axis."""
        nd_sp = self._term_spatial_ndim(term)
        if val.ndim == nd_sp:
            val = val[..., None]
        elif val.ndim == nd_sp + 1:
            pass
        else:
            raise SpecError(
                f"energy term {term.index}: rank {val.ndim} does not match its "
                f"domain {term.domain}"
            )
        return val

    def _term_spatial_ndim(self, term: EnergyTerm) -> int:
        kind, dom = term.domain
        return dom.ndim if kind == "centered" else 1

    def _apply_bbox(self, val, term: EnergyTerm):
        """Reference o.t:1930-1933: zero residuals whose accesses leave the grid."""
        if term.domain[0] != "centered" or term.uses_bounds or term.bbox is None:
            return val
        bmin, bmax = term.bbox
        if all(o == 0 for o in bmin) and all(o == 0 for o in bmax):
            return val
        shape = term.domain[1].shape(self.dim_sizes)
        # multiplicative 0/1 mask, not a select — see exclusion_masks on why.
        m = bbox_mask(shape, bmin, bmax, dtype=val.dtype)
        return val * m

    def residual_terms(
        self, unknowns, consts, graphs, params, mesh=None
    ) -> List[jnp.ndarray]:
        """All residual terms (bbox-masked), *not* exclusion-masked.

        Matches the reference's F as used by evalJTF/applyJTJ: residual
        instances centered at excluded pixels still contribute to gradients —
        only rows/updates for excluded unknowns are dropped (exclude gating in
        solverGPUGaussNewton.t is on the unknown index, not on gathered
        residual instances)."""
        b = self._run("field", unknowns, consts, graphs, params, mesh=mesh)
        out = []
        scales = self.graph_term_scales(graphs)
        for term, val, sc in zip(self.terms, b.energy_values, scales):
            val = self._apply_bbox(self._normalize_term(val, term), term)
            out.append(val if sc is None else val * sc)
        return out

    def graph_term_scales(self, graphs):
        """Per-term residual scale from the optional per-edge ``valid``
        masks ([E, 1] each, stop-gradient'd), aligned with ``self.terms``
        (None where no mask applies). Masking the RESIDUAL zeroes the
        edge's rows of J, its JᵀF/diag contributions and its cost
        consistently — everything downstream flows through r. Callers that
        evaluate residuals or their linearizations outside residual_terms
        (slot-form probes) must apply the same scales."""
        out = []
        for term in self.terms:
            sc = None
            if term.domain and term.domain[0] == "graph":
                g = graphs.get(term.domain[1])
                if g is not None and g.get("valid") is not None:
                    sc = jax.lax.stop_gradient(g["valid"])
            out.append(sc)
        return out

    def residual_fn(self, consts, graphs, params, mesh=None):
        """Closure over constants: X -> list of residual term arrays."""
        return lambda unknowns: self.residual_terms(
            unknowns, consts, graphs, params, mesh=mesh
        )

    def exclusion_masks(self, unknowns, consts, graphs, params, mesh=None):
        """Per-ispace 'is excluded' masks [*spatial, 1] in the compute dtype
        (1.0 = excluded, 0.0 = active), or {} if none.

        Reference: fmap.exclude gating every centered kernel
        (solverGPUGaussNewton.t:371,424,450...).

        Float (not bool) on purpose: masking on the solver hot path is done
        multiplicatively: boolean selects interleaved with the transposed
        (``add_any``) stencil graph can break XLA's fusion, while multiplies
        fuse freely (a choice from before the H100, not yet measured
        there); the
        masks are 0/1 constants so the arithmetic is exact."""
        if not self.registry.exclude_terms:
            return {}
        b = self._run("field", unknowns, consts, graphs, params, mesh=mesh)
        masks: Dict[IndexSpace, jnp.ndarray] = {}
        for et, val in zip(self.registry.exclude_terms, b.exclude_values):
            if val.ndim == et.ispace.ndim:
                val = val[..., None]
            elif val.ndim == et.ispace.ndim + 1 and val.shape[-1] != 1:
                val = jnp.any(val != 0, axis=-1, keepdims=True)
            val = val.astype(self.dtype) if val.dtype != self.dtype else val
            prev = masks.get(et.ispace)
            masks[et.ispace] = val if prev is None else jnp.maximum(prev, val)
        # stop_gradient: exclusion is a constant gate, never differentiated.
        return {k: jax.lax.stop_gradient(v) for k, v in masks.items()}

    def unknown_row_masks(self, excl_by_ispace):
        """name -> float mask (1.0 = active row, 0.0 = excluded) or None."""
        out = {}
        for name in self.unknown_names:
            isp = self.registry.images[name].ispace
            m = excl_by_ispace.get(isp)
            out[name] = None if m is None else (1.0 - m)
        return out

    def term_cost_mask(self, term: EnergyTerm, excl_by_ispace):
        """Cost gating: residuals centered at excluded pixels do not count
        toward the cost (reference computeCost skips excluded indices,
        solverGPUGaussNewton.t:580-592); graph residuals always count."""
        if term.domain[0] != "centered":
            return None
        return excl_by_ispace.get(term.domain[1])

    # ---- slot-mode ----------------------------------------------------------
    def gather_slot_values(self, unknowns, consts, graphs, params=None, mesh=None):
        """Materialize every slot's value field (shift / edge gather / mask).

        ComputedArray slots (cimg/cgrad) materialize the computed value AND
        per-unknown gradient fields once per call — the reference's
        per-nonlinear-iteration ``precompute`` kernels (o.t:2387-2409,
        solverGPUGaussNewton.t:1005,1116,1155)."""
        from .ops.graph_ops import edge_gather
        from .ops.shift import in_bounds_mask, shift

        def _resolve(s):
            decl = self.registry.images[s.image]
            if decl.alias is not None:
                return jax.lax.stop_gradient(unknowns[decl.alias])
            return (unknowns if decl.kind == UNKNOWN else consts)[s.image]

        # sharded graph reads: ONE channel-stacked exchange per
        # (graph, slot) serves every image read there (collective latency
        # is per-op — parallel/mesh.py grouped_slot_halo_gather)
        halo_reads = {}
        if mesh is not None and getattr(mesh, "size", 1) > 1:
            from .parallel.mesh import grouped_slot_halo_gather

            import numpy as _np

            by_gs = {}
            for s in self.registry.slots:
                if s.kind == "gimg":
                    arr = _resolve(s)
                    # tables are built for the slot's vertex count; images
                    # on a different-sized space keep the plain take
                    slot_n = int(
                        _np.prod(
                            self.registry.graphs[s.graph]
                            .slots[s.key[3]]
                            .shape(self.dim_sizes)
                        )
                    )
                    if arr.shape[0] == slot_n:
                        by_gs.setdefault((s.graph, s.key[3]), {})[
                            s.image
                        ] = arr
            for (g, slot), imgs in by_gs.items():
                got = grouped_slot_halo_gather(
                    mesh, list(imgs.items()), graphs[g], slot
                )
                if got is not None:
                    for name, v in got.items():
                        halo_reads[(g, slot, name)] = v

        bundle = None
        vals = []
        for s in self.registry.slots:
            if s.kind in ("img", "gimg"):
                arr = _resolve(s)
                if s.kind == "img":
                    vals.append(shift(arr, s.offset))
                else:
                    got = halo_reads.get((s.graph, s.key[3], s.image))
                    if got is None:
                        idx = graphs[s.graph][s.key[3]]
                        got = edge_gather(arr, idx)
                    vals.append(got)
            elif s.kind == "bounds":
                shape = s.ispace.shape(self.dim_sizes)
                vals.append(in_bounds_mask(shape, s.offset, s.expand, dtype=self.dtype))
            elif s.kind in ("cimg", "cgrad"):
                if bundle is None:
                    bundle = self._computed_bundle(
                        unknowns, consts, graphs, params or {}
                    )
                C, G = bundle[s.image]  # image holds the handle name
                if s.kind == "cimg":
                    vals.append(shift(C, s.offset))
                else:
                    uname, t = s.key[3], s.key[4]
                    vals.append(shift(G[(uname, t)], s.offset))
            else:  # pragma: no cover
                raise AssertionError(s.kind)
        return vals

    def _computed_bundle(self, unknowns, consts, graphs, params):
        """{handle name: (value field [*sp, cc], {(uname, t): gradient field
        [*sp, cc*cu]})} at the current linearization point.

        One field-mode run of the spec captures every computed value;
        ``jax.linearize`` against per-(unknown, offset) substituted reads
        separates the gradient fields with one tangent pass per touched
        (offset, channel) — the probe analogue of the reference storing
        gradient images per ComputedImage (o.t:1007-1040)."""
        from .ops.shift import shift

        reg = self.registry
        # only pairs some registered cgrad slot actually reads
        need_g = {}
        handles = []
        for s in reg.slots:
            if s.kind == "cimg" and s.image not in handles:
                handles.append(s.image)
            if s.kind == "cgrad":
                need_g.setdefault(s.image, set()).add((s.key[3], s.key[4]))
        sub_keys = sorted(
            {pair for pairs in need_g.values() for pair in pairs}
        )

        def run(sub_vals):
            subs = dict(zip(sub_keys, sub_vals))
            b = self._run(
                "field", unknowns, consts, graphs, params,
                computed_subs=subs,
            )
            return [b._computed_cache[h] for h in handles]

        base = []
        for (uname, t) in sub_keys:
            arr = unknowns[uname]
            if arr.ndim == reg.images[uname].ispace.ndim:
                arr = arr[..., None]
            base.append(shift(arr, t))
        prim, lin = jax.linearize(run, base)

        out = {}
        for hi, hname in enumerate(handles):
            Gmap = {}
            for (uname, t) in sorted(need_g.get(hname, ())):
                ki = sub_keys.index((uname, t))
                cu = base[ki].shape[-1]
                cols = []
                for ch in range(cu):
                    tans = [jnp.zeros_like(v) for v in base]
                    z = jnp.zeros_like(base[ki]).at[..., ch].set(1.0)
                    tans[ki] = z
                    cols.append(lin(tans)[hi])  # [*sp, cc]
                G = jnp.stack(cols, axis=-1)  # [*sp, cc, cu]
                Gmap[(uname, t)] = G.reshape(G.shape[:-2] + (-1,))
            out[hname] = (prim[hi], Gmap)
        return out

    def local_residual_terms(
        self, slot_values, params, consts=None
    ) -> List[jnp.ndarray]:
        """Residual terms as a pointwise function of slot values (bbox-masked
        identically to :meth:`residual_terms`).

        ``consts`` must be passed for specs using SampledImage: the sampled
        image/derivative arrays are read directly (they are not slots, since
        sampling coordinates are dynamic)."""
        b = self._run("slots", {}, consts or {}, {}, params, slot_values=list(slot_values))
        out = []
        for term, val in zip(self.terms, b.energy_values):
            out.append(self._apply_bbox(self._normalize_term(val, term), term))
        return out

    def unknown_slot_ids(self) -> List[int]:
        return [i for i, s in enumerate(self.registry.slots) if s.is_unknown]


# ---------------------------------------------------------------------------
# compile_spec
# ---------------------------------------------------------------------------


_COMPILE_CACHE: "OrderedDict" = None  # lazy-initialized LRU
_COMPILE_CACHE_MAX = 128


def compile_spec(spec_fn: Callable, dim_sizes: Dict[str, int], dtype) -> CompiledProblem:
    """Trace a spec function and classify its residual terms.

    This is the (cheap) analogue of the reference's ``Opt_ProblemPlan``
    front-half (o.t:861-882): run the user spec, derive per-term domains and
    bounds masks. The back-half (kernel generation) is deferred to JAX/XLA at
    first solve.

    Results are memoized per (spec function, dims, dtype): tracing is
    deterministic and CompiledProblem carries no binding state, so repeated
    plans of the same problem (pyramid schedules, create/free cycles —
    tests/create_delete_cycle/main.cpp:22-27) skip the two trace passes.
    The cache is a bounded LRU (not weak-keyed: CompiledProblem stores
    spec_fn, so a weak key would always be strongly reachable through its
    own value and never collect — throwaway lambdas accumulate only up to
    the cap)."""
    global _COMPILE_CACHE
    from collections import OrderedDict

    if _COMPILE_CACHE is None:
        _COMPILE_CACHE = OrderedDict()
    try:
        key = (spec_fn, tuple(sorted(dim_sizes.items())), np.dtype(dtype).name)
        hit = _COMPILE_CACHE.get(key)
    except TypeError:  # spec_fn not hashable
        key = None
        hit = None
    if hit is not None:
        _COMPILE_CACHE.move_to_end(key)
        return hit

    compiled = _compile_spec_uncached(spec_fn, dim_sizes, dtype)
    if key is not None:
        _COMPILE_CACHE[key] = compiled
        while len(_COMPILE_CACHE) > _COMPILE_CACHE_MAX:
            _COMPILE_CACHE.popitem(last=False)
    return compiled


def _compile_spec_uncached(
    spec_fn: Callable, dim_sizes: Dict[str, int], dtype
) -> CompiledProblem:
    registry = SpecRegistry()

    # Pass 1: discovery under abstract evaluation (no real compute).
    def _discover():
        b = SpecBuilder("discover", dim_sizes, dtype, registry=registry)
        with b:
            spec_fn(b)
        return tuple(b.energy_values) + tuple(b.exclude_values)

    jax.eval_shape(_discover)
    if not registry.energy_terms:
        raise SpecError("spec defines no Energy terms")
    registry.frozen = True

    # Pass 2: jaxpr of the slot-form function, for dependence slicing.
    slot_avals = []
    for s in registry.slots:
        if s.kind == "gimg":
            shape = (registry.dummy_edge_count, s.channels)
        elif s.kind in ("img", "cimg", "cgrad"):
            shape = s.ispace.shape(dim_sizes) + (s.channels,)
        else:
            shape = s.ispace.shape(dim_sizes) + (1,)
        slot_avals.append(jax.ShapeDtypeStruct(shape, dtype))

    def _slot_run(*slot_values):
        b = SpecBuilder(
            "slots", dim_sizes, dtype, registry=registry,
            bindings={"params": {}}, slot_values=list(slot_values),
        )
        with b:
            spec_fn(b)
        return tuple(b.energy_values) + tuple(b.exclude_values)

    closed = jax.make_jaxpr(_slot_run)(*slot_avals)
    deps = _jaxpr_output_deps(closed)
    n_terms = len(registry.energy_terms)
    term_deps = deps[:n_terms]
    excl_deps = deps[n_terms:]
    term_shapes = [v.aval.shape for v in closed.jaxpr.outvars[:n_terms]]

    for term, dset, shape in zip(registry.energy_terms, term_deps, term_shapes):
        slots = [registry.slots[i] for i in sorted(dset)]
        term.slot_ids = tuple(sorted(dset))
        graphs = sorted({s.graph for s in slots if s.kind == "gimg"})
        ispaces = []
        for s in slots:
            if s.kind in ("img", "cimg") and s.ispace not in ispaces:
                ispaces.append(s.ispace)
        term.uses_bounds = any(
            s.kind == "bounds" and not s.internal for s in slots
        )
        if graphs:
            if len(graphs) > 1 or ispaces:
                raise SpecError(
                    f"energy term {term.index}: residual contains image reads "
                    f"from multiple domains (reference o.t:1916)"
                )
            term.domain = ("graph", graphs[0])
        else:
            if len(ispaces) != 1:
                if not ispaces:
                    raise SpecError(
                        f"energy term {term.index}: residual must actually use "
                        "some image (reference o.t:1922)"
                    )
                raise SpecError(
                    f"energy term {term.index}: residual mixes index spaces {ispaces}"
                )
            term.domain = ("centered", ispaces[0])
            nd = ispaces[0].ndim
            bmin = [0] * nd
            bmax = [0] * nd
            for s in slots:
                if s.kind in ("img", "cimg"):
                    for d in range(nd):
                        bmin[d] = min(bmin[d], s.offset[d])
                        bmax[d] = max(bmax[d], s.offset[d])
            term.bbox = (tuple(bmin), tuple(bmax))
        nd_sp = term.domain[1].ndim if term.domain[0] == "centered" else 1
        term.channels = 1 if len(shape) == nd_sp else int(shape[-1])

    for et, dset in zip(registry.exclude_terms, excl_deps):
        et.slot_ids = tuple(sorted(dset))
        ispaces = []
        for i in sorted(dset):
            s = registry.slots[i]
            if s.kind in ("img", "bounds") and s.ispace not in ispaces:
                ispaces.append(s.ispace)
        if len(ispaces) != 1:
            raise SpecError(
                f"Exclude() expression must read exactly one grid index space, got {ispaces}"
            )
        et.ispace = ispaces[0]

    return CompiledProblem(spec_fn, registry, dict(dim_sizes), dtype)
