"""Assembled gather-form JᵀJ operator for grid (centered) and graph domains.

This is the equivalent of the reference's symbolic matrix-free
JᵀJ derivation — ``createjtjcentered`` (API/src/o.t:2029-2089) for stencil
domains and ``createjtjgraph`` (o.t:2092-2126) for hyperedge domains:
instead of composing Jᵀ(J·p) from the residual linearization on every CG
iteration, the solver assembles — once per nonlinear iteration, at the
linearization point — coefficient fields:

* centered:  W[(u_out, u_in, Δ, i, j)][q]
    = Σ_{t, s_out, s_in : s_in - s_out = Δ}
      Σ_rch ∂r_t[q-s_out, rch]/∂u_out[q, i] · ∂r_t[q-s_out, rch]/∂u_in[q+Δ, j]
  applied in the CG hot loop as weighted shifts:
    (JᵀJ p)[u_out][q, i] = Σ W[...][q] · p[u_in][q+Δ, j]

* graph:  G[(g, u_out, k_out, u_in, k_in, i, j)][e]
    = Σ_{t, slots} Σ_rch ∂r_t[e, rch]/∂u_out[idx_{k_out}(e), i]
                        · ∂r_t[e, rch]/∂u_in[idx_{k_in}(e), j]
  applied as edge gathers + one segment scatter-add per (u_out, k_out) —
  the atomics-free form of the reference's per-edge atomicAdd scatters.

The reference reaches the same forms symbolically (its CAS groups residual
instances touching the center unknown, o.t:1996-2006, and polysimplify
minimizes ops, ad.t:803-926); here the per-slot Jacobian fields
``D[t, s] = ∂r_t/∂slot_s`` are obtained numerically by one-hot jvp probes of
the pointwise slot-form residual function — no CAS required — and the
channel-pair sparsity (which (i, j) blocks are structurally zero) is detected
once per plan by probing with randomized inputs.

Exclusion semantics match the exclude gating of the reference PCG kernels
(solverGPUGaussNewton.t:371,424,450): centered coefficient fields fold the
0/1 row masks on both sides (cheap shifts); graph paths instead apply
out = M · A(M · p) in the CG loop — identical algebra for diagonal 0/1
masks, and it avoids per-coupling edge-domain mask gathers at assembly.

Levenberg-Marquardt wraps this operator with + CtC·p exactly as the
reference adds the damping diagonal inside applyJTJ (o.t:2076-2082).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.shift import shift

# centered: (u_out, u_in, delta, i, j) -> [(term_idx, sid_out, sid_in), ...]
WKey = Tuple[str, str, Tuple[int, ...], int, int]
# graph: (graph, u_out, key_out, u_in, key_in, i, j) -> contributions
GKey = Tuple[str, str, str, str, str, int, int]


@dataclasses.dataclass
class AssemblyPlan:
    """Static description of the nonzero JᵀJ coefficient fields."""

    w_spec: Dict[WKey, List[Tuple[int, int, int]]]
    g_spec: Dict[GKey, List[Tuple[int, int, int]]]
    needed_slots: List[int]  # unknown slot ids probed at assembly time
    # (u_out, u_in, delta) / (g, u_out, k_out, u_in, k_in) groups whose
    # diagonal pair fields are channel-independent (probed equal): store one
    # [*dom, 1] field and broadcast, instead of C identical copies.
    scalar_groups: frozenset = frozenset()
    # (term_idx, slot_id) Jacobian fields that are independent of the
    # unknowns (probed identical under two X draws at fixed consts): their
    # probes and pair products are hoisted out of the nonlinear loop via
    # assemble_const (ARAP: ∂r/∂Offset = ±w·I at both endpoints — 9 of 12
    # probe columns; linear problems like poisson hoist everything).
    const_tsids: frozenset = frozenset()

    def centered_memory_bytes(self, compiled) -> int:
        total = 0
        for (u_out, *_rest) in self.w_spec:
            shape = compiled.unknown_shape(u_out)[:-1]
            total += int(np.prod(shape)) * np.dtype(compiled.dtype).itemsize
        return total


def _gauss_jordan_inv(B):
    """Batched inverse of small regularized-SPD blocks [..., c, c] by
    pivot-free Gauss-Jordan: c rounds of elementwise row ops, all
    vectorized over the batch, where ``jnp.linalg.inv`` would run a
    pivoted LU per [c, c] block (a choice from before the H100, not
    yet measured there). No pivoting is safe: callers regularize the diagonal, so
    every pivot is bounded away from zero."""
    c = B.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(c, dtype=B.dtype), B.shape)
    M = jnp.concatenate([B, eye], axis=-1)  # [..., c, 2c]
    for k in range(c):
        piv = M[..., k, :] / M[..., k, k : k + 1]
        M = M - M[..., :, k : k + 1] * piv[..., None, :]
        M = M.at[..., k, :].set(piv)
    X = M[..., :, c:]
    # one Newton refinement X <- X(2I - BX) squares the pivot-free f32
    # rounding residual (two batched tiny matmuls, once per nonlinear
    # iteration — matches pivoted-LU accuracy on reference blocks)
    hp = jax.lax.Precision.HIGHEST
    BX = jnp.matmul(B, X, precision=hp)
    return jnp.matmul(X, 2.0 * eye - BX, precision=hp)


def _comparison_constants(compiled, X, consts, graphs, params) -> List[float]:
    """Scalar constants appearing as comparison operands in the residual
    jaxpr (gt/lt/ge/le/eq/ne). Data-dependent gates like ``greater(D, 2.0)``
    only flip under the probe distribution if probe values straddle the
    threshold; the reference's symbolic zero elimination (polysimplify,
    ad.t:803-926) is exact and has no such blind spot, so the probe value
    set must cover every traced threshold."""
    import jax.extend.core as jec

    f = lambda sv: compiled.local_residual_terms(sv, params, consts)
    sv = compiled.gather_slot_values(X, consts, graphs, params)
    try:
        jaxpr = jax.make_jaxpr(f)(sv)
    except Exception:  # pragma: no cover - tracing of spec already succeeded
        return []
    # max/min (jnp.maximum/minimum) gate the Jacobian exactly like
    # comparisons: d/dx max(x, t) is a select on x > t. A literal operand t
    # is a harvestable threshold for the probes to straddle.
    prims = {"gt", "lt", "ge", "le", "eq", "ne", "max", "min"}
    out = set()

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name in prims:
                for v in eqn.invars:
                    if isinstance(v, jec.Literal):
                        val = np.asarray(v.val)
                        if val.size == 1 and np.issubdtype(
                            val.dtype, np.number
                        ):
                            t = float(val.reshape(()))
                            if np.isfinite(t):
                                out.add(t)
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    if isinstance(sub, jec.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jec.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    vals = set()
    for t in sorted(out):
        vals.update((t, t - 0.5, t + 0.5))
    return sorted(vals)


def _terms_with_traced_gates(compiled, X, consts, graphs, params):
    """Residual-term indices whose computation contains a comparison with
    NO literal operand (array-vs-array gates like ``less(X(0,0), A(0,0) -
    5.0)``). ``_comparison_constants`` can only harvest literal thresholds,
    so the probe distribution has nothing to straddle for these gates: a
    branch that never flips under the draws would be (unsoundly) pruned as
    structurally zero. The planner refuses structural pruning, constant
    hoisting and scalar-group collapsing for tainted terms instead — the
    safe fallback the reference never needs (its polysimplify is exact,
    ad.t:803-926). Taint propagates forward through the jaxpr, and any
    literal-free comparison inside an equation's sub-jaxprs taints that
    equation's outputs (conservative).

    A literal operand is only an escape hatch when the OTHER operand is a
    directly-drawn input: the probes place harvested threshold values into
    the raw slot draws, so ``eq(Mask, 0)`` takes both truth values across
    the probe grid. A ComputedArray slot's value is NOT drawn — it is
    recomputed from the probe unknowns (gather_slot_values materializes
    the bundle, compile.py) — so a gate on it compares a FUNCTION of the
    draws against the literal, and no input-space value set can straddle
    that threshold in general (SFS round-4 case: ``eq(valid, 1)`` where
    ``valid`` requires four |ΔX|<0.01 neighbor coincidences that no O(1)
    draw produces — the shading-smoothness couplings probed identically
    zero and were unsoundly pruned, caught at solve time by
    validate_assembly and silently costing the fused path since round 2).
    Gates whose non-literal operand derives from a cimg/cgrad slot
    therefore taint regardless of literal operands."""
    import jax.extend.core as jec

    f = lambda sv: compiled.local_residual_terms(sv, params, consts)
    sv = compiled.gather_slot_values(X, consts, graphs, params)
    try:
        jaxpr = jax.make_jaxpr(f)(sv).jaxpr
    except Exception:  # pragma: no cover - spec already traced upstream
        return frozenset(range(len(compiled.terms)))
    # forward dataflow: which vars derive from a ComputedArray slot value
    # (sv is the gather_slot_values list, so invars align with
    # registry.slots one-to-one)
    derived = {
        id(v)
        for v, s in zip(jaxpr.invars, compiled.registry.slots)
        if s.kind in ("cimg", "cgrad")
    }
    for eqn in jaxpr.eqns:
        if any(
            not isinstance(v, jec.Literal) and id(v) in derived
            for v in eqn.invars
        ):
            derived.update(id(o) for o in eqn.outvars)
    # max/min with two non-literal operands are array-vs-array gates too:
    # their derivative is a select with no literal threshold for the probes
    # to straddle, so treat them exactly like literal-free comparisons
    #.
    prims = {"gt", "lt", "ge", "le", "eq", "ne", "max", "min"}
    # Piecewise-constant primitives gate the Jacobian with no literal
    # threshold at all (every integer is a breakpoint): sign/floor/ceil/
    # round outputs — and float->int casts — are locally constant in their
    # input, so a coefficient field built from them can look X-independent
    # (false constant-hoist) or identically zero (false prune) under any
    # finite probe draw. A literal operand means a
    # compile-time constant, which is harmless.
    pw_prims = {"sign", "floor", "ceil", "round"}
    custom_calls = {"custom_jvp_call", "custom_vjp_call",
                    "custom_jvp_call_jaxpr", "custom_vjp_call_jaxpr"}

    def _on_derived(eqn) -> bool:
        # a literal threshold is no escape when the compared value is a
        # recomputed ComputedArray (see docstring): probes can't straddle
        # a threshold through the computed function
        return any(
            not isinstance(v, jec.Literal) and id(v) in derived
            for v in eqn.invars
        )

    def _is_gate(eqn, include_pw) -> bool:
        name = eqn.primitive.name
        if name in prims:
            return (
                not any(isinstance(v, jec.Literal) for v in eqn.invars)
                or _on_derived(eqn)
            )
        if not include_pw:
            return False
        if name in pw_prims:
            return (
                not any(isinstance(v, jec.Literal) for v in eqn.invars)
                or _on_derived(eqn)
            )
        if name == "convert_element_type":
            nd = eqn.params.get("new_dtype")
            v = eqn.invars[0]
            return (
                nd is not None
                and np.issubdtype(np.dtype(nd), np.integer)
                and not isinstance(v, jec.Literal)
                and np.issubdtype(v.aval.dtype, np.floating)
            )
        return False

    def _gate_in(jx) -> bool:
        for eqn in jx.eqns:
            if _is_gate(eqn, True):
                return True
            # inside a custom_jvp/vjp the derivative comes from the custom
            # rule, not the primal, and the probes evaluate that rule
            # exactly — the floor/casts/clip-comparisons there are how
            # smooth interpolants are implemented (ops/sampling.py's
            # bilinear kernel), not Jacobian gates. Don't descend: a custom
            # rule's structure is its author's contract, and the runtime
            # validate_assembly check remains the backstop. (Until r4 the
            # clip min/max inside the sampling primal tainted every
            # SampledImage fit term — pure conservatism, no unsoundness.)
            if eqn.primitive.name in custom_calls:
                continue
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    if isinstance(sub, jec.ClosedJaxpr) and _gate_in(
                        sub.jaxpr
                    ):
                        return True
                    if isinstance(sub, jec.Jaxpr) and _gate_in(sub):
                        return True
        return False

    taint = set()
    for eqn in jaxpr.eqns:
        dirty = any(
            not isinstance(v, jec.Literal) and id(v) in taint
            for v in eqn.invars
        )
        if not dirty and _is_gate(eqn, True):
            dirty = True
        if not dirty and eqn.primitive.name not in custom_calls:
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    if (
                        isinstance(sub, jec.ClosedJaxpr)
                        and _gate_in(sub.jaxpr)
                    ) or (isinstance(sub, jec.Jaxpr) and _gate_in(sub)):
                        dirty = True
                        break
                if dirty:
                    break
        if dirty:
            taint.update(id(o) for o in eqn.outvars)
    return frozenset(
        t
        for t, v in enumerate(jaxpr.outvars)
        if not isinstance(v, jec.Literal) and id(v) in taint
    )


def _probe_inputs(compiled, rng, probe_edges: int, extra_vals=()):
    """Randomized inputs exercising both branches of mask-style selects:
    constants mix exact {0, 1, -1} — plus every traced comparison threshold
    and values straddling it (``extra_vals``) — with uniform values per
    pixel so that predicates like eq(M, 0) or greater(D, 2.0) take both
    truth values across the probe grid. Unknowns mix a uniform base with the
    same threshold-straddling values (gates may compare unknowns). Graph
    index arrays are uniform random valid indices."""
    base_vals = [0.0, 1.0, -1.0] + [
        v for v in extra_vals if v not in (0.0, 1.0, -1.0)
    ]
    unknowns, consts = {}, {}
    for name, decl in compiled.registry.images.items():
        if decl.alias is not None:
            continue
        shape = decl.ispace.shape(compiled.dim_sizes) + (decl.channels,)
        if decl.kind == "unknown":
            vals = rng.uniform(0.5, 1.5, shape)
            if extra_vals:
                pick = np.asarray(extra_vals)[
                    rng.randint(0, len(extra_vals), shape)
                ]
                vals = np.where(rng.rand(*shape) < 0.25, pick, vals)
            unknowns[name] = jnp.asarray(vals, compiled.dtype)
        else:
            cat = rng.randint(0, len(base_vals) + 1, shape)
            vals = rng.uniform(0.3, 1.7, shape)
            for k, bv in enumerate(base_vals):
                vals = np.where(cat == k, bv, vals)
            consts[name] = jnp.asarray(vals, compiled.dtype)
    graphs = {}
    for gname, gdecl in compiled.registry.graphs.items():
        graphs[gname] = {
            slot: jnp.asarray(
                rng.randint(0, max(1, int(np.prod(isp.shape(compiled.dim_sizes)))), probe_edges),
                jnp.int32,
            )
            for slot, isp in gdecl.slots.items()
        }
    params = {
        p: jnp.asarray(rng.uniform(0.5, 1.5), compiled.dtype)
        for p in compiled.registry.params
    }
    return unknowns, consts, graphs, params


def _slot_jacobians(compiled, X, consts, graphs, params, slot_ids, mesh=None):
    """D[(term_idx, sid)] = ∂r_t/∂slot_sid as [*dom, r_ch, C_s] via one-hot
    jvp probes of the slot-form residual function (same mechanism as the
    exact Jacobi diagonal, functions.py jtj_diag). All probes across slots
    and channels run as ONE vmapped linear evaluation."""
    sv = compiled.gather_slot_values(X, consts, graphs, params, mesh=mesh)
    # per-edge validity masks scale the slot-form residuals exactly as
    # residual_terms does (compile.graph_term_scales contract): masked
    # edges' Jacobian fields — and every coefficient product built from
    # them — are exactly zero
    scales = compiled.graph_term_scales(graphs)

    def f(s):
        terms = compiled.local_residual_terms(s, params, consts)
        return [t if sc is None else t * sc for t, sc in zip(terms, scales)]

    primal, lin = jax.linearize(f, sv)

    # stack every (slot, channel) one-hot tangent along a leading probe axis
    n_probes = sum(compiled.registry.slots[sid].channels for sid in slot_ids)
    probe_of = []  # (sid, ch) per probe index
    for sid in slot_ids:
        for ch in range(compiled.registry.slots[sid].channels):
            probe_of.append((sid, ch))

    # one-hot tangents as lazily-broadcast selector constants: a [n_probes,
    # C_k] 0/1 matrix broadcast over the domain axes. Materializing dense
    # [n_probes, *dom, C] tangents with dynamic-update-slices costs more HBM
    # traffic than the probe evaluation itself; a broadcast is free until
    # consumed and XLA folds it into the jvp products.
    batched_tangents = []
    for k, v in enumerate(sv):
        sel = np.zeros((n_probes, v.shape[-1]), np.float64)
        for pi, (sid, ch) in enumerate(probe_of):
            if sid == k:
                sel[pi, ch] = 1.0
        sel_j = jnp.asarray(sel, v.dtype).reshape(
            (n_probes,) + (1,) * (v.ndim - 1) + (v.shape[-1],)
        )
        batched_tangents.append(jnp.broadcast_to(sel_j, (n_probes,) + v.shape))

    d_all = jax.vmap(lambda *ts: lin(list(ts)))(*batched_tangents)
    # d_all: list over terms of [n_probes, *dom, r_ch]

    # ONE probe-axis transpose per term, then minor-dim slices per slot:
    # stacking per-channel slices instead costs ~3x in relayouts
    moved = [jnp.moveaxis(d, 0, -1) for d in d_all]  # [*dom, r_ch, n_probes]
    base_of = {}
    for sid in slot_ids:
        base_of[sid] = next(
            pi for pi, (psid, pch) in enumerate(probe_of) if psid == sid
        )
    D = {}
    for t_idx, term in enumerate(compiled.terms):
        for sid in slot_ids:
            if sid not in term.slot_ids:
                continue
            s = compiled.registry.slots[sid]
            base = base_of[sid]
            # [*dom, r_ch, C_s]
            D[(t_idx, sid)] = moved[t_idx][..., base : base + s.channels]
    # the raw probe tensors let consumers contract over ALL probe columns in
    # one op (columns of slots absent from a term are exactly zero) and
    # slice lazily — materializing per-slot slices relayouts every field.
    # The linearize PRIMAL is the residual-term evaluation at X itself —
    # returned so assemble() can hand it to the solver as r_terms and the
    # GN step skips its separate fs.linearize(X) residual pass.
    return D, moved, base_of, primal


def plan_assembly(
    spec_fn,
    compiled,
    *,
    probe_size: int = 8,
    probe_edges: int = 32,
    memory_limit_bytes: int = 1 << 31,
) -> Optional[AssemblyPlan]:
    """Build the static assembly plan, or None when it would exceed the
    centered-field memory budget.

    Channel-pair sparsity is detected by evaluating the per-pair coefficient
    fields at two randomized probe input sets on a small grid: a pair whose
    field is exactly zero at every probe element under both draws is
    structurally zero (coefficients are analytic in the inputs, and the
    probes mix exact {0,1,-1} with uniform values so mask selects take both
    branches; NaN/Inf under probes counts as nonzero, never prunable). This
    replaces the reference's symbolic zero elimination (polysimplify,
    ad.t:803-926) without a CAS.
    """
    # Deterministic given (compiled, knobs): memoize on the compiled object
    # (itself cached per (spec, dims, dtype) by compile_spec), so repeated
    # plans of one problem skip the probe evaluation entirely.
    cache_key = (probe_size, probe_edges, memory_limit_bytes)
    cache = getattr(compiled, "_assembly_plan_cache", None)
    if cache is None:
        cache = {}
        compiled._assembly_plan_cache = cache
    if cache_key not in cache:
        cache[cache_key] = _plan_assembly_uncached(
            spec_fn,
            compiled,
            probe_size=probe_size,
            probe_edges=probe_edges,
            memory_limit_bytes=memory_limit_bytes,
        )
    return cache[cache_key]


def _plan_assembly_uncached(
    spec_fn,
    compiled,
    *,
    probe_size: int,
    probe_edges: int,
    memory_limit_bytes: int,
) -> Optional[AssemblyPlan]:
    from .compile import compile_spec

    probe_dims = {k: min(v, probe_size) for k, v in compiled.dim_sizes.items()}
    # probes detect STRUCTURE (which channel-pair fields are exactly zero),
    # not values, so they always run in float32 — structural zeros are
    # dtype-independent, and the x64 CPU probe evaluation aborts with heap
    # corruption inside jaxlib's slice on this rig (pre-existing at r4;
    # minimal repro: poisson x64 plan; tests/test_double_precision.py)
    probe = compile_spec(spec_fn, probe_dims, jnp.float32)

    # the plan stores probe slot/term ids and assemble() resolves them in the
    # real compile — tracing is deterministic so the registries must agree;
    # bail out to the composed operator if a spec somehow traces
    # size-dependently.
    ps, cs = probe.registry.slots, compiled.registry.slots
    if len(ps) != len(cs) or len(probe.terms) != len(compiled.terms) or any(
        (a.kind, a.image, a.offset, a.graph, a.channels)
        != (b.kind, b.image, b.offset, b.graph, b.channels)
        for a, b in zip(ps, cs)
    ):
        return None

    unknown_sids = probe.unknown_slot_ids()
    if not unknown_sids:
        return None

    rng = np.random.RandomState(20260816)
    slots = probe.registry.slots

    def _group_key(so, si):
        s_out, s_in = slots[so], slots[si]
        if s_out.kind == "img":
            delta = tuple(b - a for a, b in zip(s_out.offset, s_in.offset))
            return (s_out.image, s_in.image, delta)
        return (s_out.graph, s_out.image, s_out.key[3], s_in.image, s_in.key[3])

    # traced comparison thresholds widen the probe value set so that
    # data-dependent gates flip across the probe grid
    Xp0, constsp0, graphsp0, paramsp0 = _probe_inputs(probe, rng, probe_edges)
    extra_vals = _comparison_constants(probe, Xp0, constsp0, graphsp0, paramsp0)

    nonzero: Dict[Tuple[int, int, int, int, int], bool] = {}
    probe_fields: List[Dict[Tuple, np.ndarray]] = []
    D = constsp = graphsp = paramsp = None
    for _draw in range(2):
        Xp, constsp, graphsp, paramsp = _probe_inputs(
            probe, rng, probe_edges, extra_vals
        )
        D, _mv, _bo, _pr = _slot_jacobians(probe, Xp, constsp, graphsp, paramsp, unknown_sids)
        pf: Dict[Tuple, np.ndarray] = {}
        for t_idx, term in enumerate(probe.terms):
            t_sids = [sid for sid in unknown_sids if sid in term.slot_ids]
            for so in t_sids:
                for si in t_sids:
                    Do = np.asarray(D[(t_idx, so)])
                    Di = np.asarray(D[(t_idx, si)])
                    # B[q, i, j] = sum_rch Do[q, rch, i] * Di[q, rch, j]
                    B = np.einsum("...ri,...rj->...ij", Do, Di)
                    nz = ~np.all(
                        B.reshape(-1, B.shape[-2], B.shape[-1]) == 0, axis=0
                    )
                    if slots[so].kind == "img":
                        off = tuple(-o for o in slots[so].offset)
                        Bacc = np.asarray(shift(jnp.asarray(B), off + (0, 0)))
                    else:
                        Bacc = B
                    gk = _group_key(so, si)
                    for i in range(nz.shape[0]):
                        for j in range(nz.shape[1]):
                            if nz[i, j]:
                                nonzero[(t_idx, so, si, i, j)] = True
                            prev = pf.get((gk, i, j))
                            pf[(gk, i, j)] = (
                                Bacc[..., i, j]
                                if prev is None
                                else prev + Bacc[..., i, j]
                            )
        probe_fields.append(pf)

    # terms with array-vs-array comparison gates: the probes can't certify
    # structure there (no literal threshold to straddle), so keep EVERY
    # channel pair of those terms — no structural pruning (safe fallback)
    tainted_terms = _terms_with_traced_gates(
        probe, Xp0, constsp0, graphsp0, paramsp0
    )
    for t_idx in tainted_terms:
        term = probe.terms[t_idx]
        t_sids = [sid for sid in unknown_sids if sid in term.slot_ids]
        for so in t_sids:
            for si in t_sids:
                for i in range(slots[so].channels):
                    for j in range(slots[si].channels):
                        nonzero[(t_idx, so, si, i, j)] = True

    w_spec: Dict[WKey, List[Tuple[int, int, int]]] = {}
    g_spec: Dict[GKey, List[Tuple[int, int, int]]] = {}
    group_pairs: Dict[Tuple, set] = {}
    group_channels: Dict[Tuple, Tuple[int, int]] = {}
    for (t_idx, so, si, i, j) in sorted(nonzero):
        s_out, s_in = slots[so], slots[si]
        gk = _group_key(so, si)
        group_pairs.setdefault(gk, set()).add((i, j))
        group_channels[gk] = (s_out.channels, s_in.channels)
        if s_out.kind == "img":
            key = gk + (i, j)
            w_spec.setdefault(key, []).append((t_idx, so, si))
        else:
            key = gk + (i, j)
            g_spec.setdefault(key, []).append((t_idx, so, si))

    # scalar groups: full diagonal with channel-identical fields at both draws
    scalar = set()
    for gk, pairs in group_pairs.items():
        c_out, c_in = group_channels[gk]
        if c_out != c_in or c_out < 2:
            continue
        if pairs != {(i, i) for i in range(c_out)}:
            continue
        same = True
        for pf in probe_fields:
            f0 = pf.get((gk, 0, 0))
            for i in range(1, c_out):
                fi = pf.get((gk, i, i))
                if f0 is None or fi is None or not np.array_equal(f0, fi):
                    same = False
                    break
            if not same:
                break
        if same:
            scalar.add(gk)
    if tainted_terms:
        # value-based detections are as unsound as zero-pruning for tainted
        # terms: drop their groups from the channel-identical collapse
        dirty_gks = {
            key[:-2]
            for spec_d in (w_spec, g_spec)
            for key, contribs in spec_d.items()
            if any(t in tainted_terms for (t, _so, _si) in contribs)
        }
        scalar -= dirty_gks

    needed = set()
    for contribs in list(w_spec.values()) + list(g_spec.values()):
        for (_t, so, si) in contribs:
            needed.add(so)
            needed.add(si)

    # constant-slot detection: a (term, slot) Jacobian field that is
    # bit-identical under a fresh unknown draw (consts/graphs/params held
    # fixed) is independent of X — its probes and pair products hoist out of
    # the nonlinear loop (assemble_const). Detection shares the probe
    # distribution's threshold-aware value mixing, so X-gated fields flip
    # and register as varying; like the structural-zero pruning it is
    # probabilistic, backed by the first-solve validation against the
    # composed operator (GaussNewtonSolver.validate_assembly).
    Xp_alt, _c2, _g2, _p2 = _probe_inputs(probe, rng, probe_edges, extra_vals)
    D_alt, _mv2, _bo2, _pr2 = _slot_jacobians(
        probe, Xp_alt, constsp, graphsp, paramsp, unknown_sids
    )
    const_tsids = set()
    for key in D:
        if key[0] in tainted_terms:
            continue  # gate may freeze under probes; never hoist (see above)
        a, b = np.asarray(D[key]), np.asarray(D_alt[key])
        if np.all(np.isfinite(a)) and np.array_equal(a, b):
            const_tsids.add(key)

    plan = AssemblyPlan(
        w_spec=w_spec,
        g_spec=g_spec,
        needed_slots=sorted(needed),
        scalar_groups=frozenset(scalar),
        const_tsids=frozenset(const_tsids),
    )
    if plan.centered_memory_bytes(compiled) > memory_limit_bytes:
        return None
    return plan


def _used_tsids(compiled, plan) -> List[Tuple[int, int]]:
    return [
        (t_idx, sid)
        for t_idx, term in enumerate(compiled.terms)
        for sid in plan.needed_slots
        if sid in term.slot_ids
    ]


def assemble_const(compiled, plan: AssemblyPlan, X0, consts, graphs, params,
                   mesh=None):
    """Loop-invariant assembly phase: probe the X-independent (term, slot)
    Jacobian fields once (any evaluation point is valid — here the solve's
    initial unknowns) and pre-multiply every coupling block whose both sides
    are constant. The solver runs this BEFORE the nonlinear ``while_loop``;
    the per-step :func:`assemble` then probes only the varying slots. For
    ARAP this hoists 9 of 12 probe columns and the Offset×Offset blocks; for
    linear problems (poisson) the entire operator hoists and per-step
    assembly is free."""
    used = _used_tsids(compiled, plan)
    const_ts = [k for k in used if k in plan.const_tsids]
    var_slots = sorted(
        {sid for (t, sid) in used if (t, sid) not in plan.const_tsids}
    )
    if not const_ts:
        return {"D": {}, "moved": None, "base": {}, "B": {},
                "var_slots": var_slots}
    cache_slots = sorted({sid for (_t, sid) in const_ts})
    D_all, moved, base_of, _pr_const = _slot_jacobians(
        compiled, X0, consts, graphs, params, cache_slots, mesh=mesh
    )
    D = {k: D_all[k] for k in const_ts}
    B: Dict[Tuple[int, int, int], jnp.ndarray] = {}
    for contribs in list(plan.w_spec.values()) + list(plan.g_spec.values()):
        for key in contribs:
            t_idx, so, si = key
            if key in B:
                continue
            if (t_idx, so) in plan.const_tsids and (
                t_idx, si
            ) in plan.const_tsids:
                Do = D[(t_idx, so)][..., :, :, None]
                Di = D[(t_idx, si)][..., :, None, :]
                B[key] = jnp.sum(Do * Di, axis=-3)
    return {"D": D, "moved": moved, "base": base_of, "B": B,
            "var_slots": var_slots}


def assemble(compiled, plan: AssemblyPlan, X, consts, graphs, params,
             row_masks, const_cache=None, mesh=None, coeff_dtype=None):
    """Assemble the coefficient fields at linearization point X.

    Returns (apply_fn, diag, jtf_fn, cg_meta): the row/column-masked JᵀJ·p
    operator, the (row-masked) Jacobi diagonal — read off the Δ=0 (i, i)
    fields and the same-endpoint graph fields, so the separate diagonal
    probe pass is unnecessary — a JᵀF evaluator over residual term arrays,
    and the stencil kernel's inputs (ops/stencil_kernel.py) or None;
    ``apply_fn.stencil_decline`` says why they are None.

    With ``const_cache`` (from :func:`assemble_const`) only the varying
    slots are probed at X; constant fields and constant×constant coupling
    blocks come from the cache and stay loop-invariant inside the solver's
    fused ``while_loop`` — the analogue of the reference folding
    input-independent partials at compile time (ad.t:129-251 constant
    folding under polysimplify).

    ``coeff_dtype`` (e.g. ``jnp.bfloat16``) narrows ONLY the storage of the
    CG-loop-resident coefficient fields (the HBM traffic of the hot loop);
    probes, JᵀF, the Jacobi diagonal and all CG state stay in the solve
    dtype, and the bf16·f32 multiplies promote back to f32
    (InitializationParameters.coefficient_dtype).
    """
    slots = compiled.registry.slots
    dt = compiled.dtype

    r_terms_primal = None
    if const_cache is None:
        D, moved, base_of, r_terms_primal = _slot_jacobians(
            compiled, X, consts, graphs, params, plan.needed_slots, mesh=mesh
        )
        jt_sources = [(moved, base_of)]
        src_of = {k: 0 for k in D}
        B_pre: Dict[Tuple[int, int, int], jnp.ndarray] = {}
    else:
        var_slots = const_cache["var_slots"]
        if var_slots:
            D_var, moved_var, base_var, r_terms_primal = _slot_jacobians(
                compiled, X, consts, graphs, params, var_slots, mesh=mesh
            )
        else:
            D_var, moved_var, base_var = {}, None, {}
        D = dict(D_var)
        # cache wins for constant (t, sid): the cached array is
        # loop-invariant, so every product against it hoists too
        D.update(const_cache["D"])
        jt_sources = []
        src_of = {}
        vi = None
        if moved_var is not None:
            vi = len(jt_sources)
            jt_sources.append((moved_var, base_var))
        ci = None
        if const_cache["moved"] is not None:
            ci = len(jt_sources)
            jt_sources.append((const_cache["moved"], const_cache["base"]))
        for k in D:
            src_of[k] = ci if k in const_cache["D"] else vi
        B_pre = const_cache["B"]

    # full coupling blocks per (term, slot-pair), each ONE product; the
    # per-channel-pair fields below are cheap slices of these. (A single
    # Gram matrix per term — einsum('...rp,...rq->...pq') over all probe
    # columns — lowers to batched tiny matmuls; it was slower on earlier
    # hardware, not yet measured on the H100.)
    B_all: Dict[Tuple[int, int, int], jnp.ndarray] = dict(B_pre)
    for contribs in list(plan.w_spec.values()) + list(plan.g_spec.values()):
        for (t_idx, so, si) in contribs:
            if (t_idx, so, si) not in B_all:
                # outer-product-and-reduce, elementwise
                Do = D[(t_idx, so)][..., :, :, None]  # [*dom, r, C_so, 1]
                Di = D[(t_idx, si)][..., :, None, :]  # [*dom, r, 1, C_si]
                B_all[(t_idx, so, si)] = jnp.sum(Do * Di, axis=-3)

    def _pair_field(contribs, i, j):
        for (t_idx, so, si) in contribs:
            yield (so, B_all[(t_idx, so, si)][..., i, j])

    # -- centered fields --------------------------------------------------
    fields: Dict[WKey, jnp.ndarray] = {}
    for key, contribs in plan.w_spec.items():
        u_out, u_in, delta, i, j = key
        if key[:3] in plan.scalar_groups and (i, j) != (0, 0):
            continue  # channel-identical: only the (0,0) field is materialized
        acc = None
        for so, B in _pair_field(contribs, i, j):
            off = tuple(-o for o in slots[so].offset)
            Bs = shift(B[..., None], off)[..., 0]
            acc = Bs if acc is None else acc + Bs
        m_out = row_masks.get(u_out)
        if m_out is not None:
            acc = acc * m_out[..., 0]
        m_in = row_masks.get(u_in)
        if m_in is not None:
            acc = acc * shift(m_in, delta)[..., 0]
        fields[key] = acc

    # -- graph couplings ------------------------------------------------------
    # with ELL tables bound, whole coupling blocks come straight from B_all
    # (one masked add per (term, slot pair) — no per-channel-pair detour);
    # without tables, per-(i,j) fields feed the scatter fallback below.
    g_couplings = {}  # (g,u_out,k_out,u_in,k_in) -> {(t,so,si), ...}
    for key, contribs in plan.g_spec.items():
        g, u_out, k_out, u_in, k_in, i, j = key
        g_couplings.setdefault(key[:5], set()).update(contribs)

    def _graph_masks(g, u_out, k_out, u_in, k_in):
        m = None
        m_out = row_masks.get(u_out)
        if m_out is not None:
            m = jnp.take(m_out[..., 0], graphs[g][k_out], axis=0)
        m_in = row_masks.get(u_in)
        if m_in is not None:
            mi = jnp.take(m_in[..., 0], graphs[g][k_in], axis=0)
            m = mi if m is None else m * mi
        return m

    def _coupling_block(ck):
        """UNMASKED [E, C_out, C_in] coupling block summed over
        contributions. Exclusion masking is applied in the CG loop as
        out = M · A(M · p) — identical algebra (masks are 0/1 diagonal),
        and it avoids one [E]-row mask gather per coupling side (~18
        gathers per ARAP assembly)."""
        acc = None
        for (t_idx, so, si) in sorted(g_couplings[ck]):
            B = B_all[(t_idx, so, si)]
            acc = B if acc is None else acc + B
        return acc

    # ---- classify coupling coverage -----------------------------------------
    # Every coupling runs through exactly one of three paths:
    #   * combined within-group ELL (both slots in one vertex-space group
    #     with combined incidence + cross tables bound): pre-summed same-slot
    #     blocks + ONE stacked cross gather per group — the fast path.
    #   * per-pair ELL (slots in different vertex-space groups, per-slot
    #     tables bound): rare cross-space unknown couplings.
    #   * scatter fallback (no tables): per-(i, j) fields + .at[].add — the
    #     oracle path in tests.
    from .ops.graph_ops import slot_groups

    unknown_channels = {
        u: compiled.unknown_shape(u)[-1] for u in compiled.unknown_names
    }

    g_layouts = {}  # (g, group_key) -> (names, u_list, offs, Ctot)
    _slot_of_group = {}
    for g in sorted({ck[0] for ck in g_couplings}):
        gdecl = compiled.registry.graphs[g]
        for group_key, names, _n in slot_groups(gdecl, compiled.dim_sizes):
            if graphs[g].get(group_key) is None:
                continue
            us = set()
            for (gg, u_out, k_out, u_in, k_in) in g_couplings:
                if gg != g:
                    continue
                if k_out in names:
                    us.add(u_out)
                if k_in in names:
                    us.add(u_in)
            if not us:
                continue
            u_list = sorted(us)
            offs, o = {}, 0
            for u in u_list:
                offs[u] = o
                o += unknown_channels[u]
            g_layouts[(g, group_key)] = (names, u_list, offs, o)
            for k in names:
                _slot_of_group[(g, k)] = group_key

    _group_mask_cache: Dict[Tuple[str, str], Optional[jnp.ndarray]] = {}

    def _group_mask(g, gk):
        """Packed [N, Ctot] 0/1 row mask for a vertex-space group (None when
        nothing is excluded) — the M in out = M · A(M · p)."""
        key = (g, gk)
        if key in _group_mask_cache:
            return _group_mask_cache[key]
        _names, u_list, _offs, _ctot = g_layouts[key]
        if all(row_masks.get(u) is None for u in u_list):
            pm = None
        else:
            parts = []
            for u in u_list:
                m = row_masks.get(u)
                shape = (
                    compiled.unknown_shape(u)[0],
                    unknown_channels[u],
                )
                parts.append(
                    jnp.ones(shape, dt)
                    if m is None
                    else jnp.broadcast_to(m, shape)
                )
            pm = (
                jnp.concatenate(parts, axis=-1)
                if len(parts) > 1
                else parts[0]
            )
        _group_mask_cache[key] = pm
        return pm

    grp_cks: Dict[Tuple[str, str], list] = {}
    pair_cks: Dict[Tuple, list] = {}
    covered = set()
    for ck in sorted(g_couplings):
        g, u_out, k_out, u_in, k_in = ck
        gk_o = _slot_of_group.get((g, k_out))
        gk_i = _slot_of_group.get((g, k_in))
        if gk_o is None or gk_i is None:
            continue
        if gk_o == gk_i:
            if graphs[g].get("__ellx__" + gk_o[len("__inc__"):]) is None:
                continue
            grp_cks.setdefault((g, gk_o), []).append(ck)
        else:
            if (
                graphs[g].get(f"__ell_inc_{k_out}") is None
                or graphs[g].get(f"__ell_{k_out}__{k_in}") is None
            ):
                continue
            pair_cks.setdefault((g, gk_o, gk_i, k_out, k_in), []).append(ck)
        covered.add(ck)

    gfields: Dict[GKey, jnp.ndarray] = {}
    for key, contribs in plan.g_spec.items():
        g, u_out, k_out, u_in, k_in, i, j = key
        if key[:5] in covered:
            continue  # ELL paths build whole blocks; no per-pair fields
        if key[:5] in plan.scalar_groups and (i, j) != (0, 0):
            continue
        acc = None
        for _so, B in _pair_field(contribs, i, j):
            acc = B if acc is None else acc + B
        m = _graph_masks(g, u_out, k_out, u_in, k_in)
        gfields[key] = acc if m is None else acc * m

    # Group per (u_out, u_in, Δ) / per graph coupling and pre-pack the channel
    # structure into one of two vectorized forms so the CG hot loop runs a few
    # wide elementwise ops instead of one pass per channel pair:
    #   'diag'  — pairs are a subset of the diagonal: one [*dom, C] multiply
    #   'block' — general coupling: one [*dom, C_out, C_in] einsum
    def _pack_group(pair_fields, c_out, c_in, dom_shape, is_scalar):
        pairs = sorted(pair_fields)
        if is_scalar:
            # one [*dom, 1] field broadcast over channels
            return ("scalar", pair_fields[(0, 0)][..., None])
        if all(i == j for (i, j) in pairs):
            cols = [
                pair_fields.get((i, i), None) for i in range(min(c_out, c_in))
            ]
            cols = [
                c if c is not None else jnp.zeros(dom_shape, dt) for c in cols
            ]
            return ("diag", jnp.stack(cols, axis=-1))
        block = jnp.zeros(dom_shape + (c_out, c_in), dt)
        for (i, j), f in pair_fields.items():
            block = block.at[..., i, j].set(f)
        return ("block", block)

    w_groups = {}
    for (u_out, u_in, delta, i, j), field in fields.items():
        w_groups.setdefault((u_out, u_in, delta), {})[(i, j)] = field

    # pack ACROSS unknowns per (index space, Δ): when several (u_out, u_in)
    # couplings share a stencil offset (mixed-unknown problems like
    # image_warping's Offset/Angle), one shift of the channel-packed p and
    # one block multiply replace one shift + one op per coupling.
    isp_of = {
        u: compiled.registry.images[u].ispace for u in compiled.unknown_names
    }
    by_isp_delta: Dict[Tuple, list] = {}
    for (u_out, u_in, delta), pf in w_groups.items():
        by_isp_delta.setdefault((isp_of[u_out], delta), []).append(
            (u_out, u_in, pf)
        )

    w_layouts = {}  # ispace -> (u_list, offs, ctot)
    for isp in {k[0] for k in by_isp_delta}:
        u_list = [u for u in compiled.unknown_names if isp_of[u] == isp]
        offs, o = {}, 0
        for u in u_list:
            offs[u] = o
            o += unknown_channels[u]
        w_layouts[isp] = (u_list, offs, o)

    w_packed = []  # (isp, delta, kind, W) — kind 'scalar'|'diag'|'block'
    for (isp, delta), groups in by_isp_delta.items():
        u_list, offs, ctot = w_layouts[isp]
        dom = isp.shape(compiled.dim_sizes)
        if len(groups) == 1 and groups[0][0] == groups[0][1]:
            # single same-unknown coupling: keep the cheap narrow forms
            u_out, u_in, pf = groups[0]
            kind, W = _pack_group(
                pf, unknown_channels[u_out], unknown_channels[u_in], dom,
                (u_out, u_in, delta) in plan.scalar_groups,
            )
            w_packed.append((isp, delta, kind, W, offs[u_out], offs[u_in],
                             unknown_channels[u_out], unknown_channels[u_in]))
            continue
        block = jnp.zeros(dom + (ctot, ctot), dt)
        for (u_out, u_in, pf) in groups:
            oo, oi = offs[u_out], offs[u_in]
            if (u_out, u_in, delta) in plan.scalar_groups:
                f = pf[(0, 0)]
                for ch in range(unknown_channels[u_out]):
                    block = block.at[..., oo + ch, oi + ch].add(f)
            else:
                for (i, j), f in pf.items():
                    block = block.at[..., oo + i, oi + j].add(f)
        w_packed.append((isp, delta, "block", block, 0, 0, ctot, ctot))

    g_groups = {}
    for (g, u_out, k_out, u_in, k_in, i, j), field in gfields.items():
        g_groups.setdefault((g, u_out, k_out, u_in, k_in), {})[(i, j)] = field
    g_packed = []
    for (g, u_out, k_out, u_in, k_in), pf in g_groups.items():
        E = graphs[g][k_out].shape[0]
        kind, W = _pack_group(
            pf, unknown_channels[u_out], unknown_channels[u_in], (E,),
            (g, u_out, k_out, u_in, k_in) in plan.scalar_groups,
        )
        g_packed.append((g, u_out, k_out, u_in, k_in, kind, W))

    # ---- combined within-group ELL exec -------------------------------------
    # Per (graph, vertex-space group): ONE stacked block array over all
    # incidence rows — position 0 holds the same-slot block P(k, k)[e],
    # positions 1..m-1 the cross blocks P(k, rot_j(k))[e] in the rotation
    # order of ops/graph_ops.combined_cross_table — gathered through the
    # combined incidence table in ONE take (gather cost is per row; packing
    # all slots and couplings into shared rows is the whole ballgame). The
    # same-slot blocks reduce over incidences at assembly time (their
    # p-value is p[v] for every incidence), so the CG hot loop applies a
    # single [N, Ct, Ct] block plus one cross gather + reduction.
    grp_exec = {}
    # incidence-aligned groups: per-step assembly gathers the NARROW raw
    # probe columns into incidence space and builds coupling blocks
    # post-gather (flat minor, static placement matmuls), gathering
    # [N·D, r·P] probe elements instead of [m·E, m·Ct²] stacked
    # coefficient rows (opt-in; not yet measured on the H100).
    # Constant-source probe gathers are loop-invariant and LICM-hoisted.
    # aligned_jtf[(g, gk)](r_terms) reuses the same gathered probes for the
    # group's JᵀF rows. Single-device path (meshes keep the stacked-row
    # halo exchange below).
    aligned_jtf = {}
    aligned_slots = set()  # (graph, slot key3) handled by an aligned group

    def _place(a, M):
        """Static 0/1 placement matmul at full f32 accuracy: a reduced-
        precision pass (TF32 on the H100) would round the coefficient
        operand to ~3 decimal digits, enough to fail validate_assembly's
        5e-4 assembled-vs-composed check and drop the plan to the composed
        operator."""
        return jnp.matmul(a, M, precision=jax.lax.Precision.HIGHEST)

    def _make_aligned_exec(g, gk, cks):
        suffix = gk[len("__inc__"):]
        names, u_list, offs, ct = g_layouts[(g, gk)]
        m = len(names)
        E = graphs[g][names[0]].shape[0]
        edge_t = graphs[g]["__edge__" + suffix]  # [N, D] int32, sentinel E
        anchor = graphs[g]["__anchor__" + suffix].astype(dt)  # [N, D, m]
        n_out, d_tot = edge_t.shape
        inc_flat = edge_t.reshape(-1)
        a_of = {k: i for i, k in enumerate(names)}

        movedg: Dict[Tuple[int, int], jnp.ndarray] = {}

        def _gath(src, t_idx2):
            """Per-term probe matrix gathered to incidence space:
            [N, D, r_t, P_src]. Constant sources depend only on loop
            invariants, so XLA hoists their gather out of the solver's
            while_loop."""
            key = (src, t_idx2)
            got = movedg.get(key)
            if got is None:
                mv = jt_sources[src][0][t_idx2]  # [E, r, P]
                r_, P_ = mv.shape[-2], mv.shape[-1]
                flat = mv.reshape(E, r_ * P_)
                ext = jnp.concatenate(
                    [flat, jnp.zeros((1, r_ * P_), flat.dtype)], 0
                )
                got = jnp.take(ext, inc_flat, axis=0).reshape(
                    n_out, d_tot, r_, P_
                )
                movedg[key] = got
            return got

        def _Dg(t_idx2, sid):
            src = src_of[(t_idx2, sid)]
            base = jt_sources[src][1][sid]
            s = slots[sid]
            return _gath(src, t_idx2)[..., base : base + s.channels]

        # coupling blocks at incidence rows, gated by the anchor one-hot
        s_parts, s_cols = [], []  # same-slot → S
        c_parts, c_meta = [], []  # cross → rotation-aware placement
        for ck in sorted(cks):
            _, u_out, k_out, u_in, k_in = ck
            a = a_of[k_out]
            gate = anchor[..., a]
            co, ci = unknown_channels[u_out], unknown_channels[u_in]
            oo, oi = offs[u_out], offs[u_in]
            acc = None
            for (t_idx2, so, si) in sorted(g_couplings[ck]):
                Do = _Dg(t_idx2, so)  # [N, D, r, co]
                Di = _Dg(t_idx2, si)  # [N, D, r, ci]
                B = (Do[..., :, :, None] * Di[..., :, None, :]).reshape(
                    n_out, d_tot, -1, co * ci
                ).sum(-2)
                acc = B if acc is None else acc + B
            acc = acc * gate[..., None]
            cols = [
                (oo + i_) * ct + (oi + j_)
                for i_ in range(co)
                for j_ in range(ci)
            ]
            if k_out == k_in:
                s_parts.append(acc)
                s_cols.append(cols)
            else:
                c_parts.append(acc)
                c_meta.append(((a_of[k_in] - a - 1) % m, cols))

        # S: reduce over incidences FIRST, then one placement matmul
        K_s = sum(p.shape[-1] for p in s_parts)
        M_s = np.zeros((max(1, K_s), ct * ct), np.float64)
        col0 = 0
        for p, cols in zip(s_parts, s_cols):
            for kk, cc_ in enumerate(cols):
                M_s[col0 + kk, cc_] = 1.0
            col0 += p.shape[-1]
        if s_parts:
            S_pre = jnp.concatenate(s_parts, -1).sum(1)  # [N, K_s]
            S_flat = _place(S_pre, jnp.asarray(M_s, dt))  # [N, ct*ct] flat
        else:
            S_flat = jnp.zeros((n_out, ct * ct), dt)

        exec_entry = {"S": S_flat, "ct": ct, "dia": [], "C": None,
                      "cross": None, "halo": (None, None)}

        if c_parts:
            dia_masks = {}
            pref = f"__diamask__{suffix}__"
            for key in graphs[g]:
                if key.startswith(pref):
                    dia_masks[int(key[len(pref):])] = graphs[g][key]
            rem_pos = graphs[g].get(f"__diarem__{suffix}")
            need_full = (not dia_masks) or (
                rem_pos is not None and rem_pos.shape[1] > 0
            )
            if dia_masks:
                # per-offset fields: mask BEFORE placement on the narrow
                # parts (mask[:, :, j_rot] per part), one matmul per offset
                M_c36 = np.zeros(
                    (sum(p.shape[-1] for p in c_parts), ct * ct), np.float64
                )
                col0 = 0
                for p, (j_rot, cols) in zip(c_parts, c_meta):
                    for kk, cc_ in enumerate(cols):
                        M_c36[col0 + kk, cc_] = 1.0
                    col0 += p.shape[-1]
                M_c36j = jnp.asarray(M_c36, dt)
                for off in sorted(dia_masks):
                    mask = dia_masks[off].astype(dt)  # [N, D, m-1]
                    masked = jnp.concatenate(
                        [
                            p * mask[:, :, j_rot][..., None]
                            for p, (j_rot, _c) in zip(c_parts, c_meta)
                        ],
                        -1,
                    ).sum(1)  # [N, K_c]
                    exec_entry["dia"].append((int(off), _place(masked, M_c36j)))
            if need_full:
                # full cross rows for the remainder gather / no-DIA apply:
                # one rotation-aware placement matmul, flat minor
                K_c = sum(p.shape[-1] for p in c_parts)
                M_c = np.zeros((K_c, (m - 1) * ct * ct), np.float64)
                col0 = 0
                for p, (j_rot, cols) in zip(c_parts, c_meta):
                    for kk, cc_ in enumerate(cols):
                        M_c[col0 + kk, j_rot * ct * ct + cc_] = 1.0
                    col0 += p.shape[-1]
                Cb_flat = _place(
                    jnp.concatenate(c_parts, -1), jnp.asarray(M_c, dt)
                )  # [N, D, (m-1)*ct*ct]
                if rem_pos is not None:
                    # [N, Dm, K] merged duplicate reads (dedup_reads): the
                    # K blocks of one merged endpoint pre-sum per GN step
                    d_rem = rem_pos.shape[1]
                    C_flat = Cb_flat.reshape(
                        n_out, d_tot * (m - 1), ct * ct
                    )
                    C_ext = jnp.concatenate(
                        [C_flat, jnp.zeros((n_out, 1, ct * ct), dt)], axis=1
                    )
                    C_r = None
                    for k_d in range(rem_pos.shape[2]):
                        part = jnp.take_along_axis(
                            C_ext, rem_pos[:, :, k_d][..., None], axis=1
                        )
                        C_r = part if C_r is None else C_r + part
                    exec_entry["C"] = jnp.transpose(
                        C_r.reshape(n_out, d_rem, ct, ct), (0, 2, 1, 3)
                    ).reshape(n_out, ct, d_rem * ct)
                    exec_entry["cross"] = graphs[g][
                        f"__diaremcross__{suffix}"
                    ][:, :, None]
                else:
                    exec_entry["C"] = jnp.transpose(
                        Cb_flat.reshape(n_out, d_tot, m - 1, ct, ct),
                        (0, 3, 1, 2, 4),
                    ).reshape(n_out, ct, d_tot * (m - 1) * ct)
                    exec_entry["cross"] = graphs[g]["__ellx__" + suffix]

        # JᵀF rows through the same gathered probes: jt[v,d,p] =
        # Σ_rch moved[v,d,rch,p]·r[v,d,rch], anchor-gated per slot, placed
        # into packed channels by one static [m·P, ct] matmul per source
        # term (o.t:2228-2253 createjtfgraph, scatter-free).
        # every (term, slot) in D touching this group — not just the JᵀJ
        # couplings' terms — so no JᵀF contribution is dropped
        t_set = sorted({
            t
            for (t, sid) in D
            if slots[sid].kind != "img"
            and slots[sid].graph == g
            and slots[sid].key[3] in a_of
        })
        jt_specs = []
        for t_idx2 in t_set:
            for src in {
                src_of[(t_idx2, sid)]
                for sid in plan.needed_slots
                if (t_idx2, sid) in src_of
            }:
                P_src = jt_sources[src][0][t_idx2].shape[-1]
                Mjt = np.zeros((m * P_src, ct), np.float64)
                any_nz = False
                for sid, base in jt_sources[src][1].items():
                    if (t_idx2, sid) not in src_of or src_of[
                        (t_idx2, sid)
                    ] != src:
                        continue
                    s = slots[sid]
                    if s.kind == "img" or s.graph != g or (
                        s.key[3] not in a_of
                    ):
                        continue
                    a = a_of[s.key[3]]
                    for chv in range(s.channels):
                        Mjt[a * P_src + base + chv, offs[s.image] + chv] = 1.0
                        any_nz = True
                if any_nz:
                    jt_specs.append((src, t_idx2, jnp.asarray(Mjt, dt)))

        def group_jtf(r_terms):
            out_g = jnp.zeros((n_out, ct), dt)
            rg_cache = {}
            for (src, t_idx2, Mjt) in jt_specs:
                rg = rg_cache.get(t_idx2)
                if rg is None:
                    rt = r_terms[t_idx2]  # [E, r]
                    ext = jnp.concatenate(
                        [rt, jnp.zeros((1, rt.shape[-1]), rt.dtype)], 0
                    )
                    rg = jnp.take(ext, inc_flat, axis=0).reshape(
                        n_out, d_tot, rt.shape[-1]
                    )
                    rg_cache[t_idx2] = rg
                jt = jnp.sum(
                    _gath(src, t_idx2) * rg[..., None], axis=-2
                )  # [N, D, P]
                # anchor-gated reduction per slot position, then placement
                w = jnp.concatenate(
                    [
                        jnp.sum(jt * anchor[..., a][..., None], axis=1)
                        for a in range(m)
                    ],
                    -1,
                )  # [N, m*P]
                out_g = out_g + _place(w, Mjt)
            return out_g

        for k in names:
            aligned_slots.add((g, k))
        aligned_jtf[(g, gk)] = group_jtf
        return exec_entry

    for (g, gk), cks in grp_cks.items():
        names, u_list, offs, ct = g_layouts[(g, gk)]
        m = len(names)
        E = graphs[g][names[0]].shape[0]
        suffix = gk[len("__inc__"):]
        if mesh is None and graphs[g].get("__edge__" + suffix) is not None:
            grp_exec[(g, gk)] = _make_aligned_exec(g, gk, cks)
            continue
        by_pair: Dict[Tuple[str, str], list] = {}
        for ck in cks:
            by_pair.setdefault((ck[2], ck[4]), []).append(ck)

        def _build_P(ko, ki, _offs=offs, _ct=ct, _E=E, _bp=by_pair):
            parts = _bp.get((ko, ki))
            if parts is None:
                return None
            acc = jnp.zeros((_E, _ct, _ct), dt)
            for ck in parts:
                _, u_out, _, u_in, _ = ck
                oo, oi = _offs[u_out], _offs[u_in]
                co, ci = unknown_channels[u_out], unknown_channels[u_in]
                acc = acc.at[:, oo : oo + co, oi : oi + ci].add(
                    _coupling_block(ck)
                )
            return acc

        P = {}
        for a in range(m):
            for b in range(a, m):
                ko, ki = names[a], names[b]
                blk = _build_P(ko, ki)
                if blk is not None:
                    P[(ko, ki)] = blk
                    if a != b:
                        # JᵀJ symmetry: P(ki, ko)[e] = P(ko, ki)[e]ᵀ exactly
                        # (products commute elementwise; masks are per
                        # (unknown, vertex) so the product is symmetric too)
                        P[(ki, ko)] = jnp.swapaxes(blk, -1, -2)
                elif a != b:
                    blk_t = _build_P(ki, ko)
                    if blk_t is not None:
                        P[(ki, ko)] = blk_t
                        P[(ko, ki)] = jnp.swapaxes(blk_t, -1, -2)

        has_cross = any(k1 != k2 for (k1, k2) in P)
        n_stack = m if has_cross else 1
        # stacked rows are stored FLAT ([rows, n_stack*ct*ct], one large
        # minor dim) — the block shape reappears only inside the fused
        # consumer reductions (a layout from before the H100, not yet
        # measured there).
        zero = jnp.zeros((E, ct, ct), dt)
        rows = []
        for a, k in enumerate(names):
            cols = [P.get((k, k), zero)]
            for j in range(n_stack - 1):
                cols.append(P.get((k, names[(a + 1 + j) % m]), zero))
            rows.append(
                jnp.concatenate(
                    [c.reshape(E, ct * ct) for c in cols], axis=-1
                )
            )  # [E, n_stack*ct*ct]
        inc = graphs[g][gk]
        n_out, d_tot = inc.shape
        inc_send = graphs[g].get("__halo_send__" + gk)
        inc_loc = graphs[g].get("__halo_loc__" + gk)
        if mesh is not None and inc_send is not None:
            # owner-block neighbor exchange for the per-GN-step assembly
            # gather: a global take here reads edge-block rows from
            # vertex-owner rows, which XLA SPMD satisfies by all-gathering
            # the whole stacked block array every GN step (O(m·E·Ct²), the
            # dominant per-step collective). Each device instead sends just
            # the boundary rows of its own edge shards through one
            # all_to_all (tables precomputed at bind over the device-major
            # row mapping — parallel/mesh.py map_stacked_rows_device_major).
            from .parallel.mesh import halo_gather_parts

            G = halo_gather_parts(mesh, rows, inc_send, inc_loc)
        else:
            W_grp = jnp.concatenate(
                rows + [jnp.zeros((1, n_stack * ct * ct), dt)], axis=0
            )  # [m*E + 1, ...]; the inc sentinel (m*E) reads the zero row
            G = jnp.take(W_grp, inc.reshape(-1), axis=0).reshape(
                (n_out, d_tot, n_stack * ct * ct)
            )
        # S and the DIA fields are stored FLAT [N, ct*ct] (loop-resident
        # reads; trailing [ct, ct] dims lane-pad ~(128/ct)x in HBM) and
        # reshaped inside the fused consumers.
        S_sum = jnp.sum(G[:, :, : ct * ct], axis=1)
        exec_entry = {"S": S_sum, "ct": ct, "dia": [], "C": None,
                      "cross": None, "halo": (None, None)}
        if has_cross:
            suffix = gk[len("__inc__"):]
            Cb = G[:, :, ct * ct :].reshape(n_out, d_tot, m - 1, ct, ct)
            dia_masks = {}
            pref = f"__diamask__{suffix}__"
            for key in graphs[g]:
                if key.startswith(pref):
                    dia_masks[int(key[len(pref):])] = graphs[g][key]
            rem_pos = graphs[g].get(f"__diarem__{suffix}")
            if dia_masks:
                # DIA split (ops/graph_ops.dia_split): incidences at the
                # dominant vertex-id offsets pre-sum into per-offset blocks
                # applied as SHIFTED adds — the CG-loop gather (~85% of a
                # graph CG iteration) only covers the irregular remainder
                for off in sorted(dia_masks):
                    mask = dia_masks[off]  # [N, D, m-1] float
                    W_off = jnp.sum(
                        Cb * mask[..., None, None], axis=(1, 2)
                    ).reshape(n_out, ct * ct)  # flat, see S above
                    exec_entry["dia"].append((int(off), W_off))
            if rem_pos is not None:
                # rem_pos [N, Dm, K]: duplicate (v, u) reads merged — the K
                # coupling blocks of a merged read pre-sum HERE (per GN
                # step), so the CG loop gathers one p row per DISTINCT
                # endpoint (ops/graph_ops.dedup_reads; ~2x fewer
                # latency-bound gather rows on 2-slot meshes)
                if rem_pos.shape[1] > 0:
                    d_rem = rem_pos.shape[1]
                    C_flat = Cb.reshape(n_out, d_tot * (m - 1), ct * ct)
                    C_ext = jnp.concatenate(
                        [C_flat, jnp.zeros((n_out, 1, ct * ct), dt)], axis=1
                    )
                    C_r = None
                    for k_d in range(rem_pos.shape[2]):
                        part = jnp.take_along_axis(
                            C_ext, rem_pos[:, :, k_d][..., None], axis=1
                        )  # [N, D_rem, ct*ct]
                        C_r = part if C_r is None else C_r + part
                    exec_entry["C"] = jnp.transpose(
                        C_r.reshape(n_out, d_rem, ct, ct), (0, 2, 1, 3)
                    ).reshape(n_out, ct, d_rem * ct)
                    exec_entry["cross"] = graphs[g][
                        f"__diaremcross__{suffix}"
                    ][:, :, None]
                    exec_entry["halo"] = (
                        graphs[g].get(
                            "__halo_send__" + f"__diaremcross__{suffix}"
                        ),
                        graphs[g].get(
                            "__halo_loc__" + f"__diaremcross__{suffix}"
                        ),
                    )
            elif not dia_masks:
                # output-channel-major layout [N, i, D*(m-1)*k]: the CG-loop
                # cross apply becomes ONE broadcast-multiply with a single
                # minor-axis (lane) reduction — reductions over scattered
                # middle axes measured ~30% slower per iteration
                exec_entry["C"] = jnp.transpose(
                    Cb, (0, 3, 1, 2, 4)
                ).reshape(n_out, ct, d_tot * (m - 1) * ct)
                exec_entry["cross"] = graphs[g]["__ellx__" + suffix]
                exec_entry["halo"] = (
                    graphs[g].get("__halo_send__" + "__ellx__" + suffix),
                    graphs[g].get("__halo_loc__" + "__ellx__" + suffix),
                )
        grp_exec[(g, gk)] = exec_entry

    # ---- cross-group per-pair ELL exec (unknowns in different vertex
    # spaces coupled through one hyperedge) ------------------------------------
    pair_exec = {}
    for key, cks in pair_cks.items():
        g, gk_out, gk_in, k_out, k_in = key
        E = graphs[g][k_out].shape[0]
        _, _, offs_o, ct_o = g_layouts[(g, gk_out)]
        _, _, offs_i, ct_i = g_layouts[(g, gk_in)]
        Wb = jnp.zeros((E, ct_o, ct_i), dt)
        for ck in cks:
            _, u_out, _, u_in, _ = ck
            oo, oi = offs_o[u_out], offs_i[u_in]
            co, ci = unknown_channels[u_out], unknown_channels[u_in]
            Wb = Wb.at[:, oo : oo + co, oi : oi + ci].add(_coupling_block(ck))
        inc = graphs[g][f"__ell_inc_{k_out}"]  # [N_out, D] edge ids, sentinel E
        W_ext = jnp.concatenate([Wb, jnp.zeros((1, ct_o, ct_i), dt)], axis=0)
        n_out, d_max = inc.shape
        W_ell = jnp.take(
            W_ext, jnp.minimum(inc, E).reshape(-1), axis=0
        ).reshape((n_out, d_max, ct_o, ct_i))
        ell = graphs[g][f"__ell_{k_out}__{k_in}"]  # [N_out, D] vertex ids
        pair_exec[key] = (W_ell, ell)

    # couplings without tables fall back to the scatter path
    g_unhandled = list(g_packed)

    def apply_fn(p):
        out = {u: None for u in unknown_channels}

        # centered: one shift of the channel-packed p per (ispace, Δ), one
        # multiply per entry, vectorized over channels
        packed_pc = {
            isp: jnp.concatenate([p[u] for u in u_list], axis=-1)
            if len(u_list) > 1
            else p[u_list[0]]
            for isp, (u_list, _offs, _ct) in w_layouts.items()
        }
        shifted = {}
        acc_c = {isp: None for isp in w_layouts}
        for (isp, delta, kind, W, oo, oi, co, ci) in w_packed:
            key_s = (isp, delta)
            ps_full = shifted.get(key_s)
            if ps_full is None:
                ps_full = shift(packed_pc[isp], delta)
                shifted[key_s] = ps_full
            ctot = w_layouts[isp][2]
            ps = ps_full[..., oi : oi + ci] if (oi, ci) != (0, ctot) else ps_full
            if kind == "scalar":
                contrib = W * ps  # [*dom,1] broadcast over channels
            elif kind == "diag":
                c = W.shape[-1]
                contrib = W * ps[..., :c]
                if c < co:
                    contrib = jnp.pad(
                        contrib,
                        [(0, 0)] * (contrib.ndim - 1) + [(0, co - c)],
                    )
            else:
                # broadcast-mul + reduce: no tiny matmuls, so no reduced-
                # precision (TF32) pass on these 1-3 channel blocks
                contrib = jnp.sum(W * ps[..., None, :], axis=-1)
            if (oo, co) != (0, ctot):
                contrib = jnp.pad(
                    contrib,
                    [(0, 0)] * (contrib.ndim - 1) + [(oo, ctot - oo - co)],
                )
            acc_c[isp] = contrib if acc_c[isp] is None else acc_c[isp] + contrib
        for isp, acc in acc_c.items():
            if acc is None:
                continue
            u_list, offs, _ct = w_layouts[isp]
            for u in u_list:
                sl = acc[..., offs[u] : offs[u] + unknown_channels[u]]
                out[u] = sl if out[u] is None else out[u] + sl

        # graph fast path: channel-packed p per (graph, vertex-space) group;
        # pre-summed same-slot blocks apply as one [N, Ct, Ct]·p[v] product
        # (no gather at all); cross couplings gather p once through the
        # combined cross table and reduce over the padded incidence axis —
        # no HBM-source output gather and no scatter.
        packed_p = {}
        for (g, gk), (names, u_list, offs, ctot) in g_layouts.items():
            pp = (
                jnp.concatenate([p[u] for u in u_list], axis=-1)
                if len(u_list) > 1
                else p[u_list[0]]
            )
            pm = _group_mask(g, gk)
            packed_p[(g, gk)] = pp if pm is None else pp * pm

        def _block_matvec(W_flat, pv, ct_g):
            # out[:, i] = Σ_j W_flat[:, i·ct+j] · pv[:, j] as ct sublane
            # slices + minor reduces on the FLAT [N, ct²] field — no
            # [N, ct, ct] value ever exists in the CG loop. The 3-D
            # broadcast-mul form costs a tile-relayout copy per iteration
            # when XLA sinks the invariant reshape into the while body
            # (interleaved A/B: 7.33 vs 0.074 ms/iter, scripts/ab_arap.py);
            # this form measures 16x faster than even the carried-3-D form
            # (scripts/apply_micro.py: 0.0009 vs 0.0148 ms/iter at 36k·6).
            return jnp.stack(
                [
                    jnp.sum(W_flat[:, i * ct_g : (i + 1) * ct_g] * pv, -1)
                    for i in range(ct_g)
                ],
                axis=-1,
            )

        group_acc: Dict[Tuple[str, str], jnp.ndarray] = {}
        for (g, gk), ex in grp_exec.items():
            pp = packed_p[(g, gk)]
            ct_g = ex["ct"]
            contrib = _block_matvec(ex["S"], pp, ct_g)  # [N, Ct]
            # DIA offsets: cross couplings at dominant vertex-id offsets
            # read p by a zero-padded shift — no gather
            for off, W_off in ex["dia"]:
                ps = shift(pp, (off,))
                contrib = contrib + _block_matvec(W_off, ps, ct_g)
            C_ell, cross = ex["C"], ex["cross"]
            if C_ell is not None:
                n_out = cross.shape[0]
                h_send, h_loc = ex.get("halo", (None, None))
                if mesh is not None and h_send is not None:
                    # owner-block neighbor exchange: one all_to_all of the
                    # precomputed boundary rows + a local gather, instead
                    # of the XLA-SPMD all-gather a global take would cost
                    # (parallel/mesh.py halo_gather)
                    from .parallel.mesh import halo_gather

                    pc = halo_gather(mesh, pp, h_send, h_loc).reshape(
                        (n_out, 1, C_ell.shape[-1])
                    )
                else:
                    pp_ext = jnp.concatenate(
                        [pp, jnp.zeros((1, pp.shape[-1]), dt)], axis=0
                    )
                    pc = jnp.take(
                        pp_ext, cross.reshape(-1), axis=0
                    ).reshape(
                        (n_out, 1, C_ell.shape[-1])
                    )  # [N, 1, D_rem*k] in (d, j, k) order, matching C_ell
                contrib = contrib + jnp.sum(C_ell * pc, axis=-1)
            key_a = (g, gk)
            cur = group_acc.get(key_a)
            group_acc[key_a] = contrib if cur is None else cur + contrib

        for key, (W_ell, ell) in pair_exec.items():
            g, gk_out, gk_in, k_out, k_in = key
            pp = packed_p[(g, gk_in)]
            pp_ext = jnp.concatenate(
                [pp, jnp.zeros((1, pp.shape[-1]), dt)], axis=0
            )
            n_out, d_max = ell.shape
            pg = jnp.take(pp_ext, ell.reshape(-1), axis=0).reshape(
                (n_out, d_max, pp.shape[-1])
            )
            contrib = jnp.einsum(
                "vdik,vdk->vi", W_ell, pg, precision=jax.lax.Precision.HIGHEST
            )  # full f32: no TF32 pass on the H100
            key_a = (g, gk_out)
            cur = group_acc.get(key_a)
            group_acc[key_a] = contrib if cur is None else cur + contrib

        for (g, gk), acc in group_acc.items():
            _names, u_list, offs, _ctot = g_layouts[(g, gk)]
            pm = _group_mask(g, gk)
            if pm is not None:
                acc = acc * pm  # output-row exclusion mask
            for u in u_list:
                sl = acc[:, offs[u] : offs[u] + unknown_channels[u]]
                out[u] = sl if out[u] is None else out[u] + sl

        # fallback: couplings without a combined table — per-coupling ops and
        # a scatter-add (still the oracle path in tests)
        gathered = {}
        edge_acc: Dict[Tuple[str, str, str], jnp.ndarray] = {}
        for (g, u_out, k_out, u_in, k_in, kind, W) in g_unhandled:
            key_g = (g, u_in, k_in)
            pg = gathered.get(key_g)
            if pg is None:
                pg = jnp.take(p[u_in], graphs[g][k_in], axis=0)  # [E, C_in]
                gathered[key_g] = pg
            if kind == "scalar":
                contrib = W * pg
            elif kind == "diag":
                c = W.shape[-1]
                contrib = W * pg[..., :c]
                if c < unknown_channels[u_out]:
                    contrib = jnp.pad(
                        contrib, [(0, 0), (0, unknown_channels[u_out] - c)]
                    )
            else:
                contrib = jnp.einsum(
                    "eij,ej->ei", W, pg, precision=jax.lax.Precision.HIGHEST
                )  # full f32: no TF32 pass on the H100
            key_a = (g, u_out, k_out)
            cur = edge_acc.get(key_a)
            edge_acc[key_a] = contrib if cur is None else cur + contrib

        for u in out:
            if out[u] is None:
                out[u] = jnp.zeros(compiled.unknown_shape(u), dt)
        for (g, u_out, k_out), mat in edge_acc.items():
            out[u_out] = out[u_out].at[graphs[g][k_out]].add(mat)
        return out

    # -- assembled JᵀF -------------------------------------------------------
    def jtf_fn(r_terms):
        """JᵀF from the same D fields: Σ_t Σ_s adjoint_s(Σ_rch D[t,s]·r_t).
        The reference's evalJTF gather/scatter kernels (o.t:2129-2172,
        o.t:2228-2253) in one pass — and for graph slots through the packed
        combined-incidence gather instead of the transpose's scatter-add."""
        out = {u: None for u in unknown_channels}
        # ONE r-contraction per (term, probe source) over all its probe
        # columns, sliced lazily per slot (separate per-slot einsums each
        # paid ~1 ms in relayouts on the 147k-edge ARAP). With a const
        # cache there are up to two sources per term: the per-step varying
        # probes and the hoisted constant probes.
        jt_all = {}
        for (t_idx, sid) in D:
            si_ = src_of[(t_idx, sid)]
            if (si_, t_idx) not in jt_all:
                mv = jt_sources[si_][0]
                jt_all[(si_, t_idx)] = jnp.sum(
                    mv[t_idx] * r_terms[t_idx][..., None], axis=-2
                )  # mul+reduce, not einsum: full f32, no tiny matmuls
        # (graph, group, slot, image) -> [E, C_img]
        edge_parts: Dict[Tuple[str, Optional[str], str, str], jnp.ndarray] = {}
        for (t_idx, sid) in D:
            s = slots[sid]
            si_ = src_of[(t_idx, sid)]
            base = jt_sources[si_][1][sid]
            contrib = jt_all[(si_, t_idx)][..., base : base + s.channels]  # [*dom, C_s]
            if s.kind == "img":
                off = tuple(-o for o in s.offset)
                add = shift(contrib, off)
                cur = out[s.image]
                out[s.image] = add if cur is None else cur + add
            else:
                if (s.graph, s.key[3]) in aligned_slots:
                    continue  # handled by the aligned group path below
                gk = None
                for (g2, gkey), (names, _ul, _offs, _ct) in g_layouts.items():
                    if g2 == s.graph and s.key[3] in names:
                        gk = gkey
                        break
                key = (s.graph, gk, s.key[3], s.image)
                cur = edge_parts.get(key)
                edge_parts[key] = contrib if cur is None else cur + contrib

        # incidence-aligned groups: JᵀF through the already-gathered probe
        # matrices (one narrow r gather per term; no stacked-row gather)
        for (g, gk), group_fn in aligned_jtf.items():
            acc = group_fn(r_terms)
            _names, u_list, offs, _ctot = g_layouts[(g, gk)]
            for u in u_list:
                sl = acc[:, offs[u] : offs[u] + unknown_channels[u]]
                cur = out[u]
                out[u] = sl if cur is None else cur + sl

        # pack graph parts through the combined-incidence gather
        handled_groups = {}
        for (g, gk, k, img), contrib in edge_parts.items():
            if gk is None:
                continue
            handled_groups.setdefault((g, gk), {}).setdefault(k, {})[img] = contrib
        for (g, gk), per_k in handled_groups.items():
            names, u_list, offs, ctot = g_layouts[(g, gk)]
            E = graphs[g][names[0]].shape[0]
            blocks = []
            for k in names:
                per_img = per_k.get(k)
                if not per_img:
                    blocks.append(jnp.zeros((E, ctot), dt))
                    continue
                padded = jnp.zeros((E, ctot), dt)
                for img, c in per_img.items():
                    o = offs[img]
                    padded = padded.at[:, o : o + unknown_channels[img]].set(c)
                blocks.append(padded)
            jt_send = graphs[g].get("__halo_send__" + gk)
            jt_loc = graphs[g].get("__halo_loc__" + gk)
            if mesh is not None and jt_send is not None:
                # same neighbor exchange (and same tables) as the assembly
                # gather above: the per-slot edge blocks are the parts
                from .parallel.mesh import halo_gather_parts

                acc = halo_gather_parts(
                    mesh, blocks, jt_send, jt_loc
                ).sum(axis=1)
            else:
                rows = jnp.concatenate(
                    blocks + [jnp.zeros((1, ctot), dt)], axis=0
                )
                acc = jnp.take(rows, graphs[g][gk], axis=0).sum(axis=1)
            for u in u_list:
                sl = acc[:, offs[u] : offs[u] + unknown_channels[u]]
                cur = out[u]
                out[u] = sl if cur is None else cur + sl
        for (g, gk, k, img), contrib in edge_parts.items():
            if gk is not None:
                continue
            cur = out[img]
            base = (
                cur
                if cur is not None
                else jnp.zeros(compiled.unknown_shape(img), dt)
            )
            out[img] = base.at[graphs[g][k]].add(contrib)

        res = {}
        for u in unknown_channels:
            v = out[u]
            if v is None:
                v = jnp.zeros(compiled.unknown_shape(u), dt)
            m = row_masks.get(u)
            res[u] = v if m is None else v * m
        return res

    # -- free Jacobi diagonal ----------------------------------------------
    diag = {}
    for u, c in unknown_channels.items():
        sp = compiled.unknown_shape(u)[:-1]
        zero = tuple([0] * len(sp))
        if (u, u, zero) in plan.scalar_groups:
            f0 = fields[(u, u, zero, 0, 0)]
            diag[u] = jnp.broadcast_to(f0[..., None], sp + (c,))
            continue
        cols = []
        for i in range(c):
            f = fields.get((u, u, zero, i, i))
            cols.append(f if f is not None else jnp.zeros(sp, dt))
        diag[u] = jnp.stack(cols, axis=-1)
    # graph part of the diagonal: the pre-summed same-slot blocks already
    # hold Σ_incidences P(k,k)[e] per vertex — the Jacobi diagonal is their
    # diagonal, no scatters; scatter fallback only for couplings no ELL
    # path covers (those have per-pair gfields).
    for (g, gk), ex in grp_exec.items():
        _ctg = ex["ct"]
        # diagonal of the flat [N, ct²] block rows: columns i·(ct+1)
        dcontrib = ex["S"][:, :: _ctg + 1]  # [N, Ct]
        pm = _group_mask(g, gk)
        if pm is not None:
            dcontrib = dcontrib * pm  # masked-operator diagonal (m·d·m, m 0/1)
        _names, u_list, offs, _ct = g_layouts[(g, gk)]
        for u in u_list:
            diag[u] = diag[u] + dcontrib[:, offs[u] : offs[u] + unknown_channels[u]]
    for (g, u_out, k_out, u_in, k_in, i, j), field in gfields.items():
        if u_out == u_in and k_out == k_in:
            if (g, u_out, k_out, u_in, k_in) in plan.scalar_groups:
                # one field, broadcast over all channels
                diag[u_out] = diag[u_out].at[graphs[g][k_out], :].add(
                    field[:, None]
                )
            elif i == j:
                diag[u_out] = diag[u_out].at[graphs[g][k_out], i].add(field)

    # -- optional per-element block-Jacobi preconditioner ---------------------
    # (opt-in via InitializationParameters.preconditioner="block_jacobi"; no
    # reference counterpart — the reference is scalar Jacobi only,
    # o.t:2149-2168). The Δ=0 coupling block per packed element — centered
    # zero-offset fields plus the pre-summed same-vertex graph blocks — is
    # exactly the best per-element SPD approximation of JᵀJ the assembly
    # already holds; inverting the C×C blocks once per nonlinear iteration
    # couples the channels the scalar Jacobi ignores (Offset×Angle,
    # rotation×translation), cutting CG iterations on mixed-unknown
    # problems. Exposed as an attribute so the (apply, diag, jtf, meta)
    # result shape stays stable for every existing caller.
    # snapshot the FULL-PRECISION sources for the block preconditioner
    # before any coefficient-dtype narrowing below mutates these containers
    # in place: the narrowing contract covers only CG-loop-resident
    # storage, and M⁻¹ must be built from solve-dtype blocks
    _bp_w_packed = tuple(w_packed)
    _bp_S = {key: ex["S"] for key, ex in grp_exec.items()}

    def make_block_pre(extra_diag=None):
        """Build M⁻¹ from the Δ=0 blocks and return ``r -> M⁻¹·r`` (row
        masks applied to the output; inputs are the solver's already
        row-masked residuals). ``extra_diag``: optional per-unknown
        diagonal to add before inversion (LM damping)."""
        from .solver.params import FLOAT_EPSILON

        isp_layouts = dict(w_layouts)  # ispace -> (u_list, offs, ctot)

        def _layout_for(isp):
            got = isp_layouts.get(isp)
            if got is None:
                u_list = [
                    u for u in compiled.unknown_names if isp_of[u] == isp
                ]
                offs, o = {}, 0
                for u in u_list:
                    offs[u] = o
                    o += unknown_channels[u]
                got = (u_list, offs, o)
                isp_layouts[isp] = got
            return got

        blocks = {}

        def _block_for(isp):
            B = blocks.get(isp)
            if B is None:
                _ul, _offs, ctot = _layout_for(isp)
                dom = isp.shape(compiled.dim_sizes)
                B = jnp.zeros(dom + (ctot, ctot), dt)
            return B

        # centered Δ=0 packed fields
        for (isp, delta, kind, W, oo, oi, co, ci) in _bp_w_packed:
            if any(d != 0 for d in delta):
                continue
            B = _block_for(isp)
            Wf = W.astype(dt)
            if kind == "scalar":
                for k in range(co):
                    B = B.at[..., oo + k, oi + k].add(Wf[..., 0])
            elif kind == "diag":
                for k in range(Wf.shape[-1]):
                    B = B.at[..., oo + k, oi + k].add(Wf[..., k])
            else:
                B = B.at[..., oo : oo + co, oi : oi + ci].add(Wf)
            blocks[isp] = B

        # pre-summed same-vertex graph blocks, remapped from the group
        # layout into the ispace layout; masked on both sides like the
        # scalar diag path (the operator the loop applies is M·A(M·p), so
        # its Δ=0 block is m·B·m — without this, inv(B) couples masked
        # channels into unmasked ones at constraint boundaries)
        for (g, gk) in grp_exec:
            _names, gu_list, goffs, _gct = g_layouts[(g, gk)]
            isp = isp_of[gu_list[0]]
            B = _block_for(isp)
            _ul, woffs, _ctot = _layout_for(isp)
            _ctg = grp_exec[(g, gk)]["ct"]
            S = _bp_S[(g, gk)].astype(dt).reshape(-1, _ctg, _ctg)
            pm = _group_mask(g, gk)
            if pm is not None:
                S = S * pm[:, :, None] * pm[:, None, :]
            for uo in gu_list:
                for ui in gu_list:
                    co, ci = unknown_channels[uo], unknown_channels[ui]
                    B = B.at[
                        ..., woffs[uo] : woffs[uo] + co,
                        woffs[ui] : woffs[ui] + ci,
                    ].add(
                        S[
                            :, goffs[uo] : goffs[uo] + co,
                            goffs[ui] : goffs[ui] + ci,
                        ]
                    )
            blocks[isp] = B

        # scatter-fallback same-vertex couplings (no ELL tables)
        for (g, u_out, k_out, u_in, k_in, i, j), field in gfields.items():
            if k_out != k_in:
                continue
            isp = isp_of[u_out]
            B = _block_for(isp)
            _ul, woffs, _ctot = _layout_for(isp)
            idx = graphs[g][k_out]
            f = field.astype(dt)
            if (g, u_out, k_out, u_in, k_in) in plan.scalar_groups:
                for ch in range(unknown_channels[u_out]):
                    B = B.at[
                        idx, woffs[u_out] + ch, woffs[u_in] + ch
                    ].add(f)
            else:
                B = B.at[idx, woffs[u_out] + i, woffs[u_in] + j].add(f)
            blocks[isp] = B

        inv = {}
        for isp, B in blocks.items():
            u_list, offs, ctot = isp_layouts[isp]
            if extra_diag is not None:
                for u in u_list:
                    e = extra_diag.get(u)
                    if e is None:
                        continue
                    for k in range(unknown_channels[u]):
                        B = B.at[..., offs[u] + k, offs[u] + k].add(
                            e[..., k]
                        )
            # relative diagonal regularization keeps rank-deficient blocks
            # (excluded rows, unconstrained channels) invertible without
            # perturbing well-conditioned ones; symmetrized against inv()
            # roundoff so M⁻¹ stays SPD for CG
            dvals = jnp.diagonal(B, axis1=-2, axis2=-1)
            reg = 1e-5 * dvals + FLOAT_EPSILON
            Breg = B + reg[..., :, None] * jnp.eye(ctot, dtype=dt)
            Minv = _gauss_jordan_inv(Breg)
            inv[isp] = 0.5 * (Minv + jnp.swapaxes(Minv, -1, -2))

        def pre_apply(r):
            out = {}
            for isp, Minv in inv.items():
                u_list, offs, _ctot = isp_layouts[isp]
                rp = (
                    jnp.concatenate([r[u] for u in u_list], axis=-1)
                    if len(u_list) > 1
                    else r[u_list[0]]
                )
                # broadcast-mul + minor-axis reduce: full f32 on tiny
                # blocks, no matmul
                z = jnp.sum(Minv * rp[..., None, :], axis=-1)
                for u in u_list:
                    sl = z[..., offs[u] : offs[u] + unknown_channels[u]]
                    m = row_masks.get(u)
                    out[u] = sl if m is None else sl * m
            for u in unknown_channels:  # unknowns with no Δ=0 block
                if u not in out:
                    out[u] = r[u]
            return out

        return pre_apply

    apply_fn.block_pre = make_block_pre

    if coeff_dtype is not None:
        # narrow ONLY the loop-resident coefficient storage, after the
        # full-precision Jacobi diagonal above was read off; apply_fn closes
        # over these containers, so in-place replacement is visible at its
        # trace. The multiplies against f32 p promote back to f32.
        cdt = jnp.dtype(coeff_dtype)
        w_packed[:] = [
            (isp, delta, kind, W.astype(cdt), oo, oi, co, ci)
            for (isp, delta, kind, W, oo, oi, co, ci) in w_packed
        ]
        for ex in grp_exec.values():
            ex["S"] = ex["S"].astype(cdt)
            ex["dia"] = [(off, W.astype(cdt)) for off, W in ex["dia"]]
            if ex["C"] is not None:
                ex["C"] = ex["C"].astype(cdt)
        for key in list(pair_exec):
            W_ell, ell = pair_exec[key]
            pair_exec[key] = (W_ell.astype(cdt), ell)
        g_unhandled[:] = [
            (g, uo, ko, ui, ki, kind, W.astype(cdt))
            for (g, uo, ko, ui, ki, kind, W) in g_unhandled
        ]

    # stencil-kernel eligibility: the masked per-channel-pair fields of a
    # pure 2-D grid stencil over one index space, for the Triton apply
    # (ops/stencil_kernel.py); None with the reason otherwise. The kernel
    # stores the fields in coeff_dtype too.
    from .ops.stencil_kernel import plan_grid_stencil

    cg_meta, apply_fn.stencil_decline = plan_grid_stencil(
        compiled, plan, fields, w_layouts, grp_exec, pair_exec, g_unhandled,
        coeff_dtype=coeff_dtype,
    )
    # the probe linearize's primal IS the residual evaluation at X (scaled
    # exactly as residual_terms scales); expose it so the GN step can skip
    # its separate fs.linearize(X) pass. None when every
    # needed slot was const-hoisted (no per-step probe ran).
    jtf_fn.r_terms = r_terms_primal
    return apply_fn, diag, jtf_fn, cg_meta


# Backwards-compatible name (earlier revisions assembled stencils only).
plan_stencil = plan_assembly
