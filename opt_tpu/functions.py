"""Matrix-free solver operators derived from a compiled problem.

Replaces the reference's symbolic operator derivation:

* ``evalJTF`` (o.t:2129-2172 centered, o.t:2228-2253 graph) — here JᵀF comes
  from one ``jax.linearize`` + ``jax.linear_transpose`` of the residual
  function; graph scatter-adds fall out of the transpose of ``jnp.take``.
* ``applyJTJ`` (o.t:2029-2089 centered gather form, o.t:2092-2126 graph
  scatter form) — here ``Jᵀ(J·p)`` via the same linearization, evaluated
  inside the PCG loop with the linearization point hoisted out by XLA.
* the Jacobi preconditioner / LM damping diagonal Σ(∂r/∂x)² (o.t:2129-2172
  P_hat, o.t:2255-2316 computeCtC) — here computed *exactly* via one one-hot
  jvp probe per (unknown slot, channel) of the pointwise slot-form residual
  function, squared and scattered back through the slot's shift/graph adjoint.
* ``modelcost`` (o.t:2174-2225) — ½‖F + J·δ‖² from the same linearization.

Exclusion semantics follow the reference kernels exactly: excluded unknowns
have their rows masked out of JᵀF/diag/JᵀJp outputs and their residual terms
masked out of cost/modelcost, but residual instances centered at excluded
pixels still feed the gradients of non-excluded unknowns (exclude gating in
solverGPUGaussNewton.t:371,424,450 is on the unknown index only).
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp

from .compile import CompiledProblem
from .ops.shift import shift_adjoint


def _mask_rows(x: Dict[str, jnp.ndarray], row_masks) -> Dict[str, jnp.ndarray]:
    # row_masks are 0/1 floats; multiplication (not select) keeps the masking
    # fused with the transposed stencil graph (see
    # CompiledProblem.exclusion_masks).
    out = {}
    for k, v in x.items():
        m = row_masks.get(k)
        out[k] = v if m is None else v * m
    return out


def _mask_rows_select(x: Dict[str, jnp.ndarray], row_masks) -> Dict[str, jnp.ndarray]:
    # Select-based masking for values that may be non-finite at excluded rows
    # (e.g. the LM damping diagonal, where 1/SSq = inf at diag(JᵀJ)=0): v*m
    # would produce inf*0 = NaN. Used once per nonlinear iteration, outside
    # the CG hot loop, so the multiplicative-fusion rationale of _mask_rows
    # does not apply.
    out = {}
    for k, v in x.items():
        m = row_masks.get(k)
        out[k] = v if m is None else jnp.where(m != 0, v, jnp.zeros_like(v))
    return out


def tree_dot(a: Dict[str, jnp.ndarray], b: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Global dot product over the unknown super-vector (reference: warp
    shuffle + atomicAdd reductions, util.t:612-623). jnp.sum + psum under a
    mesh replaces the atomics."""
    total = None
    for k in a:
        s = jnp.sum(a[k] * b[k])
        total = s if total is None else total + s
    return total


class FunctionSet:
    """Per-(problem, bound-constants) operator bundle used by the solver."""

    def __init__(self, compiled: CompiledProblem, consts, graphs, params,
                 mesh=None):
        self.c = compiled
        self.consts = consts
        self.graphs = graphs
        self.params = params
        self.mesh = mesh  # sharded graph reads ride the neighbor exchange
        self.F = compiled.residual_fn(consts, graphs, params, mesh=mesh)
        self._mask_cache = None

    def masks(self, X):
        """(per-ispace exclusion masks, per-unknown row masks).

        Evaluated lazily with X available (Exclude expressions may in
        principle read any image); under one jit trace XLA CSEs repeats."""
        if self._mask_cache is None:
            excl = self.c.exclusion_masks(
                X, self.consts, self.graphs, self.params, mesh=self.mesh
            )
            self._mask_cache = (excl, self.c.unknown_row_masks(excl))
        return self._mask_cache

    @property
    def row_masks(self):
        assert self._mask_cache is not None, "call masks(X) first"
        return self._mask_cache[1]

    # -- costs ---------------------------------------------------------------
    def _masked_half_sq_sum(self, terms: List[jnp.ndarray], excl) -> jnp.ndarray:
        total = jnp.zeros((), self.c.dtype)
        for term, val in zip(self.c.terms, terms):
            sq = val * val
            m = self.c.term_cost_mask(term, excl)
            if m is not None:
                sq = sq * (1.0 - m)  # m: 1.0 = excluded center
            total = total + jnp.sum(sq)
        return 0.5 * total

    def cost(self, X) -> jnp.ndarray:
        """½ Σ r² over non-excluded centers (reference createcost o.t:2375-2385
        + exclude gating in computeCost)."""
        excl, _ = self.masks(X)
        return self._masked_half_sq_sum(self.F(X), excl)

    # -- linearization bundle --------------------------------------------------
    def linearize(self, X):
        """Returns (residual terms, J·(), Jᵀ·()) at X."""
        _, row_masks = self.masks(X)
        r_terms, jvp_fn = jax.linearize(self.F, X)
        transpose_fn = jax.linear_transpose(jvp_fn, X)

        def J(p):
            return jvp_fn(p)

        def JT(terms):
            (g,) = transpose_fn(terms)
            return _mask_rows(g, row_masks)

        return r_terms, J, JT

    def jtf(self, X):
        """JᵀF (positive sign, as the reference's evalJTF F_hat; the solver
        negates: residuum = -JᵀF, solverGPUGaussNewton.t:374-377)."""
        r_terms, _, JT = self.linearize(X)
        return JT(r_terms)

    def make_jtj_apply(self, X):
        r_terms, J, JT = self.linearize(X)

        def apply_jtj(p):
            return JT(J(p))

        return r_terms, J, JT, apply_jtj

    def model_cost(self, X, r_terms, J, delta) -> jnp.ndarray:
        """½‖F + Jδ‖² over non-excluded centers (o.t:2174-2225; kernel gating
        solverGPUGaussNewton.t:666-678)."""
        excl, _ = self.masks(X)
        jd = J(delta)
        return self._masked_half_sq_sum([r + d for r, d in zip(r_terms, jd)], excl)

    # -- exact Jacobi diagonal ---------------------------------------------------
    def jtj_diag(self, X) -> Dict[str, jnp.ndarray]:
        """diag(JᵀJ) per unknown channel, rows masked at excluded unknowns.

        Exact, matrix-free: for each (unknown slot, channel), a spatially
        uniform one-hot tangent probes the pointwise slot-form residual
        function; the probe output is exactly the local derivative field
        ∂r[q]/∂x[q+s,c], which is squared, summed over residual channels and
        scattered back via the slot's adjoint (shift for stencils, segment
        scatter for graphs). This reproduces the reference's symbolic
        Σ(∂r/∂x00)² (o.t:2149-2160) without a CAS.

        Like the reference's per-endpoint scatter (createjtfgraph
        o.t:2228-2253), the sum is PER SLOT: if a hyperedge references the
        same vertex through two slots (a self-loop), the cross term is not
        included and the value differs from the true diag(JᵀJ) there. The
        reference's graph builders never emit self-loops
        (OptGraph.h createGraphFromNeighborLists); the JᵀJ·p apply is exact
        regardless (see tests/test_fuzz_operator.py)."""
        _, row_masks = self.masks(X)
        c = self.c
        slot_vals = c.gather_slot_values(
            X, self.consts, self.graphs, self.params, mesh=self.mesh
        )
        # per-edge validity masks scale the slot-form residuals exactly as
        # residual_terms does (graph_term_scales contract)
        scales = c.graph_term_scales(self.graphs)

        def f(sv):
            terms = c.local_residual_terms(sv, self.params, self.consts)
            return [
                t if sc is None else t * sc for t, sc in zip(terms, scales)
            ]

        _, lin = jax.linearize(f, slot_vals)

        diag = {
            name: jnp.zeros(c.unknown_shape(name), c.dtype)
            for name in c.unknown_names
        }
        zeros = [jnp.zeros_like(v) for v in slot_vals]
        import numpy as _np

        for sid in c.unknown_slot_ids():
            s = c.registry.slots[sid]
            per_ch = []
            for ch in range(s.channels):
                tangents = list(zeros)
                t = jnp.zeros_like(slot_vals[sid])
                t = t.at[..., ch].set(1.0)
                tangents[sid] = t
                d_terms = lin(tangents)
                contrib = None
                for term, dt in zip(c.terms, d_terms):
                    if sid not in term.slot_ids:
                        continue
                    sq = jnp.sum(dt * dt, axis=-1)  # [*sp] or [E]
                    contrib = sq if contrib is None else contrib + sq
                per_ch.append(contrib)
            if all(v is None for v in per_ch):
                continue  # slot feeds no term (contrib is ch-independent)
            if s.kind == "img":
                for ch, contrib in enumerate(per_ch):
                    add = shift_adjoint(contrib[..., None], s.offset)[..., 0]
                    diag[s.image] = diag[s.image].at[..., ch].add(add)
            else:  # gimg: one stacked scatter per slot (not per channel)
                from .parallel.mesh import slot_halo_scatter_add

                ct = jnp.stack(per_ch, axis=-1)  # [E, C]
                n_rows = c.unknown_shape(s.image)[0]
                slot_n = int(
                    _np.prod(
                        c.registry.graphs[s.graph]
                        .slots[s.key[3]]
                        .shape(c.dim_sizes)
                    )
                )
                add = None
                if n_rows == slot_n:
                    # reverse exchange (transpose of the halo read) —
                    # boundary-sized, ONE all_to_all for all channels.
                    # Images on a different-sized space than the slot's
                    # fall through: the tables were built for slot_n rows.
                    add = slot_halo_scatter_add(
                        self.mesh, ct, n_rows,
                        self.graphs[s.graph], s.key[3],
                    )
                if add is not None:
                    diag[s.image] = diag[s.image] + add
                else:
                    idx = self.graphs[s.graph][s.key[3]]
                    diag[s.image] = diag[s.image].at[idx].add(ct)
        return _mask_rows(diag, row_masks)

    def jtf_and_pre(self, X):
        """(JᵀF, raw preconditioner diag) — the reference evalJTF pair
        (o.t:2129-2172). pre = 1 when UsePreconditioner(false)
        (o.t:2162-2168)."""
        _, row_masks = self.masks(X)
        g = self.jtf(X)
        if self.c.use_preconditioner:
            pre = self.jtj_diag(X)
        else:
            pre = {k: jnp.ones_like(v) for k, v in g.items()}
            pre = _mask_rows(pre, row_masks)
        return g, pre

    def mask_rows(self, x):
        _, row_masks = self._mask_cache
        return _mask_rows(x, row_masks)

    def mask_rows_select(self, x):
        """Where-based row masking, safe for non-finite inputs at excluded
        rows (multiplicative masking would yield inf*0 = NaN)."""
        _, row_masks = self._mask_cache
        return _mask_rows_select(x, row_masks)

    # -- assembled gather-form JᵀJ (see assembly.py) ---------------------------
    def assemble_stencil(self, X, plan, const_cache=None, mesh=None,
                         coeff_dtype=None):
        """(apply_fn, diag, jtf_fn, cg_meta): row/column-masked JᵀJ·p in
        assembled gather form, the Jacobi diagonal read off the Δ=0 fields,
        a JᵀF evaluator, and the stencil kernel's inputs (or None). The
        equivalent of the reference's fused createjtjcentered/
        createjtjgraph/evalJTF kernels (o.t:2029-2172). ``mesh`` activates
        the owner-block neighbor exchange for graph cross-endpoint reads;
        ``coeff_dtype`` narrows the loop-resident coefficient storage
        (assembly.assemble)."""
        from .assembly import assemble

        _, row_masks = self.masks(X)
        return assemble(
            self.c, plan, X, self.consts, self.graphs, self.params, row_masks,
            const_cache=const_cache, mesh=mesh, coeff_dtype=coeff_dtype,
        )

    def assemble_const(self, X0, plan):
        """Loop-invariant assembly phase (assembly.assemble_const): probes
        the X-independent (term, slot) Jacobian fields once. Run before the
        nonlinear loop; pass the result to assemble_stencil each step."""
        from .assembly import assemble_const

        return assemble_const(
            self.c, plan, X0, self.consts, self.graphs, self.params,
            mesh=self.mesh,
        )

    # -- misc ---------------------------------------------------------------
    def zeros_like_unknowns(self, X):
        return {k: jnp.zeros_like(v) for k, v in X.items()}
