"""Explicit sparse-J path — the reference's optional cusparse branch.

The reference can dump J to CSR and run the PCG inner loop as two sparse
matvecs q = J·p, out = Jᵀ·q instead of the matrix-free fused apply
(solverGPUGaussNewton.t:74-90, 215-218, 835-954; off by default there
too). The equivalent here builds J as a ``jax.experimental.sparse``
BCOO once per nonlinear iteration — the sparsity STRUCTURE is static (the
stencil/graph incidence), only the values change with the linearization
point — and applies JᵀJ·p as two BCOO matvecs.

Enable with ``InitializationParameters(use_explicit_jtj=True)``. Mainly a
verification / very-ill-conditioned-problem surface, mirroring the
reference's positioning; the assembled gather-form operator (assembly.py)
is the production path.

Row/column layout matches jacobian.dump_jacobian: rows ordered per term
then element then residual channel; columns index the unknown super-vector
in ``compiled.unknown_names`` order.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import _slot_jacobians
from .jacobian import _unknown_offsets


def build_explicit_j(compiled, X, consts, graphs, params):
    """Traced BCOO J at linearization point X (structure static, values
    traced). Returns (J, n_rows, n_cols)."""
    from jax.experimental import sparse as jsparse

    slot_ids = [
        sid
        for sid in compiled.unknown_slot_ids()
        if any(sid in t.slot_ids for t in compiled.terms)
    ]
    D, _mv, _bo, _pr = _slot_jacobians(compiled, X, consts, graphs, params, slot_ids)
    col_off, n_cols = _unknown_offsets(compiled)

    rows_l, cols_l, vals_l = [], [], []
    row_base = 0
    for t_idx, term in enumerate(compiled.terms):
        kind, dom = term.domain
        rch = term.channels
        n_el = None
        for sid in slot_ids:
            if sid not in term.slot_ids:
                continue
            s = compiled.registry.slots[sid]
            Dv = D[(t_idx, sid)]  # [*dom, rch, C]
            C = compiled.unknown_shape(s.image)[-1]
            if kind == "centered":
                sp = dom.shape(compiled.dim_sizes)
                n_el = int(np.prod(sp))
                grid = np.stack(
                    np.meshgrid(*[np.arange(n) for n in sp], indexing="ij"),
                    -1,
                )
                tgt = grid + np.asarray(s.offset)
                valid = np.all((tgt >= 0) & (tgt < np.asarray(sp)), axis=-1)
                flat_sp = np.ravel_multi_index(
                    tuple(
                        np.clip(tgt[..., d], 0, sp[d] - 1)
                        for d in range(len(sp))
                    ),
                    sp,
                ).reshape(-1)
                el = np.arange(n_el)
                rows = (
                    row_base
                    + (el[:, None, None] * rch)
                    + np.arange(rch)[None, :, None]
                    + np.zeros((1, 1, C), np.int64)
                )
                cols = (
                    col_off[s.image]
                    + flat_sp[:, None, None] * C
                    + np.arange(C)[None, None, :]
                    + np.zeros((1, rch, 1), np.int64)
                )
                vals = Dv.reshape(n_el, rch, C) * jnp.asarray(
                    valid.reshape(n_el, 1, 1), compiled.dtype
                )
                rows_l.append(jnp.asarray(rows.reshape(-1), jnp.int32))
                cols_l.append(jnp.asarray(cols.reshape(-1), jnp.int32))
                vals_l.append(vals.reshape(-1))
            else:
                idx = graphs[s.graph][s.key[3]]  # [E], traced
                n_el = int(idx.shape[0])
                el = np.arange(n_el)
                rows = (
                    row_base
                    + (el[:, None, None] * rch)
                    + np.arange(rch)[None, :, None]
                    + np.zeros((1, 1, C), np.int64)
                )
                cols = (
                    col_off[s.image]
                    + jnp.asarray(idx, jnp.int32)[:, None, None] * C
                    + jnp.arange(C, dtype=jnp.int32)[None, None, :]
                    + jnp.zeros((1, rch, 1), jnp.int32)
                )
                rows_l.append(jnp.asarray(rows.reshape(-1), jnp.int32))
                cols_l.append(cols.reshape(-1).astype(jnp.int32))
                vals_l.append(Dv.reshape(-1))
        if n_el is None:  # term with no unknown slots
            if kind == "centered":
                n_el = int(np.prod(dom.shape(compiled.dim_sizes)))
            else:
                n_el = int(next(iter(graphs[dom].values())).shape[0])
        row_base += n_el * rch

    vals = jnp.concatenate(vals_l)
    idx2 = jnp.stack(
        [jnp.concatenate(rows_l), jnp.concatenate(cols_l)], axis=-1
    )
    J = jsparse.BCOO((vals, idx2), shape=(row_base, n_cols))
    return J, row_base, n_cols


def explicit_jtj_apply(compiled, J, row_masks):
    """(JᵀJ)·p as two sparse matvecs over the flattened unknown
    super-vector; output rows masked like every other operator form. The
    matvecs are written as f32 products plus segment sums, so no dot (and
    no reduced-precision TF32 pass) is involved."""
    rows, cols = J.indices[:, 0], J.indices[:, 1]
    n_rows, n_cols = J.shape

    def apply_fn(p: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        flat = jnp.concatenate(
            [p[u].reshape(-1) for u in compiled.unknown_names]
        )
        q = jax.ops.segment_sum(J.data * flat[cols], rows, num_segments=n_rows)
        out_flat = jax.ops.segment_sum(
            J.data * q[rows], cols, num_segments=n_cols
        )
        out = {}
        o = 0
        for u in compiled.unknown_names:
            n = int(np.prod(compiled.unknown_shape(u)))
            v = out_flat[o : o + n].reshape(compiled.unknown_shape(u))
            m = row_masks.get(u)
            out[u] = v if m is None else v * m
            o += n
        return out

    return apply_fn
