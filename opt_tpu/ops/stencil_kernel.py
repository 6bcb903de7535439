"""Grid-stencil JᵀJ·p apply with a fused pᵀAp partial: one Pallas kernel
through Triton.

The assembled operator of a grid problem over one 2-D index space is a sum
of per-channel-pair triples over the packed unknown channels:

    (JᵀJ·p)[i, q] = Σ_t F_t[q] · p[j_t, q + Δ_t]

for triples t = (Δ, i, j, field) read off the assembled coefficient fields
(assembly.py). This module plans those triples once per GN step
(:func:`plan_grid_stencil`) and applies them in one launch per CG iteration
(:func:`stencil_apply`): every program owns one [BH, BW] tile of every
output channel, reads the shifted p tiles through masked loads (the halo is
just the neighbours' part of p), accumulates in registers, stores Ap and
writes its tile's share of pᵀAp. XLA sums the per-tile partials, so the
reduction needs no atomics and its order is fixed from run to run.

This is the reference's ``PCGStep1`` (solverGPUGaussNewton.t:421-460: the
JᵀJ·p apply fused with the pᵀAp reduction), minus its ``atomicAdd``.

Layout: the CG state is channel-major [C, Hp, Wp], the domain at the origin
and zero padding up to a whole number of tiles. The fields are zero in the
padding and carry the in-bounds mask of their offset, so every read that
leaves the domain is multiplied by an exact zero, and padded entries of Ap
are zero. The kernel reads through flat indices: in interpret mode the
indices are clamped into the array (the interpreter gathers them), on the
card they stay affine and the mask guards the address.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

# [BH, BW] output tile of one program and its launch shape; powers of two
# (Triton block shapes). Chosen by a sweep of the apply alone on an H100
# (PERF.md, PR 1): over poisson 512² and image_warping 512²/1024², (8, 128)
# with 8 warps was fastest or within ~10% of the fastest tile.
BLOCK = (8, 128)
NUM_WARPS = 8
NUM_STAGES = 1


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_grid_stencil(
    compiled,
    plan,
    fields: Dict,
    w_layouts: Dict,
    grp_exec,
    pair_exec,
    g_unhandled,
    coeff_dtype=None,
    block: Tuple[int, int] = BLOCK,
):
    """Kernel inputs for a pure 2-D grid stencil, or the reason it declines.

    Returns ``(meta, None)`` or ``(None, reason)``. ``meta`` holds the packed
    layout (``u_list``, ``offs``, ``channels``, ``ctot``), the static
    ``triples`` ((dy, dx), i, j, field id), the masked, tile-padded field
    stack ``F`` [T, Hp, Wp] (in ``coeff_dtype`` when given), the domain
    ``dom`` (H, W) and the ``block``."""
    from .shift import in_bounds_mask

    if grp_exec or pair_exec or g_unhandled:
        return None, "graph couplings"
    if not fields:
        return None, "no assembled fields"
    if compiled.dtype != jnp.float32:
        return None, "solve dtype is not float32"
    if len(w_layouts) != 1:
        return None, "more than one index space"
    ((isp, (u_list, offs, ctot)),) = w_layouts.items()
    if isp.ndim != 2:
        return None, f"{isp.ndim}-D index space"
    if sorted(compiled.unknown_names) != sorted(u_list):
        return None, "unknowns outside the grid"
    dom = tuple(int(d) for d in isp.shape(compiled.dim_sizes))
    channels = {u: compiled.unknown_shape(u)[-1] for u in u_list}
    bh, bw = block
    hp, wp = _round_up(dom[0], bh), _round_up(dom[1], bw)

    field_list = []
    triples = []
    masks = {}
    for (u_out, u_in, delta, i, j), f in sorted(fields.items()):
        m = masks.get(delta)
        if m is None:
            m = in_bounds_mask(dom, delta, dtype=compiled.dtype)[..., 0]
            masks[delta] = m
        fid = len(field_list)
        field_list.append(f * m)
        d = tuple(int(o) for o in delta)
        if (u_out, u_in, delta) in plan.scalar_groups:
            # channel-identical diagonal: one field, one triple per channel
            for c in range(channels[u_out]):
                triples.append((d, offs[u_out] + c, offs[u_in] + c, fid))
        else:
            triples.append((d, offs[u_out] + i, offs[u_in] + j, fid))
    F = jnp.stack(field_list, axis=0)
    F = jnp.pad(F, ((0, 0), (0, hp - dom[0]), (0, wp - dom[1])))
    if coeff_dtype is not None:
        F = F.astype(coeff_dtype)
    meta = {
        "u_list": tuple(u_list),
        "offs": dict(offs),
        "channels": channels,
        "ctot": int(ctot),
        "triples": tuple(triples),
        "F": F,
        "dom": dom,
        "block": (bh, bw),
    }
    return meta, None


def pack(meta: Dict, d: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Per-unknown [H, W, c] arrays -> the kernel's [C, Hp, Wp] layout."""
    u_list = meta["u_list"]
    a = (
        jnp.concatenate([d[u] for u in u_list], axis=-1)
        if len(u_list) > 1
        else d[u_list[0]]
    )
    a = jnp.moveaxis(a, -1, 0)
    hp, wp = meta["F"].shape[1:]
    h, w = meta["dom"]
    return jnp.pad(a, ((0, 0), (0, hp - h), (0, wp - w)))


def unpack(meta: Dict, a: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Inverse of :func:`pack`."""
    h, w = meta["dom"]
    packed = jnp.moveaxis(a[:, :h, :w], 0, -1)
    return {
        u: packed[..., meta["offs"][u] : meta["offs"][u] + meta["channels"][u]]
        for u in meta["u_list"]
    }


def _tile_groups(triples):
    """Triples grouped by the shifted p tile they read, ((dy, dx), j) ->
    ((i, fid), ...), in (Δ, j) order so a field's tile stays live only over
    neighbouring groups."""
    groups = {}
    for d, i, j, fid in triples:
        groups.setdefault((d, j), []).append((i, fid))
    return tuple((k, tuple(v)) for k, v in sorted(groups.items()))


def _kernel(f_ref, p_ref, ap_ref, part_ref, *, groups, n_channels, hp, wp,
            bh, bw, clamp):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    ti, tj = pl.program_id(0), pl.program_id(1)
    rows = ti * bh + jnp.arange(bh, dtype=jnp.int32)
    cols = tj * bw + jnp.arange(bw, dtype=jnp.int32)
    plane = hp * wp
    here = rows[:, None] * wp + cols[None, :]

    fields = {}

    def field(fid):
        f = fields.get(fid)
        if f is None:
            f = plgpu.load(f_ref.at[fid * plane + here]).astype(jnp.float32)
            fields[fid] = f
        return f

    acc = [None] * n_channels
    centre = {}
    for ((dy, dx), j), uses in groups:
        r = rows + dy
        c = cols + dx
        ok = ((r >= 0) & (r < hp))[:, None] & ((c >= 0) & (c < wp))[None, :]
        if clamp:
            r = jnp.clip(r, 0, hp - 1)
            c = jnp.clip(c, 0, wp - 1)
        ps = plgpu.load(
            p_ref.at[j * plane + r[:, None] * wp + c[None, :]],
            mask=ok,
            other=0.0,
        )
        if dy == 0 and dx == 0:
            centre[j] = ps
        for i, fid in uses:
            t = field(fid) * ps
            acc[i] = t if acc[i] is None else acc[i] + t

    part = jnp.zeros((), jnp.float32)
    for c in range(n_channels):
        a = acc[c] if acc[c] is not None else jnp.zeros((bh, bw), jnp.float32)
        plgpu.store(ap_ref.at[c * plane + here], a)
        pc = centre.get(c)
        if pc is None:
            pc = plgpu.load(p_ref.at[c * plane + here])
        part = part + jnp.sum(pc * a)
    plgpu.store(part_ref.at[ti * pl.num_programs(1) + tj], part)


def stencil_apply(meta: Dict, p: jnp.ndarray, *, interpret: bool = False,
                  num_warps: int = NUM_WARPS):
    """(JᵀJ·p, pᵀ(JᵀJ·p)) for packed ``p`` [C, Hp, Wp] in one kernel launch.

    ``interpret=True`` runs the same kernel through the Pallas interpreter
    (CPU tests); otherwise it compiles through Triton for a CUDA device."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    F = meta["F"]
    _t, hp, wp = F.shape
    bh, bw = meta["block"]
    C = p.shape[0]
    nbh, nbw = hp // bh, wp // bw
    kernel = functools.partial(
        _kernel,
        groups=_tile_groups(meta["triples"]),
        n_channels=C,
        hp=hp,
        wp=wp,
        bh=bh,
        bw=bw,
        clamp=interpret,
    )
    ap, part = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((C * hp * wp,), p.dtype),
            jax.ShapeDtypeStruct((nbh * nbw,), jnp.float32),
        ],
        grid=(nbh, nbw),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=NUM_STAGES
        ),
        name="stencil_jtj_apply",
    )(F.reshape(-1), p.reshape(-1))
    return ap.reshape(C, hp, wp), jnp.sum(part).astype(p.dtype)


def stencil_apply_reference(meta: Dict, p: jnp.ndarray):
    """Plain jnp apply of the same triples on the same layout (zero-padded
    shifts): the reference the kernel is checked against."""
    from .shift import shift

    F = meta["F"].astype(jnp.float32)
    acc = [jnp.zeros(p.shape[1:], p.dtype) for _ in range(p.shape[0])]
    for d, i, j, fid in meta["triples"]:
        acc[i] = acc[i] + F[fid] * shift(p[j], d)
    ap = jnp.stack(acc)
    return ap, jnp.vdot(p, ap)


class PackedStencil:
    """The kernel as the CG loop's operator: vectors are ``{"p": [C, Hp,
    Wp]}`` dicts, so the solver's dict algebra runs on them unchanged."""

    def __init__(self, meta: Dict, interpret: bool = False):
        self.meta = meta
        self.interpret = interpret

    def pack(self, d):
        return {"p": pack(self.meta, d)}

    def unpack(self, d):
        return unpack(self.meta, d["p"])

    def apply_dot(self, v):
        ap, den = stencil_apply(self.meta, v["p"], interpret=self.interpret)
        return {"p": ap}, den
