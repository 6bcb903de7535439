"""DSL standard library — the helpers visible in reference energy specs.

Equivalent of API/src/lib.t: ``Select``, ``All/Any/Not``,
comparison helpers, ``Rotate2D/3D``, vector math, robust norms. All of these
operate on ordinary ``jnp`` arrays with a trailing channel axis, so they are
usable both inside spec functions and in normal JAX code.

Module-level ``InBounds``/``InBoundsExpanded``/``Index``/``Energy`` etc.
delegate to the spec builder currently being traced, so reference-style specs
port with minimal edits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .spec import current_builder

# ---------------------------------------------------------------------------
# logic / comparison (lib.t: All/And/Or/Not, ad.t comparison ops)
# ---------------------------------------------------------------------------


def Select(cond, a, b):
    """reference ad.select: elementwise cond ? a : b with broadcasting.

    Compiled as the double-``where`` form: each operand is select-guarded
    before the outer select, so the untaken side contributes neither values
    nor gradients. This matches the reference's condition-block semantics —
    it emits real branches and never evaluates the untaken side
    (o.t:1634-1650, ad.t:928-942 splitcondition). Reference apps rely on
    this with non-finite sentinels (invalid constraints are filled with
    -inf, e.g. arap_mesh_deformation/src/CombinedSolver.h:83, and specs gate
    on ``greatereq(C, -999999.9)``): a plain ``jnp.where`` would forward the
    value correctly but let ±inf from the untaken branch poison the vjp
    (0·inf = NaN in downstream product rules). The inner guards clamp the
    untaken side to 0, keeping both the value and every tangent/cotangent
    finite."""
    a = jnp.asarray(a)
    b = jnp.asarray(b) if not isinstance(b, (int, float)) else jnp.asarray(b, a.dtype)
    if hasattr(cond, "dtype") and cond.dtype != jnp.bool_:
        cond = cond != 0
    a_g = jnp.where(cond, a, jnp.zeros((), a.dtype))
    b_g = jnp.where(cond, jnp.zeros((), b.dtype), b)
    return jnp.where(cond, a_g, b_g)


def All(v):
    """Conjunction over the channel axis, keepdims (lib.t All)."""
    v = jnp.asarray(v)
    if v.dtype != jnp.bool_:
        v = v != 0
    return jnp.all(v, axis=-1, keepdims=True)


def Any(v):
    v = jnp.asarray(v)
    if v.dtype != jnp.bool_:
        v = v != 0
    return jnp.any(v, axis=-1, keepdims=True)


def And(*args):
    out = None
    for a in args:
        a = jnp.asarray(a)
        if a.dtype != jnp.bool_:
            a = a != 0
        out = a if out is None else out & a
    return out


def Or(*args):
    out = None
    for a in args:
        a = jnp.asarray(a)
        if a.dtype != jnp.bool_:
            a = a != 0
        out = a if out is None else out | a
    return out


def Not(v):
    v = jnp.asarray(v)
    if v.dtype != jnp.bool_:
        v = v != 0
    return ~v


def eq(a, b):
    return jnp.asarray(a) == b


def neq(a, b):
    return jnp.asarray(a) != b


def greater(a, b):
    return jnp.asarray(a) > b


def less(a, b):
    return jnp.asarray(a) < b


def greatereq(a, b):
    return jnp.asarray(a) >= b


def lesseq(a, b):
    return jnp.asarray(a) <= b


# ---------------------------------------------------------------------------
# vector / matrix math (lib.t:66-104)
# ---------------------------------------------------------------------------


def Dot(a, b):
    return jnp.sum(jnp.asarray(a) * b, axis=-1, keepdims=True)


Dot3 = Dot


def Slice(v, lo: int, hi: int):
    """Channel sub-range of a vector value (reference lib.t Slice)."""
    return jnp.asarray(v)[..., int(lo) : int(hi)]


def Reduce(v):
    """Sum over the channel axis, keepdims (reference lib.t Reduce)."""
    return jnp.sum(jnp.asarray(v), axis=-1, keepdims=True)


def length(v, axis=-1):
    return jnp.sqrt(jnp.sum(jnp.square(v), axis=axis, keepdims=True))


def normalize(v):
    return v / length(v)


def Sqrt(v):
    return jnp.sqrt(v)


def abs_(v):
    return jnp.abs(v)


def Rotate2D(angle, v):
    """2D rotation of channel-pair vectors by per-pixel angle (lib.t:92-96).

    angle: [..., 1]; v: [..., 2].
    """
    a = angle[..., 0] if angle.shape[-1] == 1 else angle
    ca, sa = jnp.cos(a), jnp.sin(a)
    x, y = v[..., 0], v[..., 1]
    return jnp.stack([ca * x - sa * y, sa * x + ca * y], axis=-1)


def RotationMatrix3D(angles):
    """Euler-angle (XYZ, as lib.t:77-91 evalR) rotation matrix [..., 3, 3]."""
    alpha, beta, gamma = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, cb, cg = jnp.cos(alpha), jnp.cos(beta), jnp.cos(gamma)
    sa, sb, sg = jnp.sin(alpha), jnp.sin(beta), jnp.sin(gamma)
    # R = Rz(gamma?) — reference evalR composes CosAlpha..: matches lib.t
    r00 = cg * cb
    r01 = -sg * ca + cg * sb * sa
    r02 = sg * sa + cg * sb * ca
    r10 = sg * cb
    r11 = cg * ca + sg * sb * sa
    r12 = -cg * sa + sg * sb * ca
    r20 = -sb
    r21 = cb * sa
    r22 = cb * ca
    rows = [
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def _mat3_vec(R, v):
    # per-element 3x3 · 3-vector at full float32: at default precision the
    # batched dot could run as TF32 on tensor cores and lose digits inside
    # the residuals
    return jnp.einsum(
        "...ij,...j->...i", R, v, precision=jax.lax.Precision.HIGHEST
    )


def Rotate3D(angles, v):
    """Rotate [...,3] vectors by per-element Euler angles [...,3] (lib.t:77-91)."""
    return _mat3_vec(RotationMatrix3D(angles), v)


def Matrix3x3Mul(m, v):
    """m: [..., 9] row-major 3x3; v: [..., 3] (lib.t Matrix3x3Mul)."""
    return _mat3_vec(m.reshape(m.shape[:-1] + (3, 3)), v)


# ---------------------------------------------------------------------------
# robust norms (lib.t:98-114)
# ---------------------------------------------------------------------------


def L_2_norm(v):
    return length(v)


def L_p(val, val_const, p, dims=None):
    """Robust p-norm residual weighting (lib.t:105-114).

    Reference semantics: C = (‖val_const‖+eps)^(p-2); the weight sqrt(C) is
    stored in a ComputedArray (constant during the nonlinear iteration, since
    val_const is a const view of the unknown) and multiplied onto val. Here
    the constancy comes from stop_gradient; `dims` is accepted for spec
    portability and ignored."""
    import jax

    del dims
    eps = 1e-7
    dist = jnp.sqrt(jnp.sum(jnp.square(val_const), axis=-1, keepdims=True))
    w = jnp.sqrt(jnp.power(dist + eps, p - 2.0))
    return jax.lax.stop_gradient(w) * val


# ---------------------------------------------------------------------------
# builder-contextual helpers (module-level versions of SpecBuilder methods)
# ---------------------------------------------------------------------------


def InBounds(*off):
    return current_builder().InBounds(*off)


def InBoundsExpanded(*args):
    return current_builder().InBoundsExpanded(*args)


def Index(axis, dims=None):
    return current_builder().Index(axis, dims)


def Energy(*terms):
    return current_builder().Energy(*terms)


def Exclude(cond):
    return current_builder().Exclude(cond)


def UsePreconditioner(flag):
    return current_builder().UsePreconditioner(flag)


def Stencil(offsets):
    """Iterate stencil offsets (lib.t:117-124)."""
    for off in offsets:
        yield tuple(off)
