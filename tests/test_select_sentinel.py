"""Select condition-block semantics with non-finite sentinels.

The reference compiles ``ad.select`` into real condition blocks so the
untaken branch is never evaluated (o.t:1634-1650); its example apps rely on
this by filling invalid constraint entries with -inf
(arap_mesh_deformation/src/CombinedSolver.h:83) while the spec gates on
``greatereq(Constraints(0), -999999.9)``. These tests run the bundled ARAP
spec verbatim on -inf-sentinel data — the double-``where`` Select must keep
values, gradients and full GN/LM solves NaN-free.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import opt_tpu as ot
from opt_tpu.models.specs import arap_mesh_deformation

f32 = np.float32


def _arap_inputs(N=24, use_inf=True):
    rng = np.random.RandomState(7)
    pos = rng.uniform(0, 1, (N, 3)).astype(f32)
    v0 = np.arange(N, dtype=np.int32)
    v1 = np.roll(v0, 1).astype(np.int32)
    # both sentinels fail the spec's >= -999999.9 validity test; -1e9 is the
    # finite control (note -1.0 would PASS the test and constrain everything)
    sentinel = -np.inf if use_inf else -1e9
    con = np.full((N, 3), sentinel, f32)
    con[0] = pos[0]
    con[N // 2] = pos[N // 2] + np.array([0.5, 0.0, 0.2], f32)
    return {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), f32),
        "UrShape": pos,
        "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]), "v1": np.concatenate([v1, v0])},
        "w_fitSqrt": f32(1.0),
        "w_regSqrt": f32(np.sqrt(0.5)),
    }


def test_select_double_where_output_isolation():
    """The double-``where`` Select keeps its output and the gradients of
    everything DOWNSTREAM of it finite when the untaken branch carries ±inf
    (a plain where forwards the value but lets inf poison downstream product
    vjps)."""
    con = jnp.asarray([-jnp.inf, 2.0, jnp.inf], jnp.float32)

    def f(x):
        valid = (con >= -999999.9) & (con <= 999999.9)
        r = ot.Select(valid, x - con, 0.0)  # branch linear in the sentinel
        return jnp.sum(x * r * r)  # downstream products of the Select output

    x = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
    val, grad = jax.value_and_grad(f)(x)
    assert np.isfinite(float(val))
    assert np.all(np.isfinite(np.asarray(grad))), grad
    # taken entry: d/dx [x(x-2)^2] = (x-2)^2 + 2x(x-2) = 1 - 2 = -1
    np.testing.assert_allclose(np.asarray(grad), [0.0, -1.0, 0.0], rtol=1e-5)


def test_bind_time_sentinel_sanitization():
    """±inf in bound constant arrays is clamped to a finite sentinel that
    preserves every traced comparison (the trace-level analogue of the
    reference never evaluating untaken branches, o.t:1634-1650) — so even
    NONLINEAR branch expressions over the sentinel stay NaN-free."""
    from opt_tpu.compile import compile_spec

    def spec(S):
        N = S.Dim("N")
        X = S.Unknown("X", 1, (N,))
        C = S.Array("C", 1, (N,))
        valid = ot.greatereq(C(0), -999999.9)
        # nonlinear in the sentinel: (x - c)^2 inside the branch
        S.Energy(ot.Select(valid, (X(0) - C(0)) * (X(0) - C(0)), 0.0))

    c = compile_spec(spec, {"N": 4}, jnp.float32)
    u, consts, g, p = c.normalize_inputs(
        {"X": np.ones(4, f32), "C": np.array([-np.inf, 0.5, np.inf, 1.0], f32)}
    )
    assert np.all(np.isfinite(np.asarray(consts["C"]))), "inf not clamped"
    # clamped value still fails the validity test
    assert float(consts["C"][0, 0]) < -999999.9
    assert float(consts["C"][2, 0]) > 999999.9


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("fused", [True, False])
def test_arap_inf_sentinels_solve(kind, fused):
    """The reference ARAP data pattern (-inf invalid constraints) solves
    NaN-free and reaches the same final cost as finite sentinels."""
    N = 24
    ip = ot.InitializationParameters(use_fused_jtj=fused)
    plan = ot.Problem(arap_mesh_deformation, kind=kind).plan(
        dims={"N": N}, init_params=ip
    )
    sp = {"nIterations": 6, "lIterations": 20}

    res_inf = plan.solve(_arap_inputs(N, use_inf=True), **sp)
    assert np.isfinite(res_inf.final_cost), "solve NaN'd on -inf sentinels"
    res_fin = plan.solve(_arap_inputs(N, use_inf=False), **sp)
    assert np.isfinite(res_fin.final_cost)
    # -inf and -1e9 sentinels describe the same problem (both fail the
    # >= -999999.9 validity test) — costs must agree to float tolerance
    np.testing.assert_allclose(
        res_inf.final_cost, res_fin.final_cost, rtol=1e-4
    )
    assert res_inf.final_cost < res_inf.costs[0]


def _inf_unknown_spec(S):
    """SFS-style shape: the UNKNOWN itself carries -inf invalid markers
    (the reference's SFS data stores -inf in both targetDepth and the
    initial unknown), an Exclude freezes them, and the smoothness term at
    valid neighbors is gated on the neighbor being valid."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    D = S.Array("D", 1, (W, H))
    valid_c = ot.greater(D(0, 0), 0.0)
    S.Exclude(ot.Not(valid_c))
    S.Energy(ot.Select(valid_c, X(0, 0) - D(0, 0), 0.0))
    both = ot.And(valid_c, ot.greater(D(1, 0), 0.0))
    # nonlinear in the neighbor read so inf intermediates would NaN the vjp
    S.Energy(ot.Select(both, 0.3 * (X(0, 0) - X(1, 0)) * X(1, 0), 0.0))


def test_inf_sentinels_in_unknowns_solve_and_restore():
    """Regression: -inf invalid markers in the INITIAL UNKNOWN (SFS-style
    data) must neither NaN the solve (vjp cotangents multiply 0 by inf
    intermediates at valid/invalid boundaries) nor disappear from the
    output — excluded rows are frozen, so the solved unknowns carry the
    markers verbatim, as the reference's untouched GPU memory does."""
    n = 12
    rng = np.random.RandomState(3)
    d = rng.uniform(0.5, 1.5, (n, n)).astype(f32)
    invalid = np.zeros((n, n), bool)
    invalid[:, : n // 3] = True
    d[invalid] = -1.0  # invalid depth marker in the const array
    x0 = d + 0.4 * rng.randn(n, n).astype(f32)
    x0[invalid] = -np.inf  # the reference stores -inf in the unknown
    inputs = {"X": x0, "D": d}
    for kind in ("gaussNewtonGPU", "LMGPU"):
        plan = ot.Problem(_inf_unknown_spec).plan({"W": n, "H": n}, kind=kind)
        res = plan.solve(dict(inputs), nIterations=6, lIterations=25)
        assert np.isfinite(res.final_cost), kind
        assert all(np.isfinite(c) for c in res.costs), kind
        X = np.asarray(res.unknowns["X"])[..., 0]
        assert np.isneginf(X[invalid]).all(), "markers must be restored"
        assert np.isfinite(X[~invalid]).all()
        # the two terms compete, so the optimum is nonzero — require real
        # progress (costs[0] is already post-first-iteration)
        assert res.final_cost < 0.99 * res.costs[0], (kind, res.costs)


def test_sentinel_clamp_warning_at_verbosity(capsys):
    """Clamping ±inf sentinels is a quiet semantic rewrite: at verbosity>=1
    the bind must report that it fired (count +
    magnitude); at verbosity 0 it stays silent."""
    from opt_tpu.utils.logging import set_verbosity

    inputs = _arap_inputs(N=12, use_inf=True)
    plan = ot.Problem(arap_mesh_deformation).plan({"N": 12})
    try:
        set_verbosity(1)
        plan.compiled.normalize_inputs(dict(inputs))
        err = capsys.readouterr().err
        assert "clamped" in err and "sentinel" in err, err
        set_verbosity(0)
        plan.compiled.normalize_inputs(dict(inputs))
        err = capsys.readouterr().err
        assert "clamped" not in err, err
    finally:
        set_verbosity(0)
