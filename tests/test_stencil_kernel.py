"""Grid-stencil CG apply kernel (ops/stencil_kernel.py).

On the CPU the kernel runs through the Pallas interpreter
(``use_pallas_cg="interpret"``): its apply must match the jnp apply of the
same triples, its per-tile pᵀAp partials must sum to ``jnp.vdot``, and a
whole solve through it must track the XLA loop. The wrapper's choices —
layout, padding, which plans take the kernel, what ``"auto"`` picks, the
error for a forced kernel off the GPU — are checked here too. Tests marked
``gpu`` compile the kernel for the card and skip elsewhere.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import opt_tpu as ot
from opt_tpu.functions import FunctionSet
from opt_tpu.models.specs import image_warping, laplacian, poisson_image_editing
from opt_tpu.ops import stencil_kernel as sk
from opt_tpu.solver.params import InitializationParameters as IP


def _poisson_inputs(h, w=None, seed=0):
    w = w or h
    rng = np.random.RandomState(seed)
    mask = np.ones((h, w), np.float32)
    mask[h // 4 : -h // 4, w // 4 : -w // 4] = 0.0
    return {
        "X": rng.rand(h, w, 4).astype(np.float32),
        "T": rng.rand(h, w, 4).astype(np.float32),
        "M": mask,
    }


def _warp_inputs(n, seed=1):
    rng = np.random.RandomState(seed)
    ur = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1
    ).astype(np.float32)
    con = -np.ones((n, n, 2), np.float32)
    con[2, 2] = [3.0, 1.5]
    con[n - 3, n - 3] = [n - 5.0, n - 2.0]
    return {
        "Offset": ur + rng.rand(n, n, 2).astype(np.float32) * 0.1,
        "Angle": np.zeros((n, n), np.float32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": np.zeros((n, n), np.float32),
        "w_fitSqrt": np.float32(np.sqrt(10.0)),
        "w_regSqrt": np.float32(1.0),
    }


def _radius2(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.3 * (X(0, 0) - A(0, 0)))
    for dx, dy in ot.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2), (1, 1)]):
        S.Energy(ot.Select(ot.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def _radius2_inputs(h, w, seed=2):
    rng = np.random.RandomState(seed)
    return {
        "X": rng.rand(h, w).astype(np.float32),
        "A": rng.rand(h, w).astype(np.float32),
    }


def _meta(spec, dims, inputs, **ip):
    """The kernel's meta as the solver plans it, at the initial unknowns."""
    plan = ot.Problem(spec).plan(dims=dims, init_params=IP(**ip))
    u, c, g, pa = plan._normalize_and_place(dict(inputs))
    fs = FunctionSet(plan.compiled, c, g, pa)
    A, _d, _j, meta = fs.assemble_stencil(
        u, plan.solver._stencil_plan,
        coeff_dtype=plan.solver.ip.coefficient_dtype,
    )
    return A, meta


KERNEL_CASES = {
    "poisson_float4": (poisson_image_editing, (24, 24), _poisson_inputs(24), {}),
    "image_warping_mixed": (image_warping, (24, 24), _warp_inputs(24), {}),
    "radius2_stencil": (_radius2, (20, 20), _radius2_inputs(20, 20), {}),
    "odd_37x53": (poisson_image_editing, (37, 53), _poisson_inputs(37, 53), {}),
    "bf16_coefficients": (
        poisson_image_editing, (24, 24), _poisson_inputs(24),
        {"coefficient_dtype": "bfloat16"},
    ),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_interpret_kernel_matches_jnp_apply(case):
    spec, (h, w), inputs, ip = KERNEL_CASES[case]
    _A, meta = _meta(spec, {"W": h, "H": w}, inputs, **ip)
    assert meta is not None
    if ip.get("coefficient_dtype"):
        assert meta["F"].dtype == jnp.bfloat16
    hp, wp = meta["F"].shape[1:]
    bh, bw = meta["block"]
    assert hp % bh == 0 and wp % bw == 0 and hp >= h and wp >= w
    C = meta["ctot"]
    rng = np.random.RandomState(7)
    p = np.zeros((C, hp, wp), np.float32)
    p[:, :h, :w] = rng.randn(C, h, w)
    p = jnp.asarray(p)
    ap, den = sk.stencil_apply(meta, p, interpret=True)
    ap_r, den_r = sk.stencil_apply_reference(meta, p)
    scale = float(jnp.max(jnp.abs(ap_r)))
    np.testing.assert_allclose(np.asarray(ap), np.asarray(ap_r),
                               atol=1e-5 * scale)
    # the per-tile partials sum to pᵀAp
    np.testing.assert_allclose(float(den), float(jnp.vdot(p, ap)), rtol=1e-5)
    np.testing.assert_allclose(float(den), float(den_r), rtol=1e-5)
    # the padding stays zero
    ap = np.asarray(ap)
    assert not ap[:, h:, :].any() and not ap[:, :, w:].any()


@pytest.mark.parametrize("case", ["poisson_float4", "image_warping_mixed",
                                  "radius2_stencil"])
def test_packed_apply_equals_assembled_operator(case):
    """The packed-layout kernel applies the same operator as the XLA loop's
    assembled apply on the per-unknown layout."""
    spec, (h, w), inputs, ip = KERNEL_CASES[case]
    A, meta = _meta(spec, {"W": h, "H": w}, inputs, **ip)
    rng = np.random.RandomState(3)
    pd = {
        u: jnp.asarray(rng.randn(h, w, meta["channels"][u]).astype(np.float32))
        for u in meta["u_list"]
    }
    ap, _ = sk.PackedStencil(meta, interpret=True).apply_dot(
        {"p": sk.pack(meta, pd)}
    )
    got = sk.unpack(meta, ap["p"])
    want = A(pd)
    for u in meta["u_list"]:
        scale = float(jnp.max(jnp.abs(want[u])))
        np.testing.assert_allclose(np.asarray(got[u]), np.asarray(want[u]),
                                   atol=1e-5 * scale)


def test_pack_unpack_roundtrip_with_padding():
    meta = {
        "u_list": ("A", "B"), "offs": {"A": 0, "B": 2},
        "channels": {"A": 2, "B": 1}, "dom": (5, 7),
        "F": jnp.zeros((1, 8, 128)),
    }
    rng = np.random.RandomState(0)
    d = {"A": jnp.asarray(rng.randn(5, 7, 2)), "B": jnp.asarray(rng.randn(5, 7, 1))}
    packed = sk.pack(meta, d)
    assert packed.shape == (3, 8, 128)
    assert not np.asarray(packed)[:, 5:, :].any()
    back = sk.unpack(meta, packed)
    for u in d:
        np.testing.assert_array_equal(np.asarray(back[u]), np.asarray(d[u]))


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("variant", ["standard", "chronopoulos_gear"])
def test_interpret_kernel_solve_matches_xla_loop(kind, variant):
    n = 32
    inputs = _poisson_inputs(n)
    res = {}
    for mode in ("interpret", False):
        plan = ot.Problem(poisson_image_editing, kind=kind).plan(
            dims={"W": n, "H": n},
            init_params=IP(use_pallas_cg=mode, cg_variant=variant),
        )
        res[mode] = plan.solve(dict(inputs), nIterations=2, lIterations=60)
        assert plan.cg_path == ("interpret" if mode else "xla")
    a, b = res["interpret"], res[False]
    np.testing.assert_allclose(a.final_cost, b.final_cost, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.unknowns["X"]),
                               np.asarray(b.unknowns["X"]), atol=1e-4)
    assert abs(a.num_linear_iterations - b.num_linear_iterations) <= 2


def test_interpret_kernel_solve_mixed_unknowns():
    n = 24
    res = {}
    for mode in ("interpret", False):
        plan = ot.Problem(image_warping).plan(
            dims={"W": n, "H": n}, init_params=IP(use_pallas_cg=mode)
        )
        res[mode] = plan.solve(_warp_inputs(n), nIterations=3, lIterations=30)
    np.testing.assert_allclose(res["interpret"].final_cost,
                               res[False].final_cost, rtol=1e-4)


def test_interpret_kernel_under_vmap_batched_solve():
    B, n = 3, 16
    rng = np.random.RandomState(0)
    inputs = {
        "X": rng.rand(B, n, n).astype(np.float32),
        "A": rng.rand(B, n, n).astype(np.float32),
    }
    out = {}
    for mode in ("interpret", False):
        plan = ot.Problem(laplacian).plan(
            dims={"W": n, "H": n}, init_params=IP(use_pallas_cg=mode)
        )
        out[mode] = plan.solve_batched(dict(inputs), nIterations=3,
                                       lIterations=20)
        assert plan.cg_path == ("interpret" if mode else "xla")
    np.testing.assert_allclose(out["interpret"].final_costs,
                               out[False].final_costs, rtol=1e-4)


def test_auto_picks_xla_loop_off_gpu():
    plan = ot.Problem(poisson_image_editing).plan(dims={"W": 16, "H": 16})
    assert plan.cg_path is None  # nothing traced yet
    plan.solve(_poisson_inputs(16), nIterations=1, lIterations=5)
    assert plan.cg_path == "xla"
    assert plan.cg_path_reason == "kernel off"


@pytest.mark.parametrize("mode", [True, "on"])
def test_forcing_compiled_kernel_off_gpu_raises(mode):
    with pytest.raises(ValueError, match="CUDA device"):
        ot.Problem(poisson_image_editing).plan(
            dims={"W": 16, "H": 16}, init_params=IP(use_pallas_cg=mode)
        )


def test_unknown_kernel_mode_raises():
    with pytest.raises(ValueError, match="use_pallas_cg"):
        ot.Problem(poisson_image_editing).plan(
            dims={"W": 16, "H": 16}, init_params=IP(use_pallas_cg="maybe")
        )


@pytest.mark.parametrize(
    "what,reason",
    [
        ("block_jacobi", "block_jacobi preconditioner"),
        ("graph", "graph couplings"),
        ("volume", "3-D index space"),
    ],
)
def test_declined_plans_say_why(what, reason):
    if what == "block_jacobi":
        plan = ot.Problem(image_warping).plan(
            dims={"W": 16, "H": 16},
            init_params=IP(use_pallas_cg="interpret",
                           preconditioner="block_jacobi"),
        )
        plan.solve(_warp_inputs(16), nIterations=1, lIterations=5)
    elif what == "graph":
        from opt_tpu.models.specs import arap_mesh_deformation

        N = 12
        pos = np.random.RandomState(0).rand(N, 3).astype(np.float32)
        v0 = np.arange(N, dtype=np.int32)
        con = -np.ones((N, 3), np.float32)
        con[0] = pos[0]
        plan = ot.Problem(arap_mesh_deformation).plan(
            dims={"N": N}, init_params=IP(use_pallas_cg="interpret")
        )
        plan.solve({
            "Offset": pos.copy(), "Angle": np.zeros((N, 3), np.float32),
            "UrShape": pos, "Constraints": con,
            "G": {"v0": v0, "v1": (v0 + 1) % N},
            "w_fitSqrt": np.float32(1.0), "w_regSqrt": np.float32(1.0),
        }, nIterations=1, lIterations=5)
    else:
        from opt_tpu.models.specs import volumetric_mesh_deformation

        n = 4
        ii, jj, kk = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
        ur = np.stack([ii, jj, kk], -1).astype(np.float32)
        con = -1e6 * np.ones((n, n, n, 3), np.float32)
        con[0, 0, 0] = ur[0, 0, 0]
        plan = ot.Problem(volumetric_mesh_deformation).plan(
            dims={"W": n, "H": n, "D": n},
            init_params=IP(use_pallas_cg="interpret"),
        )
        plan.solve({
            "Offset": ur.copy(), "Angle": np.zeros((n, n, n, 3), np.float32),
            "UrShape": ur, "Constraints": con,
            "w_fitSqrt": np.float32(1.0), "w_regSqrt": np.float32(1.0),
        }, nIterations=1, lIterations=5)
    assert plan.cg_path == "xla"
    assert plan.cg_path_reason == reason


# ---------------------------------------------------------------------------
# on the card only
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_compiled_kernel_matches_jnp_apply(gpu, case):
    spec, (h, w), inputs, ip = KERNEL_CASES[case]
    _A, meta = _meta(spec, {"W": h, "H": w}, inputs, **ip)
    C = meta["ctot"]
    hp, wp = meta["F"].shape[1:]
    p = np.zeros((C, hp, wp), np.float32)
    p[:, :h, :w] = np.random.RandomState(7).randn(C, h, w)
    p = jnp.asarray(p)
    ap, den = sk.stencil_apply(meta, p)
    ap_r, den_r = sk.stencil_apply_reference(meta, p)
    scale = float(jnp.max(jnp.abs(ap_r)))
    np.testing.assert_allclose(np.asarray(ap), np.asarray(ap_r),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(den), float(den_r), rtol=1e-4)


@pytest.mark.gpu
def test_auto_engages_compiled_kernel_on_gpu(gpu):
    n = 64
    res = {}
    for mode in ("auto", False):
        plan = ot.Problem(poisson_image_editing).plan(
            dims={"W": n, "H": n}, init_params=IP(use_pallas_cg=mode)
        )
        res[mode] = plan.solve(_poisson_inputs(n), nIterations=1,
                               lIterations=200)
        assert plan.cg_path == ("triton" if mode == "auto" else "xla")
    np.testing.assert_allclose(res["auto"].final_cost, res[False].final_cost,
                               rtol=1e-4)
