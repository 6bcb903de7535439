"""Multi-device sharding tests on the 8-virtual-CPU mesh (SURVEY.md §4:
test multi-host logic the JAX-native way with forced host platform devices).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import opt_tpu as ot
from opt_tpu.parallel.mesh import make_mesh

# Sharded-vs-single-device EQUIVALENCE tests pin the solver variant: under
# a mesh the auto policy (params.resolve_auto_policy) picks
# chronopoulos_gear + block_jacobi + owner reorder, a deliberately
# DIFFERENT trajectory from the single-device standard/jacobi defaults.
# These tests isolate the sharding math, so both sides run the same
# algorithm; tests/test_auto_policy.py covers the auto configuration.
def pinned_ip(**kw):
    base = dict(
        cg_variant="standard", preconditioner="jacobi", edge_reorder=False
    )
    base.update(kw)
    return ot.InitializationParameters(**base)


def poisson_spec(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 2, (W, H))
    T = S.Array("T", 2, (W, H))
    M = S.Array("M", 1, (W, H))
    S.UsePreconditioner(False)
    S.Exclude(ot.Not(ot.eq(M(0, 0), 0)))
    for dx, dy in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e = (X(0, 0) - X(dx, dy)) - (T(0, 0) - T(dx, dy))
        S.Energy(ot.Select(ot.InBounds(dx, dy), e, 0.0))


def test_sharded_solve_matches_single_device():
    assert len(jax.devices()) == 8, jax.devices()
    n = 32
    rng = np.random.RandomState(0)
    inputs = {
        "X": rng.rand(n, n, 2).astype(np.float32),
        "T": rng.rand(n, n, 2).astype(np.float32),
        "M": (rng.rand(n, n) > 0.7).astype(np.float32),
    }
    res1 = ot.Problem(poisson_spec).plan(dims={"W": n, "H": n}).solve(
        dict(inputs), nIterations=2, lIterations=50
    )
    mesh = make_mesh()  # 8 devices -> (2,4) tiling
    res8 = ot.Problem(poisson_spec).plan(dims={"W": n, "H": n}, mesh=mesh).solve(
        dict(inputs), nIterations=2, lIterations=50
    )
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=1e-4)
    assert np.allclose(
        np.asarray(res1.unknowns["X"]), np.asarray(res8.unknowns["X"]), atol=1e-4
    )
    # the sharded result really is tiled over the mesh
    shard_shapes = {s.data.shape for s in res8.unknowns["X"].addressable_shards}
    assert shard_shapes == {(n // 2, n // 4, 2)}, shard_shapes


def test_sharded_graph_solve():
    def curve_spec(S):
        N, U = S.Dim("N"), S.Dim("U")
        fp = S.Unknown("funcParams", 2, (U,))
        data = S.Image("data", 2, (N,))
        G = S.Graph("G", d=(N,), p=(U,))
        x = data(G.d)[..., 0]
        y = data(G.d)[..., 1]
        a = fp(G.p)[..., 0]
        b = fp(G.p)[..., 1]
        S.Energy(y - (a * jnp.cos(b * x) + b * jnp.sin(a * x)))

    N = 512
    rng = np.random.RandomState(1)
    xs = rng.rand(N) * 0.1
    ys = 100.0 * np.cos(102.0 * xs) + 102.0 * np.sin(100.0 * xs)
    inputs = {
        "funcParams": np.array([[99.7, 102.3]], np.float32),
        "data": np.stack([xs, ys], -1).astype(np.float32),
        "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)},
    }
    mesh = make_mesh()
    plan = ot.Problem(curve_spec).plan(dims={"N": N, "U": 1}, mesh=mesh)
    res = plan.solve(inputs, nIterations=15, lIterations=40)
    got = np.asarray(res.unknowns["funcParams"])[0]
    assert abs(got[0] - 100.0) < 0.3 and abs(got[1] - 102.0) < 0.3, got


def _arap_inputs(n_side):
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(np.float32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -1e6 * np.ones((N, 3), np.float32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array([2.0, 0, 1.0], np.float32)
    return N, {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "UrShape": pos,
        "Constraints": con,
        "G": {
            "v0": np.concatenate([v0, v1]).astype(np.int32),
            "v1": np.concatenate([v1, v0]).astype(np.int32),
        },
        "w_fitSqrt": np.float32(1.0),
        "w_regSqrt": np.float32(0.7),
    }


def test_owner_block_graph_sharding_matches_single_device():
    """Vertex arrays + ELL tables shard by owner blocks over the mesh; the
    sharded ARAP solve must match the single-device solve and actually be
    block-sharded (not replicated)."""
    from opt_tpu.models.specs import arap_mesh_deformation as arap_spec

    n_side = 16  # N=256, divisible by 8 devices
    N, inputs = _arap_inputs(n_side)
    res1 = ot.Problem(arap_spec).plan(dims={"N": N}).solve(
        dict(inputs), nIterations=3, lIterations=20
    )
    mesh = make_mesh()
    plan8 = ot.Problem(arap_spec).plan(
        dims={"N": N}, mesh=mesh, init_params=pinned_ip()
    )
    res8 = plan8.solve(dict(inputs), nIterations=3, lIterations=20)
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=1e-4), (
        res1.final_cost,
        res8.final_cost,
    )
    assert np.allclose(
        np.asarray(res1.unknowns["Offset"]),
        np.asarray(res8.unknowns["Offset"]),
        atol=1e-4,
    )
    shard_shapes = {s.data.shape for s in res8.unknowns["Offset"].addressable_shards}
    assert shard_shapes == {(N // 8, 3)}, shard_shapes


def test_edge_reorder_owner_shrinks_assembly_exchange():
    """edge_reorder="owner" (opt-in): owner-sorted edges must (a) match
    the unsorted sharded solve (sum over edges — only float reduction
    order changes) and (b) shrink the per-GN-step device-major edge-row
    exchange (its all_to_all payload M), whose volume is set by
    edge-numbering alignment rather than boundary size. Shuffled vertex
    ids make the adversarial case: random owners scatter edge rows
    across all devices."""
    from opt_tpu.models.specs import arap_mesh_deformation as arap_spec

    N, inputs = _arap_inputs(16)
    # shuffle the vertex numbering so the natural edge order has no
    # owner alignment at all
    rng = np.random.RandomState(3)
    perm = rng.permutation(N).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    inputs = dict(inputs)
    for k in ("Offset", "Angle", "UrShape", "Constraints"):
        inputs[k] = np.asarray(inputs[k])[inv].copy()
    inputs["G"] = {
        "v0": perm[inputs["G"]["v0"]],
        "v1": perm[inputs["G"]["v1"]],
    }
    mesh = make_mesh()
    sp = dict(nIterations=3, lIterations=20)
    sizes = {}
    costs = {}
    for tag, ip in [
        ("base", pinned_ip()),
        ("owner", pinned_ip(edge_reorder="owner")),
    ]:
        plan = ot.Problem(arap_spec).plan(
            dims={"N": N}, mesh=mesh, init_params=ip
        )
        u, c, g, p = plan._normalize_and_place(dict(inputs))
        sizes[tag] = g["G"]["__halo_send____inc__v0|v1"].shape[2]
        costs[tag] = plan.solve(dict(inputs), **sp).final_cost
    np.testing.assert_allclose(costs["owner"], costs["base"], rtol=2e-3)
    assert sizes["owner"] < 0.7 * sizes["base"], sizes


def test_mismatched_space_read_falls_back_to_take():
    """An image on a DIFFERENT-sized 1-D space than the slot's (legal —
    edge_gather just takes) must not ride the slot's exchange tables,
    whose localized ids assume the slot's vertex count: sharded solve
    equals single-device."""
    def spec(S):
        N, M = S.Dim("N"), S.Dim("M")
        X = S.Unknown("X", 1, (N,))
        W = S.Array("W", 1, (M,))
        G = S.Graph("G", a=(N,), b=(N,))
        S.Energy(X(G.a) - X(G.b), 0.3 * (X(G.a) - W(G.a)))

    N, M = 64, 128
    rng = np.random.RandomState(0)
    inputs = {
        "X": rng.rand(N, 1).astype(np.float32),
        "W": rng.rand(M, 1).astype(np.float32),
        "G": {
            "a": np.arange(N, dtype=np.int32),
            "b": ((np.arange(N) + 1) % N).astype(np.int32),
        },
    }
    sp = dict(nIterations=3, lIterations=15)
    r1 = ot.Problem(spec).plan(dims={"N": N, "M": M}).solve(dict(inputs), **sp)
    r8 = ot.Problem(spec).plan(dims={"N": N, "M": M}, mesh=make_mesh()).solve(
        dict(inputs), **sp
    )
    np.testing.assert_allclose(r8.final_cost, r1.final_cost, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(r8.unknowns["X"]), np.asarray(r1.unknowns["X"]), atol=1e-5
    )


def test_unknown_edge_reorder_mode_raises():
    from opt_tpu.models.specs import arap_mesh_deformation as arap_spec

    with pytest.raises(ValueError, match="edge_reorder"):
        ot.Problem(arap_spec).plan(
            dims={"N": 16},
            mesh=make_mesh(),
            init_params=ot.InitializationParameters(edge_reorder="hilbert"),
        )


def test_halo_gather_matches_plain_take():
    """Owner-block neighbor exchange (parallel/mesh.py halo_gather): the
    all_to_all + local-gather read must reproduce the plain global take
    exactly, for 2-D (remainder) and 3-D (full-cross) id tables."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from opt_tpu.parallel.mesh import build_halo_tables, halo_gather

    rng = np.random.RandomState(0)
    N, C, ndev = 64, 3, 8
    mesh = make_mesh()
    p = rng.rand(N, C).astype(np.float32)
    p_ext = np.concatenate([p, np.zeros((1, C), np.float32)])
    pj = jax.device_put(p, NamedSharding(mesh, P(("gx", "gy"), None)))
    for shape in [(N, 5), (N, 4, 2)]:
        cross = rng.randint(0, N + 1, size=shape).astype(np.int32)
        halo = build_halo_tables(cross, N, ndev)
        assert halo is not None
        send = jax.device_put(
            jnp.asarray(halo["send"]), NamedSharding(mesh, P(("gx", "gy")))
        )
        loc = jax.device_put(
            jnp.asarray(halo["loc"]), NamedSharding(mesh, P(("gx", "gy")))
        )
        got = np.asarray(
            jax.jit(lambda a, b, c: halo_gather(mesh, a, b, c))(pj, send, loc)
        )
        np.testing.assert_array_equal(got, p_ext[cross])


def test_graph_halo_exchange_replaces_cg_loop_all_gather():
    """With an active mesh, the graph CG loop's irregular
    cross-endpoint p read must ride a boundary-sized all_to_all, not an
    all-gather of the whole packed p. Checked two ways: the sharded solve
    still matches single-device on a SHUFFLED-id graph (no DIA offsets, so
    the irregular path is the hot path), and the compiled HLO swaps
    all-gather for all-to-all when the halo tables are present."""
    import jax

    from opt_tpu.models.specs import arap_mesh_deformation as arap_spec

    N, inputs = _arap_inputs(16)
    rng = np.random.RandomState(5)
    perm = rng.permutation(N).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    sh = dict(inputs)
    for k in ("Offset", "Angle", "UrShape", "Constraints"):
        sh[k] = np.asarray(inputs[k])[inv]
    sh["G"] = {"v0": perm[inputs["G"]["v0"]], "v1": perm[inputs["G"]["v1"]]}

    res1 = ot.Problem(arap_spec).plan(dims={"N": N}).solve(
        dict(sh), nIterations=3, lIterations=20
    )
    mesh = make_mesh()
    plan8 = ot.Problem(arap_spec).plan(
        dims={"N": N}, mesh=mesh, init_params=pinned_ip()
    )
    res8 = plan8.solve(dict(sh), nIterations=3, lIterations=20)
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=1e-4)

    u, c, g, p = plan8._normalize_and_place(dict(sh))
    assert any(k.startswith("__halo") for k in g["G"]), "halo tables missing"
    sp = plan8.solver._traced_sp(
        ot.SOLVER_PARAMETER_DEFAULTS | {"nIterations": 3, "lIterations": 20}
    )

    def hlo(graphs):
        return (
            jax.jit(
                lambda X, cs, gs, ps: plan8.solver._solve_core(
                    X, cs, gs, ps, sp, 3
                )
            )
            .lower(u, c, graphs, p)
            .compile()
            .as_text()
        )

    h_on = hlo(g)
    g_off = {
        "G": {k: v for k, v in g["G"].items() if not k.startswith("__halo")}
    }
    h_off = hlo(g_off)
    # the CG-loop all-gather disappears; the boundary all_to_all appears
    assert h_on.count("all-gather") < h_off.count("all-gather"), (
        h_on.count("all-gather"),
        h_off.count("all-gather"),
    )
    # the exchange actually runs (a raw count comparison against h_off is
    # brittle: XLA SPMD lowers the fallback's cross-sharded takes with
    # all-to-alls of its own)
    assert "all-to-all" in h_on

    # per-GN-step assembly, JᵀF AND the residual/probe vertex reads all
    # ride the exchange now: the compiled graph solve contains NO
    # all-gather at all — every remaining collective is boundary-sized
    # (all_to_all / collective-permute) or scalar (all-reduce)
    assert "all-gather" not in h_on, h_on.count("all-gather")


def test_grid_cg_loop_compiles_to_halo_permutes_only():
    """Grid problems under a mesh: the solve must contain NO all-gathers —
    stencil reads lower to collective-permute halo exchanges and the CG
    scalars to all-reduce (the design target of the 2-D tile sharding)."""
    import jax

    from opt_tpu.models.specs import poisson_image_editing

    n = 64
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), np.float32)
    mask[8:-8, 8:-8] = 0
    inputs = {
        "X": rng.rand(n, n, 4).astype(np.float32),
        "T": rng.rand(n, n, 4).astype(np.float32),
        "M": mask,
    }
    mesh = make_mesh()
    plan = ot.Problem(poisson_image_editing).plan({"W": n, "H": n}, mesh=mesh)
    u, c, g, p = plan._normalize_and_place(dict(inputs))
    sp = plan.solver._traced_sp(
        ot.SOLVER_PARAMETER_DEFAULTS | {"nIterations": 1, "lIterations": 20}
    )
    hlo = (
        jax.jit(
            lambda X, cs, gs, ps: plan.solver._solve_core(X, cs, gs, ps, sp, 1)
        )
        .lower(u, c, g, p)
        .compile()
        .as_text()
    )
    assert "all-gather" not in hlo, "grid solve should not all-gather"
    assert "collective-permute" in hlo  # halo exchanges
    assert "all-reduce" in hlo  # CG dot products / cost


@pytest.mark.parametrize(
    "seed,n_verts",
    [(0, 64), (1, 48), (2, 49), (3, 8)],  # 49: not divisible -> replicate
)
def test_fuzz_sharded_graph_solve_matches_single_device(seed, n_verts):
    """Random graph energies (gated couplings, random channel counts,
    random permutation topologies) solved over the 8-device mesh must
    match the single-device solve — stresses the owner-block halo index
    math (build_halo_tables, map_stacked_rows_device_major) across
    topology/divisibility edge cases, including the replication fallback
    for odd vertex counts."""
    import test_fuzz_operator as tfo

    old_n = tfo.N
    tfo.N = n_verts
    try:
        rng = np.random.RandomState(1000 + seed)
        spec, dims, inputs = tfo._random_graph_spec(rng)
    finally:
        tfo.N = old_n

    sp = dict(nIterations=3, lIterations=15)
    res1 = ot.Problem(spec).plan(dims=dims).solve(dict(inputs), **sp)
    plan8 = ot.Problem(spec).plan(dims=dims, mesh=make_mesh())
    res8 = plan8.solve(dict(inputs), **sp)
    assert np.isfinite(res8.final_cost)
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=2e-4), (
        res1.final_cost, res8.final_cost,
    )


def test_sharded_four_slot_hypergraph_matches_single_device():
    """cotangent-style 4-endpoint hyperedges: the m=4 slot stacking in the
    combined-incidence exchange (device-major row mapping with 4 slot
    blocks per device) must reproduce the single-device solve."""
    from opt_tpu.models.specs import cotangent_mesh_smoothing

    n_side = 8
    N = n_side * n_side
    rng = np.random.RandomState(7)
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack(
        [ii.ravel(), jj.ravel(), 0.1 * rng.rand(N)], -1
    ).astype(np.float32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()]).astype(
        np.int32
    )
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()]).astype(
        np.int32
    )
    inputs = {
        "X": pos.copy(),
        "A": pos,
        "G": {"v0": v0, "v1": v1, "v2": (v0 + 2) % N, "v3": (v0 + 3) % N},
        "w_fit": 1.0,
        "w_reg": 0.5,
    }
    sp = dict(nIterations=3, lIterations=15)
    res1 = ot.Problem(cotangent_mesh_smoothing).plan(dims={"N": N}).solve(
        dict(inputs), **sp
    )
    plan8 = ot.Problem(cotangent_mesh_smoothing).plan(
        dims={"N": N}, mesh=make_mesh(), init_params=pinned_ip()
    )
    res8 = plan8.solve(dict(inputs), **sp)
    u, c, g, p = plan8._normalize_and_place(dict(inputs))
    assert any(
        k.startswith("__halo_send____inc__") for k in g["G"]
    ), "4-slot inc halo tables missing"
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=2e-4), (
        res1.final_cost, res8.final_cost,
    )


# ---------------------------------------------------------------------------
# The CG apply kernel under a mesh: the plan declines it ("sharded mesh") and
# XLA SPMD runs the sharded loop (collective-permute halos, all-reduced
# dots), which must match the single-device solve.
# ---------------------------------------------------------------------------


def _assert_sharded_xla_loop(plan):
    assert plan.cg_path == "xla", plan.cg_path
    assert plan.cg_path_reason in (
        "sharded mesh", "block_jacobi preconditioner"
    ), plan.cg_path_reason


@pytest.mark.parametrize(
    "kind,variant,prec",
    [
        ("gaussNewtonGPU", "standard", "jacobi"),
        ("gaussNewtonGPU", "chronopoulos_gear", "block_jacobi"),
        ("LMGPU", "standard", "jacobi"),
        ("LMGPU", "chronopoulos_gear", "block_jacobi"),
    ],
)
def test_sharded_fused_cg_matches_single_device(kind, variant, prec):
    from opt_tpu.models.specs import image_warping

    n = 32
    rng = np.random.RandomState(0)
    f32 = np.float32
    ur = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1
    ).astype(f32)
    con = -np.ones((n, n, 2), f32)
    for k in range(6):
        i, j = rng.randint(0, n, 2)
        con[i, j] = [i + rng.randn(), j + rng.randn()]
    inputs = {
        "Offset": ur.copy(),
        "Angle": np.zeros((n, n), f32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": np.sqrt(100.0).astype(f32),
        "w_regSqrt": np.sqrt(0.01).astype(f32),
    }
    ipk = dict(cg_variant=variant, preconditioner=prec, edge_reorder=False)
    res1 = ot.Problem(image_warping, kind=kind).plan(
        dims={"W": n, "H": n},
        init_params=ot.InitializationParameters(**ipk),
    ).solve(dict(inputs), nIterations=3, lIterations=20)
    plan8 = ot.Problem(image_warping, kind=kind).plan(
        dims={"W": n, "H": n},
        mesh=make_mesh(),
        init_params=ot.InitializationParameters(
            use_pallas_cg="interpret", **ipk
        ),
    )
    res8 = plan8.solve(dict(inputs), nIterations=3, lIterations=20)
    _assert_sharded_xla_loop(plan8)
    assert res1.num_linear_iterations == res8.num_linear_iterations
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=1e-3)
    assert np.allclose(
        np.asarray(res1.unknowns["Offset"]),
        np.asarray(res8.unknowns["Offset"]),
        atol=1e-3,
    )


def test_sharded_fused_cg_unsupported_falls_back():
    """Graph problems decline the stencil kernel and solve via the XLA
    loop, sharded."""
    N = 64
    rng = np.random.RandomState(3)
    pos = rng.rand(N, 3).astype(np.float32)
    con = -np.ones((N, 3), np.float32)
    con[0] = pos[0] + 0.25
    v0 = np.arange(N, dtype=np.int32)
    from opt_tpu.models.specs import arap_mesh_deformation

    inputs = {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "UrShape": pos,
        "Constraints": con,
        "G": {"v0": v0, "v1": (v0 + 1) % N},
        "w_fitSqrt": np.sqrt(10.0).astype(np.float32),
        "w_regSqrt": np.sqrt(1.0).astype(np.float32),
    }
    plan = ot.Problem(arap_mesh_deformation).plan(
        dims={"N": N},
        mesh=make_mesh(),
        init_params=ot.InitializationParameters(
            use_pallas_cg="interpret",
            cg_variant="standard",
            preconditioner="jacobi",
            edge_reorder=False,
        ),
    )
    res = plan.solve(dict(inputs), nIterations=2, lIterations=10)
    assert np.isfinite(res.final_cost)
    assert plan.cg_path == "xla"
    assert plan.cg_path_reason == "graph couplings", plan.cg_path_reason


def test_sharded_fused_cg_radius2_stencil():
    """Halo width 2: a second-neighbor stencil must exchange two rows/cols
    per side through the sharded loop's halo (only radius-1 paths were
    covered)."""

    def biharmonic_ish(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(0.3 * (X(0, 0) - A(0, 0)))
        for dx, dy in ot.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
            S.Energy(
                ot.Select(
                    ot.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0
                )
            )

    n = 32
    rng = np.random.RandomState(5)
    inputs = {
        "X": rng.rand(n, n).astype(np.float32),
        "A": rng.rand(n, n).astype(np.float32),
    }
    r1 = ot.Problem(biharmonic_ish).plan(
        dims={"W": n, "H": n}, init_params=pinned_ip()
    ).solve(dict(inputs), nIterations=2, lIterations=25)
    plan8 = ot.Problem(biharmonic_ish).plan(
        dims={"W": n, "H": n},
        mesh=make_mesh(),
        init_params=pinned_ip(use_pallas_cg="interpret"),
    )
    r8 = plan8.solve(dict(inputs), nIterations=2, lIterations=25)
    _assert_sharded_xla_loop(plan8)
    assert r1.num_linear_iterations == r8.num_linear_iterations
    assert np.allclose(r1.final_cost, r8.final_cost, rtol=1e-4)
    assert np.allclose(
        np.asarray(r1.unknowns["X"]), np.asarray(r8.unknowns["X"]), atol=1e-4
    )
