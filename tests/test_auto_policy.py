"""Auto-selection of solver variants per execution regime.

The reference ships one hardcoded kernel configuration
(solverGPUGaussNewton.t:19-39); here the communication-relevant switches
default to "auto" and resolve from device count + domain kind
(solver/params.resolve_auto_policy). These tests pin the chosen config per
regime and audit the resulting compiled HLO collective counts.
"""

import numpy as np
import pytest
import jax

import opt_tpu as ot
from opt_tpu.parallel.mesh import make_mesh
from opt_tpu.models.specs import (
    poisson_image_editing,
    arap_mesh_deformation,
)


def _arap_inputs(n_side):
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(
        np.float32
    )
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    v0b = np.concatenate([v0, v1]).astype(np.int32)
    v1b = np.concatenate([v1, v0]).astype(np.int32)
    con = -np.ones((N, 3), np.float32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array(
        [1.0, 0, 0.5], np.float32
    )
    return N, {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "UrShape": pos,
        "Constraints": con,
        "G": {"v0": v0b, "v1": v1b},
        "w_fitSqrt": np.sqrt(1.0).astype(np.float32),
        "w_regSqrt": np.sqrt(0.5).astype(np.float32),
    }


def test_single_device_resolution():
    """No mesh: the reference-trajectory config — standard CG, scalar
    Jacobi, no edge reorder (a fused CG iteration is ~5 µs; nothing to
    trade iterations against)."""
    plan = ot.Problem(poisson_image_editing).plan({"W": 16, "H": 16})
    ip = plan.solver.ip
    assert ip.cg_variant == "standard"
    assert ip.preconditioner == "jacobi"
    assert ip.edge_reorder is False


def test_mesh_resolution_grid():
    """Mesh with >1 device, grid domain: one-all-reduce CG + block-Jacobi;
    edge_reorder stays off (no graphs to renumber)."""
    plan = ot.Problem(poisson_image_editing).plan(
        {"W": 16, "H": 16}, mesh=make_mesh()
    )
    ip = plan.solver.ip
    assert ip.cg_variant == "chronopoulos_gear"
    assert ip.preconditioner == "block_jacobi"
    assert ip.edge_reorder is False


def test_mesh_resolution_graph():
    """Mesh with >1 device, graph domain: additionally owner edge reorder
    (collapses the per-step edge-row exchange toward the boundary)."""
    N, _ = _arap_inputs(8)
    plan = ot.Problem(arap_mesh_deformation).plan(
        {"N": N}, mesh=make_mesh()
    )
    ip = plan.solver.ip
    assert ip.cg_variant == "chronopoulos_gear"
    assert ip.preconditioner == "block_jacobi"
    assert ip.edge_reorder == "owner"


def test_manual_overrides_pass_through():
    """Explicit values are never touched by the policy."""
    plan = ot.Problem(arap_mesh_deformation).plan(
        {"N": 64},
        mesh=make_mesh(),
        init_params=ot.InitializationParameters(
            cg_variant="standard",
            preconditioner="jacobi",
            edge_reorder=False,
        ),
    )
    ip = plan.solver.ip
    assert ip.cg_variant == "standard"
    assert ip.preconditioner == "jacobi"
    assert ip.edge_reorder is False


def test_auto_config_matches_pinned_equivalent_on_mesh():
    """The auto-selected mesh config solves to the same costs as the SAME
    explicit config on a single device — the policy changes trajectory
    only via the documented variant switches, not via sharding."""
    N, inputs = _arap_inputs(16)
    sp = dict(nIterations=3, lIterations=20)
    res1 = ot.Problem(arap_mesh_deformation).plan(
        {"N": N},
        init_params=ot.InitializationParameters(
            cg_variant="chronopoulos_gear", preconditioner="block_jacobi"
        ),
    ).solve(dict(inputs), **sp)
    res8 = ot.Problem(arap_mesh_deformation).plan(
        {"N": N}, mesh=make_mesh()
    ).solve(dict(inputs), **sp)
    # owner reorder perturbs the per-edge reduction order -> small drift
    assert np.allclose(res1.final_cost, res8.final_cost, rtol=2e-3), (
        res1.final_cost,
        res8.final_cost,
    )


def _solve_hlo(plan, inputs, n_outer, n_inner):
    u, c, g, p = plan._normalize_and_place(dict(inputs))
    sp = plan.solver._traced_sp(
        ot.SOLVER_PARAMETER_DEFAULTS
        | {"nIterations": n_outer, "lIterations": n_inner}
    )
    return (
        jax.jit(
            lambda X, cs, gs, ps: plan.solver._solve_core(
                X, cs, gs, ps, sp, n_outer
            )
        )
        .lower(u, c, g, p)
        .compile()
        .as_text()
    )


def test_hlo_audit_cs_halves_cg_loop_all_reduces():
    """Static HLO pin for the policy's reason-to-exist: on the sharded
    grid solve, the auto (chronopoulos_gear) program carries FEWER
    all-reduce ops than the standard-CG program — XLA's collective
    combiner merges the CS variant's independent reductions (γ, δ and the
    LM Q-dot ride one all-reduce; standard CG needs two dependent ones per
    iteration)."""
    n = 32
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), np.float32)
    mask[8:-8, 8:-8] = 0
    inputs = {
        "X": rng.rand(n, n, 4).astype(np.float32),
        "T": rng.rand(n, n, 4).astype(np.float32),
        "M": mask,
    }
    mesh = make_mesh()
    counts = {}
    for tag, ip in [
        ("auto", None),
        (
            "standard",
            ot.InitializationParameters(
                cg_variant="standard", preconditioner="jacobi"
            ),
        ),
    ]:
        plan = ot.Problem(poisson_image_editing).plan(
            {"W": n, "H": n}, mesh=mesh, init_params=ip
        )
        hlo = _solve_hlo(plan, inputs, 1, 10)
        # count distinct all-reduce ops in the program text (a while-body
        # op is counted once, executed per iteration)
        counts[tag] = hlo.count(" all-reduce(") + hlo.count(
            " all-reduce-start("
        )
    assert counts["auto"] < counts["standard"], counts
