"""bfloat16 coefficient storage (InitializationParameters.coefficient_dtype).

The CG hot loop reads the assembled coefficients every iteration; storing
them in bf16 halves that traffic (no reference counterpart). Numerically the inner CG then solves a ~3-decimal-digit
perturbation of JᵀJ while JᵀF stays exact per outer iteration, so the
outer GN/LM loop acts as iterative refinement — final costs must land on
the f32 results on these well-conditioned problems.
"""

import numpy as np
import pytest

import opt_tpu as ot
from opt_tpu.models.specs import (
    arap_mesh_deformation,
    image_warping,
    poisson_image_editing,
)


def _poisson_inputs(n):
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), np.float32)
    mask[n // 4 : -n // 4, n // 4 : -n // 4] = 0.0
    return {
        "X": rng.rand(n, n, 4).astype(np.float32),
        "T": rng.rand(n, n, 4).astype(np.float32),
        "M": mask,
    }


def _warp_inputs(n):
    rng = np.random.RandomState(0)
    ur = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1
    ).astype(np.float32)
    con = -np.ones((n, n, 2), np.float32)
    con[1, 1] = [2.0, 2.0]
    con[n - 2, n - 2] = [n - 3.0, n - 1.0]
    return {
        "Offset": ur + 0.05 * rng.randn(n, n, 2).astype(np.float32),
        "Angle": np.zeros((n, n), np.float32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": np.zeros((n, n), np.float32),
        "w_fitSqrt": np.float32(3.0),
        "w_regSqrt": np.float32(1.0),
    }


def _arap_inputs(n_side):
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(
        np.float32
    )
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -np.ones((N, 3), np.float32)
    con[0] = pos[0]
    con[-1] = pos[-1] + [2, 0, 1]
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
        "w_regSqrt": np.float32(np.sqrt(0.5)),
    }


CASES = {
    "poisson": (poisson_image_editing, {"W": 24, "H": 24},
                lambda: _poisson_inputs(24), dict(nIterations=4, lIterations=60)),
    "image_warping": (image_warping, {"W": 16, "H": 16},
                      lambda: _warp_inputs(16), dict(nIterations=6, lIterations=40)),
    "arap": (arap_mesh_deformation, {"N": 64},
             lambda: _arap_inputs(8)[1], dict(nIterations=6, lIterations=40)),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_bf16_coefficients_match_f32_final_cost(name, kind):
    if name == "arap" and kind == "gaussNewtonGPU":
        # Known limitation, documented on coefficient_dtype: plain GN
        # accepts every step, and on stiff graph energies (ARAP's
        # near-singular rotation directions) the bf16 operator
        # perturbation can produce non-descent steps — cost rises. LM's
        # trust region rejects those steps and converges (case below);
        # use LM with bf16 coefficients on graph energies.
        pytest.skip("bf16+plain-GN on stiff graph energies: use LM")
    spec, dims, make, sp = CASES[name]
    res_f32 = ot.Problem(spec, kind=kind).plan(dims=dims).solve(
        make(), **sp
    )
    plan16 = ot.Problem(spec, kind=kind).plan(
        dims=dims,
        init_params=ot.InitializationParameters(
            coefficient_dtype="bfloat16"
        ),
    )
    assert plan16.solver._stencil_plan is not None, "needs the assembled path"
    res_16 = plan16.solve(make(), **sp)
    assert np.isfinite(res_16.final_cost)
    assert res_16.final_cost <= res_16.costs[0] + 1e-6
    # outer refinement absorbs the bf16 operator perturbation
    np.testing.assert_allclose(
        res_16.final_cost, res_f32.final_cost, rtol=5e-3, atol=1e-6
    )
