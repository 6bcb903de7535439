"""Medium-size golden final-cost pins for every bundled energy.

The toy-size operator-parity tests (test_specs.py, test_operator_parity.py)
prove the operators; these pin END-TO-END final costs at medium sizes so a
solver/numerics regression of the round-1 kind (e.g. a schedule or masking
change shifting final energies) fails CI instead of surfacing in a
regression log. Golden values were recorded on CPU with the oracle-validated
build (regression_logs_oracle/, docs/REGRESSION.md); tolerances absorb
XLA-version float drift, not algorithm changes.
"""

import numpy as np
import pytest

import opt_tpu as ot
from opt_tpu.models.specs import ALL_SPECS

import tests.test_specs as ts

# (kind, nIterations, lIterations, golden final cost)
GOLDEN = {
    "laplacian": ("gaussNewtonGPU", 6, 40, 1.6753909587860107),
    "curve_fitting": ("LMGPU", 12, 60, 14.498645782470703),
    "poisson_image_editing": ("gaussNewtonGPU", 2, 120, 258.89776611328125),
    "image_warping": ("LMGPU", 10, 60, 3.3203492039168836e-12),
    "optical_flow": ("gaussNewtonGPU", 4, 40, 7330.97265625),
    "intrinsic_image_decomposition": ("gaussNewtonGPU", 6, 30, 845.5782470703125),
    "volumetric_mesh_deformation": ("gaussNewtonGPU", 8, 40, 108.64008331298828),
    "arap_mesh_deformation": ("gaussNewtonGPU", 10, 60, 43.62834167480469),
    "cotangent_mesh_smoothing": ("LMGPU", 8, 40, 3.7031397819519043),
    "embedded_mesh_deformation": ("LMGPU", 10, 40, 47.63282775878906),
    "robust_nonrigid_alignment": ("LMGPU", 8, 40, 33.04822540283203),
    # re-recorded r4: the computed-gate taint fix restored the E_s
    # couplings to the assembled operator and Jacobi diagonal (they were
    # probe-pruned; the solve ran the composed fallback) — the corrected
    # preconditioner converges to a LOWER final cost (was 50.383064)
    "shape_from_shading": ("LMGPU", 8, 30, 47.196999),
}


def _medium_cases(monkeypatch=None):
    """test_specs._cases scaled up: 32-square grids, 10^3 volume, 200-vertex
    graphs — big enough that stencil interiors, DIA splits and graph tables
    all take their real code paths, small enough for CPU CI."""
    saved = (ts.N_GRID, ts.N_VERT)
    ts.N_GRID, ts.N_VERT = 32, 200
    try:
        return ts._cases()
    finally:
        ts.N_GRID, ts.N_VERT = saved


CASES = None


def _get_case(name):
    global CASES
    if CASES is None:
        CASES = _medium_cases()
    return CASES[name]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_final_cost(name):
    kind, nl, lin, golden = GOLDEN[name]
    dims, inputs = _get_case(name)
    plan = ot.Problem(ALL_SPECS[name]).plan(dims=dims, kind=kind)
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=lin)
    assert np.isfinite(res.final_cost), (name, res.costs)
    if golden is None:
        pytest.fail(
            f"golden for {name}: {res.final_cost!r}  (record it in GOLDEN)"
        )
    np.testing.assert_allclose(
        res.final_cost,
        golden,
        rtol=5e-3,
        atol=1e-8,  # near-zero goldens (unconstrained warps collapse to ~0)
        err_msg=f"{name} drifted from its golden final cost "
        f"(docs/REGRESSION.md methodology)",
    )
