"""x64 golden sweep: grid LM, graph GN, the assembled
operator and the Pallas-kernel fallback all run under double precision.

The reference converts any example to double per-solve
(examples/shared/OptSolver.h:17-36) and ships tests/minimal_graph_only in
double. Here: image_warping (grid, LM, assembled operator) and
arap_mesh_deformation (graph, GN) solve at the golden-cost medium sizes in
x64 and land within float-drift tolerance of the recorded f32 goldens; the
fused Pallas CG planners require float32 by design, so under x64 the plan
must carry NO fused-CG descriptor and fall back to the XLA loop (the
documented f64 fallback).

Subprocess because jax x64 is process-global.
"""

import os
import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import opt_tpu as ot
from opt_tpu.models.specs import ALL_SPECS
from opt_tpu.solver.params import InitializationParameters

ot.enable_double_precision()

import test_specs as ts
ts.N_GRID, ts.N_VERT = 32, 200
CASES = ts._cases()

# (name, kind, nIterations, lIterations, f32 golden final cost) — goldens
# from tests/test_golden_costs.py GOLDEN
RUNS = [
    ("image_warping", "LMGPU", 10, 60, 3.3203492039168836e-12),
    ("arap_mesh_deformation", "gaussNewtonGPU", 10, 60, 43.62834167480469),
]
for name, kind, n_it, l_it, golden in RUNS:
    dims, inputs = CASES[name]
    inputs = {{
        k: v
        if isinstance(v, dict) or not np.issubdtype(
            np.asarray(v).dtype, np.floating
        )
        else np.asarray(v, np.float64)
        for k, v in inputs.items()
    }}
    plan = ot.Problem(ALL_SPECS[name], kind=kind).plan(
        dims=dims,
        double_precision=True,
        init_params=InitializationParameters(use_pallas_cg="interpret"),
    )
    # the fused Pallas planners are float32-only by design: under x64 the
    # assembled plan must carry no fused-CG descriptor (XLA-loop fallback)
    from opt_tpu.functions import FunctionSet

    u, c, g, p = plan._normalize_and_place(dict(inputs))
    fs = FunctionSet(plan.compiled, c, g, p)
    assert plan.solver._stencil_plan is not None  # assembled operator ON
    _A, _d, _j, meta = fs.assemble_stencil(u, plan.solver._stencil_plan)
    assert meta is None, (name, "expected f64 Pallas fallback")

    res = plan.solve(dict(inputs), nIterations=n_it, lIterations=l_it)
    for k, v in res.unknowns.items():
        assert np.asarray(v).dtype == np.float64, (name, k, v.dtype)
    assert np.isfinite(res.final_cost)
    if golden > 1e-9:
        rel = abs(res.final_cost - golden) / golden
        assert rel < 0.05, (name, res.final_cost, golden, rel)
    else:
        # converged-to-zero golden: x64 should be at least as deep
        assert res.final_cost < 1e-10, (name, res.final_cost)
    print("X64 OK", name, res.final_cost)
print("SWEEP DONE")
"""


def test_double_precision_golden_sweep(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tests = os.path.join(repo, "tests")
    script = tmp_path / "x64sweep.py"
    script.write_text(_SCRIPT.format(repo=repo, tests=tests))
    out = subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SWEEP DONE" in out.stdout
    assert out.stdout.count("X64 OK") == 2
