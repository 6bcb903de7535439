"""Native layer tests: the C API (embedded CPython) and the fastgraph
extension (reference parity: API/src/createwrapper.t and
examples/shared/OptGraph.h)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


def _build():
    r = subprocess.run(
        ["make", "-C", NATIVE], capture_output=True, text=True
    )
    if r.returncode != 0:
        pytest.skip(f"native build unavailable: {r.stderr[-300:]}")


def test_c_api_client():
    _build()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [os.path.join(NATIVE, "build", "test_client")],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout


def test_fastgraph_matches_numpy_fallback():
    import opt_tpu.utils.io as io

    if io._FASTGRAPH is None:
        _build()
        io._FASTGRAPH = io._load_fastgraph()
    if io._FASTGRAPH is None:
        pytest.skip("fastgraph not built")
    rng = np.random.RandomState(0)
    faces = rng.randint(0, 200, size=(500, 3)).astype(np.int32)
    v0, v1 = io.mesh_edges(faces)
    saved = io._FASTGRAPH
    try:
        io._FASTGRAPH = None
        v0b, v1b = io.mesh_edges(faces)
    finally:
        io._FASTGRAPH = saved
    assert np.array_equal(v0, v0b) and np.array_equal(v1, v1b)
    rp, ci = io.csr_from_edges(v0, v1, 200)
    assert rp[-1] == len(v0)
    assert np.all(np.diff(rp) >= 0)
