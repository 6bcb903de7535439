"""True multi-process (multi-host analogue) solve: two processes, each with
4 virtual CPU devices, form one 8-device global mesh via jax.distributed
(parallel/distributed.py) — the same code path a multi-host deployment
uses. Both processes must agree with each other and with the single-process
solve (SURVEY §2.4 / BASELINE north star: ≥2-host scaling path)."""

import os
import re
import subprocess
import sys
import socket

import numpy as np

import opt_tpu as ot
from opt_tpu.models.specs import poisson_image_editing

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import numpy as np
import opt_tpu as ot
import opt_tpu.parallel.distributed as dist
from opt_tpu.models.specs import poisson_image_editing
from opt_tpu.parallel.mesh import make_mesh

dist.initialize(
    coordinator_address="localhost:" + port, num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc
n = 48
rng = np.random.RandomState(0)
mask = np.ones((n, n), np.float32); mask[8:-8, 8:-8] = 0
inputs = {{"X": rng.rand(n, n, 4).astype(np.float32),
           "T": rng.rand(n, n, 4).astype(np.float32), "M": mask}}
mesh = make_mesh()
# pin the single-device-default variant config: this test isolates the
# two-process sharding math against the unsharded reference solve (the
# mesh auto policy would otherwise pick a different CG trajectory --
# tests/test_auto_policy.py covers that)
pinned = ot.InitializationParameters(
    cg_variant="standard", preconditioner="jacobi", edge_reorder=False)
plan = ot.Problem(poisson_image_editing).plan(
    dims={{"W": n, "H": n}}, mesh=mesh, init_params=pinned)
res = plan.solve(dict(inputs), nIterations=1, lIterations=50)
print("MHCOST", pid, repr(float(res.final_cost)), flush=True)

# graph domain with shuffled vertex ids: the CG loop's cross-endpoint read
# takes the owner-block halo exchange (all_to_all over the 2-process global
# mesh -- the multi-host path for graph problems)
from opt_tpu.models.specs import arap_mesh_deformation
ga = __import__("importlib").import_module("_arap_shared")
N, ginputs = ga.shuffled_arap_inputs()
gplan = ot.Problem(arap_mesh_deformation).plan(
    dims={{"N": N}}, mesh=mesh, init_params=pinned)
u, c, g, p = gplan._normalize_and_place(dict(ginputs))
assert any(k.startswith("__halo") for k in g["G"]), "halo tables missing"
gres = gplan.solve(dict(ginputs), nIterations=3, lIterations=20)
print("MHGRAPH", pid, repr(float(gres.final_cost)), flush=True)
"""

_ARAP_SHARED = r"""
import numpy as np

def shuffled_arap_inputs(n_side=16, seed=5):
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(np.float32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -1e6 * np.ones((N, 3), np.float32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array([2.0, 0, 1.0], np.float32)
    inputs = {
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
    rng = np.random.RandomState(seed)
    perm = rng.permutation(N).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    sh = dict(inputs)
    for k in ("Offset", "Angle", "UrShape", "Constraints"):
        sh[k] = np.asarray(inputs[k])[inv]
    sh["G"] = {
        "v0": perm[inputs["G"]["v0"]],
        "v1": perm[inputs["G"]["v1"]],
    }
    return N, sh
"""


def test_two_process_solve_matches_single_process(tmp_path):
    n = 48
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), np.float32)
    mask[8:-8, 8:-8] = 0
    inputs = {
        "X": rng.rand(n, n, 4).astype(np.float32),
        "T": rng.rand(n, n, 4).astype(np.float32),
        "M": mask,
    }
    ref = ot.Problem(poisson_image_editing).plan(dims={"W": n, "H": n}).solve(
        dict(inputs), nIterations=1, lIterations=50
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    (tmp_path / "_arap_shared.py").write_text(_ARAP_SHARED)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", port],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    costs = []
    for out in outs:
        m = re.search(r"MHCOST \d+ (\S+)", out)
        assert m, out
        costs.append(float(m.group(1)))
    assert np.isclose(costs[0], costs[1], rtol=0), costs
    assert np.isclose(costs[0], ref.final_cost, rtol=1e-4), (
        costs,
        ref.final_cost,
    )

    # graph halo-exchange path over the 2-process mesh
    ns: dict = {}
    exec(_ARAP_SHARED, ns)
    N, ginputs = ns["shuffled_arap_inputs"]()
    from opt_tpu.models.specs import arap_mesh_deformation

    gref = ot.Problem(arap_mesh_deformation).plan(dims={"N": N}).solve(
        dict(ginputs), nIterations=3, lIterations=20
    )
    gcosts = []
    for out in outs:
        m = re.search(r"MHGRAPH \d+ (\S+)", out)
        assert m, out
        gcosts.append(float(m.group(1)))
    assert np.isclose(gcosts[0], gcosts[1], rtol=0), gcosts
    assert np.isclose(gcosts[0], gref.final_cost, rtol=1e-4), (
        gcosts,
        gref.final_cost,
    )
