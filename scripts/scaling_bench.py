"""Multi-chip scaling benchmark (BASELINE.json north_star harness).

Measures GN iterations/s and PCG iterations/s for the flagship problems on a
device mesh of each size 1..N and reports strong-scaling efficiency. On a
multi-GPU host run it as-is; without one, validate the sharded program
end-to-end on virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/scaling_bench.py --sizes 1,2,4,8 --n 256

(CPU timings say nothing about the interconnect; the point of the CPU run
is that the sharded solve compiles, executes, and matches the
single-device cost. The same script on several GPUs produces the real
scaling table.)
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def bench_poisson(mesh, n, n_inner, repeats=3):
    import jax
    import opt_tpu as ot
    from opt_tpu.models.specs import poisson_image_editing

    rng = np.random.RandomState(0)
    f32 = np.float32
    mask = np.ones((n, n), f32)
    mask[n // 8 : -n // 8, n // 8 : -n // 8] = 0.0
    inputs = {
        "X": rng.rand(n, n, 4).astype(f32),
        "T": rng.rand(n, n, 4).astype(f32),
        "M": mask,
    }
    plan = ot.Problem(poisson_image_editing).plan(dims={"W": n, "H": n}, mesh=mesh)
    res = plan.solve(dict(inputs), nIterations=1, lIterations=n_inner)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = plan.solve(dict(inputs), nIterations=1, lIterations=n_inner)
        best = min(best, time.perf_counter() - t0)
    return max(1, res.num_linear_iterations) / best, float(res.final_cost)


def bench_arap(mesh, n_side, n_inner, repeats=3):
    """Graph-domain scaling: owner-block vertex sharding + edge sharding
    (vertex arrays and ELL accumulation tables shard by contiguous blocks
    over the flattened mesh; see opt_tpu/parallel/mesh.py)."""
    import opt_tpu as ot
    from opt_tpu.models.specs import arap_mesh_deformation

    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(np.float32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -1e6 * np.ones((N, 3), np.float32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array([5.0, 0, 2.0], np.float32)
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
    plan = ot.Problem(arap_mesh_deformation).plan(dims={"N": N}, mesh=mesh)
    res = plan.solve(dict(inputs), nIterations=4, lIterations=n_inner)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = plan.solve(dict(inputs), nIterations=4, lIterations=n_inner)
        best = min(best, time.perf_counter() - t0)
    return max(1, res.num_linear_iterations) / best, float(res.final_cost)


def main():
    import jax
    from opt_tpu.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--graph-side", type=int, default=128)
    ap.add_argument("--inner", type=int, default=500)
    args = ap.parse_args()

    sizes = [int(s) for s in args.sizes.split(",")]
    devices = jax.devices()
    rows = []
    base = {}
    for s in sizes:
        if s > len(devices):
            print(f"skip mesh size {s}: only {len(devices)} devices")
            continue
        mesh = make_mesh(devices[:s]) if s > 1 else None
        row = {"devices": s}
        for name, fn in (
            ("poisson", lambda m: bench_poisson(m, args.n, args.inner)),
            ("arap", lambda m: bench_arap(m, args.graph_side, min(args.inner, 100))),
        ):
            rate, cost = fn(mesh)
            if name not in base:
                base[name] = (rate, cost)
            brate, bcost = base[name]
            row[f"{name}_pcg_iters_per_sec"] = round(rate, 1)
            row[f"{name}_scaling_efficiency"] = round(rate / (brate * s), 3)
            row[f"{name}_final_cost"] = cost
            assert abs(cost - bcost) / max(abs(bcost), 1e-9) < 1e-3, (
                f"{name}: sharded solve diverged from single-device cost: "
                f"{cost} vs {bcost}"
            )
        rows.append(row)
        print(json.dumps(row))
    print(json.dumps({"scaling": rows}))


if __name__ == "__main__":
    main()
