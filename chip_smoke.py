#!/usr/bin/env python3
"""Run the solver's main path on a CUDA GPU once, and check every phase.

    python chip_smoke.py            # one card: every single-card phase
    python chip_smoke.py --four     # four cards: the sharded phase only

Every phase solves through the public entry points (``ot.Problem(spec)
.plan(dims=...).solve(...)``, ``solve_batched``) at the sizes the benchmark
uses, with inputs made from ``--seed``, and compares the result with a
plain reference:

  poisson         poisson_image_editing 512² float4, GN, 1 x <=2000 CG,
                  Exclude mask; the composed Jᵀ(J·p) plan at "highest"
                  precision; the frozen region must come back bit-identical
  image_warping   mixed float2+float unknowns 512², GN and LM, 8 x 400 CG;
                  the composed plan at "highest" precision
  arap_irregular  ARAP on the armadillo mesh (31k vertices), LM, graph path;
                  the composed plan at "highest" precision
  batched         512 curve fits (N=256) in one solve_batched LM program;
                  scipy's TRF (opt_tpu.reference_solver) on 8 of them
  kernel          the compiled Triton stencil kernel on the poisson and
                  image_warping fields at 512² and 1024²; the jnp apply of
                  the same triples
  sharded         (--four only) image_warping 1024² on a 2x2 mesh and the
                  armadillo ARAP on 4 devices; the same solves on one card

Each phase asserts that the assembled operator stayed in use
(``plan.fused_fallback is None``), which CG path ran (``plan.cg_path``),
and a finite final cost within its tolerance of the reference.

Tolerances, and why:
  FINAL_COST_RTOL   1e-3  the assembled and the composed operator sum the
                          same f32 products in another order, and the
                          difference compounds over up to 2000 CG steps
  KERNEL_APPLY_RTOL 1e-5  per element the kernel and the jnp apply add the
                          same ~20 f32 products in another order (relative
                          to max |Ap|)
  KERNEL_DOT_RTOL   1e-4  pᵀAp: per-tile partials summed by XLA against
                          one jnp.vdot over ~10⁶ terms
  FIT_PARAM_RTOL    1e-4  curve parameters: f32 LM against scipy's float64
                          TRF on noise-free data (both reach the truth)
  FIT_COST_ATOL     1e-3  the same fits' final costs are ~0; this is the f32
                          residual floor of 256 samples of magnitude ~100
  ARAP_LONG_RTOL    2e-2  the armadillo ARAP after 8 LM steps of <=100 CG:
                          the truncated CG on this ill-conditioned,
                          nonconvex problem amplifies the operators' f32
                          rounding differences step by step (on the CPU the
                          two solves end 0.3% apart after 8 LM steps, 1.2%
                          after 30, while after 2 steps they agree to 3e-5),
                          so the 2-step solve is held to FINAL_COST_RTOL and
                          the 8-step one only to this bound

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the script exits non-zero and prints no such line.
Without a GPU it exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FINAL_COST_RTOL = 1e-3
KERNEL_APPLY_RTOL = 1e-5
KERNEL_DOT_RTOL = 1e-4
FIT_PARAM_RTOL = 1e-4
FIT_COST_ATOL = 1e-3
ARAP_LONG_RTOL = 2e-2

# the CG apply "auto" picks on a CUDA device for a 2-D grid stencil
GRID_CG_PATH = "triton"

ROOT = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# inputs (the benchmark's cases, made from a seed)
# ---------------------------------------------------------------------------


def poisson_inputs(n, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, n), np.float32)
    mask[n // 8 : -n // 8, n // 8 : -n // 8] = 0.0
    return {
        "X": rng.rand(n, n, 4).astype(np.float32),
        "T": rng.rand(n, n, 4).astype(np.float32),
        "M": mask,
    }


def warping_inputs(n, seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    ur = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1
    ).astype(f32)
    con = -np.ones((n, n, 2), f32)
    for _ in range(16):
        i, j = rng.randint(0, n, 2)
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    return {
        "Offset": ur.copy(),
        "Angle": np.zeros((n, n), f32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": np.sqrt(100.0).astype(f32),
        "w_regSqrt": np.sqrt(0.01).astype(f32),
    }


def armadillo_inputs(seed, multiple=1):
    """ARAP on benchdata/armadillo31k.npz, vertices in grid-embedding order:
    the lowest 1% pinned, the highest 1% pulled up by a fifth of the
    height (jittered by the seed). ``multiple`` pads the vertex count with
    isolated, unconstrained vertices (no edges, so no residuals) to a
    multiple of the device count, which vertex sharding needs."""
    from opt_tpu.utils.reorder import (
        grid_embed_order,
        permute_vertices,
        remap_edges,
    )

    d = np.load(os.path.join(ROOT, "benchdata", "armadillo31k.npz"))
    verts = d["verts"].astype(np.float32)
    v0, v1 = d["v0"].astype(np.int32), d["v1"].astype(np.int32)
    N = verts.shape[0]
    perm = grid_embed_order(v0, v1, N)
    pos = permute_vertices(perm, verts)
    v0r, v1r = remap_edges(perm, v0, v1)
    extra = -N % multiple
    if extra:
        pos = np.concatenate([pos, np.repeat(pos.mean(0, keepdims=True), extra, 0)])
        N += extra
    rng = np.random.RandomState(seed)
    z = pos[:, 2]
    lo = z <= np.quantile(z, 0.01)
    hi = z >= np.quantile(z, 0.99)
    lift = 0.2 * (z.max() - z.min()) * (1.0 + 0.05 * rng.randn())
    con = -np.ones((N, 3), np.float32)
    con[lo] = pos[lo]
    con[hi] = pos[hi] + np.array([0.0, 0.0, lift], np.float32)
    con[N - extra:] = -1.0
    return N, {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "UrShape": pos,
        "Constraints": con,
        "G": {"v0": v0r, "v1": v1r},
        "w_fitSqrt": np.float32(1.0),
        "w_regSqrt": np.float32(np.sqrt(0.5)),
    }


def curve_inputs(B, N, seed):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, N)
    truths = rng.uniform(80, 120, (B, 2))
    data = np.stack(
        [np.stack([x, a * np.cos(b * x) + b * np.sin(a * x)], -1)
         for a, b in truths]
    ).astype(np.float32)
    init = (truths + rng.randn(B, 2) * 0.05).astype(np.float32)
    return truths, {
        "funcParams": init[:, None, :],
        "data": data,
        "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)},
    }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def timed_solve(plan, inputs, **sp):
    """(result, first-call seconds, steady solve seconds). The first call
    traces and compiles; the second runs the compiled program."""
    import jax

    inputs = {
        k: (jax.device_put(v) if not isinstance(v, dict) else v)
        for k, v in inputs.items()
    }
    t0 = time.perf_counter()
    res = plan.solve(dict(inputs), **sp)
    jax.block_until_ready(res.unknowns)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = plan.solve(dict(inputs), **sp)
    jax.block_until_ready(res.unknowns)
    return res, first, time.perf_counter() - t0


def reference_solve(spec, dims, inputs, kind, mesh=None, **sp):
    """The same solve with the composed Jᵀ(J·p) operator, every matmul at
    "highest" precision."""
    import jax
    import opt_tpu as ot

    with jax.default_matmul_precision("highest"):
        plan = ot.Problem(spec, kind=kind).plan(
            dims=dims,
            mesh=mesh,
            init_params=ot.InitializationParameters(use_fused_jtj=False),
        )
        return plan.solve(dict(inputs), **sp)


def check_cost(name, got, ref, rtol=FINAL_COST_RTOL):
    assert np.isfinite(got), f"{name}: final cost {got} is not finite"
    rel = abs(got - ref) / max(abs(ref), 1e-30)
    assert rel <= rtol, f"{name}: final cost {got} vs reference {ref} (rel {rel:.3g} > {rtol})"
    return rel


def report(phase, res, first, solve, ref_cost, rel, plan):
    from opt_tpu.utils.memory import report as mem_report

    print(
        f"[{phase}] compile_s={first - solve:.3f} solve_s={solve:.4f} "
        f"cg_iters={res.num_linear_iterations} gn_iters={res.num_iterations} "
        f"final_cost={res.final_cost:.9g} reference={ref_cost:.9g} "
        f"rel_diff={rel:.3g} cg_path={plan.cg_path}"
        + (f" ({plan.cg_path_reason})" if plan.cg_path_reason else "")
    )
    mem_report(print_fn=lambda s: print(f"[{phase}] {s}"))
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_poisson(seed):
    import opt_tpu as ot
    from opt_tpu.models.specs import poisson_image_editing

    n = 512
    inputs = poisson_inputs(n, seed)
    dims = {"W": n, "H": n}
    sp = dict(nIterations=1, lIterations=2000)
    plan = ot.Problem(poisson_image_editing).plan(dims=dims)
    res, first, solve = timed_solve(plan, inputs, **sp)
    assert plan.fused_fallback is None, plan.fused_fallback
    assert plan.cg_path == GRID_CG_PATH, (plan.cg_path, plan.cg_path_reason)
    ref = reference_solve(poisson_image_editing, dims, inputs, "gaussNewtonGPU", **sp)
    rel = check_cost("poisson", res.final_cost, ref.final_cost)
    frozen = inputs["M"] != 0
    out = np.asarray(res.unknowns["X"])
    assert np.array_equal(out[frozen], inputs["X"][frozen]), (
        "poisson: the Exclude-frozen region changed"
    )
    report("poisson", res, first, solve, ref.final_cost, rel, plan)


def phase_image_warping(seed):
    import opt_tpu as ot
    from opt_tpu.models.specs import image_warping

    n = 512
    inputs = warping_inputs(n, seed)
    dims = {"W": n, "H": n}
    sp = dict(nIterations=8, lIterations=400)
    for kind in ("gaussNewtonGPU", "LMGPU"):
        plan = ot.Problem(image_warping, kind=kind).plan(dims=dims)
        res, first, solve = timed_solve(plan, inputs, **sp)
        assert plan.fused_fallback is None, plan.fused_fallback
        assert plan.cg_path == GRID_CG_PATH, (plan.cg_path, plan.cg_path_reason)
        ref = reference_solve(image_warping, dims, inputs, kind, **sp)
        rel = check_cost(f"image_warping {kind}", res.final_cost, ref.final_cost)
        report(f"image_warping {kind}", res, first, solve, ref.final_cost, rel, plan)


def phase_arap_irregular(seed):
    import opt_tpu as ot
    from opt_tpu.models.specs import arap_mesh_deformation

    N, inputs = armadillo_inputs(seed)
    dims = {"N": N}
    plan = ot.Problem(arap_mesh_deformation, kind="LMGPU").plan(dims=dims)
    for sp, rtol in (
        (dict(nIterations=2, lIterations=100), FINAL_COST_RTOL),
        (dict(nIterations=8, lIterations=100), ARAP_LONG_RTOL),
    ):
        res, first, solve = timed_solve(plan, inputs, **sp)
        assert plan.fused_fallback is None, plan.fused_fallback
        assert plan.cg_path == "xla", (plan.cg_path, plan.cg_path_reason)
        ref = reference_solve(arap_mesh_deformation, dims, inputs, "LMGPU", **sp)
        rel = check_cost("arap_irregular", res.final_cost, ref.final_cost, rtol)
        report(f"arap_irregular {sp['nIterations']} LM steps", res, first,
               solve, ref.final_cost, rel, plan)


def phase_batched(seed):
    import jax
    import opt_tpu as ot
    from opt_tpu.models.specs import curve_fitting
    from opt_tpu.reference_solver import solve_scipy

    B, N = 512, 256
    truths, inputs = curve_inputs(B, N, seed)
    dims = {"N": N, "U": 1}
    sp = dict(nIterations=10, lIterations=20)
    plan = ot.Problem(curve_fitting, kind="LMGPU").plan(dims=dims)
    t0 = time.perf_counter()
    res = plan.solve_batched(dict(inputs), **sp)
    jax.block_until_ready(res.unknowns)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = plan.solve_batched(dict(inputs), **sp)
    jax.block_until_ready(res.unknowns)
    solve = time.perf_counter() - t0
    assert plan.fused_fallback is None, plan.fused_fallback
    assert plan.cg_path == "xla", (plan.cg_path, plan.cg_path_reason)
    costs = np.asarray(res.final_costs)
    params = np.asarray(res.unknowns["funcParams"])[:, 0, :]
    assert np.all(np.isfinite(costs)), "batched: non-finite final costs"
    worst_p = worst_c = 0.0
    for b in np.linspace(0, B - 1, 8).astype(int):
        one = {
            "funcParams": inputs["funcParams"][b],
            "data": inputs["data"][b],
            "G": inputs["G"],
        }
        ref_cost, ref_u = solve_scipy(curve_fitting, dims, one)
        ref_p = np.asarray(ref_u["funcParams"]).reshape(-1)
        dp = float(np.max(np.abs(params[b] - ref_p) / np.abs(ref_p)))
        dc = abs(float(costs[b]) - float(ref_cost))
        assert dp <= FIT_PARAM_RTOL, f"batched[{b}]: params {params[b]} vs scipy {ref_p}"
        assert dc <= FIT_COST_ATOL, f"batched[{b}]: cost {costs[b]} vs scipy {ref_cost}"
        worst_p, worst_c = max(worst_p, dp), max(worst_c, dc)
    print(
        f"[batched] compile_s={first - solve:.3f} solve_s={solve:.4f} "
        f"fits_per_s={B / solve:.1f} worst_param_rel={worst_p:.3g} "
        f"worst_cost_abs={worst_c:.3g} (8 instances vs scipy TRF) "
        f"cg_path={plan.cg_path} ({plan.cg_path_reason})"
    )
    from opt_tpu.utils.memory import report as mem_report

    mem_report(print_fn=lambda s: print(f"[batched] {s}"))


def grid_meta(spec, dims, inputs):
    """The stencil kernel's inputs (fields, triples) for a grid plan,
    assembled at the initial unknowns."""
    import opt_tpu as ot
    from opt_tpu.functions import FunctionSet

    plan = ot.Problem(spec).plan(dims=dims)
    u, c, g, pa = plan._normalize_and_place(dict(inputs))
    fs = FunctionSet(plan.compiled, c, g, pa)
    _A, _d, _j, meta = fs.assemble_stencil(u, plan.solver._stencil_plan)
    assert meta is not None, "grid plan declined the stencil kernel"
    return meta


def phase_kernel(seed):
    import jax
    import jax.numpy as jnp
    from opt_tpu.models.specs import image_warping, poisson_image_editing
    from opt_tpu.ops.stencil_kernel import (
        stencil_apply,
        stencil_apply_reference,
    )

    rng = np.random.RandomState(seed)
    for name, spec, make in (
        ("poisson", poisson_image_editing, poisson_inputs),
        ("image_warping", image_warping, warping_inputs),
    ):
        for n in (512, 1024):
            meta = grid_meta(spec, {"W": n, "H": n}, make(n, seed))
            C = meta["ctot"]
            hp, wp = meta["F"].shape[1:]
            p = np.zeros((C, hp, wp), np.float32)
            p[:, :n, :n] = rng.randn(C, n, n)
            p = jnp.asarray(p)
            static = {k: v for k, v in meta.items() if k != "F"}
            ap, den = jax.jit(
                lambda F, p: stencil_apply({**static, "F": F}, p)
            )(meta["F"], p)
            with jax.default_matmul_precision("highest"):
                ap_r, den_r = jax.jit(
                    lambda F, p: stencil_apply_reference({**static, "F": F}, p)
                )(meta["F"], p)
            scale = float(jnp.max(jnp.abs(ap_r)))
            err = float(jnp.max(jnp.abs(ap - ap_r)))
            drel = abs(float(den) - float(den_r)) / abs(float(den_r))
            assert err <= KERNEL_APPLY_RTOL * scale, (name, n, err, scale)
            assert drel <= KERNEL_DOT_RTOL, (name, n, float(den), float(den_r))
            print(
                f"[kernel] {name} {n}² C={C} triples={len(meta['triples'])} "
                f"max_abs_err={err:.3g} (scale {scale:.3g}) "
                f"pAp_rel_err={drel:.3g}"
            )


def same_algorithm(plan):
    """One-card parameters that run the algorithm a mesh plan resolved its
    "auto" variants to (a mesh picks the communication-reduced CG and the
    block preconditioner), so the comparison isolates the sharding."""
    import opt_tpu as ot

    ip = plan.solver.ip
    return ot.InitializationParameters(
        cg_variant=ip.cg_variant, preconditioner=ip.preconditioner
    )


def phase_sharded(seed):
    """image_warping 1024² on a 2x2 mesh and the armadillo ARAP on 4
    devices, each against the same solve on one card."""
    import jax
    import opt_tpu as ot
    from opt_tpu.models.specs import arap_mesh_deformation, image_warping
    from opt_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}"
    mesh = make_mesh(devs[:4], shape=(2, 2))

    def shard_report(name, arr):
        shards = [(s.device.id, tuple(s.data.shape)) for s in arr.addressable_shards]
        held = sorted({d for d, _ in shards})
        print(f"[sharded] {name} shards (device, shape): {shards}")
        per_dev = []
        for d in devs[:4]:
            st = d.memory_stats() or {}
            per_dev.append((d.id, st.get("bytes_in_use", 0)))
        print(f"[sharded] {name} bytes in use per device: {per_dev}")
        return held == [d.id for d in devs[:4]]

    n = 1024
    inputs = warping_inputs(n, seed)
    dims = {"W": n, "H": n}
    sp = dict(nIterations=8, lIterations=400)
    plan4 = ot.Problem(image_warping).plan(dims=dims, mesh=mesh)
    res4, first, solve = timed_solve(plan4, inputs, **sp)
    assert plan4.fused_fallback is None, plan4.fused_fallback
    plan1 = ot.Problem(image_warping).plan(dims=dims, init_params=same_algorithm(plan4))
    res1, first1, solve1 = timed_solve(plan1, inputs, **sp)
    rel = check_cost("sharded image_warping", res4.final_cost, res1.final_cost)
    spread = shard_report("image_warping Offset", res4.unknowns["Offset"])
    print(
        f"[sharded] image_warping 1024² 2x2 mesh: compile_s={first - solve:.3f} "
        f"solve_s={solve:.4f} one-card solve_s={solve1:.4f} "
        f"final_cost={res4.final_cost:.9g} one-card={res1.final_cost:.9g} "
        f"rel_diff={rel:.3g} cg_path={plan4.cg_path} ({plan4.cg_path_reason}) "
        f"every device held a shard: {spread}"
    )

    N, ginputs = armadillo_inputs(seed, multiple=4)
    gdims = {"N": N}
    gmesh = make_mesh(devs[:4])
    plan4 = ot.Problem(arap_mesh_deformation, kind="LMGPU").plan(dims=gdims, mesh=gmesh)
    _u, _c, g, _p = plan4._normalize_and_place(dict(ginputs))
    assert any(k.startswith("__halo") for k in g["G"]), "halo tables missing"
    plan1 = ot.Problem(arap_mesh_deformation, kind="LMGPU").plan(
        dims=gdims, init_params=same_algorithm(plan4)
    )
    for gsp, rtol in (
        (dict(nIterations=2, lIterations=100), FINAL_COST_RTOL),
        (dict(nIterations=8, lIterations=100), ARAP_LONG_RTOL),
    ):
        res4, first, solve = timed_solve(plan4, ginputs, **gsp)
        assert plan4.fused_fallback is None, plan4.fused_fallback
        res1, first1, solve1 = timed_solve(plan1, ginputs, **gsp)
        rel = check_cost("sharded arap_irregular", res4.final_cost,
                         res1.final_cost, rtol)
        spread = shard_report("arap Offset", res4.unknowns["Offset"])
        print(
            f"[sharded] arap_irregular {gsp['nIterations']} LM steps on 4 "
            f"devices: compile_s={first - solve:.3f} solve_s={solve:.4f} "
            f"one-card solve_s={solve1:.4f} final_cost={res4.final_cost:.9g} "
            f"one-card={res1.final_cost:.9g} rel_diff={rel:.3g} "
            f"every device held a shard: {spread}"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--phase", action="append", default=None,
                    help="run only this single-card phase (repeatable)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(
            f"chip_smoke: no GPU found (JAX's default backend is "
            f"{devs[0].platform!r}); nothing was run"
        )
    import opt_tpu  # noqa: F401  (fails here when run outside the repo)

    print(f"[device] {len(devs)} x {devs[0].device_kind} ({devs[0].platform})")
    print(card_line())
    sys.stdout.flush()

    if args.four:
        phases = [phase_sharded]
    else:
        phases = [
            phase_poisson,
            phase_image_warping,
            phase_arap_irregular,
            phase_batched,
            phase_kernel,
        ]
    if args.phase:
        phases = [p for p in phases if p.__name__[6:] in args.phase]
        assert phases, f"no phase named {args.phase}"
    for phase in phases:
        t0 = time.perf_counter()
        phase(args.seed)
        print(f"[{phase.__name__[6:]}] phase_s={time.perf_counter() - t0:.1f}")
        sys.stdout.flush()

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))


if __name__ == "__main__":
    main()
