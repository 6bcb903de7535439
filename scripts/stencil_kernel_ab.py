#!/usr/bin/env python3
"""The Triton stencil kernel against the XLA CG loop, on one CUDA GPU.

    python scripts/stencil_kernel_ab.py [--repeats 3] [--sweep]

Three whole solves, each with ``use_pallas_cg=True`` (kernel) and
``use_pallas_cg=False`` (XLA loop), timed in turns (xla, kernel, kernel,
xla per round): poisson 512² float4 GN 1 x 2000 CG, image_warping 512² GN
8 x 400 CG and image_warping 1024² GN 8 x 400 CG. Then the apply alone:
the kernel and the XLA apply (assembled operator plus pᵀAp), each as 200
back-to-back iterations inside one jitted loop. ``--sweep`` also times the
kernel alone over a few tile shapes and warp counts.

Bytes per CG iteration are a lower bound from shapes: the apply reads
every field and p once and writes Ap; the vector updates read p, Ap, δ, r
and the preconditioner and write δ, r and p (8·C planes). The share of the
card's 3.35 TB/s (NVIDIA data sheet, H100 SXM) divides that bound by the
measured time. Prints one JSON object per measurement, then a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def _emit(rec):
    print(json.dumps(rec), flush=True)


def cases(seed):
    from chip_smoke import poisson_inputs, warping_inputs
    from opt_tpu.models.specs import image_warping, poisson_image_editing

    return [
        ("poisson512", poisson_image_editing, 512, poisson_inputs(512, seed),
         dict(nIterations=1, lIterations=2000)),
        ("image_warping512", image_warping, 512, warping_inputs(512, seed),
         dict(nIterations=8, lIterations=400)),
        ("image_warping1024", image_warping, 1024, warping_inputs(1024, seed),
         dict(nIterations=8, lIterations=400)),
    ]


def solve_once(plan, inputs, sp):
    import jax

    t0 = time.perf_counter()
    res = plan.solve(dict(inputs), **sp)
    jax.block_until_ready(res.unknowns)
    return time.perf_counter() - t0, res


def apply_bytes(meta):
    """Device-memory bytes one apply must move at least: every field once,
    every p channel once (the shifted reads hit cache), Ap written once."""
    F = meta["F"]
    _t, hp, wp = F.shape
    return int(F.size * F.dtype.itemsize + 2 * meta["ctot"] * hp * wp * 4)


def iteration_bytes(meta):
    """apply_bytes plus the vector updates: p, Ap, δ, r and the
    preconditioner read, δ, r and p written (8·C planes)."""
    hp, wp = meta["F"].shape[1:]
    return apply_bytes(meta) + 8 * meta["ctot"] * hp * wp * 4


def with_block(meta, block):
    """The same meta re-padded for another tile shape."""
    import jax.numpy as jnp

    h, w = meta["dom"]
    bh, bw = block
    hp, wp = -(-h // bh) * bh, -(-w // bw) * bw
    F = jnp.pad(meta["F"][:, :h, :w], ((0, 0), (0, hp - h), (0, wp - w)))
    return {**meta, "F": F, "block": block}


def per_apply_seconds(build, args, iters=200, reps=5):
    """Seconds per apply. ``build(*args) -> (fn, q0)`` runs inside the jit
    (so the operator's data are arguments, not constants); ``fn(q)``
    returns (A·q, qᵀA·q). Each apply depends on the last, and the time of
    a one-apply loop is subtracted, so set-up does not count."""
    import jax
    import jax.numpy as jnp

    def runner(n):
        @jax.jit
        def run(*args):
            fn, q0 = build(*args)

            def body(_, c):
                q, acc = c
                ap, d = fn(q)
                q = jax.tree_util.tree_map(lambda a, b: a + 1e-30 * b, q, ap)
                return (q, acc + d)

            return jax.lax.fori_loop(
                0, n, body, (q0, jnp.zeros((), jnp.float32))
            )

        return run

    times = {}
    for n in (1, iters):
        run = runner(n)
        jax.block_until_ready(run(*args))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(*args))
            best = min(best, time.perf_counter() - t0)
        times[n] = best
    return (times[iters] - times[1]) / (iters - 1)


def kernel_builder(meta, **kw):
    from opt_tpu.ops.stencil_kernel import stencil_apply

    static = {k: v for k, v in meta.items() if k != "F"}

    def build(F, p):
        m = {**static, "F": F}
        return (lambda q: stencil_apply(m, q, **kw)), p

    return build


def reference_builder(meta):
    from opt_tpu.ops.stencil_kernel import stencil_apply_reference

    static = {k: v for k, v in meta.items() if k != "F"}

    def build(F, p):
        m = {**static, "F": F}
        return (lambda q: stencil_apply_reference(m, q)), p

    return build


def xla_builder(plan, meta):
    """The XLA loop's own apply: the assembled operator on the per-unknown
    layout, plus its pᵀAp, assembled inside the jit at the bound inputs."""
    from opt_tpu.functions import FunctionSet
    from opt_tpu.ops.stencil_kernel import unpack
    from opt_tpu.solver.gauss_newton import _apply_dot

    def build(u, c, g, pa, p):
        fs = FunctionSet(plan.compiled, c, g, pa)
        A, _d, _j, _m = fs.assemble_stencil(u, plan.solver._stencil_plan)
        return (lambda q: _apply_dot(A, q)), unpack(meta, p)

    return build


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("stencil_kernel_ab: needs a CUDA GPU")
    from chip_smoke import card_line, grid_meta
    import opt_tpu as ot
    card = card_line()
    print(card, flush=True)
    summary = []
    for name, spec, n, inputs, sp in cases(args.seed):
        dims = {"W": n, "H": n}
        inputs = {k: jax.device_put(v) for k, v in inputs.items()}
        plans = {
            mode: ot.Problem(spec).plan(
                dims=dims,
                init_params=ot.InitializationParameters(use_pallas_cg=flag),
            )
            for mode, flag in (("xla", False), ("kernel", True))
        }
        res = {}
        for mode, plan in plans.items():
            first, res[mode] = solve_once(plan, inputs, sp)
            _emit({"case": name, "mode": mode, "first_call_s": first,
                   "cg_path": plan.cg_path, "card": card})
        times = {"xla": [], "kernel": []}
        for _ in range(args.repeats):
            for mode in ("xla", "kernel", "kernel", "xla"):
                t, res[mode] = solve_once(plans[mode], inputs, sp)
                times[mode].append(t)
        meta = grid_meta(spec, dims, inputs)
        bytes_it = iteration_bytes(meta)
        row = {"case": name, "card": card, "bytes_per_cg_iter": bytes_it}
        for mode in ("xla", "kernel"):
            t = statistics.median(times[mode])
            it = res[mode].num_linear_iterations
            row[mode] = {
                "solve_s_median": t,
                "solve_s_all": times[mode],
                "cg_iters": it,
                "final_cost": res[mode].final_cost,
                "s_per_cg_iter": t / max(1, it),
                "hbm_share": bytes_it / (t / max(1, it)) / HBM_BYTES_PER_S,
                "cg_path": plans[mode].cg_path,
            }
        row["speedup_kernel_over_xla"] = (
            row["xla"]["solve_s_median"] / row["kernel"]["solve_s_median"]
        )

        # the apply alone, same layout, same card
        C = meta["ctot"]
        hp, wp = meta["F"].shape[1:]
        rng = np.random.RandomState(args.seed)
        p = np.zeros((C, hp, wp), np.float32)
        p[:, :n, :n] = rng.randn(C, n, n)
        p = jnp.asarray(p)
        tk = per_apply_seconds(kernel_builder(meta), (meta["F"], p))
        tr = per_apply_seconds(reference_builder(meta), (meta["F"], p))
        bound = plans["xla"]._normalize_and_place(dict(inputs))
        tx = per_apply_seconds(xla_builder(plans["xla"], meta), (*bound, p))
        kb = apply_bytes(meta)
        row["apply_alone"] = {
            "kernel_s": tk,
            "xla_s": tx,
            "jnp_reference_s": tr,
            "bytes": kb,
            "kernel_hbm_share": kb / tk / HBM_BYTES_PER_S,
            "xla_hbm_share": kb / tx / HBM_BYTES_PER_S,
        }
        if args.sweep:
            sweep = []
            for block in ((8, 64), (16, 64), (8, 128), (16, 128), (32, 64),
                          (32, 32)):
                m2 = with_block(meta, block)
                p2 = jnp.pad(p[:, :n, :n], ((0, 0),
                             (0, m2["F"].shape[1] - n),
                             (0, m2["F"].shape[2] - n)))
                for warps in (2, 4, 8):
                    t = per_apply_seconds(
                        kernel_builder(m2, num_warps=warps), (m2["F"], p2),
                        iters=100, reps=3,
                    )
                    sweep.append({"block": block, "num_warps": warps,
                                  "kernel_s": t})
            row["sweep"] = sorted(sweep, key=lambda r: r["kernel_s"])[:6]
        _emit(row)
        summary.append(row)
    _emit({"summary": [
        {"case": r["case"],
         "xla_solve_s": r["xla"]["solve_s_median"],
         "kernel_solve_s": r["kernel"]["solve_s_median"],
         "speedup": r["speedup_kernel_over_xla"],
         "apply_kernel_us": r["apply_alone"]["kernel_s"] * 1e6,
         "apply_xla_us": r["apply_alone"]["xla_s"] * 1e6}
        for r in summary], "card": card})


if __name__ == "__main__":
    main()
