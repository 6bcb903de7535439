"""Solver parameters and configuration enums.

Names, defaults and semantics mirror the reference exactly so that final
energies match (reference: API/src/solverGPUGaussNewton.t:12-39; runtime
setting via Opt_SetSolverParameter, solverGPUGaussNewton.t:1205-1221).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict


class GuardedInvertType(enum.Enum):
    CERES = "ceres"
    MODIFIED_CERES = "modified_ceres"
    EPSILON_ADD = "epsilon_add"


class JacobiScalingType(enum.Enum):
    NONE = "none"
    ONCE_PER_SOLVE = "once_per_solve"
    EVERY_ITERATION = "every_iteration"


FLOAT_EPSILON = 1e-8  # solverGPUGaussNewton.t:96


@dataclasses.dataclass
class InitializationParameters:
    """Compile-time solver switches (solverGPUGaussNewton.t:19-24)."""

    guarded_invert_type: GuardedInvertType = GuardedInvertType.CERES
    jacobi_scaling: JacobiScalingType = JacobiScalingType.ONCE_PER_SOLVE
    guard_division_by_zero: bool = True  # solverGPUGaussNewton.t:17
    # Assemble the gather-form JᵀJ stencil once per nonlinear iteration and
    # apply it as weighted shifts in the CG loop (the reference's fused
    # createjtjcentered form; its initialization_parameters.use_fused_jtj
    # analogue). Falls back to composed Jᵀ(J·p) for graph problems or when
    # the coefficient fields would exceed the memory budget.
    use_fused_jtj: bool = True
    fused_jtj_memory_limit_bytes: int = 1 << 31
    # Validate the assembled (fused) JᵀJ operator against the composed
    # Jᵀ(J·p) once per plan, at the first solve's real inputs: a single
    # random-vector apply comparison. Probe-based structural-zero detection
    # can in principle prune couplings whose data-dependent gates never flip
    # under the probe distribution (the reference's symbolic polysimplify is
    # exact); on mismatch the plan silently falls back to the composed
    # operator. Costs one extra small compile per plan.
    validate_fused_jtj: bool = True
    # CG apply of 2-D grid stencils as one Pallas kernel through Triton
    # (ops/stencil_kernel.py): JᵀJ·p fused with its pᵀAp partials, on a
    # channel-major layout. "auto": on CUDA devices when the assembled
    # operator qualifies (Plan.cg_path says which apply ran, and
    # Plan.cg_path_reason why not); True forces it (an error on any other
    # backend); False turns it off; "interpret" runs the same kernel
    # through the Pallas interpreter (CPU tests).
    use_pallas_cg: Any = "auto"
    # Explicit sparse-J path (the reference's optional use_cusparse branch,
    # solverGPUGaussNewton.t:74-90 — off by default there too): build J as
    # a BCOO once per nonlinear iteration and run JᵀJ·p as two sparse
    # matvecs (explicit.py). Verification / special-purpose surface.
    use_explicit_jtj: bool = False
    # Dynamic graph topology without retraces: pad every graph's edge axis
    # to a power-of-two bucket (padded edges carry a zero validity mask and
    # contribute nothing — exactly the edge-mask semantics), bucket the
    # derived incidence-table widths, and skip the topology-specialized DIA
    # split. Re-solving the plan with a changed topology in the same bucket
    # then hits the jit cache; only the cheap vectorized host-side tables
    # rebuild. The analogue of the reference's RUNTIME edge count (kernels
    # guard idx < N at launch, util.t:728), which lets per-frame topology
    # changes (nonrigid tracking) run without recompiling.
    dynamic_topology: bool = False
    # Opt_InitializationParameters.collectPerKernelTimingInfo (Opt.h:21-25):
    # after each solve, print the per-phase timing table plus the greppable
    # ``TIMING`` / ``Per-iter times ms (nonlinear, linear)`` lines
    # (util.t:469-508 format; utils/timer.report_solve_timing).
    collect_per_kernel_timing: bool = False
    # CG inner-loop variant (GN and LM). "standard" is the reference's PCG
    # recurrence (two DEPENDENT reductions per iteration: pᵀAp before the
    # x/r updates, rᵀz after). "chronopoulos_gear" computes both dot
    # products on the same vector pair (γ=rᵀu, δ=uᵀAu with u=M⁻¹r) and
    # maintains s=Ap by recurrence, so the two reductions are independent
    # and XLA's collective combiner merges them into ONE all-reduce per
    # iteration — half the latency-bound synchronizations per CG iteration
    # on a mesh (PAPERS.md: communication-reduced CG variants). Identical
    # iterates in exact arithmetic; one extra vector recurrence and
    # slightly different rounding. Under LM the previous update's Q value
    # (the ζ exit, t:478-481, t:1093-1102) joins the same fused reduction,
    # so all THREE per-iteration dots ride one all-reduce; LM's residual
    # reset recomputes r on the reference period (the α-denominator
    # recurrence itself is not reset).
    # Default "auto": single device -> "standard" (the two
    # on-chip reductions are ~free; the reference recurrence's rounding is
    # the golden-pinned one); mesh with >1 device -> "chronopoulos_gear"
    # (one all-reduce per CG iteration instead of two). Explicit values
    # override.
    cg_variant: str = "auto"
    # Preconditioner choice. "jacobi" (default) is the reference's scalar
    # Jacobi (o.t:2149-2168). "block_jacobi" (no reference counterpart,
    # assembled path only) inverts the full per-element Δ=0 coupling
    # block — the channel coupling scalar Jacobi ignores — cutting CG
    # iterations on mixed-unknown problems (Offset×Angle, ARAP blocks);
    # built from blocks the assembly already holds, inverted once per
    # nonlinear iteration. Under LM the DAMPED block (B + diag(CtC)) is
    # inverted, modeling the trust-region operator exactly per element
    # (the reference's scalar Jacobi-scaling pipeline applies only to the
    # scalar mode). The composed/explicit paths use scalar Jacobi.
    # Default "auto": single device -> "jacobi" (a CG iteration is cheap
    # there, so trading iterations for per-apply block matvecs was a
    # wall-clock loss on earlier hardware; not yet measured on the
    # H100); mesh with
    # >1 device -> "block_jacobi"
    # (each CG iteration costs latency-bound collectives, so the −60–70%
    # iteration count is the communication-optimal choice; harmlessly
    # equals scalar Jacobi when the Δ=0 block is diagonal, and falls back
    # to scalar where the assembled block source is unavailable). Explicit
    # values override.
    preconditioner: str = "auto"
    # Bind-time edge renumbering for mesh locality (no reference
    # counterpart — single-GPU reference). "owner": stable-sort each
    # graph's edges by the device owner of their first endpoint, so a
    # device's edge shard mostly holds edges whose accumulation target it
    # owns. The per-GN-step device-major edge-row exchange
    # (parallel/mesh.py map_stacked_rows_device_major + build_halo_tables)
    # has volume set by edge-numbering ALIGNMENT, not boundary size; owner
    # sorting collapses it toward the true boundary. It perturbs the
    # per-edge float reduction order (golden-cost drift) and dumpJ's
    # per-edge row order, so it stays off without a mesh.
    # Default "auto": False on a single device or for
    # grid-only problems; "owner" for graph problems on a mesh with >1
    # device. Explicit values override.
    edge_reorder: Any = "auto"
    # EXPERIMENTAL, default OFF: incidence-aligned graph assembly
    # (assembly.py aligned branch; no reference counterpart — the reference
    # scatters per edge with atomics, o.t:2092-2126). The per-GN-step
    # coefficient accumulation gathers the NARROW raw probe columns into
    # incidence space ([N, D, r·P] elements) and builds the coupling blocks
    # post-gather via static placement matmuls, instead of gathering wide
    # pre-stacked coefficient rows ([m·E, m·Ct²] elements). It lost on earlier
    # hardware, where XLA sank the flat→[N, ct, ct] field reshape into the CG
    # while body; not yet measured on the H100 (ROADMAP design item 4).
    # Parity is pinned by tests either way. Single-device path; meshes
    # always use the stacked-row exchange.
    aligned_graph_assembly: bool = False
    # EXPERIMENTAL, no reference counterpart: store the assembled JᵀJ
    # coefficient fields in a narrower dtype ("bfloat16") while all CG
    # state, dots and the Jacobi diagonal stay in the solve dtype. The CG
    # hot loop reads the coefficients every iteration, so halving their
    # bytes halves that traffic; the inner solve then runs on a
    # ~3-decimal-digit perturbation of JᵀJ, which the exact per-outer-step
    # JᵀF turns into iterative refinement (outer GN/LM corrects the inner
    # error; final costs match f32 on well-conditioned problems). None =
    # full precision. The stencil kernel stores its fields in this dtype
    # too. On stiff graph energies (ARAP-style
    # near-singular rotation directions) pair it with LM: plain GN accepts
    # every step and the perturbed directions can be non-descent
    # (tests/test_bf16_coefficients.py).
    coefficient_dtype: Any = None


def resolve_auto_policy(
    ip: "InitializationParameters", n_devices: int, has_graphs: bool
) -> "InitializationParameters":
    """Resolve the "auto" solver-variant flags per execution regime
    The reference ships ONE hardcoded kernel config; here the defaults
    are part of the design, so the
    communication-relevant switches pick themselves from the static facts
    available at plan time — device count and domain kind:

    * single device: "standard" CG (on-device reductions are cheap),
      scalar "jacobi" (block matvecs per apply were a wall-clock loss on
      earlier hardware; not yet measured on the H100), no edge reorder
      (preserves the reference's per-edge reduction order, golden-pinned);
    * mesh with >1 device: "chronopoulos_gear" (ONE all-reduce per CG
      iteration — the three LM dots share it), "block_jacobi" (CG
      iterations cost latency-bound collectives; fewer iterations wins),
      "owner" edge reorder for graph problems (collapses the per-step
      edge-row exchange toward the true partition boundary).

    Explicit (non-"auto") values always pass through — manual override is
    the escape hatch, exactly like the reference's hand-edited solver
    defines. scripts/collective_report.py audits the resulting HLO
    collective counts; tests/test_auto_policy.py pins the choices.
    """
    import dataclasses

    multi = n_devices > 1
    upd = {}
    if ip.cg_variant == "auto":
        upd["cg_variant"] = "chronopoulos_gear" if multi else "standard"
    if ip.preconditioner == "auto":
        upd["preconditioner"] = "block_jacobi" if multi else "jacobi"
    if ip.edge_reorder == "auto":
        # owner reorder is a per-topology bind-time renumbering; under
        # dynamic_topology it would re-derive tables per frame and defeat
        # the shared-trace guarantee, so it stays off there
        upd["edge_reorder"] = (
            "owner"
            if (multi and has_graphs and not ip.dynamic_topology)
            else False
        )
    return dataclasses.replace(ip, **upd) if upd else ip


# Runtime-settable parameters (solverGPUGaussNewton.t:26-39). `nIterations`
# and `lIterations` are dynamic (no recompile when changed), unlike the
# reference where everything is baked per-plan anyway.
SOLVER_PARAMETER_DEFAULTS: Dict[str, Any] = {
    "residual_reset_period": 10,
    "min_relative_decrease": 1e-3,
    "min_trust_region_radius": 1e-32,
    "max_trust_region_radius": 1e16,
    "q_tolerance": 1e-4,
    "function_tolerance": 1e-6,
    "trust_region_radius": 1e4,
    "radius_decrease_factor": 2.0,
    "min_lm_diagonal": 1e-6,
    "max_lm_diagonal": 1e32,
    "nIterations": 10,
    "lIterations": 10,
    # Extension over the reference parameter set (solverGPUGaussNewton.t:26-39):
    # terminate the CG inner loop when rᵀz falls below this fraction of its
    # initial value. The reference runs a fixed iteration count, which in
    # float32 diverges once CG reaches exact convergence (α = rᵀz/pᵀAp with
    # both ~eps²); at 1e-12 this exit only fires in that degenerate regime.
    "cg_rz_tolerance": 1e-12,
}

_INT_PARAMS = {"residual_reset_period", "nIterations", "lIterations"}


def normalize_solver_params(overrides: Dict[str, Any]) -> Dict[str, Any]:
    params = dict(SOLVER_PARAMETER_DEFAULTS)
    for k, v in overrides.items():
        if k not in params:
            raise KeyError(
                f"unknown solver parameter {k!r} "
                f"(valid: {sorted(params)}; reference solverGPUGaussNewton.t:26-39)"
            )
        params[k] = int(v) if k in _INT_PARAMS else float(v)
    return params
