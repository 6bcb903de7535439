"""Device-side coarse-to-fine pyramid schedules.

The reference drives multi-resolution solves from the HOST: the app loop
swaps pyramid-level images into the problem parameters, upsamples the
unknowns on the CPU, and launches a fresh solve per level
(optical_flow/src/CombinedSolver.h:22-61). On a latency-bound rig every
level pays full dispatch + transfer round-trips.

Redesign: all levels run inside ONE jitted XLA program. Each
level's fused solve (`GaussNewtonSolver._solve_core` — itself a
`lax.while_loop` over GN/LM steps) is chained with a user-supplied
device-side prolongation between levels. Shapes per level are static, so
XLA compiles the whole schedule once; a solve is then a single dispatch
with no host synchronization between levels.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

from .problem import Problem, SolveResult
from .solver.params import (
    InitializationParameters,
    normalize_solver_params,
)


def upsample2x_nearest(arr: jnp.ndarray, shape, scale: float = 1.0):
    """Nearest-neighbour 2x upsampling to `shape` (spatial dims), values
    multiplied by `scale` — the flow-style prolongation (displacements double
    at double resolution; CombinedSolver.h upsamples flow and scales by 2)."""
    out = jnp.repeat(jnp.repeat(arr, 2, axis=0), 2, axis=1) * scale
    return out[: shape[0], : shape[1]]


class PyramidPlan:
    """A chain of per-level plans compiled into one solve program.

    Parameters
    ----------
    problem : the Problem (energy spec) shared by all levels
    level_dims : dims dict per level, coarse to fine
    prolong : (unknowns_dict, level_index, next_dims) -> unknowns_dict
        device-side (traced) prolongation from level `i`'s solution to
        level `i+1`'s initial unknowns
    """

    def __init__(
        self,
        problem: Problem,
        level_dims: List[Dict[str, int]],
        prolong: Callable[[Dict[str, jnp.ndarray], int, Dict[str, int]], Dict[str, jnp.ndarray]],
        kind: Optional[str] = None,
        init_params: Optional[InitializationParameters] = None,
        mesh=None,
        **solver_params,
    ):
        if not level_dims:
            raise ValueError("need at least one pyramid level")
        self.plans = [
            problem.plan(
                dims=d, kind=kind, init_params=init_params, mesh=mesh,
                **solver_params,
            )
            for d in level_dims
        ]
        self.level_dims = list(level_dims)
        self.prolong = prolong
        self.solver_params = normalize_solver_params(solver_params)
        self._jitted = None

    def _build(self, max_iters: int):
        plans = self.plans
        prolong = self.prolong
        level_dims = self.level_dims

        def run(X0, bound, sp):
            # bound: list of (consts, graphs, params) per level; sp: traced
            # solver-parameter scalars (shared across levels)
            X = X0
            finals = []
            lin_total = jnp.zeros((), jnp.int32)
            state = None
            for i, plan in enumerate(plans):
                consts, graphs, params = bound[i]
                state, _ = plan.solver._solve_core(
                    X, consts, graphs, params, sp, max_iters
                )
                finals.append(state["prev_cost"])
                lin_total = lin_total + state["lin_iters"]
                if i + 1 < len(plans):
                    X = prolong(state["X"], i, level_dims[i + 1])
            return state, jnp.stack(finals), lin_total

        return jax.jit(run)

    def solve(
        self, level_inputs: List[Dict[str, Any]], **solver_param_overrides
    ) -> SolveResult:
        """Solve the full schedule. `level_inputs[0]` must contain the
        coarse-level unknowns; later levels' unknown entries are ignored
        (their initial values come from the prolongation)."""
        sp = normalize_solver_params(
            {**self.solver_params, **solver_param_overrides}
        )
        if len(level_inputs) != len(self.plans):
            raise ValueError(
                f"expected {len(self.plans)} input dicts, got {len(level_inputs)}"
            )
        bound = []
        X0 = None
        for i, (plan, inputs) in enumerate(zip(self.plans, level_inputs)):
            unknowns, consts, graphs, params = plan._normalize_and_place(inputs)
            plan._validate_fused(unknowns, consts, graphs, params)
            if i == 0:
                X0 = unknowns
            bound.append((consts, graphs, params))
        max_iters = int(sp["nIterations"])
        if self._jitted is None or self._jitted[0] != max_iters:
            self._jitted = (max_iters, self._build(max_iters))
        t0 = time.perf_counter()
        state, finals, lin_total = self._jitted[1](
            X0, bound, self.plans[0].solver._traced_sp(sp)
        )
        finals_h = jax.device_get(finals)
        wall = time.perf_counter() - t0
        return SolveResult(
            # same ±inf invalid-marker restore as every other solve entry
            # point: markers in the finest level's unknown INPUTS (whose
            # values are otherwise ignored) come back verbatim
            unknowns=self.plans[-1]._restore_sentinels(state["X"]),
            final_cost=float(finals_h[-1]),
            costs=[float(c) for c in finals_h],
            num_iterations=len(self.plans) * int(sp["nIterations"]),
            wall_time_s=wall,
            num_linear_iterations=int(lin_total),
        )
