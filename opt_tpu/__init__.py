"""opt_tpu — a nonlinear least-squares DSL and solver framework for JAX.

A from-scratch re-design of the capabilities of niessner/Opt: users write
energy functions — sums of squared residual terms over image grids and
hypergraphs — as plain Python spec functions; the framework derives
matrix-free Gauss-Newton / Levenberg-Marquardt solvers with a
Jacobi-preconditioned CG inner loop via JAX autodiff, compiled by XLA, and
shardable over device meshes with jax.sharding.

Quick start::

    import opt_tpu as ot

    def laplacian(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(0.2 * (X(0, 0) - A(0, 0)),
                 X(0, 0) - X(1, 0),
                 X(0, 0) - X(0, 1))

    plan = ot.Problem(laplacian).plan(dims={"W": 512, "H": 512})
    result = plan.solve({"X": x0, "A": target})
"""

from __future__ import annotations

import os

import jax

# JAX's persistent compilation cache. Where JAX_COMPILATION_CACHE_DIR is
# set, JAX reads it itself and this sets nothing; otherwise the cache lives
# at a fixed path beside the package, so every process of this checkout
# finds what an earlier one compiled.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from .dims import Dim, IndexSpace
from .lib import (
    All,
    And,
    Any,
    Dot,
    Dot3,
    Energy,
    Exclude,
    InBounds,
    InBoundsExpanded,
    Index,
    L_2_norm,
    L_p,
    Matrix3x3Mul,
    Not,
    Or,
    Reduce,
    Rotate2D,
    Rotate3D,
    Select,
    Slice,
    Sqrt,
    Stencil,
    UsePreconditioner,
    eq,
    greater,
    greatereq,
    length,
    less,
    lesseq,
    neq,
    normalize,
)
from .problem import BatchedSolveResult, Plan, Problem, SolveResult
from .pyramid import PyramidPlan, upsample2x_nearest
from . import parallel  # ot.parallel.mesh.make_mesh (docs/MANUAL.md)
from .solver.params import (
    GuardedInvertType,
    InitializationParameters,
    JacobiScalingType,
    SOLVER_PARAMETER_DEFAULTS,
)
from .spec import SpecError

__version__ = "0.8.0"


def enable_double_precision():
    """Opt-style doublePrecision init parameter (Opt.h:10-30)."""
    jax.config.update("jax_enable_x64", True)


__all__ = [
    "Dim",
    "IndexSpace",
    "Problem",
    "Plan",
    "SolveResult",
    "SpecError",
    "GuardedInvertType",
    "JacobiScalingType",
    "InitializationParameters",
    "SOLVER_PARAMETER_DEFAULTS",
    "enable_double_precision",
    "BatchedSolveResult",
    "PyramidPlan",
    "upsample2x_nearest",
    # DSL stdlib
    "All", "And", "Any", "Dot", "Dot3", "Energy", "Exclude", "InBounds",
    "InBoundsExpanded", "Index", "L_2_norm", "L_p", "Matrix3x3Mul", "Not",
    "Or", "Reduce", "Rotate2D", "Rotate3D", "Select", "Slice", "Sqrt", "Stencil",
    "UsePreconditioner", "eq", "greater", "greatereq", "length", "less",
    "lesseq", "neq", "normalize",
]
