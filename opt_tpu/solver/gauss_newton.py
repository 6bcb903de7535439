"""Gauss-Newton / Levenberg-Marquardt solver with Jacobi-preconditioned CG.

This is the re-design of the reference's single solver backend
(API/src/solverGPUGaussNewton.t — both the "gaussNewtonGPU" and "LMGPU" plan
kinds, o.t:122). The numerics follow the reference kernel-for-kernel so final
energies match:

* PCGInit1 (t:361-419): delta=0, r=-JᵀF, p=M⁻¹r with the guarded invert
  (t:325-351), rᵀz reduction.
* PCGStep1/2/3 (t:421-550): α=rᵀz/pᵀAp (division guarded, t:457), x/r updates,
  β=rᵀz_new/rᵀz_old, with the LM residual re-computation every
  ``residual_reset_period`` inner iterations (t:491-534, t:1077-1086) and the
  Ceres Q/ζ early exit ζ=(i+1)(Q1−Q0)/Q1 < q_tolerance (t:446-489,
  t:1093-1102).
* LM damping: CtC = diag(JᵀJ)/radius, Jacobi-scaled + clamped, preconditioner
  1/(CtC + radius·CtC_unclamped) (PCGComputeCtC/PCGFinalizeDiagonal,
  t:615-664); Ceres-style trust-region accept/reject with radius update
  ÷max(⅓, 1−(2ρ−1)³) and function_tolerance / min-radius exits (t:1119-1164).

The design departure from the reference is architectural, not numerical: the
reference launches ~6 CUDA kernels per linear iteration with device↔host
scalar memcpys for the reductions (t:790-814, t:1091); here the entire
nonlinear step — including every CG dot product — is one jitted program with
``lax.while_loop``s, so scalars never leave the device and XLA fuses the
element-wise PCG algebra into the JᵀJ matvec.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ..compile import CompiledProblem
from ..functions import FunctionSet, tree_dot
from .params import (
    FLOAT_EPSILON,
    GuardedInvertType,
    InitializationParameters,
    JacobiScalingType,
)

# pytree helpers over unknown dicts ----------------------------------------


def _axpy(a, x, y):  # y + a*x
    return {k: y[k] + a * x[k] for k in y}


def _sub(x, y):
    return {k: x[k] - y[k] for k in x}


def _mul(x, y):
    return {k: x[k] * y[k] for k in x}


def _where(c, x, y):
    return {k: jnp.where(c, x[k], y[k]) for k in x}


def _zeros_like(x):
    return {k: jnp.zeros_like(v) for k, v in x.items()}


def _apply_dot(A, v):
    Av = A(v)
    return Av, tree_dot(v, Av)


def _kernel_mode(mode):
    """``use_pallas_cg`` -> None (XLA loop), "compiled" or "interpret".
    "auto" compiles the stencil kernel on CUDA devices only; forcing it on
    another backend is an error, never a silent fallback."""
    if mode in (False, "off", None):
        return None
    if mode == "interpret":
        return "interpret"
    backend = jax.default_backend()
    if mode in (True, "on"):
        if backend != "gpu":
            raise ValueError(
                "use_pallas_cg=True compiles the Triton stencil kernel, which "
                f"needs a CUDA device; the default backend is {backend!r} "
                '(use_pallas_cg="interpret" runs it through the Pallas '
                "interpreter)"
            )
        return "compiled"
    if mode != "auto":
        raise ValueError(f"use_pallas_cg={mode!r}: expected auto/on/off/interpret")
    return "compiled" if backend == "gpu" else None


class GaussNewtonSolver:
    """One solver instance per (compiled problem, kind)."""

    def __init__(
        self,
        compiled: CompiledProblem,
        uses_lambda: bool,
        init_params: Optional[InitializationParameters] = None,
        sharding_rules=None,
    ):
        self.compiled = compiled
        self.uses_lambda = bool(uses_lambda)
        self.ip = init_params or InitializationParameters()
        self.rules = sharding_rules
        # resolve "auto" variant flags from the execution regime (device
        # count, domain kind) — explicit values pass through untouched
        from .params import resolve_auto_policy

        ndev = (
            sharding_rules.mesh.size
            if sharding_rules is not None
            and getattr(sharding_rules, "mesh", None) is not None
            else 1
        )
        self.ip = resolve_auto_policy(
            self.ip, ndev, bool(getattr(compiled.registry, "graphs", None))
        )
        self._stencil_plan = None
        if self.ip.use_fused_jtj and not getattr(
            self.ip, "use_explicit_jtj", False
        ):
            from ..assembly import plan_assembly
            from ..utils.logging import log_solver

            try:
                self._stencil_plan = plan_assembly(
                    compiled.spec_fn,
                    compiled,
                    memory_limit_bytes=self.ip.fused_jtj_memory_limit_bytes,
                )
            except Exception as e:  # pragma: no cover - spec-dependent
                log_solver(f"fused JtJ assembly disabled ({e!r})")
        self._kernel_mode = _kernel_mode(getattr(self.ip, "use_pallas_cg", "auto"))
        # which CG apply the last traced step used ("triton", "interpret"
        # or "xla") and, for "xla", why the kernel did not run
        self.cg_path = None
        self.cg_path_reason = None
        self._step_jit = jax.jit(self._step, donate_argnums=(0,))
        self._init_jit = jax.jit(self._init_state)
        self._sp_cache = {}

    def _mesh(self):
        return self.rules.mesh if self.rules is not None else None

    def _constrain(self, X):
        if self.rules is None:
            return X
        return self.rules.constrain_unknowns(self.compiled, X)

    # -- numerics helpers ------------------------------------------------------
    def _guarded_invert(self, p):
        """solverGPUGaussNewton.t:325-351."""
        t = self.ip.guarded_invert_type
        if t == GuardedInvertType.CERES:
            inv = lambda v: 1.0 / jnp.square(1.0 + jnp.sqrt(v))
        elif t == GuardedInvertType.MODIFIED_CERES:
            inv = lambda v: 1.0 / (1.0 + v)
        else:
            inv = lambda v: 1.0 / (FLOAT_EPSILON + v)
        return {k: inv(v) for k, v in p.items()}

    def _safe_div(self, num, den):
        """α/β division guard (guardDivisionByZero, t:17, t:457, t:545)."""
        if not self.ip.guard_division_by_zero:
            return num / den
        return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)

    def _cs_recurrence(
        self, delta, r, p, s, u, w, gamma, gamma_new, delta_d, alpha_prev,
        first, stop_now,
    ):
        """Shared Chronopoulos–Gear update pipeline (GN and LM CS loops):
        β from the carried γ, the pipelined step denominator
        den = uᵀAu − β·γ_new/α_prev (equal to pᵀAp in exact arithmetic),
        and the p/s/δ/r recurrences. Returns
        (delta, r, p, s, alpha, used_den)."""
        beta = jnp.where(
            first,
            jnp.zeros_like(gamma_new),
            self._safe_div(gamma_new, gamma),
        )
        den = delta_d - beta * self._safe_div(gamma_new, alpha_prev)
        used_den = jnp.where(first, delta_d, den)
        alpha = jnp.where(
            stop_now,
            jnp.zeros_like(gamma_new),
            self._safe_div(gamma_new, used_den),
        )
        p = _axpy(beta, p, u)
        s = _axpy(beta, s, w)
        delta = _axpy(alpha, p, delta)
        r = _axpy(-alpha, s, r)
        return delta, r, p, s, alpha, used_den

    # -- state -----------------------------------------------------------------
    def _init_state(self, X, consts, graphs, params, sp):
        X = self._constrain(X)
        fs = FunctionSet(self.compiled, consts, graphs, params, mesh=self._mesh())
        dt = self.compiled.dtype
        return {
            "X": X,
            "SSq": {k: jnp.ones_like(v) for k, v in X.items()},
            "prev_cost": fs.cost(X).astype(dt),
            "trust_region_radius": jnp.asarray(sp["trust_region_radius"], dt),
            "radius_decrease_factor": jnp.asarray(sp["radius_decrease_factor"], dt),
            "n_iter": jnp.zeros((), jnp.int32),
            "lin_iters": jnp.zeros((), jnp.int32),
            "done": jnp.zeros((), jnp.bool_),
        }

    def init(self, X, consts, graphs, params, sp):
        return self._init_jit(X, consts, graphs, params, self._traced_sp(sp))

    def _traced_sp(self, sp: Dict[str, Any]) -> Dict[str, Any]:
        """Solver parameters as device-resident traced scalars: changing them
        does not force a recompile (unlike the reference, where any change of
        problem size recompiles the world — README.md:487). Cached per value
        set so repeated solves cost zero host->device transfers."""
        key = tuple(sorted(sp.items()))
        cached = self._sp_cache.get(key)
        if cached is not None:
            return cached
        out = {}
        for k, v in sp.items():
            out[k] = jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
        out = jax.device_put(out)
        self._sp_cache[key] = out
        return out

    def step(self, state, consts, graphs, params, sp):
        return self._step_jit(state, consts, graphs, params, self._traced_sp(sp))

    def validate_assembly(self, X, consts, graphs, params) -> bool:
        """Random-vector apply comparison of the assembled JᵀJ operator
        against the composed Jᵀ(J·p), exercising the SAME const-cache path
        the solver runs (assemble_const + assemble_stencil), at two points:

        * the real bound inputs X — catches probe-based structural-zero
          pruning misses on the data actually being solved (the reference's
          polysimplify, ad.t:803-926, is exact and has no such blind spot);
        * a small perturbation X′ with the const cache still built at X —
          catches constant-slot false positives (a (term, slot) field the
          probe draws judged X-independent but that varies over the solve
          would be served stale from the cache; at X both trivially agree).

        Returns True when the operators agree at both points."""
        if self._stencil_plan is None:
            return True
        import numpy as np

        c = self.compiled
        rng = np.random.RandomState(20260817)
        v = {
            k: jnp.asarray(rng.uniform(-1.0, 1.0, c.unknown_shape(k)), c.dtype)
            for k in c.unknown_names
        }
        dX = {
            k: jnp.asarray(
                rng.uniform(-1.0, 1.0, c.unknown_shape(k)), c.dtype
            )
            for k in c.unknown_names
        }

        def _one(fs, Xp, A, vm):
            _r, J, JT = fs.linearize(Xp)
            ref = JT(J(vm))
            got = A(vm)
            err = jnp.zeros((), c.dtype)
            scale = jnp.zeros((), c.dtype)
            for k in ref:
                # compare only where BOTH operators are finite: the O(1)
                # perturbation below may leave a spec's numeric domain
                # (sqrt/log/÷ of unknowns), and the two paths NaN
                # asymmetrically there — the assembled fields fold masks
                # multiplicatively (0·NaN = NaN) while the composed
                # transpose zero-pads structurally. A falsely hoisted or
                # pruned coupling still perturbs the finite region almost
                # everywhere, which is where users actually solve.
                ok = jnp.isfinite(ref[k]) & jnp.isfinite(got[k])
                diff = jnp.where(ok, jnp.abs(ref[k] - got[k]), 0.0)
                err = jnp.maximum(err, jnp.max(diff))
                scale = jnp.maximum(
                    scale, jnp.max(jnp.where(ok, jnp.abs(ref[k]), 0.0))
                )
            return err, scale

        def _check(X, consts, graphs, params, v, dX):
            fs = FunctionSet(c, consts, graphs, params, mesh=self._mesh())
            fs.masks(X)
            vm = fs.mask_rows(v)
            cc = fs.assemble_const(X, self._stencil_plan)
            A, _diag, _jtf, _meta = fs.assemble_stencil(
                X, self._stencil_plan, cc
            )
            err1, scale1 = _one(fs, X, A, vm)
            # the perturbed point needs consistency, not proximity: for a
            # correct plan assembled-vs-composed agree at ANY X (truly
            # constant fields are X-independent, varying ones are re-probed
            # at X′), while a falsely-hoisted field's staleness scales with
            # the step — so perturb at O(1), not epsilon. Masks re-evaluate
            # at X′ via a fresh FunctionSet, matching _solve_core's
            # per-step mask evaluation; the const cache stays the X one.
            Xp = {
                k: X[k] + dX[k] * (0.5 * jnp.abs(X[k]) + 0.5) for k in X
            }
            fs2 = FunctionSet(c, consts, graphs, params, mesh=self._mesh())
            fs2.masks(Xp)
            vm2 = fs2.mask_rows(v)
            A2, _d2, _j2, _m2 = fs2.assemble_stencil(
                Xp, self._stencil_plan, cc
            )
            err2, scale2 = _one(fs2, Xp, A2, vm2)
            return (
                jnp.maximum(err1, err2),
                jnp.maximum(scale1, scale2),
            )

        err, scale = jax.device_get(
            jax.jit(_check)(X, consts, graphs, params, v, dX)
        )
        tol = 1e-9 if c.dtype == jnp.float64 else 5e-4
        return bool(err <= tol * (1.0 + scale))

    # -- one nonlinear iteration -------------------------------------------------
    def _step(self, state, consts, graphs, params, sp):
        fs = FunctionSet(self.compiled, consts, graphs, params, mesh=self._mesh())

        active = jnp.logical_and(
            ~state["done"], state["n_iter"] < sp["nIterations"]
        )

        def run(state):
            return (self._lm_step if self.uses_lambda else self._gn_step)(
                state, fs, sp
            )

        return jax.lax.cond(active, run, lambda s: s, state)

    def _asm_cache(self, fs: FunctionSet, X0):
        """Loop-invariant assembly data (constant-slot probes + products),
        computed once per solve before the nonlinear while_loop."""
        if self._stencil_plan is None or getattr(
            self.ip, "use_explicit_jtj", False
        ):
            return None
        return fs.assemble_const(X0, self._stencil_plan)

    # ---- shared PCG pieces -------------------------------------------------
    def _prepare(self, X, fs: FunctionSet, need_jtf: bool = True):
        fs.masks(X)  # populate the mask cache at the linearization point
        r_terms, J, JT = fs.linearize(X)
        if not need_jtf:
            return r_terms, J, JT, None
        jtf = JT(r_terms)
        r0 = {k: -v for k, v in jtf.items()}
        return r_terms, J, JT, r0

    def _select_cg_path(self, cg_meta, A, pre_apply):
        """The CG apply for this step: a packed-layout operator around the
        Triton stencil kernel (ops/stencil_kernel.py) when the kernel is on
        and the operator qualifies, else None (the XLA loop over the
        per-unknown dicts). Records the choice in ``cg_path`` and
        ``cg_path_reason`` when the step is traced."""
        reason = None
        if self._kernel_mode is None:
            reason = "kernel off"
        elif cg_meta is None:
            reason = getattr(A, "stencil_decline", None) or "no assembled stencil"
        elif pre_apply is not None:
            reason = "block_jacobi preconditioner"
        elif self._mesh() is not None and self._mesh().size > 1:
            reason = "sharded mesh"
        if reason is not None:
            self.cg_path, self.cg_path_reason = "xla", reason
            return None
        from ..ops.stencil_kernel import PackedStencil

        self.cg_path = "triton" if self._kernel_mode == "compiled" else "interpret"
        self.cg_path_reason = None
        return PackedStencil(cg_meta, interpret=self._kernel_mode == "interpret")

    def _gn_step(self, state, fs: FunctionSet, sp, asm_cache=None):
        X = self._constrain(state["X"])
        cg_meta = None
        if getattr(self.ip, "use_explicit_jtj", False):
            # reference's optional cusparse branch: explicit sparse J, two
            # matvecs per CG iteration (explicit.py)
            from ..explicit import build_explicit_j, explicit_jtj_apply

            r_terms, J, JT, r0 = self._prepare(X, fs)
            Jexp, _, _ = build_explicit_j(
                self.compiled, X, fs.consts, fs.graphs, fs.params
            )
            A, diag_asm = (
                explicit_jtj_apply(self.compiled, Jexp, fs.row_masks),
                None,
            )
        elif self._stencil_plan is not None:
            if asm_cache is None:
                asm_cache = self._asm_cache(fs, X)
            A, diag_asm, jtf_fn, cg_meta = fs.assemble_stencil(
                X, self._stencil_plan, asm_cache, mesh=self._mesh(),
                coeff_dtype=self.ip.coefficient_dtype,
            )
            # the probe linearize's primal IS the residual evaluation at X
            # — reuse it as r_terms instead of paying a separate
            # fs.linearize pass. GN never needs J/JT on this path.
            r_terms = getattr(jtf_fn, "r_terms", None)
            if r_terms is None:
                r_terms, _J, _JT, _ = self._prepare(X, fs, need_jtf=False)
            r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
        else:
            r_terms, J, JT, r0 = self._prepare(X, fs)
            A, diag_asm = (lambda v: JT(J(v))), None
        if self.compiled.use_preconditioner:
            pre_raw = diag_asm if diag_asm is not None else fs.jtj_diag(X)
        else:
            pre_raw = {k: jnp.ones_like(v) for k, v in r0.items()}
        pre = fs.mask_rows(self._guarded_invert(pre_raw))

        # block-Jacobi (opt-in, assembled path): invert the per-element
        # Δ=0 coupling block once per nonlinear iteration; z = M⁻¹r is a
        # per-element block matvec instead of the scalar multiply (the
        # scalar pre above is then dead and DCE'd).
        pre_apply = None
        if (
            self.ip.preconditioner == "block_jacobi"
            and self.compiled.use_preconditioner
            and hasattr(A, "block_pre")
        ):
            pre_apply = A.block_pre()

        M = pre_apply if pre_apply is not None else (lambda r: _mul(pre, r))
        kop = self._select_cg_path(cg_meta, A, pre_apply)
        if kop is None:
            A_dot = functools.partial(_apply_dot, A)
        else:
            # the loop runs on the kernel's packed [C, Hp, Wp] layout:
            # packed once per GN step, unpacked once after the loop
            r0 = kop.pack(r0)
            pre_k = kop.pack(pre)
            M = lambda r: _mul(pre_k, r)
            A_dot = kop.apply_dot
        delta, l_done = self._gn_cg(A_dot, M, r0, sp)
        if kop is not None:
            delta = kop.unpack(delta)

        X_new = {k: X[k] + delta[k] for k in X}
        new_cost = fs.cost(X_new)
        return {
            **state,
            "X": X_new,
            "prev_cost": new_cost.astype(state["prev_cost"].dtype),
            "n_iter": state["n_iter"] + 1,
            "lin_iters": state["lin_iters"] + l_done,
        }

    def _gn_cg(self, A_dot, M, r0, sp):
        """PCG on JᵀJ·δ = -JᵀF (PCGInit1 + PCGStep1/2/3, t:361-550).
        ``A_dot(p)`` returns (A·p, pᵀA·p). Returns (δ, iterations run)."""
        p0 = M(r0)
        rz0 = tree_dot(r0, p0)
        delta0 = _zeros_like(r0)
        rz_floor = sp["cg_rz_tolerance"].astype(rz0.dtype) * rz0

        if getattr(self.ip, "cg_variant", "standard") == "chronopoulos_gear":
            # single-reduction PCG (Chronopoulos–Gear; PAPERS.md
            # communication-reduced CG): γ=rᵀu and δ=uᵀAu are computed on
            # the same vectors, so the two reductions are independent and
            # lower to ONE all-reduce per iteration under a mesh; s=Ap is
            # maintained by the recurrence s = w + βs (still one matvec
            # per iteration). Same iterates as the standard loop in exact
            # arithmetic; same γ (=rᵀz) convergence floor and guards.
            def body_cs(carry):
                delta, r, p, s, gamma, alpha_prev, l, brk = carry
                u = M(r)
                w, delta_d = A_dot(u)
                gamma_new = tree_dot(r, u)
                first = l == 0
                # γ at the top of iteration j is the post-update rᵀz of
                # update j-1 — exactly what the standard loop checks after
                # its update. When the floor is already met, skip this
                # iteration's update and don't count it, so exits and
                # lin_iters match the standard variant (the probe matvec
                # above is already spent — inherent to the single-reduction
                # pipelining).
                stop_now = jnp.logical_and(~first, gamma_new <= rz_floor)
                delta, r, p, s, alpha, used_den = self._cs_recurrence(
                    delta, r, p, s, u, w, gamma, gamma_new, delta_d,
                    alpha_prev, first, stop_now,
                )
                # same exits as the standard loop: rᵀz floor and a
                # non-positive step denominator (the USED one, not uᵀAu)
                brk = jnp.logical_or(stop_now, used_den <= 0)
                l = l + jnp.where(stop_now, 0, 1)
                return (delta, r, p, s, gamma_new, alpha, l, brk)

            def cond_cs(carry):
                return jnp.logical_and(
                    carry[6] < sp["lIterations"], ~carry[7]
                )

            one = jnp.ones((), rz0.dtype)
            out = jax.lax.while_loop(
                cond_cs,
                body_cs,
                (
                    delta0,
                    r0,
                    _zeros_like(r0),
                    _zeros_like(r0),
                    one,
                    one,
                    jnp.zeros((), jnp.int32),
                    jnp.zeros((), jnp.bool_),
                ),
            )
            return out[0], out[6]

        def body(carry):
            delta, r, p, rz, l, brk = carry
            Ap, den = A_dot(p)
            alpha = self._safe_div(rz, den)
            delta = _axpy(alpha, p, delta)
            r = _axpy(-alpha, Ap, r)
            z = M(r)
            rz_new = tree_dot(z, r)
            beta = self._safe_div(rz_new, rz)
            p = _axpy(beta, p, z)
            brk = jnp.logical_or(rz_new <= rz_floor, den <= 0)
            return (delta, r, p, rz_new, l + 1, brk)

        def cond(carry):
            return jnp.logical_and(carry[4] < sp["lIterations"], ~carry[5])

        delta, _r, _p, _rz, l_done, _brk = jax.lax.while_loop(
            cond,
            body,
            (delta0, r0, p0, rz0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.bool_)),
        )
        return delta, l_done

    def _lm_step(self, state, fs: FunctionSet, sp, asm_cache=None):
        dt = self.compiled.dtype
        X = self._constrain(state["X"])
        radius = state["trust_region_radius"].astype(dt)
        cg_meta = None
        if getattr(self.ip, "use_explicit_jtj", False):
            from ..explicit import build_explicit_j, explicit_jtj_apply

            r_terms, J, JT, r0 = self._prepare(X, fs)
            Jexp, _, _ = build_explicit_j(
                self.compiled, X, fs.consts, fs.graphs, fs.params
            )
            A_base = explicit_jtj_apply(self.compiled, Jexp, fs.row_masks)
            diag = fs.jtj_diag(X)
        elif self._stencil_plan is not None:
            if asm_cache is None:
                asm_cache = self._asm_cache(fs, X)
            r_terms, J, _JT, _ = self._prepare(X, fs, need_jtf=False)
            A_base, diag, jtf_fn, cg_meta = fs.assemble_stencil(
                X, self._stencil_plan, asm_cache, mesh=self._mesh(),
                coeff_dtype=self.ip.coefficient_dtype,
            )
            r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
        else:
            r_terms, J, JT, r0 = self._prepare(X, fs)
            A_base, diag = (lambda v: JT(J(v))), fs.jtj_diag(X)
        # diag: actual diag(JᵀJ), also when UsePreconditioner(false)
        if self.compiled.use_preconditioner:
            pre_raw = diag
        else:
            pre_raw = fs.mask_rows({k: jnp.ones_like(v) for k, v in diag.items()})
        pre_guarded = fs.mask_rows(self._guarded_invert(pre_raw))

        # JacobiScaling ONCE_PER_SOLVE: freeze the guarded-inverted diag of the
        # first nonlinear iteration (PCGSaveSSq, t:607-613, t:1043-1045).
        if self.ip.jacobi_scaling == JacobiScalingType.ONCE_PER_SOLVE:
            SSq = _where(state["n_iter"] == 0, pre_guarded, state["SSq"])
            invS = {k: 1.0 / v for k, v in SSq.items()}
        elif self.ip.jacobi_scaling == JacobiScalingType.EVERY_ITERATION:
            SSq = state["SSq"]
            invS = {k: 1.0 / v for k, v in pre_guarded.items()}
        else:
            SSq = state["SSq"]
            invS = {k: jnp.ones_like(v) for k, v in diag.items()}

        # PCGComputeCtC (o.t:2255-2316) + PCGFinalizeDiagonal (t:631-664)
        ctc_un = {k: v / radius for k, v in diag.items()}
        min_d = sp["min_lm_diagonal"].astype(dt)
        max_d = sp["max_lm_diagonal"].astype(dt)
        ctc = {}
        pre_lm = {}
        for k in diag:
            mult = invS[k] / radius
            ctc[k] = jnp.clip(ctc_un[k], min_d * mult, max_d * mult)
            pre_lm[k] = 1.0 / (ctc[k] + radius * ctc_un[k])
        # select (not multiplicative) masking: at excluded rows diag=0 ⇒
        # SSq=0 ⇒ invS=inf ⇒ ctc=inf, and inf*0 would be NaN, poisoning
        # A(p) and stalling every LM step. Runs once per nonlinear
        # iteration, outside the CG hot loop.
        ctc = fs.mask_rows_select(ctc)
        pre_lm = fs.mask_rows_select(pre_lm)

        # block-Jacobi for LM: invert the DAMPED per-element block
        # (B_Δ0 + diag(CtC)) — the same ctc the operator A applies below,
        # so M models (A + CtC) exactly per element. The scalar pre_lm
        # (with its reference Jacobi-scaling pipeline) is then dead and
        # DCE'd; opt-in, scalar stays the default.
        pre_apply = None
        if (
            self.ip.preconditioner == "block_jacobi"
            and self.compiled.use_preconditioner
            and hasattr(A_base, "block_pre")
        ):
            pre_apply = A_base.block_pre(extra_diag=ctc)

        M = pre_apply if pre_apply is not None else (
            lambda r: _mul(pre_lm, r)
        )
        kop = self._select_cg_path(cg_meta, A_base, pre_apply)
        if kop is None:
            # JᵀJp + CtC·p (o.t:2076-2082)
            A = lambda v: _axpy(1.0, _mul(ctc, v), A_base(v))
            A_dot = functools.partial(_apply_dot, A)
        else:
            r0 = kop.pack(r0)
            pre_k = kop.pack(pre_lm)
            ctc_k = kop.pack(ctc)
            M = lambda r: _mul(pre_k, r)

            def A_dot(v):
                Av, den = kop.apply_dot(v)
                cv = _mul(ctc_k, v)
                return _axpy(1.0, cv, Av), den + tree_dot(v, cv)

        delta, l_done = self._lm_cg(A_dot, M, r0, sp)
        if kop is not None:
            delta = kop.unpack(delta)
        return self._lm_finish(state, fs, sp, X, delta, l_done, r_terms, J, SSq)

    def _lm_cg(self, A_dot, M, b, sp):
        """LM's PCG on (JᵀJ + CtC)·δ = b (t:421-550 with the LM residual
        reset and the Q/ζ exit). ``A_dot(p)`` returns (A·p, pᵀA·p) with the
        damping included. Returns (δ, iterations run)."""
        dt = self.compiled.dtype
        A = lambda v: A_dot(v)[0]
        r0 = b  # t:652 "copy over to b"
        p0 = M(r0)
        rz0 = tree_dot(r0, p0)
        rz_floor = sp["cg_rz_tolerance"].astype(dt) * rz0
        delta0 = _zeros_like(r0)
        Q0 = jnp.zeros((), dt)  # delta=0 ⇒ q=½δ·(r+r)=0 (t:658-662)

        reset_period = sp["residual_reset_period"]

        if getattr(self.ip, "cg_variant", "standard") == "chronopoulos_gear":
            # single-reduction PCG under LM: γ=rᵀu, δ=uᵀAu AND the Q value
            # of the PREVIOUS update (Q=½δᵀ(b+r), solverGPUGaussNewton.t:
            # 478-481) are all computed at the top of the iteration on
            # already-available vectors, so LM's three reductions per CG
            # iteration are independent and lower to ONE all-reduce under a
            # mesh (vs two dependent ones + the Q fetch in the standard
            # loop). Exit parity with the standard LM loop: the ζ and
            # rᵀz-floor checks fire one iteration later by construction
            # (the probe matvec is already spent — inherent to the
            # single-reduction pipelining), with identical counted
            # lin_iters. The residual reset recomputes r = b − A·δ on the
            # reference's period; note the α-denominator recurrence itself
            # is not reset (exact-arithmetic equal; opt-in variant).
            q_tol = sp["q_tolerance"].astype(dt)

            def body_cs(carry):
                delta, r, p, s, gamma, alpha_prev, Q0c, l, brk = carry
                u = M(r)
                w, delta_d = A_dot(u)
                gamma_new = tree_dot(r, u)
                Qcur = 0.5 * tree_dot(delta, _axpy(1.0, b, r))
                first = l == 0
                zeta = l.astype(dt) * (Qcur - Q0c) / Qcur
                stop_now = jnp.logical_and(
                    ~first,
                    jnp.logical_or(gamma_new <= rz_floor, zeta < q_tol),
                )
                delta, r, p, s, alpha, used_den = self._cs_recurrence(
                    delta, r, p, s, u, w, gamma, gamma_new, delta_d,
                    alpha_prev, first, stop_now,
                )
                l_new = l + jnp.where(stop_now, 0, 1)
                use_reset = jnp.logical_and(
                    l_new % reset_period == 0, ~stop_now
                )
                r = jax.lax.cond(
                    use_reset,
                    lambda _: _sub(b, A(delta)),  # t:491-534
                    lambda _: r,
                    None,
                )
                # pipelined-denominator breakdown exit (as in the GN CS
                # loop): den can round non-positive where the standard
                # loop's exact pᵀAp cannot — a frozen alpha=0 spin until
                # lIterations is the alternative
                brk = jnp.logical_or(stop_now, used_den <= 0)
                return (delta, r, p, s, gamma_new, alpha, Qcur, l_new, brk)

            def cond_cs(carry):
                return jnp.logical_and(
                    carry[7] < sp["lIterations"], ~carry[8]
                )

            one = jnp.ones((), rz0.dtype)
            out = jax.lax.while_loop(
                cond_cs,
                body_cs,
                (
                    delta0,
                    r0,
                    _zeros_like(r0),
                    _zeros_like(r0),
                    one,
                    one,
                    Q0,
                    jnp.zeros((), jnp.int32),
                    jnp.zeros((), jnp.bool_),
                ),
            )
            return out[0], out[7]

        def body(carry):
            delta, r, p, rz, Q0, l, brk = carry
            Ap, den = A_dot(p)
            alpha = self._safe_div(rz, den)
            delta = _axpy(alpha, p, delta)
            use_reset = (l + 1) % reset_period == 0
            r = jax.lax.cond(
                use_reset,
                lambda _: _sub(b, A(delta)),  # t:491-534 drift cancellation
                lambda _: _axpy(-alpha, Ap, r),
                None,
            )
            z = M(r)
            rz_new = tree_dot(z, r)
            Q1 = 0.5 * tree_dot(delta, _axpy(1.0, b, r))  # t:478-481
            beta = self._safe_div(rz_new, rz)
            p = _axpy(beta, p, z)
            zeta = (l + 1).astype(dt) * (Q1 - Q0) / Q1
            brk = zeta < sp["q_tolerance"].astype(dt)
            brk = jnp.logical_or(brk, rz_new <= rz_floor)
            return (delta, r, p, rz_new, Q1, l + 1, brk)

        def cond(carry):
            l, brk = carry[5], carry[6]
            return jnp.logical_and(l < sp["lIterations"], ~brk)

        delta, _r, _p, _rz, _Q, l_done, _brk = jax.lax.while_loop(
            cond,
            body,
            (delta0, r0, p0, rz0, Q0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.bool_)),
        )
        return delta, l_done

    def _lm_finish(self, state, fs, sp, X, delta, l_done, r_terms, J, SSq):
        """Ceres-style trust-region bookkeeping (t:1106-1164), shared by the
        dict and packed-kernel inner loops."""
        dt = self.compiled.dtype
        radius = state["trust_region_radius"].astype(dt)
        model_cost = fs.model_cost(X, r_terms, J, delta)
        prev_cost = state["prev_cost"].astype(dt)
        model_cost_change = prev_cost - model_cost

        X_new = {k: X[k] + delta[k] for k in X}
        new_cost = fs.cost(X_new)
        cost_change = prev_cost - new_cost
        relative_decrease = cost_change / model_cost_change

        accept = jnp.logical_and(
            cost_change >= 0, relative_decrease > sp["min_relative_decrease"].astype(dt)
        )
        func_tol = cost_change <= prev_cost * sp["function_tolerance"].astype(dt)

        # accepted branch
        min_factor = jnp.asarray(1.0 / 3.0, dt)
        # cube written explicitly: C pow(x,3.0) handles negative bases (odd
        # integer exponent), jnp.power with a float exponent would NaN.
        _t = 2.0 * relative_decrease - 1.0
        tmp_factor = 1.0 - _t * _t * _t
        radius_acc = radius / jnp.maximum(min_factor, tmp_factor)
        radius_acc = jnp.minimum(radius_acc, sp["max_trust_region_radius"].astype(dt))
        # on function_tolerance exit the reference returns before touching
        # prevCost/radius (t:1127-1132)
        radius_acc = jnp.where(func_tol, radius, radius_acc)
        cost_acc = jnp.where(func_tol, prev_cost, new_cost)

        # rejected branch (t:1144-1156)
        rdf = state["radius_decrease_factor"].astype(dt)
        radius_rej = radius / rdf
        min_radius_hit = radius_rej <= sp["min_trust_region_radius"].astype(dt)

        X_out = _where(accept, X_new, X)
        return {
            **state,
            "X": X_out,
            "SSq": SSq,
            "prev_cost": jnp.where(accept, cost_acc, prev_cost).astype(
                state["prev_cost"].dtype
            ),
            "trust_region_radius": jnp.where(accept, radius_acc, radius_rej).astype(
                state["trust_region_radius"].dtype
            ),
            "radius_decrease_factor": jnp.where(accept, jnp.asarray(2.0, dt), 2.0 * rdf),
            "done": jnp.where(accept, func_tol, min_radius_hit),
            "n_iter": state["n_iter"] + 1,
            "lin_iters": state["lin_iters"] + l_done,
        }

    # -- fused full solve --------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=(0, 6))
    def _solve_fused(self, X, consts, graphs, params, sp, max_iters: int):
        return self._solve_core(X, consts, graphs, params, sp, max_iters)

    @functools.partial(jax.jit, static_argnums=(0, 6, 7, 8))
    def _solve_fused_batched(
        self, X, consts, graphs, params, sp, max_iters: int,
        const_axes=(), param_axes=(),
    ):
        """vmapped full solve over a leading batch axis of unknowns; constant
        images/params are mapped (axis 0) or shared (None) per leaf, graph
        topology and solver parameters are shared.

        One XLA program solves the whole batch — the answer here to
        many-small-problems workloads (the reference runs them serially, one
        cudaLaunch stream per problem). Per-instance early exits are handled
        by the while_loop batching rule (finished instances stop updating)."""
        c_ax = dict(const_axes)
        p_ax = dict(param_axes)
        return jax.vmap(
            lambda Xi, ci, pi: self._solve_core(Xi, ci, graphs, pi, sp, max_iters),
            in_axes=(
                0,
                {k: c_ax.get(k) for k in consts},
                {k: p_ax.get(k) for k in params},
            ),
        )(X, consts, params)

    def _solve_core(self, X, consts, graphs, params, sp, max_iters: int):
        state = self._init_state(X, consts, graphs, params, sp)
        # history buffer must be non-empty even for nIterations=0: the loop
        # body is traced unconditionally and indexes it.
        costs = jnp.full((max(1, max_iters),), jnp.nan, self.compiled.dtype)

        # constant-slot assembly data, probed once at the initial X: closed
        # over by the loop body, so it enters the while_loop as an invariant
        # input — the per-step assemble probes only the varying slots.
        asm_cache = self._asm_cache(
            FunctionSet(self.compiled, consts, graphs, params, mesh=self._mesh()), X
        )

        def cond(carry):
            state, _ = carry
            return jnp.logical_and(
                ~state["done"], state["n_iter"] < sp["nIterations"]
            )

        def body(carry):
            state, costs = carry
            fs = FunctionSet(self.compiled, consts, graphs, params, mesh=self._mesh())
            new_state = (self._lm_step if self.uses_lambda else self._gn_step)(
                state, fs, sp, asm_cache
            )
            costs = costs.at[state["n_iter"]].set(new_state["prev_cost"])
            return new_state, costs

        state, costs = jax.lax.while_loop(cond, body, (state, costs))
        return state, costs

    def solve(self, X, consts, graphs, params, sp):
        """Full solve in one XLA program (Opt_ProblemSolve, o.t:2548-2551 —
        but without the reference's per-iteration host round-trips)."""
        max_iters = int(sp["nIterations"])
        return self._solve_fused(
            X, consts, graphs, params, self._traced_sp(sp), max_iters
        )
