"""What running on the card depends on, checked on the CPU: the persistent
compile cache's directory, the smoke script's refusal to run without a GPU,
and the precision of every float32 contraction on the solve path (a
default-precision dot may run as TF32 on the H100 and lose digits)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import opt_tpu as ot
from jax.extend.core import ClosedJaxpr, Jaxpr
from opt_tpu.models.specs import arap_mesh_deformation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_extra, drop=()):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra)
    out = subprocess.run(
        [sys.executable, "-c",
         "import opt_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_fixed_path_in_checkout():
    got = _cache_dir({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == os.path.join(REPO, ".jax_cache")
    assert ot.CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_compile_cache_env_variable_wins(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=120, env=env, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=120, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# float32 contractions: none may run at default precision
# ---------------------------------------------------------------------------

_HIGHEST = jax.lax.Precision.HIGHEST


def _contractions(jaxpr):
    """(primitive name, precision) of every dot in a jaxpr, sub-jaxprs
    included."""
    found = []
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "bcoo_dot_general"):
            found.append((name, eqn.params.get("precision")))
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, ClosedJaxpr):
                    found += _contractions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    found += _contractions(sub)
    return found


def _at_default_precision(found):
    bad = []
    for name, prec in found:
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        if name != "dot_general" or any(p != _HIGHEST for p in precs):
            bad.append((name, prec))
    return bad


def _two_space(S):
    """Unknowns in two vertex spaces coupled through one hyperedge: the
    assembled apply's cross-group (pair) blocks."""
    N, U = S.Dim("N"), S.Dim("U")
    a = S.Unknown("a", 2, (N,))
    b = S.Unknown("b", 2, (U,))
    t = S.Image("t", 2, (N,))
    G = S.Graph("G", d=(N,), p=(U,))
    S.Energy(a(G.d) - b(G.p) - t(G.d))


def _step_jaxpr(spec, dims, inputs, **ip):
    plan = ot.Problem(spec).plan(
        dims=dims, init_params=ot.InitializationParameters(**ip)
    )
    u, c, g, pa = plan._normalize_and_place(dict(inputs))
    sp = plan.solver._traced_sp(plan.solver_params)
    state = plan.solver._init_state(u, c, g, pa, sp)
    return jax.make_jaxpr(plan.solver._step)(state, c, g, pa, sp).jaxpr


def _arap_inputs(N=12):
    pos = np.random.RandomState(0).rand(N, 3).astype(np.float32)
    v0 = np.arange(N, dtype=np.int32)
    con = -np.ones((N, 3), np.float32)
    con[0] = pos[0]
    return {"N": N}, {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), np.float32),
        "UrShape": pos, "Constraints": con,
        "G": {"v0": v0, "v1": (v0 + 1) % N},
        "w_fitSqrt": np.float32(1.0), "w_regSqrt": np.float32(1.0),
    }


def _contraction_case(name):
    x3 = jnp.ones((5, 3), jnp.float32)
    if name == "Rotate3D":
        return jax.make_jaxpr(ot.Rotate3D)(x3, x3).jaxpr
    if name == "Matrix3x3Mul":
        return jax.make_jaxpr(ot.Matrix3x3Mul)(
            jnp.ones((5, 9), jnp.float32), x3
        ).jaxpr
    if name == "graph_apply":
        dims, inputs = _arap_inputs()
        return _step_jaxpr(arap_mesh_deformation, dims, inputs)
    if name == "graph_pair_apply":
        N, U = 10, 4
        rng = np.random.RandomState(1)
        inputs = {
            "a": rng.rand(N, 2).astype(np.float32),
            "b": rng.rand(U, 2).astype(np.float32),
            "t": rng.rand(N, 2).astype(np.float32),
            "G": {"d": np.arange(N, dtype=np.int32),
                  "p": (np.arange(N) % U).astype(np.int32)},
        }
        return _step_jaxpr(_two_space, {"N": N, "U": U}, inputs)
    if name == "explicit_jtj":
        dims, inputs = _arap_inputs()
        return _step_jaxpr(arap_mesh_deformation, dims,
                           inputs, use_explicit_jtj=True)
    raise AssertionError(name)


@pytest.mark.parametrize(
    "name",
    ["Rotate3D", "Matrix3x3Mul", "graph_apply", "graph_pair_apply",
     "explicit_jtj"],
)
def test_contractions_state_full_precision(name):
    """Every dot on these paths is either gone (a multiply-sum) or asks for
    HIGHEST precision explicitly."""
    found = _contractions(_contraction_case(name))
    assert not _at_default_precision(found), found
