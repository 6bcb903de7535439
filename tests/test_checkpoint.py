"""Checkpoint/resume: saving mid-solve and restoring into a fresh plan must
reproduce the uninterrupted solve bit-for-bit (state pytree round-trip)."""

import numpy as np
import pytest

import opt_tpu as ot
from opt_tpu.utils import checkpoint


def _laplacian(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))


def _run(plan, inputs, n_steps):
    plan.init(inputs)
    for _ in range(n_steps):
        plan.step()
    return plan


@pytest.mark.parametrize("use_orbax", [False, True])
def test_checkpoint_resume_matches_uninterrupted(tmp_path, use_orbax):
    n = 16
    rng = np.random.RandomState(0)
    inputs = {
        "X": rng.rand(n, n).astype(np.float32),
        "A": rng.rand(n, n).astype(np.float32),
    }
    mk = lambda: ot.Problem(_laplacian, kind="LMGPU").plan(
        dims={"W": n, "H": n}, nIterations=6, lIterations=10
    )

    # uninterrupted: 6 steps
    ref = _run(mk(), dict(inputs), 6)
    ref_x = np.asarray(ref.unknowns["X"])

    # interrupted: 3 steps, save, restore into a FRESH plan, 3 more
    half = _run(mk(), dict(inputs), 3)
    path = checkpoint.save(str(tmp_path / "ckpt"), half, use_orbax=use_orbax)

    fresh = mk()
    checkpoint.restore(path, fresh, inputs=dict(inputs))
    assert fresh.current_cost() == half.current_cost()
    for _ in range(3):
        fresh.step()

    np.testing.assert_array_equal(np.asarray(fresh.unknowns["X"]), ref_x)
    assert fresh.current_cost() == ref.current_cost()


def test_sharded_checkpoint_resume(tmp_path):
    """Multi-chip checkpoint/resume: save from a mesh plan mid-solve,
    restore into a fresh mesh plan, continue — matches the uninterrupted
    sharded solve, and restored unknowns come back owner/tile-sharded."""
    from opt_tpu.parallel.mesh import make_mesh

    n = 32
    rng = np.random.RandomState(0)
    inputs = {
        "X": rng.rand(n, n).astype(np.float32),
        "A": rng.rand(n, n).astype(np.float32),
    }
    mk = lambda: ot.Problem(_laplacian, kind="LMGPU").plan(
        dims={"W": n, "H": n}, mesh=make_mesh(),
        nIterations=6, lIterations=10,
    )
    ref = _run(mk(), dict(inputs), 6)
    ref_x = np.asarray(ref.unknowns["X"])

    half = _run(mk(), dict(inputs), 3)
    path = checkpoint.save(str(tmp_path / "ckpt_mesh"), half)
    fresh = mk()
    checkpoint.restore(path, fresh, inputs=dict(inputs))
    shard_shapes = {
        s.data.shape for s in fresh._state["X"]["X"].addressable_shards
    }
    assert len(shard_shapes) == 1 and (n, n, 1) not in shard_shapes, (
        "restored unknowns are replicated, not sharded"
    )
    for _ in range(3):
        fresh.step()
    np.testing.assert_array_equal(np.asarray(fresh.unknowns["X"]), ref_x)


def test_checkpoint_rejects_mismatched_plan(tmp_path):
    n = 16
    rng = np.random.RandomState(0)
    inputs = {
        "X": rng.rand(n, n).astype(np.float32),
        "A": rng.rand(n, n).astype(np.float32),
    }
    plan = ot.Problem(_laplacian).plan(dims={"W": n, "H": n}, nIterations=2)
    plan.init(dict(inputs))
    path = checkpoint.save(str(tmp_path / "c2"), plan, use_orbax=False)

    other = ot.Problem(_laplacian).plan(dims={"W": 8, "H": 8})
    with pytest.raises(ValueError):
        checkpoint.restore(path, other)


def test_restore_fresh_plan_without_inputs_raises(tmp_path):
    """Regression: restoring into a fresh plan without inputs
    left plan._bound None, so the documented step() resume crashed with a
    TypeError deep in the solver. It must fail fast with the remedy."""
    n = 8
    rng = np.random.RandomState(3)
    inputs = {
        "X": rng.rand(n, n).astype(np.float32),
        "A": rng.rand(n, n).astype(np.float32),
    }
    plan = ot.Problem(_laplacian).plan(dims={"W": n, "H": n}, nIterations=2)
    plan.init(dict(inputs))
    plan.step()
    path = checkpoint.save(str(tmp_path / "c3"), plan, use_orbax=False)

    fresh = ot.Problem(_laplacian).plan(dims={"W": n, "H": n}, nIterations=2)
    with pytest.raises(RuntimeError, match="inputs"):
        checkpoint.restore(path, fresh)
    # with inputs the same restore succeeds and steps
    checkpoint.restore(path, fresh, inputs=dict(inputs))
    fresh.step()
