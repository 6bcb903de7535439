"""Checkpoint / resume for solver state.

The reference has no in-library checkpointing (SURVEY §5): its stepwise API
(Opt_ProblemInit / Opt_ProblemStep, Opt.h:59-66) only lets the host inspect
unknowns between outer iterations, and im.t offers a raw image dump. For a
multi-host deployment, long solves (or outer schedules such as pyramids
and constraint annealing) need real save/restore, so this module provides it
natively:

* ``save(path, plan)`` / ``restore(path, plan)`` — the full solver state
  pytree (unknowns, trust-region state, iteration counters) plus the solver
  parameters, written with orbax-checkpoint when available and a portable
  npz fallback otherwise. Restoring into a freshly constructed plan resumes
  ``plan.step()`` exactly where the saved solve left off.
* Sharded arrays round-trip through orbax (per-host shards); the npz
  fallback gathers to host.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

try:  # orbax is in the base image; gate anyway for portability
    import orbax.checkpoint as ocp

    _HAVE_ORBAX = True
except Exception:  # pragma: no cover
    _HAVE_ORBAX = False


_META_NAME = "opt_tpu_meta.json"
_STATE_NAME = "state.npz"


def _meta(plan) -> Dict[str, Any]:
    return {
        "problem": plan.problem.name,
        "kind": plan.kind,
        "dims": plan.compiled.dim_sizes,
        "solver_params": {k: v for k, v in plan.solver_params.items()},
        "version": 1,
    }


def _check_meta(meta: Dict[str, Any], plan) -> None:
    if meta["dims"] != plan.compiled.dim_sizes:
        raise ValueError(
            f"checkpoint dims {meta['dims']} != plan dims {plan.compiled.dim_sizes}"
        )
    if meta["kind"].lower() != plan.kind.lower():
        raise ValueError(f"checkpoint kind {meta['kind']} != plan kind {plan.kind}")


def save(path: str, plan, use_orbax: Optional[bool] = None) -> str:
    """Write the plan's current solver state (after init()/step()/solve())."""
    if plan._state is None:
        raise RuntimeError("nothing to checkpoint: call init() or solve() first")
    if use_orbax is None:
        use_orbax = _HAVE_ORBAX
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _META_NAME), "w") as f:
        json.dump(_meta(plan), f)
    if use_orbax and _HAVE_ORBAX:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.join(path, "state"), plan._state, force=True)
        ckptr.wait_until_finished()
    else:
        flat = {}
        leaves, treedef = jax.tree.flatten_with_path(plan._state)
        for kp, leaf in leaves:
            flat[jax.tree_util.keystr(kp)] = np.asarray(leaf)
        np.savez(os.path.join(path, _STATE_NAME), **flat)
    return path


def restore(path: str, plan, inputs: Optional[Dict[str, Any]] = None):
    """Load a checkpoint into `plan`, rebinding `inputs` (problem constants)
    if given. Returns the restored state pytree."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META_NAME)) as f:
        meta = json.load(f)
    _check_meta(meta, plan)
    if inputs is not None:
        unknowns, consts, graphs, params = plan._normalize_and_place(inputs)
        plan._bound = (consts, graphs, params)
    elif plan._bound is None:
        # a fresh plan has no bound constants; stepping would crash deep in
        # the solver unpacking None — fail here with the remedy.
        raise RuntimeError(
            "restore() into a freshly constructed plan requires the problem "
            "inputs: checkpoints persist solver state (unknowns, trust "
            "region, counters) but not the constant images/graphs/params; "
            "pass restore(path, plan, inputs=...) to rebind them"
        )

    orbax_dir = os.path.join(path, "state")
    if _HAVE_ORBAX and os.path.isdir(orbax_dir):
        # restore with the current state's structure when available, else raw
        if plan._state is not None:
            target = jax.tree.map(ocp.utils.to_shape_dtype_struct, plan._state)
            state = ocp.StandardCheckpointer().restore(orbax_dir, target)
        else:
            state = ocp.StandardCheckpointer().restore(orbax_dir)
            state = jax.tree.map(jnp.asarray, state)
    else:
        data = np.load(os.path.join(path, _STATE_NAME))
        # reconstruct the (flat string key -> array) dict into the state dict;
        # solver state is a flat dict of arrays and sub-dicts of arrays.
        state: Dict[str, Any] = {}
        for key, arr in data.items():
            parts = [p for p in key.replace("[", "]").split("]") if p]
            parts = [p.strip("'\"") for p in parts]
            d = state
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = jnp.asarray(arr)
    if plan.rules is not None and plan.rules.mesh is not None:
        # mesh plans: place unknown-shaped state with its owner/tile
        # shardings so resumed solves start sharded instead of paying a
        # reshard (scalars replicate implicitly)
        for k in ("X", "SSq"):
            if isinstance(state.get(k), dict):
                state[k] = {
                    name: jax.device_put(
                        arr,
                        plan.rules.image_sharding(
                            plan.compiled.registry.images[name].ispace.ndim,
                            arr.shape,
                        ),
                    )
                    for name, arr in state[k].items()
                }
    plan._state = state
    plan.solver_params = dict(plan.solver_params, **meta["solver_params"])
    return state
