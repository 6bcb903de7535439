"""Multi-host initialization glue.

The reference is single-process (SURVEY §2.4); scaling opt_tpu beyond one
host uses jax.distributed: every host runs the same program, sees the global
device set, and the solver's sharded arrays span hosts transparently (XLA
inserts the collectives, NCCL on GPUs). This module is the thin, idempotent
bootstrap.

Typical use (one process per host; pass the coordinator explicitly where
no cluster environment describes it):

    import opt_tpu.parallel.distributed as dist
    dist.initialize(coordinator_address="host0:1234",
                    num_processes=2, process_id=0)
    mesh = make_mesh()                      # all global devices
    plan = problem.plan(dims=..., mesh=mesh)

On CPU test rigs, pass coordinator_address/num_processes/process_id
explicitly, or simulate multi-device single-host with
XLA_FLAGS=--xla_force_host_platform_device_count=N (what tests/ do).
"""

from __future__ import annotations

from typing import Optional

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Idempotent jax.distributed.initialize; returns True if running
    multi-process after the call (False for the single-process case)."""
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
        _initialized = True
    except (ValueError, RuntimeError):
        # single-process (no cluster env detected and no explicit address)
        _initialized = True
    return jax.process_count() > 1


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0
