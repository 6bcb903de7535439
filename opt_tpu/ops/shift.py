"""Zero-padded stencil shifts on grid images and their adjoints.

These replace the reference's per-thread offset indexing + zero-padding
``Image:get`` (reference: API/src/o.t:570-576) and its bindless-texture
gathers (o.t:469-501): stencil reads become whole-array pad+slice ops that
XLA fuses and, under a sharded mesh, lowers to halo exchanges (collective
permutes) automatically.

Conventions
-----------
``shift(img, off)[q] = img[q + off]`` when ``q + off`` is in bounds, else 0.
The adjoint (transpose) of ``shift(. , off)`` is ``shift(. , -off)`` because
out-of-bounds reads produce zeros and out-of-range writes are dropped.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
from jax import lax


def shift(img: jnp.ndarray, off: Sequence[int]) -> jnp.ndarray:
    """Shifted zero-padded view: result[q] = img[q + off] (0 if out of bounds).

    ``img`` has shape [*spatial, C]; ``off`` has one entry per spatial dim.
    """
    off = tuple(int(o) for o in off)
    if all(o == 0 for o in off):
        return img
    nsp = len(off)
    if img.ndim < nsp:
        raise ValueError(f"image rank {img.ndim} < spatial rank {nsp}")
    # Pad so that the slice below never leaves the array, then take a
    # same-sized window displaced by `off`. lax.pad+lax.slice fuse in XLA and
    # shard cleanly (halo exchange) under SPMD.
    pad_cfg = []
    starts = []
    for d in range(img.ndim):
        if d < nsp:
            o = off[d]
            lo = max(0, -o)
            hi = max(0, o)
            pad_cfg.append((lo, hi, 0))
            starts.append(lo + o)  # == max(0, o)
        else:
            pad_cfg.append((0, 0, 0))
            starts.append(0)
    padded = lax.pad(img, jnp.zeros((), img.dtype), pad_cfg)
    limits = [s + n for s, n in zip(starts, img.shape)]
    return lax.slice(padded, starts, limits)


def shift_adjoint(field: jnp.ndarray, off: Sequence[int]) -> jnp.ndarray:
    """Adjoint of :func:`shift`: scatter ``field`` back by ``off``."""
    return shift(field, tuple(-int(o) for o in off))


def in_bounds_mask(
    spatial_shape: Tuple[int, ...], off: Sequence[int], expand: int = 0, dtype=jnp.bool_
) -> jnp.ndarray:
    """Mask[q] = all coordinates of q+off lie within bounds shrunk by `expand`.

    Equivalent of the reference's ``InBounds``/``InBoundsExpanded``
    (o.t:388-410): with expand=e, requires e <= q_d + off_d < size_d - e for
    every spatial dim d. Returns shape [*spatial, 1] for clean broadcasting
    against [*spatial, C] residual values.
    """
    off = tuple(int(o) for o in off)
    mask = None
    for d, (n, o) in enumerate(zip(spatial_shape, off)):
        idx_shape = [1] * (len(spatial_shape) + 1)
        idx_shape[d] = n
        coords = lax.broadcasted_iota(jnp.int32, tuple(idx_shape), d)
        ok = (coords + o >= expand) & (coords + o < n - expand)
        mask = ok if mask is None else (mask & ok)
    return mask.astype(dtype)


def bbox_mask(
    spatial_shape: Tuple[int, ...],
    bmin: Sequence[int],
    bmax: Sequence[int],
    dtype=jnp.bool_,
) -> jnp.ndarray:
    """Mask[q] = q+s in bounds for every offset s in the bbox [bmin, bmax].

    This implements the reference's automatic out-of-bounds residual zeroing
    (o.t:1930-1933 ``ad.select(bbox,exp,0)`` with the bbox from
    ``bboxforexpression``, o.t:985-1005).
    """
    mask = None
    for d, n in enumerate(spatial_shape):
        idx_shape = [1] * (len(spatial_shape) + 1)
        idx_shape[d] = n
        coords = lax.broadcasted_iota(jnp.int32, tuple(idx_shape), d)
        ok = (coords + int(bmin[d]) >= 0) & (coords + int(bmax[d]) < n)
        mask = ok if mask is None else (mask & ok)
    return mask.astype(dtype)


def coordinate_field(spatial_shape: Tuple[int, ...], axis: int, dtype) -> jnp.ndarray:
    """Pixel-coordinate field along `axis` (reference ``Index(d)``, lib.t).

    Shape [*spatial, 1].
    """
    idx_shape = tuple(spatial_shape) + (1,)
    return lax.broadcasted_iota(jnp.int32, idx_shape, axis).astype(dtype)
