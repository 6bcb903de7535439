"""Named problem dimensions and index spaces.

Analogue of the reference's ``opt.Dim`` / ``IndexSpace``
(reference: API/src/o.t:320-434). In the reference, dimension sizes are baked
into generated PTX at plan time (``opt.dimensions[idx]``, o.t:320-324) and any
size change forces a full Terra->PTX recompile. Here a :class:`Dim` is a pure
name; concrete sizes are bound per-plan and jit caching by shape replaces the
reference's per-size recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Dim:
    """A named problem dimension (reference: ``Dim("W",0)``, o.t:320-324).

    The reference binds each Dim positionally to the ``dims[]`` array passed to
    ``Opt_ProblemPlan``; we bind by name via ``Problem.plan(dims={...})``.
    """

    name: str

    def __repr__(self) -> str:
        return f"Dim({self.name})"


class IndexSpace:
    """An N-d rectangular index space: an ordered tuple of Dims.

    Mirrors the reference's ``IndexSpace`` (o.t:326-434) minus the CUDA
    threadIdx mapping, which has no analogue here: element parallelism is
    expressed as whole-array ops that XLA tiles onto the device.
    """

    def __init__(self, dims: Tuple[Dim, ...]):
        if not all(isinstance(d, Dim) for d in dims):
            raise TypeError(f"IndexSpace dims must be Dim instances, got {dims}")
        self.dims = tuple(dims)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def shape(self, dim_sizes: dict) -> Tuple[int, ...]:
        """Concrete spatial shape given a {dim-name: size} binding."""
        missing = [d.name for d in self.dims if d.name not in dim_sizes]
        if missing:
            raise KeyError(f"no size bound for dims {missing}")
        return tuple(int(dim_sizes[d.name]) for d in self.dims)

    def __eq__(self, other):
        return isinstance(other, IndexSpace) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return "IndexSpace(" + ",".join(d.name for d in self.dims) + ")"


def as_ispace(dims) -> IndexSpace:
    if isinstance(dims, IndexSpace):
        return dims
    if isinstance(dims, Dim):
        return IndexSpace((dims,))
    return IndexSpace(tuple(dims))
