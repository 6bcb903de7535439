"""The energy DSL: spec tracing, accessors, and slot recording.

This is the replacement for the reference's Lua-embedded DSL
front-end + symbolic CAS (reference: API/src/lib.t, API/src/ad.t,
API/src/o.t:930-1057 ``ProblemSpecAD``). Instead of building a hash-consed
expression DAG and symbolically differentiating it (ad.t:612-660), a user spec
is a plain Python function that is *re-executed* under JAX tracing; accessor
calls like ``X(0, 0)`` return real ``jnp`` arrays (zero-padded shifted views /
edge gathers) and all arithmetic is ordinary ``jnp`` arithmetic. JAX's
``vjp``/``linearize``/``linear_transpose`` then provide the matrix-free JᵀF and
JᵀJ·p that the reference derives symbolically (o.t:2029-2172).

The spec function runs under three interchangeable accessor backends:

* ``field`` — accessors return whole-image shifted/gathered arrays. Used for
  cost, residuals, JᵀF (vjp) and JᵀJ·p (linearize + transpose).
* ``discover`` — an eager first pass that records declarations and assigns a
  stable *slot* to every distinct (image, offset-or-graph-slot) access.
* ``slots`` — accessors return entries of a slot-value list. The resulting
  ``local_F(slot_values)`` is *pointwise* over the domain (all spatial/graph
  interaction goes through the accessors, exactly the invariant the reference
  DSL enforces), which lets us compute the exact Jacobi preconditioner
  diagonal Σ(∂r/∂x)² with one one-hot jvp probe per (slot, channel) — the
  probe analogue of the reference's symbolic ``createjtfcentered`` square
  accumulation (o.t:2129-2172).

Spec functions must be deterministic across re-execution (same declarations,
same Energy calls in the same order) — the same constraint jit already places
on traced Python.

Select semantics match the reference's condition blocks (o.t:1634-1650):
``lib.Select`` uses the double-``where`` form, so the untaken branch
contributes neither values nor gradients and non-finite sentinels (±inf, as
the reference apps use for invalid constraints) are safe.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .dims import Dim, IndexSpace, as_ispace
from .ops.graph_ops import edge_gather
from .ops.sampling import central_difference_images, sample_with_derivs
from .ops.shift import coordinate_field, in_bounds_mask, shift


class SpecError(Exception):
    pass


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

UNKNOWN = "unknown"
ARRAY = "array"


@dataclasses.dataclass
class ImageDecl:
    """An image (grid or per-vertex) parameter.

    Mirrors the reference's ``ProblemSpec:Image/:Unknown`` (o.t:946-958). The
    positional binding index of the reference is replaced by name binding.
    """

    name: str
    channels: int
    ispace: IndexSpace
    kind: str  # UNKNOWN or ARRAY
    # Const view of an unknown: reads the unknown's *current* values but
    # carries no gradient. The reference achieves this by binding an Array to
    # the unknown's buffer (intrinsic_image_decomposition.t: r_const shares
    # r's binding index); here it is explicit via Array(..., alias="r").
    alias: Optional[str] = None


@dataclasses.dataclass
class GraphDecl:
    """A hyperedge set (reference ``ProblemSpec:Graph``, o.t:818-834).

    ``slots`` maps vertex-slot name -> IndexSpace the slot indexes into.
    """

    name: str
    slots: Dict[str, IndexSpace]


@dataclasses.dataclass
class ParamDecl:
    name: str


@dataclasses.dataclass(frozen=True)
class GraphSlotRef:
    graph: str
    slot: str


# ---------------------------------------------------------------------------
# Slot keys: the unit of access recording
# ---------------------------------------------------------------------------
# ('img',  image_name, offsets)            grid access at stencil offset
# ('gimg', image_name, graph, slot)        graph access at edge endpoint
# ('bounds', ispace_key, offsets, expand)  InBounds/InBoundsExpanded mask


def _img_key(name: str, off: Tuple[int, ...]):
    return ("img", name, off)


def _gimg_key(name: str, graph: str, slot: str):
    return ("gimg", name, graph, slot)


def _bounds_key(ispace_key, off, expand):
    return ("bounds", ispace_key, off, expand)


@dataclasses.dataclass
class SlotInfo:
    key: tuple
    image: Optional[str]  # image name for img/gimg slots
    kind: str  # 'img' | 'gimg' | 'bounds'
    ispace: IndexSpace  # domain the *slot value field* lives on (grid ispace
    # for img/bounds; the *edge* domain marker for gimg)
    graph: Optional[str]
    offset: Optional[Tuple[int, ...]]  # for img/bounds
    expand: int
    channels: int
    is_unknown: bool
    # True for bounds gates the framework inserted itself (ComputedArray
    # border zeroing); user InBounds accesses reset this to False.
    internal: bool = False


@dataclasses.dataclass
class EnergyTerm:
    index: int
    # filled by dependence analysis in compile.py:
    domain: Any = None  # ('centered', IndexSpace) | ('graph', graph_name)
    slot_ids: Tuple[int, ...] = ()
    uses_bounds: bool = False
    bbox: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None  # (bmin, bmax)
    channels: int = 1


@dataclasses.dataclass
class ExcludeTerm:
    index: int
    ispace: Optional[IndexSpace] = None
    slot_ids: Tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Builder context (for the module-level DSL functions in lib.py)
# ---------------------------------------------------------------------------

_BUILDER_STACK: List["SpecBuilder"] = []


def current_builder() -> "SpecBuilder":
    if not _BUILDER_STACK:
        raise SpecError(
            "this DSL function may only be used while a spec function is being traced"
        )
    return _BUILDER_STACK[-1]


# ---------------------------------------------------------------------------
# Handles returned to user spec code
# ---------------------------------------------------------------------------


class ImageHandle:
    def __init__(self, builder: "SpecBuilder", decl: ImageDecl):
        self._b = builder
        self.decl = decl

    @property
    def name(self):
        return self.decl.name

    @property
    def channels(self):
        return self.decl.channels

    def __call__(self, *index):
        return self._b._access_image(self.decl, index)


class GraphHandle:
    def __init__(self, decl: GraphDecl):
        self._decl = decl

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        if item not in self._decl.slots:
            raise SpecError(f"graph {self._decl.name} has no slot {item!r}")
        return GraphSlotRef(self._decl.name, item)


class ComputedHandle:
    """A precomputed array (reference ``ComputedArray``, o.t:1007-1040).

    ``fn`` is a zero-argument closure building the per-element expression from
    accessors. In field mode the array is materialized once per trace and
    shifted reads are zero-padded shifts of the materialized field — matching
    the reference's per-iteration ``precompute`` scatter (o.t:2387-2409). In
    slot mode the access reads a precomputed VALUE slot plus stored
    per-unknown GRADIENT slots (compile._computed_bundle), exactly the
    reference's ComputedImage value + gradient images (o.t:1007-1040) — so
    jvp probes chain through the stored gradients instead of re-evaluating
    the expression per probe. Nested ComputedArrays fall back to inlining
    with composed offsets.
    """

    def __init__(self, builder: "SpecBuilder", name: str, ispace: IndexSpace, fn):
        self._b = builder
        self.name = name
        self.ispace = ispace
        self.fn = fn

    def __call__(self, *off):
        return self._b._access_computed(self, tuple(int(o) for o in off))


class SampledImageHandle:
    """Bilinear-sampled 2D image with user derivative images.

    Reference: ``ad.sampledimage`` (o.t:2486-2501).
    """

    def __init__(self, builder, image: ImageHandle, dx: Optional[ImageHandle], dy):
        self._b = builder
        self.image = image
        self.dx = dx
        self.dy = dy

    def __call__(self, x, y):
        return self._b._access_sampled(self, x, y)


# ---------------------------------------------------------------------------
# The builder
# ---------------------------------------------------------------------------


class SpecBuilder:
    """Executes a user spec function under one of three accessor backends."""

    def __init__(
        self,
        mode: str,
        dim_sizes: Dict[str, int],
        dtype,
        registry: Optional["SpecRegistry"] = None,
        bindings: Optional[Dict[str, Any]] = None,
        slot_values: Optional[Sequence[Any]] = None,
    ):
        assert mode in ("discover", "field", "slots")
        self.mode = mode
        # held by reference: wildcard ("*") probes fill in dim sizes during
        # discovery and later passes must see them
        self.dim_sizes = dim_sizes
        self.dtype = dtype
        self.registry = registry if registry is not None else SpecRegistry()
        self.bindings = bindings or {}
        self.slot_values = list(slot_values) if slot_values is not None else None

        self.energy_values: List[Any] = []
        self.exclude_values: List[Any] = []
        self._computed_cache: Dict[str, Any] = {}
        self._offset_ctx: List[Tuple[int, ...]] = []
        self._dims_seen: Dict[str, Dim] = {}
        # active while recording a ComputedArray expression's unknown reads
        # (discover mode only): list of (image, composed_offset, channels)
        self._recording: Optional[List[tuple]] = None
        self._rec_bailed = False

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        _BUILDER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _BUILDER_STACK.pop()
        return False

    # -- declarations --------------------------------------------------------
    def Dim(self, name: str, index: Optional[int] = None) -> Dim:
        # `index` accepted for reference-spec portability; binding is by name.
        del index
        d = self._dims_seen.get(name)
        if d is None:
            d = Dim(name)
            self._dims_seen[name] = d
            if name not in self.registry.dim_order:
                self.registry.dim_order.append(name)
            if name not in self.dim_sizes:
                # "*" wildcard: probe compiles (native bridge dim-order
                # discovery) bind every dim to a default size
                if "*" in self.dim_sizes:
                    self.dim_sizes[name] = int(self.dim_sizes["*"])
                else:
                    raise SpecError(
                        f"no size bound for Dim({name!r}); pass dims={{...}} to plan()"
                    )
        return d

    def Unknown(self, name, channels, dims, index=None) -> ImageHandle:
        return self._declare_image(name, channels, dims, UNKNOWN)

    def Array(self, name, channels, dims, index=None, alias=None) -> ImageHandle:
        return self._declare_image(name, channels, dims, ARRAY, alias=alias)

    # reference alias (Image == non-unknown input image, o.t:946-958)
    Image = Array

    def _declare_image(self, name, channels, dims, kind, alias=None) -> ImageHandle:
        ispace = as_ispace(dims)
        decl = self.registry.declare_image(name, int(channels), ispace, kind, alias)
        return ImageHandle(self, decl)

    def Graph(self, name: str, *slot_pairs, **slot_kwargs) -> GraphHandle:
        """Declare a hyperedge set: ``Graph("G", v0=(N,), v1=(N,))``.

        Also accepts reference-style positional pairs
        ``Graph("G", "v0", (N,), "v1", (N,))`` (integer binding indices from
        reference specs are skipped if present).
        """
        slots: Dict[str, IndexSpace] = {}
        items = [a for a in slot_pairs if not isinstance(a, int)]
        i = 0
        while i < len(items):
            sname = items[i]
            if not isinstance(sname, str):
                raise SpecError(f"expected slot name string, got {sname!r}")
            ispace = as_ispace(items[i + 1])
            slots[sname] = ispace
            i += 2
        for sname, dims in slot_kwargs.items():
            slots[sname] = as_ispace(dims)
        decl = self.registry.declare_graph(name, slots)
        return GraphHandle(decl)

    def Param(self, name: str, typ=None, index=None):
        """A named scalar parameter (reference ``:Param``, o.t:1055)."""
        self.registry.declare_param(name)
        if self.mode == "field" or self.slot_values is not None:
            params = self.bindings.get("params", {})
            if name in params:
                v = params[name]
                return jnp.asarray(v, self.dtype) if not isinstance(v, jnp.ndarray) else v
        return jnp.ones((), self.dtype)

    def ComputedArray(self, name: str, dims, fn: Callable[[], Any]) -> ComputedHandle:
        return ComputedHandle(self, name, as_ispace(dims), fn)

    def SampledImage(self, image: ImageHandle, dx=None, dy=None) -> SampledImageHandle:
        if image.decl.ispace.ndim != 2:
            raise SpecError("sampled images must be 2D (reference o.t:2481)")
        return SampledImageHandle(self, image, dx, dy)

    # -- spec-level switches --------------------------------------------------
    def UsePreconditioner(self, flag: bool):
        self.registry.use_preconditioner = bool(flag)

    def Exclude(self, cond):
        """Freeze unknowns where cond holds (reference :Exclude, o.t:2462-2465)."""
        cond = jnp.asarray(cond)
        if cond.dtype != jnp.bool_:
            cond = cond != 0
        self.exclude_values.append(cond)
        self.registry.note_exclude(len(self.exclude_values) - 1)

    def Energy(self, *terms):
        for t in terms:
            t = jnp.asarray(t, self.dtype)
            self.energy_values.append(t)
            self.registry.note_energy(len(self.energy_values) - 1)

    # -- bounds / coordinates --------------------------------------------------
    def InBounds(self, *off):
        return self._bounds(tuple(int(o) for o in off), expand=0)

    def InBoundsExpanded(self, *args):
        *off, expand = args
        return self._bounds(tuple(int(o) for o in off), expand=int(expand))

    def _bounds(self, off: Tuple[int, ...], expand: int, internal: bool = False):
        """internal=True marks gates the framework inserts itself (ComputedArray
        border zeroing); those must not count as a user InBounds, which would
        disable the automatic bbox mask (reference o.t:1930-1933 rule)."""
        off = self._compose(off)
        ispace = self._grid_ispace_for_ndim(len(off))
        shape = ispace.shape(self.dim_sizes)
        key = _bounds_key(ispace.dims, off, expand)
        # Bounds masks are float 0/1 fields in every mode so they can ride the
        # slot machinery (jvp probes need inexact inputs) — combine with
        # ot.And/Or/Not or multiplication, as reference specs do.
        if self.mode == "field":
            return in_bounds_mask(shape, off, expand, dtype=self.dtype)
        sid = self.registry.slot_for(
            key,
            lambda: SlotInfo(
                key=key, image=None, kind="bounds", ispace=ispace, graph=None,
                offset=off, expand=expand, channels=1, is_unknown=False,
                internal=internal,
            ),
            self.mode,
        )
        if not internal:
            self.registry.slots[sid].internal = False
        if self.mode == "slots":
            return self.slot_values[sid]
        return jnp.ones(shape + (1,), self.dtype)

    def Index(self, axis: int, dims=None):
        ispace = as_ispace(dims) if dims is not None else self._grid_ispace_for_ndim(None)
        shape = ispace.shape(self.dim_sizes)
        f = coordinate_field(shape, int(axis), self.dtype)
        if self._offset_ctx:
            off = self._compose(tuple([0] * len(shape)))
            f = f + jnp.asarray(off[int(axis)], self.dtype)
        return f

    # -- access implementation -------------------------------------------------
    def _compose(self, off: Tuple[int, ...]) -> Tuple[int, ...]:
        for ctx in reversed(self._offset_ctx):
            if len(ctx) != len(off):
                raise SpecError("offset rank mismatch inside ComputedArray")
            off = tuple(a + b for a, b in zip(off, ctx))
        return off

    def _grid_ispace_for_ndim(self, ndim: Optional[int]) -> IndexSpace:
        cands = [
            d.ispace
            for d in self.registry.images.values()
            if (ndim is None or d.ispace.ndim == ndim)
        ]
        uniq = []
        for c in cands:
            if c not in uniq:
                uniq.append(c)
        if len(uniq) != 1:
            raise SpecError(
                f"cannot infer index space (candidates: {uniq}); pass dims= explicitly"
            )
        return uniq[0]

    def _access_image(self, decl: ImageDecl, index):
        if len(index) == 1 and isinstance(index[0], GraphSlotRef):
            return self._access_image_graph(decl, index[0])
        off = tuple(int(o) for o in index)
        if len(off) != decl.ispace.ndim:
            raise SpecError(
                f"{decl.name}: expected {decl.ispace.ndim} offsets, got {len(off)}"
            )
        off = self._compose(off)
        key = _img_key(decl.name, off)
        shape = decl.ispace.shape(self.dim_sizes) + (decl.channels,)
        if self._recording is not None and decl.kind == UNKNOWN and decl.alias is None:
            self._recording.append((decl.name, off, decl.channels))
        if self.mode == "field":
            # computed-gradient probing (compile._computed_bundle): unknown
            # reads at substituted offsets come from the probe inputs so
            # jax.linearize separates per-offset gradient fields
            subs = self.bindings.get("computed_subs")
            if (
                subs is not None
                and decl.kind == UNKNOWN
                and decl.alias is None
            ):
                hit = subs.get((decl.name, off))
                if hit is not None:
                    return hit
            arr = self._bound_image(decl)
            return shift(arr, off)
        sid = self.registry.slot_for(
            key,
            lambda: SlotInfo(
                key=key, image=decl.name, kind="img", ispace=decl.ispace, graph=None,
                offset=off, expand=0, channels=decl.channels,
                is_unknown=decl.kind == UNKNOWN,
            ),
            self.mode,
        )
        if self.mode == "slots":
            return self.slot_values[sid]
        return jnp.ones(shape, self.dtype)

    def _access_image_graph(self, decl: ImageDecl, ref: GraphSlotRef):
        if decl.ispace.ndim != 1:
            raise SpecError("graph-accessed images must live on a 1-D index space")
        key = _gimg_key(decl.name, ref.graph, ref.slot)
        if self.mode == "field":
            mesh = self.bindings.get("mesh")
            if mesh is not None:
                # sharded solves: per-edge vertex reads ride the bind-time
                # neighbor exchange (boundary-sized all_to_all) instead of
                # a take that all-gathers the vertex array; its linearize/
                # transpose give the exchanged JᵀF scatter for free. All
                # images registered at this (graph, slot) share ONE
                # exchange (collective latency is per-op), memoized for
                # this builder run.
                got = self._grouped_halo_read(decl, ref)
                if got is not None:
                    return got
            arr = self._bound_image(decl)
            idx = self._bound_graph_index(ref)
            return edge_gather(arr, idx)
        sid = self.registry.slot_for(
            key,
            lambda: SlotInfo(
                key=key, image=decl.name, kind="gimg", ispace=decl.ispace,
                graph=ref.graph, offset=None, expand=0, channels=decl.channels,
                is_unknown=decl.kind == UNKNOWN,
            ),
            self.mode,
        )
        if self.mode == "slots":
            return self.slot_values[sid]
        E0 = self.registry.dummy_edge_count
        return jnp.ones((E0, decl.channels), self.dtype)

    def _grouped_halo_read(self, decl, ref):
        """Exchange-served read for field mode under a mesh: one all_to_all
        per (graph, slot), channel-stacking every image the registry knows
        is read there (discovery registered them at compile), memoized per
        builder run. None when the exchange tables are absent (odd sizes)."""
        from .parallel.mesh import grouped_slot_halo_gather

        import numpy as _np

        memo = self.__dict__.setdefault("_halo_memo", {})
        gkey = (ref.graph, ref.slot)
        if gkey not in memo:
            # the exchange tables were built for the SLOT's vertex count;
            # images on a different-sized 1-D space (legal — edge_gather
            # just takes) must fall back to the take, or the localized ids
            # would silently read wrong rows
            slot_n = int(
                _np.prod(
                    self.registry.graphs[ref.graph]
                    .slots[ref.slot]
                    .shape(self.dim_sizes)
                )
            )
            items = []
            seen = set()
            for s in self.registry.slots:
                if (
                    s.kind == "gimg"
                    and s.graph == ref.graph
                    and s.key[3] == ref.slot
                    and s.image not in seen
                ):
                    seen.add(s.image)
                    d = self.registry.images[s.image]
                    arr = self._bound_image(d)
                    if arr.shape[0] == slot_n:
                        items.append((s.image, arr))
            if decl.name not in seen:
                arr = self._bound_image(decl)
                if arr.shape[0] == slot_n:
                    items.append((decl.name, arr))
            memo[gkey] = grouped_slot_halo_gather(
                self.bindings.get("mesh"),
                items,
                self.bindings.get("graphs", {}).get(ref.graph, {}),
                ref.slot,
            )
        got = memo[gkey]
        if got is None or decl.name not in got:
            return None
        return got[decl.name]

    def _access_computed(self, handle: ComputedHandle, off: Tuple[int, ...]):
        if self.mode == "field":
            if handle.name not in self._computed_cache:
                self._offset_ctx.append(tuple([0] * handle.ispace.ndim))
                try:
                    val = jnp.asarray(handle.fn(), self.dtype)
                finally:
                    self._offset_ctx.pop()
                if val.ndim == handle.ispace.ndim:
                    val = val[..., None]
                self._computed_cache[handle.name] = val
            return shift(self._computed_cache[handle.name], self._compose(off))
        # slots / discover: precomputed-field form (reference ComputedImage,
        # o.t:1007-1040 — value array + per-unknown gradient arrays,
        # recomputed once per nonlinear iteration). The access reads a
        # cached value slot (shift of the materialized field, zero-padded at
        # borders) plus a zero-valued linearization term
        # G_t·(x_t − stop_grad(x_t)) per touched unknown offset, so
        # jax.linearize chains first derivatives through the stored gradient
        # fields instead of re-differentiating the (possibly large) computed
        # expression per probe — the jvp-probe equivalent of the reference's
        # external-gradient hook (ad.t:636-647 Var:calcd).
        raw_off = off
        off = self._compose(off)  # fully composed center of this access
        if self._recording is not None:
            # nested ComputedArray inside a recording: gradients through the
            # inner array would be lost — fall back to inlining the OUTER
            self._rec_bailed = True
            return self._inline_computed(handle, raw_off)
        reg = self.registry
        meta = reg.computed_meta.get(handle.name)
        if (
            meta is None
            and self.mode == "discover"
            and handle.name not in reg.computed_failed
        ):
            meta = self._record_computed(handle, off)
        if meta is None:
            return self._inline_computed(handle, raw_off)
        sp = handle.ispace.shape(self.dim_sizes)
        cc = meta["channels"]
        key_c = ("cimg", handle.name, off)
        sid_c = reg.slot_for(
            key_c,
            lambda: SlotInfo(
                key=key_c, image=handle.name, kind="cimg",
                ispace=handle.ispace, graph=None, offset=off, expand=0,
                channels=cc, is_unknown=False,
            ),
            self.mode,
        )
        parts = []
        for (uname, t, cu) in meta["touched"]:
            x_off = tuple(a + b for a, b in zip(off, t))
            decl = reg.images[uname]
            key_x = _img_key(uname, x_off)
            sid_x = reg.slot_for(
                key_x,
                lambda: SlotInfo(
                    key=key_x, image=uname, kind="img", ispace=decl.ispace,
                    graph=None, offset=x_off, expand=0,
                    channels=decl.channels, is_unknown=True,
                ),
                self.mode,
            )
            key_g = ("cgrad", handle.name, off, uname, t)
            sid_g = reg.slot_for(
                key_g,
                lambda: SlotInfo(
                    key=key_g, image=handle.name, kind="cgrad",
                    ispace=handle.ispace, graph=None, offset=off, expand=0,
                    channels=cc * cu, is_unknown=False,
                ),
                self.mode,
            )
            parts.append((sid_x, sid_g, cu))
        if self.mode == "slots":
            import jax

            val = self.slot_values[sid_c]
            for sid_x, sid_g, cu in parts:
                xs = self.slot_values[sid_x]
                G = self.slot_values[sid_g].reshape(xs.shape[:-1] + (cc, cu))
                d = xs - jax.lax.stop_gradient(xs)
                val = val + jnp.sum(G * d[..., None, :], axis=-1)
            return val
        return jnp.ones(sp + (cc,), self.dtype)  # discover: shapes only

    def _record_computed(self, handle: ComputedHandle, off: Tuple[int, ...]):
        """Discover pass: run the computed expression once, recording which
        unknowns (at which relative offsets) it reads; registers the same
        slots every later pass looks up."""
        reg = self.registry
        rec: List[tuple] = []
        prev, prev_bail = self._recording, self._rec_bailed
        self._recording, self._rec_bailed = rec, False
        saved_ctx = self._offset_ctx
        # replace (not push) the context: ``off`` is already fully composed,
        # so inner reads compose to exactly off + t
        self._offset_ctx = [off]
        try:
            val = jnp.asarray(handle.fn(), self.dtype)
        finally:
            self._offset_ctx = saved_ctx
            bailed = self._rec_bailed
            self._recording, self._rec_bailed = prev, prev_bail
        if bailed:
            reg.computed_failed.add(handle.name)
            return None
        if val.ndim == handle.ispace.ndim:
            val = val[..., None]
        cc = int(val.shape[-1])
        touched, seen = [], set()
        for (uname, comp, cu) in rec:
            t = tuple(a - b for a, b in zip(comp, off))
            if (uname, t) not in seen:
                seen.add((uname, t))
                touched.append((uname, t, cu))
        meta = {"channels": cc, "touched": tuple(sorted(touched))}
        reg.computed_meta[handle.name] = meta
        return meta

    def _inline_computed(self, handle: ComputedHandle, off: Tuple[int, ...]):
        """Fallback (nested ComputedArrays): inline with composed offsets.
        A shifted read of the materialized array is zero (and has zero
        derivative) wherever the shift leaves the grid — replicate that by
        gating the inlined value with an internal bounds slot, otherwise the
        slot form diverges from field-mode F at the borders. ``off`` is the
        RAW (uncomposed) access offset; composition happens through the
        offset-context stack, as for any access."""
        gate = None
        if any(o != 0 for o in off):
            gate = self._bounds(off, expand=0, internal=True)
        self._offset_ctx.append(off)
        try:
            val = jnp.asarray(handle.fn(), self.dtype)
        finally:
            self._offset_ctx.pop()
        if val.ndim == handle.ispace.ndim:
            val = val[..., None]
        return val if gate is None else val * gate

    def _access_sampled(self, handle: SampledImageHandle, x, y):
        decl = handle.image.decl
        if decl.kind == UNKNOWN:
            raise SpecError("SampledImage over unknowns is not supported")
        # The sampled image and its derivative images are constants; only the
        # (possibly unknown-dependent) positions x, y carry derivatives. The
        # positions are already traced values from accessors, so sampling is
        # pointwise w.r.t. slots and works under both backends. Slot-mode runs
        # must still see the REAL constant images when they are bound (jvp
        # probes of the slot form feed the preconditioner and the assembled
        # JᵀJ; dummy fields would silently produce wrong derivatives) — only
        # the unbound discovery/jaxpr passes fall back to dummies.
        def _const_field(d):
            if self.mode == "field" or d.name in self.bindings.get("consts", {}):
                return self._bound_image(d)
            return self._dummy_field(d)

        img = _const_field(decl)
        if handle.dx is not None:
            dx = _const_field(handle.dx.decl)
            dy = _const_field(handle.dy.decl)
        else:
            dx, dy = central_difference_images(img)
        x = jnp.asarray(x, self.dtype)
        y = jnp.asarray(y, self.dtype)
        squeeze = False
        if x.ndim == img.ndim:  # [*sp,1] channel-style fields
            x = x[..., 0]
            y = y[..., 0]
        return sample_with_derivs(img, dx, dy, x, y)

    def _dummy_field(self, decl: ImageDecl):
        return jnp.ones(decl.ispace.shape(self.dim_sizes) + (decl.channels,), self.dtype)

    # -- bindings ---------------------------------------------------------------
    def _bound_image(self, decl: ImageDecl) -> jnp.ndarray:
        if decl.alias is not None:
            import jax

            arr = self.bindings.get("unknowns", {}).get(decl.alias)
            if arr is None:
                raise SpecError(f"alias image {decl.name!r}: no unknown {decl.alias!r}")
            return jax.lax.stop_gradient(arr)
        src = "unknowns" if decl.kind == UNKNOWN else "consts"
        d = self.bindings.get(src, {})
        if decl.name not in d:
            raise SpecError(f"no value bound for {decl.kind} image {decl.name!r}")
        arr = d[decl.name]
        if arr.ndim == decl.ispace.ndim:
            arr = arr[..., None]
        return arr

    def _bound_graph_index(self, ref: GraphSlotRef) -> jnp.ndarray:
        graphs = self.bindings.get("graphs", {})
        if ref.graph not in graphs:
            raise SpecError(f"no value bound for graph {ref.graph!r}")
        g = graphs[ref.graph]
        idx = g[ref.slot] if isinstance(g, dict) else getattr(g, ref.slot)
        return jnp.asarray(idx, jnp.int32)


# ---------------------------------------------------------------------------
# Registry: accumulated across builder runs; owned by the compiled problem
# ---------------------------------------------------------------------------


class SpecRegistry:
    """Declarations + slot table shared by all trace passes of one plan."""

    def __init__(self, dummy_edge_count: int = 4):
        self.dim_order: List[str] = []
        self.images: Dict[str, ImageDecl] = {}
        self.graphs: Dict[str, GraphDecl] = {}
        self.params: Dict[str, ParamDecl] = {}
        self.slots: List[SlotInfo] = []
        self._slot_by_key: Dict[tuple, int] = {}
        self.energy_terms: List[EnergyTerm] = []
        self.exclude_terms: List[ExcludeTerm] = []
        self.use_preconditioner = True
        self.dummy_edge_count = dummy_edge_count
        self.frozen = False
        # ComputedArray precompute metadata: handle name -> {channels,
        # touched: ((uname, rel_offset, channels), ...)}; `failed` lists
        # handles that fall back to inlining (nested ComputedArrays)
        self.computed_meta: Dict[str, dict] = {}
        self.computed_failed: set = set()

    def declare_image(self, name, channels, ispace, kind, alias=None) -> ImageDecl:
        prev = self.images.get(name)
        if prev is not None:
            if prev.channels != channels or prev.ispace != ispace or prev.kind != kind:
                raise SpecError(f"inconsistent re-declaration of image {name!r}")
            return prev
        if self.frozen:
            raise SpecError(f"non-deterministic spec: new image {name!r} on re-trace")
        decl = ImageDecl(name, channels, ispace, kind, alias)
        self.images[name] = decl
        return decl

    def declare_graph(self, name, slots) -> GraphDecl:
        prev = self.graphs.get(name)
        if prev is not None:
            return prev
        if self.frozen:
            raise SpecError(f"non-deterministic spec: new graph {name!r} on re-trace")
        decl = GraphDecl(name, slots)
        self.graphs[name] = decl
        return decl

    def declare_param(self, name):
        if name not in self.params:
            if self.frozen:
                raise SpecError(f"non-deterministic spec: new param {name!r} on re-trace")
            self.params[name] = ParamDecl(name)

    def slot_for(self, key, make_info, mode: str) -> int:
        sid = self._slot_by_key.get(key)
        if sid is None:
            if self.frozen:
                raise SpecError(f"non-deterministic spec: new access {key} on re-trace")
            sid = len(self.slots)
            self._slot_by_key[key] = sid
            self.slots.append(make_info())
        return sid

    def note_energy(self, idx: int):
        if idx >= len(self.energy_terms):
            if self.frozen:
                raise SpecError("non-deterministic spec: extra Energy() on re-trace")
            self.energy_terms.append(EnergyTerm(index=idx))

    def note_exclude(self, idx: int):
        if idx >= len(self.exclude_terms):
            if self.frozen:
                raise SpecError("non-deterministic spec: extra Exclude() on re-trace")
            self.exclude_terms.append(ExcludeTerm(index=idx))

    @property
    def unknown_names(self) -> List[str]:
        return [n for n, d in self.images.items() if d.kind == UNKNOWN]

    @property
    def array_names(self) -> List[str]:
        return [n for n, d in self.images.items() if d.kind == ARRAY]
