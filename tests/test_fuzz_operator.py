"""Seeded random-spec fuzzing of the assembled JᵀJ against the dense oracle.

The 12 bundled energies pin the known shapes; this generates small random
energies — mixed channel counts, stencil offsets, data-gated Selects with
random thresholds, ComputedArrays, Excludes, graph terms — and checks the
fused assembled operator (with its probe-based structural-zero pruning and
threshold-aware probe values) against the dense Jacobian. This is the
systematic defense for the probe heuristic that replaced the reference's
exact symbolic zero elimination (polysimplify, ad.t:803-926).
Deterministic: every spec derives from a fixed seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import opt_tpu as ot
from opt_tpu.functions import FunctionSet

N = 8  # grid side / vertex count


def _random_grid_spec(rng):
    """Random 2-D grid energy over 1-2 unknowns with gates/computed arrays."""
    n_unknowns = rng.randint(1, 3)
    u_ch = [int(rng.randint(1, 4)) for _ in range(n_unknowns)]
    thresholds = [float(t) for t in rng.uniform(-3, 3, 2)]
    offsets = [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1)]
    n_terms = rng.randint(2, 5)
    term_cfg = []
    for _ in range(n_terms):
        term_cfg.append(
            {
                "u": int(rng.randint(0, n_unknowns)),
                "off": offsets[rng.randint(0, len(offsets))],
                "gate": int(rng.randint(0, 3)),  # 0 none, 1 const, 2 computed
                "thr": thresholds[rng.randint(0, 2)],
                "nonlin": int(rng.randint(0, 2)),
                "w": float(rng.uniform(0.2, 2.0)),
            }
        )
    use_exclude = bool(rng.randint(0, 2))
    use_computed = any(t["gate"] == 2 for t in term_cfg) or bool(
        rng.randint(0, 2)
    )

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        U = [
            S.Unknown(f"X{i}", u_ch[i], (W, H)) for i in range(n_unknowns)
        ]
        D = S.Array("D", 1, (W, H))
        A = S.Array("A", u_ch[0], (W, H))
        C = None
        if use_computed:
            C = S.ComputedArray(
                "C", (W, H), lambda: U[0](0, 0) * U[0](0, 0) - A(0, 0)
            )
        if use_exclude:
            S.Exclude(ot.greater(D(0, 0), 2.5))
        for t in term_cfg:
            x = U[t["u"]]
            base = x(*t["off"]) - x(0, 0) * (0.5 if t["nonlin"] else 1.0)
            if t["nonlin"]:
                base = base + 0.1 * x(0, 0) * x(*t["off"])
            if t["gate"] == 1:
                base = ot.Select(
                    ot.greater(D(0, 0), t["thr"]), t["w"] * base, 0.0
                )
            elif t["gate"] == 2 and C is not None:
                # gate on C's first channel so the 0/1 mask broadcasts
                # against any term channel count
                base = ot.Select(
                    ot.less(ot.Slice(C(0, 0), 0, 1), t["thr"]),
                    t["w"] * base,
                    0.0,
                )
            else:
                base = t["w"] * base
            S.Energy(base)
        # always at least one plain fit so the problem is well-posed
        S.Energy(0.3 * (U[0](0, 0) - A(0, 0)))

    inputs = {"D": rng.uniform(-4, 4, (N, N)).astype(np.float32)}
    inputs["A"] = rng.rand(N, N, u_ch[0]).astype(np.float32)
    for i in range(n_unknowns):
        inputs[f"X{i}"] = rng.rand(N, N, u_ch[i]).astype(np.float32)
    return spec, {"W": N, "H": N}, inputs


def _random_graph_spec(rng):
    """Random graph energy: 2-endpoint edges, gated couplings."""
    ch = int(rng.randint(1, 4))
    thr = float(rng.uniform(-1, 1))
    nonlin = bool(rng.randint(0, 2))

    def spec(S):
        Nd = S.Dim("N")
        X = S.Unknown("X", ch, (Nd,))
        Dv = S.Array("Dv", 1, (Nd,))
        G = S.Graph("G", v0=(Nd,), v1=(Nd,))
        d = X(G.v0) - X(G.v1)
        if nonlin:
            d = d + 0.2 * X(G.v0) * X(G.v1)
        S.Energy(ot.Select(ot.greater(Dv(G.v0), thr), d, 0.0))
        S.Energy(0.4 * (X(0) - Dv(0)))

    rngE = np.random.RandomState(rng.randint(0, 1 << 30))
    v0 = np.arange(N, dtype=np.int32)
    # derangement: no self-loop edges. A hyperedge referencing the same
    # vertex twice makes the PER-SLOT Jacobi diagonal differ from the true
    # diag(JtJ) — by design, matching the reference's per-endpoint
    # scatter of (dr/du)^2 (createjtfgraph o.t:2228-2253); the reference's
    # graph builders (OptGraph.h createGraphFromNeighborLists) never emit
    # self-loops either. The JtJ apply itself is exact regardless.
    v1 = rngE.permutation(N).astype(np.int32)
    while np.any(v1 == v0):
        v1 = rngE.permutation(N).astype(np.int32)
    inputs = {
        "X": rng.rand(N, ch).astype(np.float32),
        "Dv": rng.uniform(-2, 2, (N,)).astype(np.float32),
        "G": {"v0": v0, "v1": v1},
    }
    return spec, {"N": N}, inputs


def _dense_check(spec, dims, inputs):
    from opt_tpu.assembly import assemble, plan_assembly

    plan = ot.Problem(spec).plan(dims=dims)
    c = plan.compiled
    unknowns, consts, graphs_in, params = c.normalize_inputs(inputs)
    graphs = plan._augment_incidence(graphs_in)
    fs = FunctionSet(c, consts, graphs, params)
    names = sorted(unknowns)
    shapes = [unknowns[n].shape for n in names]
    sizes = [int(np.prod(s)) for s in shapes]

    def unflatten(v):
        out, o = {}, 0
        for n, s, sz in zip(names, shapes, sizes):
            out[n] = v[o : o + sz].reshape(s)
            o += sz
        return out

    def flatten(d):
        return jnp.concatenate([jnp.ravel(d[n]) for n in names])

    def r_flat(v):
        return jnp.concatenate([t.ravel() for t in fs.F(unflatten(v))])

    x0 = flatten(unknowns)
    J = np.asarray(jax.jacfwd(r_flat)(x0))
    fs.masks(unknowns)
    _, row_masks = fs._mask_cache
    colmask = np.asarray(
        flatten(
            {
                n: (
                    jnp.broadcast_to(row_masks[n], unknowns[n].shape)
                    if row_masks.get(n) is not None
                    else jnp.ones_like(unknowns[n])
                )
                for n in names
            }
        )
    )
    Jm = J * colmask[None, :]

    spec_plan = plan_assembly(spec, c)
    if spec_plan is None:
        pytest.skip("assembly unavailable for this random spec")
    apply_fn, diag, jtf_fn, _meta = assemble(
        c, spec_plan, unknowns, consts, graphs, params, row_masks
    )
    np.testing.assert_allclose(
        np.asarray(flatten(diag)),
        (Jm * Jm).sum(axis=0),
        rtol=2e-3,
        atol=1e-4,
    )
    p = np.random.RandomState(7).rand(colmask.size).astype(np.float32)
    got = np.asarray(flatten(apply_fn(unflatten(jnp.asarray(p)))))
    want = Jm.T @ (Jm @ (p * colmask))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_grid_assembled_jtj(seed):
    rng = np.random.RandomState(1000 + seed)
    spec, dims, inputs = _random_grid_spec(rng)
    _dense_check(spec, dims, inputs)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_graph_assembled_jtj(seed):
    rng = np.random.RandomState(2000 + seed)
    spec, dims, inputs = _random_graph_spec(rng)
    _dense_check(spec, dims, inputs)


def _random_3d_spec(rng):
    """Random 3-D grid energy (volumetric-style stencils + gates)."""
    ch = int(rng.randint(1, 4))
    thr = float(rng.uniform(-1.5, 1.5))
    offsets = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0)]
    picked = [offsets[rng.randint(0, 4)] for _ in range(2)]
    nonlin = bool(rng.randint(0, 2))

    def spec(S):
        W, H, D = S.Dim("W"), S.Dim("H"), S.Dim("D")
        X = S.Unknown("X", ch, (W, H, D))
        A = S.Array("A", ch, (W, H, D))
        M = S.Array("M", 1, (W, H, D))
        for off in picked:
            d = X(0, 0, 0) - X(*off)
            if nonlin:
                d = d + 0.1 * X(0, 0, 0) * X(*off)
            S.Energy(ot.Select(ot.greater(M(0, 0, 0), thr), d, 0.0))
        S.Energy(0.5 * (X(0, 0, 0) - A(0, 0, 0)))

    n = 5
    inputs = {
        "X": rng.rand(n, n, n, ch).astype(np.float32),
        "A": rng.rand(n, n, n, ch).astype(np.float32),
        "M": rng.uniform(-2, 2, (n, n, n)).astype(np.float32),
    }
    return spec, {"W": n, "H": n, "D": n}, inputs


def _sampled_image_spec(rng):
    """Flow-style spec: bilinear SampledImage at unknown-dependent coords."""
    wf = float(rng.uniform(0.5, 2.0))

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 2, (W, H))
        I = S.Array("I", 1, (W, H))
        Ih = S.Array("Ih", 1, (W, H))
        Ihx = S.Array("Ihx", 1, (W, H))
        Ihy = S.Array("Ihy", 1, (W, H))
        samp = S.SampledImage(Ih, Ihx, Ihy)
        i, j = S.Index(0), S.Index(1)
        S.Energy(
            wf
            * (
                I(0, 0)
                - samp(
                    i[..., 0] + X(0, 0)[..., 0], j[..., 0] + X(0, 0)[..., 1]
                )
            )
        )
        S.Energy(0.3 * (X(0, 0) - X(1, 0)))

    inputs = {
        "X": (0.2 * rng.randn(N, N, 2)).astype(np.float32),
        "I": rng.rand(N, N).astype(np.float32),
        "Ih": rng.rand(N, N).astype(np.float32),
        "Ihx": (0.1 * rng.randn(N, N)).astype(np.float32),
        "Ihy": (0.1 * rng.randn(N, N)).astype(np.float32),
    }
    return spec, {"W": N, "H": N}, inputs


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_3d_assembled_jtj(seed):
    rng = np.random.RandomState(3000 + seed)
    spec, dims, inputs = _random_3d_spec(rng)
    _dense_check(spec, dims, inputs)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_sampled_image_assembled_jtj(seed):
    rng = np.random.RandomState(4000 + seed)
    spec, dims, inputs = _sampled_image_spec(rng)
    _dense_check(spec, dims, inputs)


def _random_traced_gate_spec(rng):
    """Adversarial class: array-vs-array comparison gates
    whose threshold sits far outside every probe value, so the gate is
    FROZEN under the probe distribution (nothing literal to straddle —
    ``_comparison_constants`` cannot harvest it) but ACTIVE at the real
    inputs. Without the traced-gate taint (assembly._terms_with_traced_gates)
    the gated smoothness coupling probes structurally zero and the
    assembled operator drops it — the dense oracle below catches that."""
    big = float(rng.uniform(30.0, 80.0))
    sgn = 1.0 if rng.randint(0, 2) else -1.0
    off = [(1, 0), (0, 1), (-1, 0)][rng.randint(0, 3)]

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),
            ot.Select(
                ot.less(A(0, 0), sgn * X(0, 0) - big),
                X(0, 0) - X(*off),
                0.0,
            ),
        )

    rng2 = np.random.RandomState(rng.randint(1 << 30))
    x0 = (sgn * (big + 5.0) + rng2.rand(N, N, 1)).astype(np.float32)
    inputs = {"X": x0, "A": rng2.rand(N, N, 1).astype(np.float32)}
    return spec, {"W": N, "H": N}, inputs


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_traced_gate_not_pruned(seed):
    rng = np.random.RandomState(5000 + seed)
    spec, dims, inputs = _random_traced_gate_spec(rng)
    _dense_check(spec, dims, inputs)


def _random_maxmin_gate_spec(rng):
    """Adversarial class: jnp.maximum/minimum with two traced
    operands gate the Jacobian exactly like array-vs-array comparisons —
    their derivative is a select with no literal threshold for the probes
    to straddle. Build a min() whose coupling branch is frozen OFF under
    the probe distribution (the other operand is ~ -big there) but taken
    at the real inputs; without treating max/min as gates the coupling
    probes structurally zero and is unsoundly pruned."""
    big = float(rng.uniform(30.0, 80.0))
    off = [(1, 0), (0, 1), (-1, 0)][rng.randint(0, 3)]
    use_max = bool(rng.randint(0, 2))

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        smooth = X(0, 0) - X(*off)
        other = X(0, 0) - A(0, 0) - big
        gated = (
            jnp.maximum(-smooth, -other) if use_max
            else jnp.minimum(smooth, other)
        )
        S.Energy(0.1 * (X(0, 0) - A(0, 0)), gated)

    rng2 = np.random.RandomState(rng.randint(1 << 30))
    # real inputs: A << -big so the coupling operand wins the min/max
    inputs = {
        "X": (0.3 * rng2.randn(N, N, 1)).astype(np.float32),
        "A": (-(big + 5.0) + rng2.rand(N, N, 1)).astype(np.float32),
    }
    return spec, {"W": N, "H": N}, inputs


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_maxmin_gate_not_pruned(seed):
    rng = np.random.RandomState(6000 + seed)
    spec, dims, inputs = _random_maxmin_gate_spec(rng)
    _dense_check(spec, dims, inputs)


def test_maxmin_literal_threshold_harvested_not_tainted():
    """max/min with a LITERAL operand keeps the escape hatch: the literal
    is a harvestable threshold (probes straddle it), so the term is NOT
    tainted and structural pruning stays available."""
    from opt_tpu.assembly import (
        _comparison_constants,
        _terms_with_traced_gates,
    )
    from opt_tpu.compile import compile_spec

    def clamped(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        S.Energy(jnp.maximum(X(0, 0), 5.0) - X(1, 0))

    c = compile_spec(clamped, {"W": 8, "H": 8}, np.float32)
    X = {"X": jnp.zeros((8, 8, 1), jnp.float32)}
    consts, graphs, params = {}, {}, {}
    vals = _comparison_constants(c, X, consts, graphs, params)
    assert any(abs(v - 5.0) < 1e-6 for v in vals), vals
    tainted = _terms_with_traced_gates(c, X, consts, graphs, params)
    assert not tainted, tainted


def test_maxmin_detector_flags_traced_gate():
    """The detector treats a two-traced-operand minimum as a gate: the
    tainted term keeps its coupling (both stencil offsets assembled) and
    its slot Jacobians are not constant-hoisted."""
    from opt_tpu.assembly import plan_assembly
    from opt_tpu.compile import compile_spec

    def gated(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),
            jnp.minimum(X(0, 0) - X(1, 0), X(0, 0) - A(0, 0) - 50.0),
        )

    c = compile_spec(gated, {"W": 16, "H": 16}, np.float32)
    sp = plan_assembly(gated, c)
    deltas = sorted({k[2] for k in sp.w_spec})
    assert (1, 0) in deltas and (-1, 0) in deltas, deltas
    assert all(t != 1 for (t, _sid) in sp.const_tsids), sp.const_tsids


def test_traced_gate_detector_flags_and_keeps_coupling():
    """The detector itself: a frozen array-vs-array gate taints its term,
    which keeps every channel pair (no pruning), disables constant hoisting
    for the term and blocks scalar-group collapsing."""
    from opt_tpu.assembly import plan_assembly
    from opt_tpu.compile import compile_spec

    def gated(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),
            ot.Select(
                ot.less(A(0, 0), X(0, 0) - 50.0), X(0, 0) - X(1, 0), 0.0
            ),
        )

    c = compile_spec(gated, {"W": 16, "H": 16}, np.float32)
    sp = plan_assembly(gated, c)
    deltas = sorted({k[2] for k in sp.w_spec})
    assert (1, 0) in deltas and (-1, 0) in deltas, deltas
    # the tainted term's slot Jacobians must not be hoisted as constant
    assert all(t != 1 for (t, _sid) in sp.const_tsids), sp.const_tsids


def _random_pwconst_gate_spec(rng):
    """Adversarial class: piecewise-constant factors
    (floor / sign / ceil / float->int cast) gate the Jacobian with no
    literal threshold anywhere — every integer is a breakpoint. Each
    construction makes the coupling coefficient IDENTICALLY ZERO under the
    probe distribution (draws are O(1); the factor's argument sits inside
    one flat cell) but nonzero at the real inputs; without treating these
    primitives as gates the coupling probes structurally zero and is
    unsoundly pruned. Dense-oracle checked at the real inputs."""
    big = float(rng.uniform(30.0, 80.0))
    off = [(1, 0), (0, 1), (-1, 0)][rng.randint(0, 3)]
    kind = ["floor", "sign", "ceil", "intcast"][rng.randint(0, 4)]

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        # probe draws keep |A| small: each factor is 0 on the whole draw
        # range but nonzero at the real A below
        if kind == "floor":
            fac = jnp.floor(jnp.maximum(A(0, 0), 0.0) / big)
        elif kind == "ceil":
            fac = jnp.ceil(jnp.minimum(A(0, 0), 0.0) / big)
        elif kind == "sign":
            fac = jnp.sign(A(0, 0) - 4.0 * big) + 1.0
        else:  # float->int cast truncation
            fac = (A(0, 0) / big).astype(jnp.int32).astype(jnp.float32)
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),
            fac * (X(0, 0) - X(*off)),
        )

    rng2 = np.random.RandomState(rng.randint(1 << 30))
    if kind == "ceil":
        a = (-(2.0 * big) - rng2.rand(N, N, 1) * big).astype(np.float32)
    elif kind == "sign":
        a = (4.0 * big + 1.0 + rng2.rand(N, N, 1)).astype(np.float32)
    else:
        a = (2.0 * big + 3.0 + rng2.rand(N, N, 1) * big).astype(np.float32)
    inputs = {
        "X": (0.3 * rng2.randn(N, N, 1)).astype(np.float32),
        "A": a,
    }
    return spec, {"W": N, "H": N}, inputs


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_pwconst_gate_not_pruned(seed):
    rng = np.random.RandomState(7000 + seed)
    spec, dims, inputs = _random_pwconst_gate_spec(rng)
    _dense_check(spec, dims, inputs)


def test_pwconst_detector_flags_and_custom_jvp_exempt():
    """The detector taints floor/sign/cast terms (no structural pruning,
    no constant hoisting) but does NOT taint the bilinear SampledImage fit
    term: its floor/casts live inside a custom_jvp whose derivative rule —
    which is what the probes evaluate — is smooth (ops/sampling.py)."""
    from opt_tpu.assembly import _terms_with_traced_gates
    from opt_tpu.compile import compile_spec

    def gated(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),                      # term 0: clean
            jnp.floor(A(0, 0) / 50.0) * (X(0, 0) - X(1, 0)),  # term 1: gate
        )

    c = compile_spec(gated, {"W": 8, "H": 8}, np.float32)
    X = {"X": jnp.zeros((8, 8, 1), jnp.float32)}
    consts = {"A": jnp.zeros((8, 8, 1), jnp.float32)}
    tainted = _terms_with_traced_gates(c, X, consts, {}, {})
    assert 1 in tainted and 0 not in tainted, tainted

    def flow_like(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 2, (W, H))
        I = S.Array("I", 1, (W, H))
        Ih = S.Array("Ih", 1, (W, H))
        Ihx = S.Array("Ihx", 1, (W, H))
        Ihy = S.Array("Ihy", 1, (W, H))
        samp = S.SampledImage(Ih, Ihx, Ihy)
        i, j = S.Index(0), S.Index(1)
        S.Energy(
            I(0, 0)
            - samp(i[..., 0] + X(0, 0)[..., 0], j[..., 0] + X(0, 0)[..., 1])
        )

    c2 = compile_spec(flow_like, {"W": 8, "H": 8}, np.float32)
    z = jnp.zeros((8, 8, 1), jnp.float32)
    consts2 = {"I": z, "Ih": z, "Ihx": z, "Ihy": z}
    X2 = {"X": jnp.zeros((8, 8, 2), jnp.float32)}
    tainted2 = _terms_with_traced_gates(c2, X2, consts2, {}, {})
    assert not tainted2, tainted2


def _computed_gate_frozen_spec(rng):
    """Adversarial class: the gate compares a COMPUTED
    array (per-iteration ComputedArray value) against another traced value
    with no literal threshold — frozen OFF under the probe distribution,
    taken at the real inputs."""
    big = float(rng.uniform(30.0, 80.0))
    off = [(1, 0), (0, 1)][rng.randint(0, 2)]

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        C = S.ComputedArray("C", (W, H), lambda: X(0, 0) * X(0, 0) + A(0, 0))
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),
            ot.Select(
                ot.greater(C(0, 0), A(0, 0) * A(0, 0) + big),
                X(0, 0) - X(*off),
                0.0,
            ),
        )

    rng2 = np.random.RandomState(rng.randint(1 << 30))
    # real X large enough that X^2 + A > A^2 + big -> gate taken
    inputs = {
        "X": (np.sqrt(big) + 2.0 + rng2.rand(N, N, 1)).astype(np.float32),
        "A": (0.3 * rng2.rand(N, N, 1)).astype(np.float32),
    }
    return spec, {"W": N, "H": N}, inputs


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_computed_gate_not_pruned(seed):
    rng = np.random.RandomState(8000 + seed)
    spec, dims, inputs = _computed_gate_frozen_spec(rng)
    _dense_check(spec, dims, inputs)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_unknown_dependent_exclude_solve(seed):
    """Masks that change between assembly and apply: an
    Exclude on the UNKNOWN re-evaluates per GN step as X moves. The
    assembled fast path must track the composed operator (use_fused_jtj=
    False) through a short solve — same per-iteration costs and unknowns."""
    rng = np.random.RandomState(9000 + seed)
    thr = float(rng.uniform(0.5, 1.5))

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Exclude(ot.greater(X(0, 0), thr))
        S.Energy(
            0.5 * (X(0, 0) - A(0, 0)),
            X(0, 0) - X(1, 0),
            X(0, 0) - X(0, 1),
        )

    inputs = {
        "X": (rng.rand(N, N, 1) * 2.0).astype(np.float32),
        "A": (rng.rand(N, N, 1) * 2.0).astype(np.float32),
    }
    rs = {}
    for fused in (True, False):
        plan = ot.Problem(spec).plan(
            dims={"W": N, "H": N},
            init_params=ot.InitializationParameters(use_fused_jtj=fused),
        )
        rs[fused] = plan.solve(dict(inputs), nIterations=4, lIterations=12)
    np.testing.assert_allclose(
        rs[True].costs, rs[False].costs, rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(rs[True].unknowns["X"]),
        np.asarray(rs[False].unknowns["X"]),
        rtol=1e-3,
        atol=1e-4,
    )


def _computed_eq_literal_gate_spec(rng):
    """Adversarial class (round 4, SFS root cause): the gate compares a
    COMPUTED array against a LITERAL (``eq(V, 1)``). The literal escape
    hatch in the taint walk is only sound for directly-drawn inputs — the
    probes place harvested thresholds into raw slot draws — but a
    ComputedArray is recomputed from the probe unknowns, so an indicator
    needing four |ΔX| < thr neighbor coincidences never fires under O(1)
    draws and its couplings probe identically zero. Without the
    derived-operand taint the term is unsoundly pruned (the exact failure
    that demoted shape_from_shading off the fused path since round 2)."""
    thr = 0.01

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))

        def cont(dx, dy):
            return ot.less(jnp.abs(X(0, 0) - X(dx, dy)), thr)

        V = S.ComputedArray(
            "V",
            (W, H),
            lambda: ot.And(
                cont(1, 0), cont(-1, 0), cont(0, 1), cont(0, -1),
                ot.InBoundsExpanded(0, 0, 1),
            ),
        )
        valid = ot.eq(V(0, 0), 1)
        S.Energy(
            0.1 * (X(0, 0) - A(0, 0)),
            ot.Select(
                valid, (X(0, 0) - X(1, 0)) + (X(0, 0) - X(0, 1)), 0.0
            ),
        )

    # piecewise-constant 4x4 blocks + sub-threshold noise: block interiors
    # satisfy all four continuity tests (gate ON), block boundaries do not
    base = np.repeat(np.repeat(rng.rand(N // 4, N // 4), 4, 0), 4, 1)
    Xr = (2.0 + base + rng.rand(N, N) * (thr * 0.2)).astype(np.float32)
    inputs = {
        "X": Xr[..., None],
        "A": rng.rand(N, N, 1).astype(np.float32),
    }
    return spec, {"W": N, "H": N}, inputs


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_computed_eq_literal_gate_not_pruned(seed):
    rng = np.random.RandomState(11000 + seed)
    spec, dims, inputs = _computed_eq_literal_gate_spec(rng)
    _dense_check(spec, dims, inputs)


def test_sfs_smooth_depth_validates_assembled():
    """shape_from_shading regression pin for the round-4 fix: at smooth
    depth the ``eq(valid, 1)`` ComputedArray gate fires at a sparse pixel
    population; the assembled operator must carry the shading-smoothness
    couplings there (pre-fix they were probe-pruned and validate_assembly
    demoted every SFS solve to the composed path — BENCH sfs512 176 vs 246
    GN it/s since round 2)."""
    from opt_tpu.models.specs import shape_from_shading

    n = 64
    rng = np.random.RandomState(0)
    depth = 2.0 + rng.rand(n, n).astype(np.float32) * 0.1
    inputs = {
        "X": depth.copy(),
        "D_i": depth,
        "Im": rng.rand(n, n).astype(np.float32),
        "edgeMaskR": np.ones((n, n), np.float32),
        "edgeMaskC": np.ones((n, n), np.float32),
        "w_p": 1.0, "w_s": 10.0, "w_g": 1.0,
        "f_x": 500.0, "f_y": 500.0, "u_x": n / 2.0, "u_y": n / 2.0,
        **{f"L_{i}": (0.5 if i == 1 else 0.1) for i in range(1, 10)},
    }
    plan = ot.Problem(shape_from_shading).plan(dims={"W": n, "H": n})
    X, c, g, p = plan._normalize_and_place(dict(inputs))
    unknowns = {k: X[k] for k in plan.compiled.unknown_names}
    assert plan.solver.validate_assembly(unknowns, c, g, p)
    res = plan.solve(dict(inputs), nIterations=2, lIterations=5)
    assert plan.fused_fallback is None
    assert np.isfinite(res.final_cost)
