"""``ops/gn_assemble.py`` against the JAX package's assembly batch rule
``_gn_assemble_vmap``.

The JAX package assembles the split expansion's Gauss-Newton model with its
hand-written batch rule ``_gn_assemble_vmap`` (``robot_mpcs_tpu/solver/
al_ilqr.py:228``) from the per-row coefficients of ``_coefs`` /
``_expansion_coefs``. The port's counterpart is ``gn_assemble``: on the card
the kernel of ``csrc/gn_assemble.cu`` (held to its plain version by
``tests/test_torch_fk_gn_emulated.py`` and on the card), on the CPU its
plain version, reached here through the port's own
``stage_expansion_blocks`` (the split path of ``build_solver``) and held to
``jax.vmap`` of the JAX solver's ``stage_expansion`` (:326) over every
(lane, stage), as ``tests/test_split_expansion.py:54`` calls it, on the same
numpy inputs: panda, boxer, the mobile panda (nv = 31), pointRobot with
slack and panda with slack and velocity limits (q-family constraint rows
with a slack column), penalties from 1e1 to 1e5 across lanes, active
constraint rows, barrier rows inside the clamp (dead) and the stage-0 pins.
Tolerance: each entry within 1e-4 of its own term scale, the sum of the
magnitudes of the terms that make it up (``ops.gn_assemble.gn_term_scale``,
``chip_smoke.gn_excess``): both compute in f32, the JAX rule summing each
entry's rows in turn, the port in matrix products, and the entries span the
penalties' seven decades, so a bar on the largest entry would not see a
term dropped from a small one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GN_RTOL, gn_excess, gn_layout, mobile_panda_setup, random_gn_inputs
from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.components import BARRIER_EPS
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import gn_assemble as ga

from test_torch_fk_gn_emulated import _panda_variant, _slack_point_setup, split_rows

torch.set_num_threads(2)

B = 4  # lanes, each over the problem's whole horizon
SETUPS = {"panda": panda_setup, "boxer": boxer_setup, "mobilePanda": mobile_panda_setup,
          "pointRobotSlack": _slack_point_setup, "pandaSlack": _panda_variant}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def case(request):
    d = SETUPS[request.param]()
    tp, jp = MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))
    d = tp.dims
    N = d.N
    rng = np.random.default_rng(sum(map(ord, request.param)))
    X = (0.6 * rng.normal(size=(B, N, d.nx))).astype(np.float32)
    W = (0.4 * rng.normal(size=(B, N, d.nu + d.ns))).astype(np.float32)
    if d.ns:
        W[..., 0] = np.abs(W[..., 0])
    P = (np.abs(rng.normal(size=(B, N, tp.npar))) * 0.5 + 0.1).astype(np.float32)
    lam = (np.abs(rng.normal(size=(B, N, tp.n_con))) * (rng.random((B, N, tp.n_con)) < 0.5)).astype(np.float32)
    mu = (10.0 ** np.linspace(1, 5, B)).astype(np.float32)
    return request.param, tp, jp, X, W, P, lam, mu


def _jax_blocks(jp, X, W, P, lam, mu, c_off):
    """``vmap`` of the JAX solver's per-stage expansion over every (lane,
    stage): its ``gn_assemble`` takes the batch rule. The five blocks, as
    torch tensors."""
    f = jp.build_solver()._internals["stage_expansion"]
    M = X.shape[0] * X.shape[1]
    flat = lambda a: jnp.asarray(a.reshape((M,) + a.shape[2:]))  # noqa: E731
    mus = np.repeat(mu, X.shape[1])
    offs = np.broadcast_to(c_off, X.shape[:2] + c_off.shape[1:])
    g, H = jax.jit(jax.vmap(f))(flat(X), flat(W), flat(P), flat(lam), jnp.asarray(mus), flat(np.asarray(offs)))
    g, H = np.asarray(g).reshape(X.shape[:2] + g.shape[1:]), np.asarray(H).reshape(X.shape[:2] + H.shape[1:])
    nx = jp.dims.nx
    return [torch.tensor(b) for b in (g[..., :nx], g[..., nx:], H[..., :nx, :nx], H[..., :nx, nx:], H[..., nx:, nx:])]


def _jax_rows(jp, X, W, P):
    """The JAX solver's inputs to its assembly at every (lane, stage), as
    ``_expansion_coefs`` (``robot_mpcs_tpu/solver/al_ilqr.py:301``) forms
    them: ``(vq, Jq, va, wrq, wbq, wra, wba)`` (the q rows' Jacobian by
    ``jax.linearize``, which reaches ``_walk_scalar``), as torch tensors."""
    split = jp.split_callbacks()
    n_q = split["n_q"]

    def rows(x, w, p):
        vq, jvp_q = jax.linearize(lambda qq: split["q_rows"](qq, p), x[:n_q])
        Jq = jax.vmap(jvp_q, out_axes=1)(jnp.eye(n_q, dtype=x.dtype))
        return (vq, Jq, split["aff_rows"](jnp.concatenate([x, w]), p), *split["weights_split"](p))

    M = X.shape[0] * X.shape[1]
    flat = lambda a: jnp.asarray(a.reshape((M,) + a.shape[2:]))  # noqa: E731
    out = jax.jit(jax.vmap(rows))(flat(X), flat(W), flat(P))
    return [torch.tensor(np.asarray(o).reshape(X.shape[:2] + o.shape[1:])) for o in out]


def test_assembly_matches_the_jax_rule(case):
    """The plain assembly fed the JAX solver's own rows, Jacobian and weights
    against the JAX rule's blocks: each entry within 1e-4 of its term
    scale."""
    _, tp, jp, X, W, P, lam, mu = case
    solve = tp.build_solver(device="cpu")
    c_off = solve._internals["C_OFF"]
    split = jp.split_callbacks()
    layout = ga.GnLayout(split["q_seg"], split["aff_seg"], split["S_aff"], nx=jp.dims.nx, ns=jp.dims.ns,
                         n_q=split["n_q"], c_off=c_off)
    inputs = (*_jax_rows(jp, X, W, P), torch.as_tensor(lam), torch.as_tensor(mu), torch.as_tensor(W))
    got = ga.gn_assemble_reference(*inputs, layout=layout)
    want = _jax_blocks(jp, X, W, P, lam, mu, c_off.numpy())
    assert gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout)) <= 1.0


def test_split_expansion_matches_the_jax_rule(case):
    """The port's whole split expansion (its rows, the walk's Jacobian, the
    assembly) against the JAX solver's. The two packages' rows and Jacobians
    differ by f32 rounding (held here within 1e-4 of each row's size, at
    least 1: rows such as the legacy goal objective's scaled residuals and
    their Jacobians reach ~1e3), and a
    Jacobian entry that is 0 in one and 1e-8 in the other moves an entry of
    lxx by that much times a barrier curvature of up to ~1e7: each entry is
    held within 1e-4 of its term scale at |Jq| + |dJq| (dJq the two
    Jacobians' difference) plus that rounding carried through the assembly
    (this scale less the one at |Jq|)."""
    name, tp, jp, X, W, P, lam, mu = case
    solve = tp.build_solver(device="cpu")
    c_off = solve._internals["C_OFF"]
    args = [torch.as_tensor(a) for a in (X, W, P, lam, mu)]
    got = solve._internals["stage_expansion_blocks"](*args)
    want = _jax_blocks(jp, X, W, P, lam, mu, c_off.numpy())
    rows = split_rows(tp, *args[:3])
    jax_rows = _jax_rows(jp, X, W, P)
    for a, b, per_row in zip(rows[:3], jax_rows[:3], (False, True, False)):
        size = (b.abs().amax(-1, keepdim=True) if per_row else b.abs()).clamp(min=1.0)
        assert bool(((a - b).abs() <= 1e-4 * size).all())
    layout = gn_layout(tp, c_off)
    rest = (args[3], args[4], args[1])
    scale = ga.gn_term_scale(*rows, *rest, layout=layout)
    wide = ga.gn_term_scale(rows[0], rows[1].abs() + (rows[1] - jax_rows[1]).abs(), *rows[2:], *rest, layout=layout)
    bound = [GN_RTOL * w + (w - s) for s, w in zip(scale, wide)]
    assert gn_excess(got, want, bound, rtol=1.0) <= 1.0

    # the inputs reach every branch: pinned stage-0 rows, active constraint
    # rows, and (where the problem has them) live and dead barrier rows
    split = tp.split_callbacks()
    qr, qb, qc = split["q_seg"]
    vq, _ = split["q_rows"](args[0][..., : split["n_q"]], args[2], False)
    assert (c_off[0] > 0).any()
    C = solve._internals["stage_ineq"](*args[:3]) + solve._internals["C_OFF"]
    assert bool((torch.as_tensor(lam) - args[4][:, None, None] * C > 0).any())
    if qb:
        bars = vq[..., qr:qr + qb]
        assert bool((bars <= BARRIER_EPS).any()) and bool((bars > BARRIER_EPS).any())


def test_blocks_are_symmetric_and_contiguous(case):
    """The plain assembly mirrors its upper triangle: lxx and lww are exactly
    symmetric, and every block is contiguous, as the Riccati kernels read
    them."""
    _, tp, _, X, W, P, lam, mu = case
    solve = tp.build_solver(device="cpu")
    blocks = solve._internals["stage_expansion_blocks"](*(torch.as_tensor(a) for a in (X, W, P, lam, mu)))
    assert all(b.is_contiguous() for b in blocks)
    assert torch.equal(blocks[2], blocks[2].transpose(-1, -2)) and torch.equal(blocks[4], blocks[4].transpose(-1, -2))


def test_entry_tables_hold_s_aff():
    """The kernel's CSR tables rebuild S^T g and S^T diag(h) S exactly."""
    tp = MpcProblem(Setup.from_dict(_panda_variant()))
    S = tp.split_callbacks()["S_aff"].astype(np.float32)
    grad_ptr, grad_row, grad_coef, pair_ptr, pair_row, pair_coef = ga.entry_tables(S)
    nv = S.shape[1]
    rng = np.random.default_rng(0)
    g_a, h_a = rng.normal(size=S.shape[0]), rng.normal(size=S.shape[0])
    g = [sum(grad_coef[p] * g_a[grad_row[p]] for p in range(grad_ptr[i], grad_ptr[i + 1])) for i in range(nv)]
    np.testing.assert_allclose(g, S.T @ g_a, atol=1e-12)
    Hd = S.T @ (h_a[:, None] * S)
    upper = [(i, j) for i in range(nv) for j in range(i, nv)]
    for u, (i, j) in enumerate(upper):
        got = sum(pair_coef[p] * h_a[pair_row[p]] for p in range(pair_ptr[u], pair_ptr[u + 1]))
        assert abs(got - Hd[i, j]) < 1e-12
    assert pair_ptr[-1] < 4 * S.shape[0]  # a handful of entries, not an (n_arows x nv^2) product


@pytest.mark.parametrize("robot", ["panda", "mobilePanda", "pandaSlack", "pointRobotSlack"])
def test_entry_schedule_rebuilds_the_assembly(robot):
    """The kernel's static schedule (``entry_schedule``), replayed in float64
    as the kernel reads it (each live entry: its terms, then its kind's q or
    slack part, written to its one or two places; every other entry 0),
    rebuilds the plain assembly of random row coefficients; each live entry
    appears once, kinds together, and the structurally zero entries (no
    term, no q or slack part) are left out."""
    tp = MpcProblem(Setup.from_dict(SETUPS[robot]()))
    layout = gn_layout(tp, torch.zeros((1, tp.n_con)))
    qr, qb, qc = layout.q_seg
    rq, ra = qr + qb + qc, sum(layout.aff_seg)
    nx, nw, nq = layout.nx, layout.nw, layout.n_q
    sched, terms = (t.numpy() for t in layout.tables)
    assert (sched.shape[0], terms.shape[0]) == (layout.n_live, layout.n_terms)
    rng = np.random.default_rng(1)
    gq, hq, g_a, h_a = (rng.normal(size=k) for k in (rq, rq, ra, ra))
    Jq = rng.normal(size=(rq, nq))
    blocks = [np.zeros(k) for k in (nx, nw, nx * nx, nx * nw, nw * nw)]
    kinds, seen = sched[:, 1] & 0xFF, set()
    assert (np.diff(kinds) >= 0).all()
    coefs = terms[:, 1].astype(np.int32).view(np.float32)
    for (span, meta, place, mirror), kind in zip(sched, kinds):
        i, j = (meta >> 8) & 0xFF, meta >> 16
        assert (kind < 3, i, j) not in seen
        seen.add((kind < 3, i, j))
        rows = (g_a if kind < 3 else h_a)
        begin, count = span & 0xFFFF, span >> 16
        acc = sum(float(coefs[p]) * rows[terms[p, 0]] for p in range(begin, begin + count))
        con = range(qr + qb, rq)
        part = {1: lambda: sum(Jq[r, i] * gq[r] for r in range(rq)), 2: lambda: sum(gq[r] for r in con),
                4: lambda: sum(hq[r] * Jq[r, i] * Jq[r, j] for r in range(rq)),
                5: lambda: sum(hq[r] * Jq[r, i] for r in con), 6: lambda: sum(hq[r] for r in con)}
        acc += part[int(kind)]() if int(kind) in part else 0.0
        for code in (place, mirror):
            if code >= 0:
                blocks[code >> 16][code & 0xFFFF] = acc
    as_t = [torch.as_tensor(a).reshape(1, 1, -1) for a in (gq, hq, g_a, h_a)]
    want = ga._assemble(*as_t, torch.as_tensor(Jq).reshape(1, 1, rq, nq), layout.S.double(),
                        layout.S_outer.double(), layout)
    for got, w in zip(blocks, want):
        np.testing.assert_allclose(got, w.reshape(-1).numpy(), rtol=1e-12, atol=1e-12)
    nv = nx + nw
    assert layout.n_live < nv + nv * (nv + 1) // 2  # the zero entries are left out


def test_wrapper_dispatch():
    """A CPU tensor takes the plain version, counting no launch; another
    device raises."""
    tp = MpcProblem(Setup.from_dict(panda_setup()))
    solve = tp.build_solver(device="cpu")
    d = tp.dims
    X, W = torch.zeros((2, d.N, d.nx)), torch.zeros((2, d.N, d.nu))
    P = torch.full((2, d.N, tp.npar), 0.3)
    lam, mu = torch.zeros((2, d.N, tp.n_con)), torch.full((2,), 10.0)
    before = ga.gn_assemble.launches
    solve._internals["stage_expansion_blocks"](X, W, P, lam, mu)
    assert ga.gn_assemble.launches == before
    layout = ga.GnLayout((0, 0, 0), (1, 0, 0), np.ones((1, 2), np.float32), nx=1, ns=0, n_q=0,
                         c_off=torch.zeros((1, 0)))
    meta = torch.zeros((1, 1, 0), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ga.gn_assemble(meta, meta, meta, meta, meta, meta, meta, meta, meta, meta, layout=layout)


@pytest.mark.parametrize("near_clamp", [False, True], ids=["live", "near-clamp"])
@pytest.mark.parametrize("fault", ["phr", "phr-sign", "residual", "slack"])
def test_the_bar_rejects_a_dropped_term(fault, near_clamp):
    """The bar of the kernel checks (each entry within 1e-4 of its own term
    scale) rejects an assembly that drops or flips one family of terms, also
    where live barriers near the clamp make the largest entries ~1e10: the
    PHR terms zeroed or their gradient's sign flipped, the residual terms
    zeroed, the slack column left out."""
    tp = MpcProblem(Setup.from_dict(_panda_variant()))
    arrays, c_off = random_gn_inputs(tp, 8, tp.dims.N, seed=5, near_clamp=near_clamp)
    inputs = [torch.as_tensor(a) for a in arrays]
    layout = gn_layout(tp, torch.as_tensor(c_off))
    want = ga.gn_assemble_reference(*inputs, layout=layout)
    vq, Jq, va, wrq, wbq, wra, wba, lam, mu, W = inputs
    gq, hq, g_a, h_a = ga._row_coefs(vq, va, wrq, wbq, wra, wba, lam, mu, W, layout)
    qr, qb, _ = layout.q_seg
    ar, ab, _ = layout.aff_seg
    if fault == "phr":
        gq[..., qr + qb:], hq[..., qr + qb:], g_a[..., ar + ab:], h_a[..., ar + ab:] = 0.0, 0.0, 0.0, 0.0
    elif fault == "phr-sign":
        gq[..., qr + qb:], g_a[..., ar + ab:] = -gq[..., qr + qb:], -g_a[..., ar + ab:]
    elif fault == "residual":
        gq[..., :qr], hq[..., :qr], g_a[..., :ar], h_a[..., :ar] = 0.0, 0.0, 0.0, 0.0
    else:
        assert layout.ns and layout.q_seg[2]
        layout.ns = 0
    got = ga._assemble(gq, hq, g_a, h_a, Jq, layout.S, layout.S_outer, layout)
    layout.ns = tp.dims.ns
    assert gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout)) > 1.0
