"""``ops/fk_walk.py`` against the JAX package's FK batch rule ``_walk_scalar``.

The JAX package's FK primitives take its hand-written batch rule
``RobotKinematics._walk_scalar`` (``robot_mpcs_tpu/models/fk.py:289``)
under ``vmap``: ``_with_jac_cv`` for positions and Jacobians, ``_fk_ad`` for
positions. The port's counterpart is ``fk_walk``: on the card the kernel of
``csrc/fk_walk.cu`` (held to its plain version by
``tests/test_torch_fk_gn_emulated.py`` and on the card), on the CPU its plain
version, which this file holds to the JAX rule on the same numpy inputs, at
every robot's link set (``MpcProblem.walk_links``): panda, pointRobot
(prismatic joints), boxer and the mobile panda (diff-drive bases) and the
6-dof chain. Tolerance 1e-5 absolute on P and J: both compute in f32 with
one sin/cos pair per joint, composing the chain in a different order.

Also on the CPU: the chain table the kernel is compiled with
(``walk_table``: one node per distinct chain prefix, the structural zeros
of the JAX rule's symbolic walk) and the wrapper's dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import chain6_setup, mobile_panda_setup
from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.components import FkEval
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.ops import fk_walk as fw

torch.set_num_threads(2)

ATOL = 1e-5
SETUPS = {"panda": panda_setup, "pointRobot": point_robot_setup, "boxer": boxer_setup,
          "mobilePanda": mobile_panda_setup, "chain6": chain6_setup}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def problems(request):
    d = SETUPS[request.param]()
    return request.param, MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))


def _q(n, lead, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, size=lead + (n,)).astype(np.float32)


def test_walk_with_jacobian_matches_the_jax_rule(problems):
    """P and J of every split-row link, lanes x stages, against
    ``vmap(_with_jac_cv(links))`` (the batch rule ``_walk_scalar`` with the
    Jacobian)."""
    _, tp, jp = problems
    links = tp.walk_links
    q = _q(tp.kin.n, (6, 5), seed=1)
    P, J = fw.fk_walk(tp.kin, torch.as_tensor(q), links, True)
    flat = jnp.asarray(q.reshape(-1, tp.kin.n))
    Pj, Jj = jax.vmap(jp.kin._with_jac_cv(tuple(links)))(flat)
    assert P.shape == (6, 5, len(links), 3) and J.shape == (6, 5, len(links), 3, tp.kin.n)
    np.testing.assert_allclose(P.numpy().reshape(Pj.shape), np.asarray(Pj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(J.numpy().reshape(Jj.shape), np.asarray(Jj), rtol=0, atol=ATOL)


def test_walk_positions_match_the_jax_rule(problems):
    """P alone against ``_walk_scalar(..., want_jac=False)``, with no
    Jacobian computed, and the fleet's end-effector position (the end link
    of the same walk) against the JAX package's ``fk_pos`` under ``vmap``."""
    _, tp, jp = problems
    links = tp.walk_links
    q = _q(tp.kin.n, (40,), seed=2)
    P, J = fw.fk_walk(tp.kin, torch.as_tensor(q), links, False)
    assert J is None
    Pj, Jj = jp.kin._walk_scalar(jnp.asarray(q), links, want_jac=False)
    assert Jj is None
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=0, atol=ATOL)
    end = FkEval(tp.kin, torch.as_tensor(q), links, False, kernel=True).pos(tp.robot.end_link)
    want = jax.vmap(lambda qq: jp.kin.fk_pos(qq, jp.robot.end_link))(jnp.asarray(q))
    np.testing.assert_allclose(end.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_walk_table_mirrors_the_jax_rule(problems):
    """The kernel's chain: one node per distinct chain prefix (the JAX
    rule's prefix cache), a link on the root's node only where its chain is
    empty, every column of a joint on a link's chain pointing at that
    joint's node, and the defines ``_build`` compiles it with."""
    name, tp, _ = problems
    links = tp.walk_links
    table = fw.walk_table(tp.kin, links)
    assert fw.walk_table(tp.kin, links) is table  # cached on the kinematics
    prefixes = {tuple(tp.kin._seg_key(s) for s in tp.kin._compile(l)[:i + 1])
                for l in links for i in range(len(tp.kin._compile(l)))}
    assert table.define("FK_S") == len(prefixes)
    assert (table.define("FK_N"), table.define("FK_L")) == (tp.kin.n, len(links)) == (table.n, table.n_links)
    assert table.define("FK_DIFFDRIVE") == int(tp.kin.base_type == "diffdrive")
    assert "," not in table.spec  # nvcc would split a define at a comma
    assert len(table.define("FK_NODE")) == 3 * (table.define("FK_S") + 2)  # the base, the nodes, the padding
    cols = np.asarray([int(v) for v in table.define("FK_COL")[:-1]]).reshape(len(links), tp.kin.n)
    for l, link in enumerate(links):
        joints = {s.q_index for s in tp.kin._compile(link) if s.q_index >= 0}
        assert {c for c in range(tp.kin.n) if cols[l, c]} == joints
    assert _build.defines("fk_walk", (table.spec,)) == [f"-D{t}" for t in table.spec.split(" ")]
    if name == "panda":  # an identity base: its rotation's off-diagonal is structurally zero
        base_zero = [int(v) for v in table.define("FK_ZERO")[9:18]]
        assert base_zero == [0, 1, 1, 1, 0, 1, 1, 1, 0]


def test_wrapper_dispatch():
    """A CPU tensor takes the plain walk (bit for bit the kinematics'
    own), counting no launch; another device raises."""
    tp = MpcProblem(Setup.from_dict(panda_setup()))
    q = torch.as_tensor(_q(7, (4,), seed=3))
    before = fw.fk_walk.launches
    P, J = fw.fk_walk(tp.kin, q, tp.walk_links, True)
    P_ref, J_ref = tp.kin.fk_pos_links_with_jac(q, tp.walk_links)
    assert torch.equal(P, P_ref) and torch.equal(J, J_ref)
    assert fw.fk_walk.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fw.fk_walk(tp.kin, q.to("meta"), tp.walk_links, False)
