"""The whole fleet step and a planner solve as one program with no host read, on the CPU.

On the card ``FleetRunner.step`` and a solve are each captured as one CUDA
graph whose loops are conditional WHILE nodes (``solver/units.py``,
``ops/graph_cond.py``); a capture fails at the first read of a tensor's
value on the host. Here, where no card is, the same code runs eagerly with
every such read patched to raise (``__bool__``, ``item``, ``tolist``,
``cpu``, ``numpy``, ``__int__``, ``__float__``, ``__index__``, ``nonzero``,
and indexing with a boolean mask), except the loops' own guard
(``units._host_flag``, the plain version's one read per trip). The results
equal an unpatched run bit for bit: pointRobot B=32 and panda B=32 with a
rescue tier of 8 slots and the kick live after 2 steps, boxer B=16 (its
``torch.func`` dynamics Jacobians) with a rescue tier, and a B=1 planner
solve. ``tests/test_torch_solver_units.py`` holds the units alone.

Also here: the launch counters' contract on the CPU (a plain version's call
is no launch; ``launch_counts`` and ``fn.launches`` agree), the loop guard's
semantics on a toy program of nested loops, and that the WHILE nodes are
refused, naming them, where a device has none.
"""

import contextlib

import pytest
import torch

from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build, graph_cond
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
from robot_mpcs_tpu_torch.solver import units

import chip_smoke

torch.set_num_threads(2)

#: (setup, B, steps, runner keywords): a rescue tier of B / ratio = 8 slots
FLEETS = {
    "pointRobot": (point_robot_setup, 32, 3, dict(compaction_ratio=4, kick_after=2)),
    "panda": (panda_setup, 32, 3, dict(compaction_ratio=4, kick_after=2)),
    "boxer": (boxer_setup, 16, 2, dict(compaction_ratio=2)),
}
READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__", "__index__", "nonzero")


def _host_read(*args, **kwargs):
    raise AssertionError("the step read a tensor's value on the host")


def _has_mask(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items)


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Every read of a tensor's value on the host raises in the block, but
    the loop guard's own; yields the count of guard reads."""
    guard = [0]
    bool_ = torch.Tensor.__bool__
    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def host_flag(flag):
        guard[0] += 1
        return bool_(flag)

    def masked_get(self, index):
        if _has_mask(index):
            _host_read()
        return getitem(self, index)

    def masked_set(self, index, value):
        if _has_mask(index):
            _host_read()
        return setitem(self, index, value)

    with monkeypatch.context() as m:
        for name in READS:
            m.setattr(torch.Tensor, name, _host_read)
        m.setattr(torch, "nonzero", _host_read)
        m.setattr(torch, "masked_select", _host_read)
        m.setattr(torch.Tensor, "__getitem__", masked_get)
        m.setattr(torch.Tensor, "__setitem__", masked_set)
        m.setattr(units, "_host_flag", host_flag)
        with pytest.raises(AssertionError, match="on the host"):
            bool(torch.ones(()))  # the patch is live
        with pytest.raises(AssertionError, match="on the host"):
            torch.ones(3)[torch.ones(3, dtype=torch.bool)]
        yield guard


def _problem(setup):
    return MpcProblem(Setup.from_dict(setup()))


def _fleet_run(problem, kind, B, steps, kw, monkeypatch=None):
    """``steps`` steps of a fresh runner; per step the state, metrics and the
    merged exit flags (the step program's carry)."""
    runner = FleetRunner(problem, B, device="cpu", **kw)
    scen = runner.to_device(random_fleet_scenario(problem, B, seed=0, **chip_smoke.sampler(kind)))
    state = runner.init_state(scen)
    out, guard = [], 0
    for _ in range(steps):
        ctx = no_host_reads(monkeypatch) if monkeypatch else contextlib.nullcontext([0])
        with ctx as reads:
            state, m = runner.step(state, scen)
        guard += reads[0]
        out.append((state, m, runner._last_program.carry["exitflag"].clone()))
    return out, guard, runner


@pytest.mark.parametrize("kind", sorted(FLEETS))
def test_whole_fleet_step_reads_nothing_on_the_host(kind, monkeypatch):
    setup, B, steps, kw = FLEETS[kind]
    problem = _problem(setup)
    want, _, _ = _fleet_run(problem, kind, B, steps, kw)
    got, guard, runner = _fleet_run(problem, kind, B, steps, kw, monkeypatch)
    assert runner._tiers and runner._tiers[0][0] == 8  # the rescue tier ran in the step
    assert guard > 0  # the loops ran, through their guard only
    for i, ((sw, mw, fw), (sg, mg, fg)) in enumerate(zip(want, got)):
        for name, a, b in zip(sw._fields, sw, sg):
            assert torch.equal(a, b), (i, name)
        for name, a, b in zip(mw._fields, mw, mg):
            assert torch.equal(a, b), (i, name)
        assert torch.equal(fw, fg), i


def test_planner_solve_reads_nothing_on_the_host(monkeypatch):
    problem = _problem(panda_setup)
    sc = random_fleet_scenario(problem, 1, seed=4, **chip_smoke.sampler("panda"))
    d = problem.dims
    z0 = torch.zeros((1, d.N, d.nz))
    z0[:, :, : d.nx] = sc.xinit[:, None]
    want = problem.build_solver(device="cpu")(sc.xinit, sc.params, z0)
    solve = problem.build_solver(device="cpu")
    with no_host_reads(monkeypatch) as guard:
        got = solve(sc.xinit, sc.params, z0)
    assert guard[0] >= 3  # one read per trip of each loop, at least one trip each
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), name


def test_loop_guard_runs_nested_loops():
    dev = torch.device("cpu")

    def init(c):
        a = torch.zeros((), dtype=torch.int32)
        return dict(a=a, n=torch.zeros((), dtype=torch.int32), any_a=a < 3)

    def inner(c):
        b = c["b"] + 1
        return dict(b=b, n=c["n"] + 1, any_b=b < 4)

    def outer_tail(c):
        a = c["a"] + 1
        return dict(a=a, any_a=a < 3)

    prog = units.UnitProgram({
        "init": init, "outer_head": lambda c: dict(b=torch.zeros((), dtype=torch.int32),
                                                   any_b=torch.ones((), dtype=torch.bool)),
        "inner": inner, "outer_tail": outer_tail}, dev)

    def drive():
        prog.run("init")
        for _ in prog.loop("any_a"):
            prog.run("outer_head")
            for _ in prog.loop("any_b"):
                prog.run("inner")
            prog.run("outer_tail")

    assert not prog.graphed()  # the CPU: the driver runs as written
    for _ in range(2):
        prog.call(drive)
        assert (int(prog.carry["a"]), int(prog.carry["n"])) == (3, 12)
    with pytest.raises(RuntimeError, match="wrote n as"):
        prog._write(prog.carry, {"n": torch.zeros(2)})


def test_launch_counts_on_the_cpu():
    """A plain version's call is no launch; counts are kept by (kernel, B)
    on the host, read by ``fn.launches`` and ``launch_counts``, and reset by
    ``fn.launches = 0``; the wrappers keep their names."""
    assert rp.riccati_backward_packed.__name__ == "riccati_backward_packed"
    assert rb.riccati_backward_batched.__name__ == "riccati_backward_batched"
    before = _build.launch_counts()
    packed = rp.riccati_backward_packed.launches
    problem = _problem(point_robot_setup)
    FleetRunner(problem, 16, device="cpu", compaction_ratio=0).run(random_fleet_scenario(problem, 16), 1)
    assert _build.launch_counts() == before and rp.riccati_backward_packed.launches == packed
    cpu = torch.device("cpu")
    with chip_smoke.launches_by_batch(1) as tally:
        for B in (4, 4, 1):
            _build.count_launch(rp.riccati_backward_packed, B, cpu)
        with _build.not_counted():
            _build.count_launch(rp.riccati_backward_packed, 4, cpu)
    assert dict(tally) == {("riccati_backward_packed", 4): 2, ("riccati_backward_packed", 1): 1}
    assert rp.riccati_backward_packed.launches == packed + 3
    rp.riccati_backward_packed.launches = 0
    assert rp.riccati_backward_packed.launches == 0
    assert not any(name == "riccati_backward_packed" for name, _ in _build.launch_counts())
    with pytest.raises(ValueError):
        rp.riccati_backward_packed.launches = 5


def test_while_nodes_refused_without_them(monkeypatch):
    """No fallback: a device without conditional WHILE nodes raises naming
    them (here the CPU; on the card ``tests/test_torch_gpu.py`` forces the
    check false)."""
    assert "not a CUDA device" in graph_cond.missing(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="conditional graph nodes"):
        graph_cond.require(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no program capture"):
        with graph_cond.while_node(torch.ones((), dtype=torch.bool)):
            pass
