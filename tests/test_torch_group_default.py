"""The mixed fleet at the runner users get by default, with the kick live,
class by class and lane for lane against the JAX package's ``FleetGroup``.

Both packages build a ``FleetGroup`` of pointRobot 64, panda 64 and boxer
128 lanes (each class's setup dict with the benchmark's weights, the
fixtures of ``tests/test_torch_fleet_group.py``) at the default runner:
each class's 1/8 rescue tier, which has its 8 slots from 64 lanes up (at
fewer both packages drop the tier, and phase 1 runs the whole budget), the
default ``kick_scale`` and ``kick_after=2``, for 6 steps. They step the
JAX package's ``mixed_fleet_scenarios(seed=0)`` with the benchmark's
samplers (``chip_smoke.sampler``), handed to the port through ``interop``
(``tests/torch_group_window.py``, which runs the same at full width).
Besides its own run, the JAX group takes one step from each of the port's
states, and each class's phase-1 solve (its runner's ``_solve``, jitted
alone) runs on each of them, so that the lanes its rescue tier takes are
known. Per class, the bars of ``tests/test_torch_point_fleet.py``:

* metrics per step: converged fraction within 2/B, mean goal distance
  within 2%, converged lanes feasible to 1e-4;
* rescued lanes: the same set from the same input on every lane whose
  phase-1 exit flag agrees, at most 2 lanes a step apart, printed;
* kicked lanes: the same set from the same input, and in the two runs on
  every lane the reference determines; each step's kicked lanes printed
  (a boxer lane drives straight at its goal and is first kicked after
  these steps, ``tests/test_torch_boxer_kick.py``);
* noise: the port's equals ``jax.random``'s draw on the fleet's key within
  1e-5, none on lanes not kicked, the JAX fleet's last two stages differ
  by the draws' difference within 1e-5;
* plant states within 1e-3 by ``torch_fleet_parity.hold_states``, where
  a lane past the bar of both JAX results counts as one the reference
  does not determine only if ``torch_fleet_parity.certify_lane`` certifies
  it: the JAX package's own inner iLQR, run from the port's state before
  each outer iteration of the lane's solve, reproduces every one of them
  to 1e-5 (boxer lane 20 at step 1: both packages agree through three AL
  iterations, and at the fourth, at penalty 1e5, f32 rounding sends the
  two solves to different stationary points, controls 0.026 apart; a
  float64 solve lands on the JAX package's).

And ``GroupMetrics.overall`` equals the JAX package's ``_aggregate`` of
the port's per-class metrics within 1e-6 (relative where above 1).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from robot_mpcs_tpu.parallel.fleet import FleetMetrics as JaxMetrics
from robot_mpcs_tpu.parallel.fleet_group import _aggregate as jax_aggregate
from robot_mpcs_tpu_torch import interop
from test_torch_fleet_group import SETUPS, problems  # noqa: F401 (a fixture)
from torch_bench_window import record_shifts
from torch_fleet_parity import (certify_lane, hold_kicked, hold_metrics, hold_rescued, hold_states, jax_phase1,
                                jax_rescue, kick_noise_errors, record_rescue)
from torch_group_window import jax_group, jax_problems, port_group, scenarios

torch.set_num_threads(2)

SIZES = {"pointRobot": 64, "panda": 64, "boxer": 128}
STEPS = 6
KICK_AFTER = 2
RUNNER_KW = dict(kick_after=KICK_AFTER)  # each class's default tier and kick_scale


def _floats(metrics):
    return {k: float(v) for k, v in metrics._asdict().items()}


@pytest.fixture(scope="module")
def runs(problems):  # noqa: F811
    """Per class and step: both groups' states (numpy) and metrics, the JAX
    group's step and each class's phase-1 rescue choice from the port's
    states, the port's rescue choices and unkicked shifts and kick flags;
    the port's overall and per-class metrics as tensors."""
    assert list(SIZES) == list(SETUPS)
    jsub = jax_problems(SIZES)
    scens = scenarios(jsub)
    state, jax_step = jax_group(jsub, scens, **RUNNER_KW)
    jax_states, jax_metrics = [state], []
    for _ in range(STEPS):
        state, m = jax_step(state)
        jax_states.append(state)
        jax_metrics.append(m)

    group, tsc = port_group({k: (problems[k], b) for k, b in SIZES.items()}, scens, **RUNNER_KW)
    shifts = {k: record_shifts(r) for k, r in group.runners.items()}
    port_rescue = {k: record_rescue(r) for k, r in group.runners.items()}
    ts = group.init_states(tsc)
    port_states, port_metrics, group_metrics = [{k: interop.state_to_numpy(s) for k, s in ts.items()}], [], []
    for _ in range(STEPS):
        ts, m = group.step(ts, tsc)
        port_states.append({k: interop.state_to_numpy(s) for k, s in ts.items()})
        port_metrics.append({"overall": _floats(m.overall), **{k: _floats(v) for k, v in m.per_class.items()}})
        group_metrics.append(m)
    jax_from_port = [jax_step(s)[0] for s in port_states[:-1]]
    jax_choice, slots = {}, {}
    for k, (jp, b) in jsub.items():
        phase1, slots[k] = jax_phase1(jp, b, **RUNNER_KW)
        jax_choice[k] = [jax_rescue(phase1, s[k], np.asarray(scens[k].params), slots[k]) for s in port_states[:-1]]

    def per_class(k, seq):
        return [x[k] for x in seq]

    out = {k: dict(jax_states=per_class(k, jax_states), jax_metrics=per_class(k, jax_metrics),
                   port_states=per_class(k, port_states), port_metrics=per_class(k, port_metrics),
                   jax_from_port=per_class(k, jax_from_port), shifts=shifts[k], port_rescue=port_rescue[k],
                   jax_rescue=jax_choice[k], dims=group.runners[k].dims,
                   slots=(group.runners[k]._tiers[0][0], slots[k]), runner=group.runners[k],
                   jax_problem=jsub[k][0], params=np.asarray(scens[k].params))
           for k in SIZES}
    out["group_metrics"] = group_metrics
    out["overall"] = dict(port=per_class("overall", port_metrics), jax=per_class("overall", jax_metrics))
    return out


CLASSES = pytest.mark.parametrize("name", list(SIZES))


@CLASSES
def test_default_tier(runs, name):
    """Each class's default tier with its B/8 slots in both packages, its
    choice made at every step."""
    r = runs[name]
    assert r["slots"] == (SIZES[name] // 8, SIZES[name] // 8)
    assert len(r["port_rescue"]) == len(r["shifts"]) == STEPS


@CLASSES
def test_fleet_metrics_match_jax(runs, name):
    r = runs[name]
    for t in range(STEPS):
        mt, mj = r["port_metrics"][t], r["jax_metrics"][t]
        print(f"{name} step {t}: converged {mj['converged_fraction']:.4f} / {mt['converged_fraction']:.4f}, "
              f"iterations {mj['mean_iterations']:.3f} / {mt['mean_iterations']:.3f}, goal distance "
              f"{mj['mean_goal_distance']:.5f} / {mt['mean_goal_distance']:.5f}, overflow "
              f"{mj['rescue_overflow_fraction']:.4f} / {mt['rescue_overflow_fraction']:.4f} (JAX / port)")
        hold_metrics(t, mt, mj, SIZES[name])
    assert int(r["port_states"][-1]["step"]) == int(r["jax_states"][-1]["step"]) == STEPS


@CLASSES
def test_rescued_lanes_match_jax(runs, name):
    r = runs[name]
    for t in range(STEPS):
        print(name, hold_rescued(t, r["port_rescue"][t], r["jax_rescue"][t]))


@CLASSES
def test_same_lanes_kicked(runs, name):
    r = runs[name]
    times = np.zeros(SIZES[name], int)
    for t in range(STEPS):
        kt, line = hold_kicked(t, r["port_states"][t], r["port_states"][t + 1], r["jax_states"][t],
                               r["jax_states"][t + 1], r["jax_from_port"][t], r["shifts"][t][1], KICK_AFTER)
        print(name, line)
        times += kt
    print(f"{name}: kicked lanes {np.flatnonzero(times).tolist()}, {int(times.sum())} kicks")


def test_lanes_are_kicked(runs):
    """The kick is live in the group: lanes of the holonomic classes are
    kicked within the run."""
    kicks = {k: sum(int(s[1].sum()) for s in runs[k]["shifts"]) for k in SIZES}
    print(f"kicks per class: {kicks}")
    assert kicks["pointRobot"] >= 1 and kicks["panda"] >= 1, kicks


@CLASSES
def test_kick_noise_is_jax_draw(runs, name):
    r = runs[name]
    nx = r["dims"].nx
    assert r["shifts"][0][0].shape[-1] - nx == r["dims"].nu + r["dims"].ns
    for t in range(STEPS):
        errs = kick_noise_errors(t, nx, r["shifts"][t], r["port_states"][t + 1], (
            (r["jax_states"][t], r["jax_states"][t + 1]), (r["port_states"][t], r["jax_from_port"][t])),
            KICK_AFTER)
        if errs is None:
            continue
        err, errs_jax = errs
        print(f"{name} step {t}: {int(r['shifts'][t][1].sum())} kicked lanes; port noise vs jax.random "
              f"{err:.3e}; JAX fleet's stage difference vs the draws' (its run, from the port's state) "
              f"{errs_jax[0]:.3e}, {errs_jax[1]:.3e}")
        assert max(err, *errs_jax) <= 1e-5, (name, t, err, errs_jax)


@CLASSES
def test_plant_states_match_jax(runs, name):
    r = runs[name]
    for t in range(STEPS):
        def certify(lane):
            return certify_lane(r["jax_problem"], r["runner"], r["port_states"][t], r["params"], lane,
                                r["port_rescue"][t]["rescued"], r["port_states"][t + 1]["x"][lane])

        _, line = hold_states(t, r["port_states"][t], r["port_states"][t + 1], r["jax_states"][t],
                              r["jax_states"][t + 1], r["jax_from_port"][t], certify=certify)
        print(name, line)


def test_overall_is_jax_aggregate(runs):
    """The port's ``GroupMetrics.overall`` is the JAX package's
    ``_aggregate`` (fleet_group.py:48-77) of the port's per-class metrics,
    and the two runs' overall metrics meet the per-step bars at the group's
    width."""
    for t, m in enumerate(runs["group_metrics"]):
        per = {k: JaxMetrics(**{f: jnp.asarray(float(v), jnp.float32) for f, v in pm._asdict().items()})
               for k, pm in m.per_class.items()}
        want = _floats(jax_aggregate(per, SIZES))
        got = _floats(m.overall)
        for f, v in want.items():
            assert abs(got[f] - v) <= 1e-6 * max(1.0, abs(v)), (t, f, got[f], v)
        hold_metrics(t, runs["overall"]["port"][t], runs["overall"]["jax"][t], sum(SIZES.values()))


#: the port's group on the CPU at full width (``chip_smoke.GROUP_SIZES``),
#: per class and over the group, per step 0-7 (``tests/torch_group_window.py``,
#: beside the JAX numbers that ``chip_smoke.GROUP_JAX_CPU`` keeps)
PORT_CPU_FULL = {
    "pointRobot": {
        "converged_fraction": (1.0,) * 8,
        "mean_iterations": (5.51171875, 3.787109375, 3.5517578125, 3.3935546875,
                            3.0830078125, 2.865234375, 2.5966796875, 2.4267578125),
        "mean_goal_distance": (1.684924840927124, 1.6682515144348145, 1.641641616821289, 1.6060919761657715,
                               1.562582015991211, 1.512068748474121, 1.4554802179336548, 1.3937129974365234),
        "rescue_overflow_fraction": (0.0,) * 8,
    },
    "panda": {
        "converged_fraction": (0.87255859375, 0.99658203125, 0.99853515625, 0.99853515625,
                               0.99951171875, 0.99755859375, 0.99658203125, 0.99169921875),
        "mean_iterations": (12.7861328125, 9.45263671875, 8.67529296875, 8.4453125,
                            8.0830078125, 8.02197265625, 7.93115234375, 8.12353515625),
        "mean_goal_distance": (0.6279032230377197, 0.6228806972503662, 0.6149303913116455, 0.6043645143508911,
                               0.5914589762687683, 0.5764666199684143, 0.5596318244934082, 0.5412015318870544),
        "rescue_overflow_fraction": (0.5, 0.0, 0.0, 0.0,
                                     0.0, 0.0, 0.0, 0.0),
    },
    "boxer": {
        "converged_fraction": (0.4404296875, 0.7578125, 0.9892578125, 0.9990234375,
                               1.0, 1.0, 1.0, 1.0),
        "mean_iterations": (16.783203125, 13.1240234375, 10.3359375, 7.5263671875,
                            7.244140625, 7.3017578125, 7.544921875, 7.5439453125),
        "mean_goal_distance": (1.6795461177825928, 1.5891072750091553, 1.4522652626037598, 1.2807085514068604,
                               1.0875413417816162, 0.8866012096405029, 0.6911186575889587, 0.5121335387229919),
        "rescue_overflow_fraction": (0.8144927620887756, 0.6464088559150696, 0.0, 0.0,
                                     0.0, 0.0, 0.0, 0.0),
    },
    "overall": {
        "converged_fraction": (0.79638671875, 0.937744140625, 0.99658203125, 0.9990234375,
                               0.999755859375, 0.998779296875, 0.998291015625, 0.995849609375),
        "mean_iterations": (11.966796875, 8.9541015625, 7.8095703125, 6.95263671875,
                            6.623291015625, 6.552734375, 6.5009765625, 6.554443359375),
        "mean_goal_distance": (1.155069351196289, 1.1257801055908203, 1.080941915512085, 1.0238823890686035,
                               0.9582603573799133, 0.8879007697105408, 0.8164656162261963, 0.7470624446868896),
        "rescue_overflow_fraction": (0.4536231756210327, 0.1616022139787674, 0.0, 0.0,
                                     0.0, 0.0, 0.0, 0.0),
    },
}


@pytest.mark.parametrize("moved", [None, "converged_fraction", "mean_iterations", "mean_goal_distance"])
@pytest.mark.parametrize("name", [*SIZES, "overall"])
def test_card_window_check(name, moved):
    """``chip_smoke.hold_window``, the card's check of the group at full
    width against the JAX package's CPU numbers over steps 2-7, takes the
    port's CPU numbers of each class and of the group and refuses them with
    one field moved away from the JAX numbers past its bar (0.006
    converged, 1.1% iterations, 0.6% goal distance)."""
    steps = chip_smoke.GROUP_STEPS
    records = [{k: v[i] for k, v in PORT_CPU_FULL[name].items()} for i in range(steps)]
    check = functools.partial(chip_smoke.hold_window, f"group {name}", reference=chip_smoke.GROUP_JAX_CPU[name],
                              window=chip_smoke.GROUP_WINDOW)
    if moved is None:
        check(records)
        return
    lo, hi = chip_smoke.GROUP_WINDOW
    away = 1.0 if np.mean([r[moved] for r in records[lo:hi]]) > np.mean(chip_smoke.GROUP_JAX_CPU[name][moved][lo:hi]) else -1.0
    for r in records[lo:hi]:
        r[moved] = r[moved] + away * 0.006 if moved == "converged_fraction" else r[moved] * (
            1.0 + away * (0.011 if moved == "mean_iterations" else 0.006))
    with pytest.raises(chip_smoke.SmokeFailure, match=moved):
        check(records)
