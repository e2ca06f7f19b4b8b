"""The pointRobot fleet at the runner users get by default, with the kick
live, lane for lane against the JAX fleet.

Both packages step ``bench.py``'s pointRobot scenario
(``bench._scenario_for``, the JAX package's draw, handed to the port
through ``interop``) at B=64 with the runner of the bench's pointRobot
extra: the default 1/8 rescue tier (8 slots here) and the default
``kick_scale``, with ``kick_after=2`` so that lanes are kicked within the
run's 10 steps (a lane parked behind an obstacle is kicked from step 2 on;
each step's kicked lanes are printed). The kick draws the noise at the
pointRobot's ``nz - nx`` = nu = 3 entries a stage. Besides its own run, the
JAX fleet takes one step from each of the port's states, and its phase-1
solve (the runner's own ``_solve``, jitted alone) runs on each of them, so
that the lanes its rescue tier takes (``lax.top_k`` over the score of
``robot_mpcs_tpu/parallel/fleet.py:335-341``) are known. Tolerances, and
why (those of ``tests/test_torch_boxer_kick.py`` and
``tests/test_torch_mobile_fleet.py``):

* metrics per step: converged fraction within 2/B, mean goal distance
  within 2%, converged lanes feasible to 1e-4;
* rescued lanes: the same set from the same input on every lane whose
  phase-1 exit flag agrees, at most 2 lanes a step apart (a borderline flag
  moves the top-k boundary), printed;
* kicked lanes: the same set from the same input, and in the two runs on
  every lane the reference determines (``torch_fleet_parity``);
* noise: what the port added (its warm start less its unkicked shift)
  equals ``jax.random.normal(fold_in(fold_in(PRNGKey(0x5EED), t), 0),
  z[..., nx:].shape)`` within 1e-5, lanes not kicked got none, and the JAX
  fleet's last two stages differ by the draws' difference within 1e-5;
* plant states within 1e-3 by ``torch_fleet_parity.hold_states`` (at most
  2 lanes a step the reference does not determine, printed).
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from robot_mpcs_tpu_torch import bench as tbench
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
from torch_bench_window import jax_fleet, record_shifts
from torch_fleet_parity import (hold_kicked, hold_metrics, hold_rescued, hold_states, jax_phase1, jax_rescue,
                                kick_noise_errors, record_rescue)

torch.set_num_threads(2)

B = 64
STEPS = 10
KICK_AFTER = 2
RUNNER_KW = dict(kick_after=KICK_AFTER)  # the default tier and kick_scale


@pytest.fixture(scope="module")
def runs():
    """Per step: both fleets' states (numpy) and metrics, the JAX step and
    its phase-1 rescue choice from the port's state, the port's rescue
    choice, and its unkicked shift and kick flags."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, _ = bench._load_problem("pointRobot")
        scen = bench._scenario_for(jp, B, "pointRobot")
    params = np.asarray(scen.params)
    state, jax_step = jax_fleet(jp, B, scen, **RUNNER_KW)
    jax_states, jax_metrics = [state], []
    for _ in range(STEPS):
        state, m = jax_step(RUNNER_KW, state)
        jax_states.append(state)
        jax_metrics.append(m)

    tp, _ = tbench._load_problem("pointRobot")
    tr = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    shifts, port_rescue = record_shifts(tr), record_rescue(tr)
    tsc = interop.scenario_from_numpy(np.asarray(scen.xinit), params, device="cpu")
    ts = tr.init_state(tsc)
    port_states, port_metrics = [interop.state_to_numpy(ts)], []
    for _ in range(STEPS):
        ts, m = tr.step(ts, tsc)
        port_states.append(interop.state_to_numpy(ts))
        port_metrics.append({k: float(v) for k, v in m._asdict().items()})
    phase1, k = jax_phase1(jp, B, **RUNNER_KW)
    return dict(jax_states=jax_states, jax_metrics=jax_metrics, port_states=port_states,
                port_metrics=port_metrics, shifts=shifts, port_rescue=port_rescue, dims=tp.dims,
                slots=(tr._tiers[0][0], k), jax_from_port=[jax_step(RUNNER_KW, s)[0] for s in port_states[:-1]],
                jax_rescue=[jax_rescue(phase1, s, params, k) for s in port_states[:-1]])


def test_default_tier(runs):
    """The configuration under test: the default tier's 8 slots in both
    packages, its choice made at every step."""
    assert runs["slots"] == (B // 8, B // 8)
    assert len(runs["port_rescue"]) == len(runs["shifts"]) == STEPS


def test_fleet_metrics_match_jax(runs):
    for t in range(STEPS):
        mt, mj = runs["port_metrics"][t], runs["jax_metrics"][t]
        print(f"step {t}: converged {mj['converged_fraction']:.4f} / {mt['converged_fraction']:.4f}, "
              f"iterations {mj['mean_iterations']:.3f} / {mt['mean_iterations']:.3f}, goal distance "
              f"{mj['mean_goal_distance']:.5f} / {mt['mean_goal_distance']:.5f}, overflow "
              f"{mj['rescue_overflow_fraction']:.4f} / {mt['rescue_overflow_fraction']:.4f} (JAX / port)")
        hold_metrics(t, mt, mj, B)
    assert int(runs["port_states"][-1]["step"]) == int(runs["jax_states"][-1]["step"]) == STEPS


def test_rescued_lanes_match_jax(runs):
    for t in range(STEPS):
        print(hold_rescued(t, runs["port_rescue"][t], runs["jax_rescue"][t]))


def test_same_lanes_kicked(runs):
    times = np.zeros(B, int)
    for t in range(STEPS):
        kt, line = hold_kicked(t, runs["port_states"][t], runs["port_states"][t + 1], runs["jax_states"][t],
                               runs["jax_states"][t + 1], runs["jax_from_port"][t], runs["shifts"][t][1],
                               KICK_AFTER)
        print(line)
        times += kt
    print(f"kicked lanes: {np.flatnonzero(times).tolist()}, {int(times.sum())} kicks")
    assert int(times.sum()) >= 2, times


def test_kick_noise_is_jax_draw(runs):
    nx = runs["dims"].nx
    assert runs["shifts"][0][0].shape[-1] - nx == runs["dims"].nu + runs["dims"].ns
    checked = 0
    for t in range(STEPS):
        errs = kick_noise_errors(t, nx, runs["shifts"][t], runs["port_states"][t + 1], (
            (runs["jax_states"][t], runs["jax_states"][t + 1]),
            (runs["port_states"][t], runs["jax_from_port"][t])), KICK_AFTER)
        if errs is None:
            continue
        err, errs_jax = errs
        kick = runs["shifts"][t][1]
        print(f"step {t}: {int(kick.sum())} kicked lanes; port noise vs jax.random {err:.3e}; "
              f"JAX fleet's stage difference vs the draws' (its run, from the port's state) "
              f"{errs_jax[0]:.3e}, {errs_jax[1]:.3e}")
        assert max(err, *errs_jax) <= 1e-5, (t, err, errs_jax)
        checked += int(kick.sum())
    assert checked >= 2, checked


def test_plant_states_match_jax(runs):
    for t in range(STEPS):
        _, line = hold_states(t, runs["port_states"][t], runs["port_states"][t + 1], runs["jax_states"][t],
                              runs["jax_states"][t + 1], runs["jax_from_port"][t])
        print(line)


#: the port's pointRobot fleet on the CPU at B=1024, per step 0-37
#: (``tests/torch_bench_window.py --robot pointRobot``, beside the JAX numbers
#: that ``chip_smoke.POINT_JAX_CPU`` keeps)
PORT_CPU_B1024 = {
    "converged_fraction": (1.0,) * 38,
    "mean_iterations": (5.51171875, 3.787109375, 3.5517578125, 3.3935546875, 3.0830078125, 2.865234375,
                        2.5966796875, 2.4267578125, 2.5615234375, 2.615234375, 2.6630859375, 2.6494140625,
                        2.6689453125, 2.6337890625, 2.6376953125, 2.6484375, 2.638671875, 2.64453125,
                        2.58984375, 2.6044921875, 2.564453125, 2.5966796875, 2.560546875, 2.5859375,
                        2.578125, 2.5771484375, 2.548828125, 2.5625, 2.5693359375, 2.5126953125,
                        2.5380859375, 2.5048828125, 2.52734375, 2.5107421875, 2.5009765625, 2.5400390625,
                        2.466796875, 2.4775390625),
    "mean_goal_distance": (1.684924840927124, 1.6682515144348145, 1.641641616821289, 1.6060919761657715,
                           1.562582015991211, 1.512068748474121, 1.4554802179336548, 1.3937129974365234,
                           1.3276265859603882, 1.2580420970916748, 1.1857391595840454, 1.111453652381897,
                           1.0358771085739136, 0.9596549868583679, 0.8833884000778198, 0.8076330423355103,
                           0.7329021692276001, 0.6596678495407104, 0.588363766670227, 0.5193889737129211,
                           0.45311325788497925, 0.3898845911026001, 0.3300454914569855, 0.27396923303604126,
                           0.22211693227291107, 0.17508381605148315, 0.1340414583683014, 0.10204173624515533,
                           0.09666954725980759, 0.11947857588529587, 0.14418239891529083, 0.16808634996414185,
                           0.19031113386154175, 0.21045748889446259, 0.22832927107810974, 0.24384276568889618,
                           0.25698399543762207, 0.26778632402420044),
}


@pytest.mark.parametrize("moved", [None, "converged_fraction", "mean_iterations", "mean_goal_distance"])
def test_card_window_check(moved):
    """``chip_smoke.hold_window``, the card's check of this fleet at B=1024
    against the JAX package's CPU numbers over steps 8-37, takes the port's
    CPU numbers and refuses them with one field moved away from the JAX
    numbers past its bar (0.006 converged, 1.1% iterations, 0.6% goal
    distance)."""
    records = [{k: v[i] for k, v in PORT_CPU_B1024.items()} for i in range(chip_smoke.POINT_STEPS)]
    check = functools.partial(chip_smoke.hold_window, "pointRobot", reference=chip_smoke.POINT_JAX_CPU,
                              window=chip_smoke.POINT_WINDOW)
    if moved is None:
        check(records)
        return
    lo, hi = chip_smoke.POINT_WINDOW
    away = 1.0 if np.mean([r[moved] for r in records[lo:hi]]) > np.mean(chip_smoke.POINT_JAX_CPU[moved][lo:hi]) else -1.0
    for r in records[lo:hi]:
        r[moved] = r[moved] + away * 0.006 if moved == "converged_fraction" else r[moved] * (
            1.0 + away * (0.011 if moved == "mean_iterations" else 0.006))
    with pytest.raises(chip_smoke.SmokeFailure, match=moved):
        check(records)
