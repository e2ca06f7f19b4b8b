"""The mobile panda's fleet at the runner users get by default, lane for lane
against the JAX fleet.

Both packages step the mobile panda (``chip_smoke.mobile_panda_setup``: the
panda arm on a diff-drive base, nx = 22, the general Riccati sweep) from the
JAX package's draw of ``MOBILE_SAMPLER`` at seed 0, handed to the port
through ``interop``, at B=64 for 6 steps, as ``chip_smoke.mobile_phase``
runs it on the card: the default runner (``compaction_ratio=8``: 8 rescue
slots, overflowing from step 0 as at B=1024), no kick (``kick_scale=0.0``).
On the CPU the JAX solver takes its scan backward and the port its general
sweep's plain version. Besides its own run, the JAX fleet takes one step
from each of the port's states, and its phase-1 solve (the runner's own
``_solve``, jitted alone) runs on each of them, so that the lanes its
rescue tier takes (``lax.top_k`` over the score of
``robot_mpcs_tpu/parallel/fleet.py:335-341``) are known. Tolerances, and why:

* metrics per step: converged fraction within 2/B, mean goal distance
  within 2%, converged lanes feasible to 1e-4 (the bars of
  ``tests/test_torch_boxer_fleet.py`` and ``tests/test_torch_distributed.py``);
* the lanes the tier rescued (the top-k lanes that were bad): the same set
  in both packages from the same input, on every lane whose phase-1 exit
  flag agrees. A borderline phase-1 flag that differs can move the top-k
  boundary by one lane, so at most 2 lanes a step may differ; they are
  printed with both packages' flags and scores;
* plant states within 1e-3 by ``torch_fleet_parity.hold_states`` (the
  rule of ``tests/test_torch_fleet_kick.py``: on lanes the reference does
  not determine, at most 2 a step, within the bar of one of the two JAX
  results).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
from torch_bench_window import jax_fleet
from torch_fleet_parity import hold_metrics, hold_rescued, hold_states, jax_phase1, jax_rescue, record_rescue
from torch_mobile_window import RUNNER_KW, problems, scenario

torch.set_num_threads(2)

B = 64
STEPS = 6
SLOTS = B // 8  # the default 1/8 tier


@pytest.fixture(scope="module")
def runs():
    """Per step: both fleets' states (numpy) and metrics, the JAX step and
    its phase-1 rescue choice from the port's state, and the port's phase-1
    flags, scores and rescued lanes."""
    tp, jp = problems()
    scen = scenario(jp, B)
    params = np.asarray(scen.params)
    state, jax_step = jax_fleet(jp, B, scen, **RUNNER_KW)
    jax_states, jax_metrics = [state], []
    for _ in range(STEPS):
        state, m = jax_step(RUNNER_KW, state)
        jax_states.append(state)
        jax_metrics.append(m)

    tr = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    port_rescue = record_rescue(tr)
    tsc = interop.scenario_from_numpy(np.asarray(scen.xinit), params, device="cpu")
    ts = tr.init_state(tsc)
    port_states, port_metrics = [interop.state_to_numpy(ts)], []
    for _ in range(STEPS):
        ts, m = tr.step(ts, tsc)
        port_states.append(interop.state_to_numpy(ts))
        port_metrics.append({k: float(v) for k, v in m._asdict().items()})

    phase1, k = jax_phase1(jp, B, **RUNNER_KW)
    return dict(jax_states=jax_states, jax_metrics=jax_metrics, port_states=port_states,
                port_metrics=port_metrics, port_rescue=port_rescue, slots=(tr._tiers[0][0], k),
                jax_from_port=[jax_step(RUNNER_KW, s)[0] for s in port_states[:-1]],
                jax_rescue=[jax_rescue(phase1, s, params, k) for s in port_states[:-1]])


def test_default_tier_overflows(runs):
    """The configuration under test: 8 slots in both packages, and more bad
    lanes than slots from step 0 in both runs."""
    assert runs["slots"] == (SLOTS, SLOTS)
    assert len(runs["port_rescue"]) == STEPS
    for pkg in ("jax_metrics", "port_metrics"):
        assert runs[pkg][0]["rescue_overflow_fraction"] > 0.5, runs[pkg][0]


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


def test_plant_states_match_jax(runs):
    for t in range(STEPS):
        _, line = hold_states(t, runs["port_states"][t], runs["port_states"][t + 1], runs["jax_states"][t],
                              runs["jax_states"][t + 1], runs["jax_from_port"][t])
        print(line)


#: the port's mobile-panda fleet on the CPU at B=1024, per step 0-5
#: (``tests/torch_mobile_window.py``, beside the JAX numbers that
#: ``chip_smoke.MOBILE_JAX_CPU`` keeps)
PORT_CPU_B1024 = {
    "converged_fraction": (0.0, 0.0, 0.1181640625, 0.2451171875, 0.4609375, 0.974609375),
    "mean_iterations": (18.22265625, 15.0810546875, 14.3251953125, 13.7275390625, 10.0087890625, 7.45703125),
    "mean_goal_distance": (1.4329122304916382, 1.4159419536590576, 1.3891514539718628, 1.353182315826416,
                           1.3085932731628418, 1.2562578916549683),
}


@pytest.mark.parametrize("moved", [None, "converged_fraction", "mean_iterations", "mean_goal_distance"])
def test_card_window_check(moved):
    """``chip_smoke.hold_window``, the card's check of this fleet at B=1024
    against the JAX package's CPU numbers (``MOBILE_JAX_CPU``), takes the
    port's CPU numbers and refuses them with one field moved past its bar
    over steps 2-5 (0.006 converged, 1.1% iterations, 0.6% goal distance)."""
    records = [{k: v[i] for k, v in PORT_CPU_B1024.items()} for i in range(STEPS)]
    check = functools.partial(chip_smoke.hold_window, "mobile panda", reference=chip_smoke.MOBILE_JAX_CPU,
                              window=chip_smoke.MOBILE_WINDOW)
    if moved is None:
        check(records)
        return
    for r in records[2:]:
        r[moved] = r[moved] + 0.006 if moved == "converged_fraction" else r[moved] * (
            1.011 if moved == "mean_iterations" else 1.006)
    with pytest.raises(chip_smoke.SmokeFailure, match=moved):
        check(records)
