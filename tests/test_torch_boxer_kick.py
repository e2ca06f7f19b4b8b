"""The boxer (diff-drive) fleet with the local-minimum kick live, lane for
lane against the JAX fleet.

Both packages step ``bench.py``'s boxer scenario (``bench._scenario_for``,
the JAX package's draw, handed to the port through ``interop``) at B=64,
where the default 1/8 rescue tier has its 8 slots, with ``kick_after=2``
and the default ``kick_scale`` for 18 steps. A boxer lane drives straight
at its goal and improves its goal distance at every step until it parks;
lanes that park more than 0.15 m from it are kicked from step 13 on, and
lanes are kicked twice from step 16 (each kicked step's lanes are
printed). The kick
draws the noise at the boxer's ``nz - nx`` = nu = 2 entries a stage. Besides
its own run, the JAX fleet also takes one step from each of the port's
states (its compiled step, on the same input as the port's step).
Tolerances, and why (those of ``tests/test_torch_fleet_kick.py``):

* kicked lanes: the same set from the same input, and in the two runs on
  every lane the reference determines (``torch_fleet_parity``). A lane is
  kicked when its ``no_improve`` reached ``kick_after`` and fell to 0
  without an improvement (``robot_mpcs_tpu/parallel/fleet.py:309-319``);
  the states show it. The smallest distance of any lane's improvement from
  the 5e-3 threshold is printed: f32 order could put a lane on it;
* noise: what the port added (its warm start less its unkicked shift)
  equals ``jax.random.normal(fold_in(fold_in(PRNGKey(0x5EED), t), 0),
  z[..., nx:].shape)`` within 1e-5 (the draws agree to 3 ulp,
  ``tests/test_torch_prng.py``; the add rounds once more), and lanes not
  kicked got none. The JAX fleet's last two warm-start stages are one
  shifted stage plus two draws, so their difference is the draws'
  difference: that, too, within 1e-5 for the JAX fleet's kicked lanes;
* metrics per step: converged fraction within 2/B, goal distance within
  2%, converged lanes feasible to 1e-4;
* plant states within 1e-3 by ``torch_fleet_parity.hold_states`` (at most
  2 lanes a step the reference does not determine, printed).
"""

import warnings

import numpy as np
import pytest
import torch

import bench
from robot_mpcs_tpu_torch import bench as tbench
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
from torch_bench_window import jax_fleet, record_shifts
from torch_fleet_parity import hold_kicked, hold_metrics, hold_states, kick_noise_errors

torch.set_num_threads(2)

B = 64
STEPS = 18
KICK_AFTER = 2
RUNNER_KW = dict(kick_after=KICK_AFTER)  # the default tier and kick_scale


@pytest.fixture(scope="module")
def runs():
    """Per step: both fleets' states (numpy), the JAX fleet's state after a
    step from the port's state, both runs' metrics, and the port's unkicked
    shift and kick flags."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, _ = bench._load_problem("boxer")
        scen = bench._scenario_for(jp, B, "boxer")
    state, jax_step = jax_fleet(jp, B, scen, **RUNNER_KW)
    jax_states, jax_metrics = [state], []
    for _ in range(STEPS):
        state, m = jax_step(RUNNER_KW, state)
        jax_states.append(state)
        jax_metrics.append(m)

    tp, _ = tbench._load_problem("boxer")
    tr = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    shifts = record_shifts(tr)
    tsc = interop.scenario_from_numpy(np.asarray(scen.xinit), np.asarray(scen.params), device="cpu")
    ts = tr.init_state(tsc)
    port_states, port_metrics = [interop.state_to_numpy(ts)], []
    for _ in range(STEPS):
        ts, m = tr.step(ts, tsc)
        port_states.append(interop.state_to_numpy(ts))
        port_metrics.append({k: float(v) for k, v in m._asdict().items()})
    return dict(jax_states=jax_states, jax_metrics=jax_metrics, port_states=port_states,
                port_metrics=port_metrics, shifts=shifts, dims=tp.dims, slots=tr._tiers[0][0],
                jax_from_port=[jax_step(RUNNER_KW, s)[0] for s in port_states[:-1]])


def test_same_lanes_kicked(runs):
    assert runs["slots"] == B // 8
    times = np.zeros(B, int)
    for t in range(STEPS):
        kt, line = hold_kicked(t, runs["port_states"][t], runs["port_states"][t + 1], runs["jax_states"][t],
                               runs["jax_states"][t + 1], runs["jax_from_port"][t], runs["shifts"][t][1],
                               KICK_AFTER)
        print(line)
        times += kt
    twice = np.flatnonzero(times >= 2)
    print(f"lanes kicked at least twice: {twice.tolist()}")
    assert int(times.sum()) >= 4 and len(twice) >= 1, times


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
    assert checked >= 4, checked


def test_boxer_fleet_with_kick_matches_jax(runs):
    for t in range(STEPS):
        mt, mj = runs["port_metrics"][t], runs["jax_metrics"][t]
        hold_metrics(t, mt, mj, B)
        _, line = hold_states(t, runs["port_states"][t], runs["port_states"][t + 1], runs["jax_states"][t],
                              runs["jax_states"][t + 1], runs["jax_from_port"][t])
        print(line)
    assert int(runs["port_states"][-1]["step"]) == int(runs["jax_states"][-1]["step"]) == STEPS
