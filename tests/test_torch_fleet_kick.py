"""The panda fleet with the local-minimum kick live, lane for lane against
the JAX fleet.

Both packages step ``bench.py``'s panda scenario (``bench._scenario_for``,
the JAX package's draw, handed to the port through ``interop``) at B=64,
where the default 1/8 rescue tier has its 8 slots, with ``kick_after=2`` and
the default ``kick_scale``: lanes that have not improved their best goal
distance by 5e-3 for two steps are kicked at steps 2 and 4. Besides its own
run, the JAX fleet also takes one step from each of the port's states (its
compiled step, on the same input as the port's step). Tolerances, and why:

* kicked lanes: the same set in both packages, in the two runs and from the
  same input. A lane is kicked when its ``no_improve`` reached
  ``kick_after`` and fell to 0 without an improvement
  (``robot_mpcs_tpu/parallel/fleet.py:309-319``); the states show it. The
  smallest distance of any lane's improvement from the 5e-3 threshold is
  printed: f32 order could put a lane on it;
* noise: what the port added (its warm start less its unkicked shift)
  equals ``jax.random.normal`` on the JAX fleet's key within 1e-5 (the
  draws agree to 3 ulp, ``tests/test_torch_prng.py``; the add rounds once
  more). The JAX fleet's last two warm-start stages are one shifted stage
  plus two draws, so their difference is the draws' difference: that, too,
  within 1e-5, for the JAX fleet's kicked lanes;
* metrics of the two runs, per step: the bars of
  ``tests/test_torch_fleet.py::test_fleet_matches_jax`` (converged fraction
  within 2/B, goal distance within 2%, converged violation <= 1e-4);
* plant states after every step within 1e-3 (that test's bar) of both the
  JAX run's and the JAX step's from the same input, on every lane where
  those two are within 1e-3 of each other. Where they are not, the
  reference does not determine the lane to the bar: an input that moved
  by ~1e-4 moved its result by more (a borderline phase-1 exit flag sends
  the lane through the rescue tier, or not; ROADMAP Queue 3). Such a lane,
  at most 2 a step (2/B, the flipped flags the converged bar allows), is
  printed and held within 1e-3 of one of the two.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from robot_mpcs_tpu_torch import bench as tbench
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED, FleetRunner
from torch_bench_window import PLATEAU, jax_fleet, kicked, record_shifts

torch.set_num_threads(2)

B = 64
STEPS = 5
KICK_AFTER = 2
X_ATOL = 1e-3


def _kicked(prev, new):
    """Lanes kicked by the step from ``prev`` to ``new`` (numpy state dicts),
    and each lane's improvement over the plateau threshold."""
    margin = (prev["best_gdist"] - PLATEAU) - new["best_gdist"]
    return kicked(prev, new, KICK_AFTER), margin


def _draw(t, shape):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KICK_SEED), t), 0)
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.fixture(scope="module")
def runs():
    """Per step: both fleets' states (numpy), the JAX fleet's state after a
    step from the port's state, both runs' metrics, and the port's unkicked
    shift and kick flags."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, _ = bench._load_problem("panda")
        scen = bench._scenario_for(jp, B, "panda")
    kw = dict(kick_after=KICK_AFTER)
    state, jax_step = jax_fleet(jp, B, scen, **kw)
    jax_states, jax_metrics = [state], []
    for _ in range(STEPS):
        state, m = jax_step(kw, state)
        jax_states.append(state)
        jax_metrics.append(m)

    tp, _ = tbench._load_problem("panda")
    tr = FleetRunner(tp, B, device="cpu", **kw)
    shifts = record_shifts(tr)
    tsc = interop.scenario_from_numpy(np.asarray(scen.xinit), np.asarray(scen.params), device="cpu")
    ts = tr.init_state(tsc)
    port_states, port_metrics = [interop.state_to_numpy(ts)], []
    for _ in range(STEPS):
        ts, m = tr.step(ts, tsc)
        port_states.append(interop.state_to_numpy(ts))
        port_metrics.append({k: float(v) for k, v in m._asdict().items()})
    return dict(jax_states=jax_states, jax_metrics=jax_metrics, port_states=port_states,
                port_metrics=port_metrics, shifts=shifts, nx=tp.dims.nx,
                jax_from_port=[jax_step(kw, s)[0] for s in port_states[:-1]])


def test_same_lanes_kicked(runs):
    total = 0
    for t in range(STEPS):
        p0, p1 = runs["port_states"][t], runs["port_states"][t + 1]
        kj, mj = _kicked(runs["jax_states"][t], runs["jax_states"][t + 1])
        kt, mt = _kicked(p0, p1)
        ks, ms = _kicked(p0, runs["jax_from_port"][t])
        margins = np.concatenate([mj, mt, ms])
        edge = float(np.min(np.abs(margins[np.isfinite(margins)]), initial=np.inf))
        print(f"step {t}: kicked JAX {np.flatnonzero(kj).tolist()}, port {np.flatnonzero(kt).tolist()}; "
              f"closest improvement to the 5e-3 threshold {edge:.3e}")
        # the port's own kick flags are what its states show
        np.testing.assert_array_equal(kt, runs["shifts"][t][1])
        np.testing.assert_array_equal(kj, kt)
        np.testing.assert_array_equal(ks, kt)
        total += int(kt.sum())
    assert total >= 4, total


def test_kick_noise_is_jax_draw(runs):
    nx = runs["nx"]
    checked = 0
    for t in range(STEPS):
        z_shift, kick = runs["shifts"][t]
        if not kick.any():
            continue
        want = _draw(t, z_shift[..., nx:].shape)
        got = runs["port_states"][t + 1]["z_warm"][..., nx:] - z_shift[..., nx:]
        err = float(np.abs(got[kick] - want[kick]).max())
        assert np.array_equal(got[~kick], np.zeros_like(got[~kick]))  # no noise elsewhere
        # the JAX fleet's stages N-2 and N-1 both shift its last solved stage
        want_diff = want[:, -1] - want[:, -2]
        errs_jax = []
        for state in (runs["jax_states"][t + 1], runs["jax_from_port"][t]):
            z = state["z_warm"][..., nx:]
            errs_jax.append(float(np.abs((z[:, -1] - z[:, -2])[kick] - want_diff[kick]).max()))
        print(f"step {t}: {int(kick.sum())} kicked lanes; port noise vs jax.random {err:.3e}; "
              f"JAX fleet's stage difference vs the draws' (its run, from the port's state) "
              f"{errs_jax[0]:.3e}, {errs_jax[1]:.3e}")
        assert max(err, *errs_jax) <= 1e-5, (t, err, errs_jax)
        checked += int(kick.sum())
    assert checked >= 4, checked


def test_fleet_with_kick_matches_jax(runs):
    for t in range(STEPS):
        mt, mj = runs["port_metrics"][t], runs["jax_metrics"][t]
        assert all(np.isfinite(v) for v in mt.values()), mt
        assert abs(mt["converged_fraction"] - mj["converged_fraction"]) <= 2 / B + 1e-6
        assert abs(mt["mean_goal_distance"] - mj["mean_goal_distance"]) <= 0.02 * mj["mean_goal_distance"]
        assert mt["max_violation_converged"] <= 1e-4
        x_port = runs["port_states"][t + 1]["x"]
        x_same = runs["jax_from_port"][t]["x"]
        x_jax = runs["jax_states"][t + 1]["x"]
        gap_run = np.abs(x_port - x_jax).max(axis=1)
        gap_same = np.abs(x_port - x_same).max(axis=1)
        spread = np.abs(x_jax - x_same).max(axis=1)
        loose = np.flatnonzero(spread > X_ATOL)
        held = spread <= X_ATOL
        print(f"step {t}: plant-state gap to the JAX run {gap_run[held].max():.3e}, to JAX from the "
              f"same input {gap_same[held].max():.3e}; lanes whose JAX state moves past the bar with "
              f"the input: {loose.tolist()} (moved {spread[loose].round(6).tolist()}; gap to the run "
              f"{gap_run[loose].round(6).tolist()}, to the same input {gap_same[loose].round(6).tolist()})")
        assert len(loose) <= 2, loose
        assert np.all(gap_run[held] <= X_ATOL) and np.all(gap_same[held] <= X_ATOL)
        assert np.all(np.minimum(gap_run, gap_same)[loose] <= X_ATOL)
    assert int(runs["port_states"][-1]["step"]) == int(runs["jax_states"][-1]["step"]) == STEPS
