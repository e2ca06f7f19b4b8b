"""Lane-for-lane holds of a port fleet against the JAX fleet, shared by the
tests that run fleets at their default runner (``test_torch_mobile_fleet.py``,
``test_torch_boxer_kick.py``, ``test_torch_distributed.py``'s kicked run).

Each step is compared three ways: the port's run, the JAX fleet's own run,
and the JAX fleet stepped from the port's state (the same input as the
port's step). The plant-state rule, with the bar of
``tests/test_torch_fleet.py`` (1e-3):

* a lane where the JAX step's two results (its run and from the port's
  state) are within the bar of each other is held within the bar of both;
* a lane where they are not, although the two inputs agreed within the
  bar, is one the reference does not determine (a borderline phase-1 exit
  flag sends it through the rescue tier, or not; ROADMAP Queue 3): at most
  ``MAX_LOOSE`` a step (2/B, the flipped flags the converged bar allows),
  printed, and held within the bar of one of the two;
* a lane whose inputs already differ (such a lane's earlier step) is held
  within the bar of the JAX step from the same input.
"""

import jax
import jax.numpy as jnp
import numpy as np

from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED

X_ATOL = 1e-3
MAX_LOOSE = 2


def kick_draw(t, rank, shape):
    """``jax.random.normal`` on the JAX fleet's kick key for step ``t`` on
    ``rank`` (``robot_mpcs_tpu/parallel/fleet.py:449-456``)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KICK_SEED), t), rank)
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _gap(a, b):
    return np.abs(a["x"] - b["x"]).max(axis=1)


def determined_lanes(port_prev, jax_prev, jax_new, jax_from_port, atol=X_ATOL):
    """Lanes on which the two runs are compared: their inputs agree, and the
    JAX step's results from the two inputs agree (numpy state dicts)."""
    return (_gap(port_prev, jax_prev) <= atol) & (_gap(jax_new, jax_from_port) <= atol)


def hold_states(t, port_prev, port_new, jax_prev, jax_new, jax_from_port, atol=X_ATOL):
    """Hold step ``t``'s plant states (numpy state dicts) by the rule above;
    returns the lanes the reference did not determine and a line to print."""
    inputs_agree = _gap(port_prev, jax_prev) <= atol
    gap_run, gap_same, spread = _gap(port_new, jax_new), _gap(port_new, jax_from_port), _gap(jax_new, jax_from_port)
    held = determined_lanes(port_prev, jax_prev, jax_new, jax_from_port, atol)
    loose = np.flatnonzero(inputs_agree & (spread > atol))
    apart = np.flatnonzero(~inputs_agree)
    line = (f"step {t}: plant-state gap to the JAX run {gap_run[held].max(initial=0):.3e}, to JAX from "
            f"the same input {gap_same[held | ~inputs_agree].max(initial=0):.3e}; "
            f"lanes the reference does not determine: {loose.tolist()} (moved "
            f"{spread[loose].round(6).tolist()}; gap to the run {gap_run[loose].round(6).tolist()}, "
            f"to the same input {gap_same[loose].round(6).tolist()}); lanes apart since an earlier "
            f"step: {apart.tolist()} (gap to the same input {gap_same[apart].round(6).tolist()})")
    assert len(loose) <= MAX_LOOSE, line
    assert np.all(gap_run[held] <= atol) and np.all(gap_same[held] <= atol), line
    assert np.all(np.minimum(gap_run, gap_same)[loose] <= atol), line
    assert np.all(gap_same[apart] <= atol), line
    return loose, line


def hold_metrics(t, port, jax_m, batch):
    """The per-step bars of ``tests/test_torch_fleet.py``: converged fraction
    within 2/B, mean goal distance within 2%, converged lanes feasible to
    1e-4, every metric finite."""
    assert all(np.isfinite(v) for v in port.values()), (t, port)
    assert abs(port["converged_fraction"] - jax_m["converged_fraction"]) <= 2 / batch + 1e-6, (t, port, jax_m)
    assert abs(port["mean_goal_distance"] - jax_m["mean_goal_distance"]) <= 0.02 * jax_m["mean_goal_distance"], (
        t, port, jax_m)
    assert port["max_violation_converged"] <= 1e-4, (t, port)
