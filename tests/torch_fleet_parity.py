"""Lane-for-lane holds of a port fleet against the JAX fleet, shared by the
tests that run fleets at their default runner (``test_torch_mobile_fleet.py``,
``test_torch_boxer_kick.py``, ``test_torch_point_fleet.py``,
``test_torch_group_default.py``, ``test_torch_distributed.py``'s kicked run).

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
  within the bar of the JAX step from the same input;
* a lane where the two JAX results agree but the port's is past the bar
  of both fails, unless the caller passes ``certify`` and it certifies
  the lane (``certify_lane``): the JAX package's own inner iLQR, run from
  the port's state before each outer (AL) iteration of the lane's solve,
  reproduces every one of the port's AL iterations to ``REPLAY_ATOL`` (and
  its multiplier update to ``REPLAY_ATOL`` over the penalty), so the
  port's result is the JAX algorithm's own from states that differ from
  JAX's by f32 rounding, which a bifurcation of the solve then amplifies.
  Such lanes count with the undetermined ones (at most ``MAX_LOOSE`` a
  step) and are printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.mesh import make_mesh
from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED

X_ATOL = 1e-3
MAX_LOOSE = 2
#: a replayed AL iteration: trajectories within 10 f32 ulps of the largest
#: entry (controls up to ~10), multiplier updates within that over the penalty
REPLAY_ATOL = 1e-5
#: ``FleetRunner``'s default phase-1 outer budget (``phase1_al_iterations``)
PHASE1_AL = 2


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


def hold_states(t, port_prev, port_new, jax_prev, jax_new, jax_from_port, atol=X_ATOL, certify=None):
    """Hold step ``t``'s plant states (numpy state dicts) by the rule above;
    ``certify(lane) -> (bool, line)`` is asked about a determined lane past
    the bar. Returns the lanes the reference did not determine and a line
    to print."""
    inputs_agree = _gap(port_prev, jax_prev) <= atol
    gap_run, gap_same, spread = _gap(port_new, jax_new), _gap(port_new, jax_from_port), _gap(jax_new, jax_from_port)
    held = determined_lanes(port_prev, jax_prev, jax_new, jax_from_port, atol)
    loose = np.flatnonzero(inputs_agree & (spread > atol))
    apart = np.flatnonzero(~inputs_agree)
    certified, notes = [], []
    if certify is not None:
        for lane in np.flatnonzero(held & ((gap_run > atol) | (gap_same > atol))):
            ok, note = certify(int(lane))
            notes.append(f"lane {lane} (gap to the run {gap_run[lane]:.6f}, to the same input "
                         f"{gap_same[lane]:.6f}): {note}")
            if ok:
                certified.append(int(lane))
    held[certified] = False
    line = (f"step {t}: plant-state gap to the JAX run {gap_run[held].max(initial=0):.3e}, to JAX from "
            f"the same input {gap_same[held | ~inputs_agree].max(initial=0):.3e}; "
            f"lanes the reference does not determine: {loose.tolist()} (moved "
            f"{spread[loose].round(6).tolist()}; gap to the run {gap_run[loose].round(6).tolist()}, "
            f"to the same input {gap_same[loose].round(6).tolist()}); lanes apart since an earlier "
            f"step: {apart.tolist()} (gap to the same input {gap_same[apart].round(6).tolist()})"
            + "".join(f"; certified {n}" for n in notes))
    assert len(loose) + len(certified) <= MAX_LOOSE, line
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


def jax_phase1(problem, batch, **runner_kw):
    """The JAX fleet's phase-1 solve (the runner's own ``_solve``, jitted
    alone) and its rescue tier's slots, for ``jax_rescue``."""
    jr = JaxRunner(problem, batch, mesh=make_mesh(devices=jax.devices()[:1]), **runner_kw)
    return jax.jit(jax.vmap(jr._solve)), jr._k_loc


def jax_rescue(solve, state, params, k):
    """The JAX fleet's phase 1 from ``state`` (numpy) and the lanes its
    rescue tier takes: the top-k score of fleet.py:335-341, by ``lax.top_k``."""
    res = solve(state["x"], params, state["z_warm"], state["lam"])
    flag, viol = np.asarray(res.exitflag), np.asarray(res.violation)
    bad = flag != 1
    score = bad.astype(np.float32) * (1.0 + np.minimum(viol, np.float32(1e3)))
    score = np.where(np.isfinite(score), score, np.float32(2e3)).astype(np.float32)
    idx = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
    return {"flag": flag, "score": score, "rescued": set(idx[bad[idx]].tolist())}


def record_rescue(runner):
    """Make the port's ``runner`` keep, for each rescue choice, its phase-1
    flags, scores and rescued lanes (numpy, the form of ``jax_rescue``);
    returns that list."""
    rescue_lanes, out = runner._rescue_lanes, []

    def recording_rescue_lanes(res, k):
        idx, bad = rescue_lanes(res, k)
        score = bad.to(torch.float32) * (1.0 + torch.clamp(res.violation, max=1e3))
        out.append({"flag": res.exitflag.cpu().numpy().copy(), "score": score.cpu().numpy().copy(),
                    "rescued": set(idx[bad[idx]].tolist())})
        return idx, bad

    runner._rescue_lanes = recording_rescue_lanes
    return out


def hold_rescued(t, port, jax_choice):
    """Step ``t``'s rescued lanes: the same set from the same input on every
    lane whose phase-1 exit flag agrees; a borderline flag that differs can
    move the top-k boundary, so at most ``MAX_LOOSE`` lanes differ. Returns
    a line to print."""
    p, j = port, jax_choice
    flipped = np.flatnonzero(p["flag"] != j["flag"])
    moved = sorted((p["rescued"] ^ j["rescued"]) - set(flipped.tolist()))
    line = (f"step {t}: rescued by the port {sorted(p['rescued'])}, by JAX {sorted(j['rescued'])}; "
            f"phase-1 flags differ on {flipped.tolist()} (port {p['flag'][flipped].tolist()}, JAX "
            f"{j['flag'][flipped].tolist()}); rescued by one only, flags agreeing: {moved} (scores port "
            f"{p['score'][moved].tolist()}, JAX {j['score'][moved].tolist()})")
    assert len(p["rescued"]) == len(j["rescued"]) or len(flipped), line
    assert len(flipped) <= MAX_LOOSE and len(moved) <= MAX_LOOSE, line
    return line


def hold_kicked(t, port_prev, port_new, jax_prev, jax_new, jax_from_port, flags, kick_after):
    """Step ``t``'s kicked lanes (``torch_bench_window.kicked``): the port's
    are its own kick flags ``flags``, the JAX step's from the same input the
    same set, and the JAX run's the same on every lane the reference
    determines. Returns the port's kicked lanes and a line to print with the
    smallest distance of an improvement from the 5e-3 threshold."""
    from torch_bench_window import PLATEAU, kicked

    kt = kicked(port_prev, port_new, kick_after)
    kj = kicked(jax_prev, jax_new, kick_after)
    ks = kicked(port_prev, jax_from_port, kick_after)
    margins = np.concatenate([(prev["best_gdist"] - PLATEAU) - new["best_gdist"] for prev, new in (
        (jax_prev, jax_new), (port_prev, port_new), (port_prev, jax_from_port))])
    edge = float(np.min(np.abs(margins[np.isfinite(margins)]), initial=np.inf))
    same = determined_lanes(port_prev, jax_prev, jax_new, jax_from_port)
    line = (f"step {t}: kicked JAX {np.flatnonzero(kj).tolist()}, port {np.flatnonzero(kt).tolist()}; "
            f"closest improvement to the 5e-3 threshold {edge:.3e}")
    np.testing.assert_array_equal(kt, flags, err_msg=line)
    np.testing.assert_array_equal(ks, kt, err_msg=line)
    np.testing.assert_array_equal(kj[same], kt[same], err_msg=line)
    return kt, line


def kick_noise_errors(t, nx, shift, port_new, jax_pairs, kick_after, rank=0):
    """Step ``t``'s kick noise: the largest difference between what the port
    added (its warm start ``port_new`` less its unkicked shift ``shift``,
    ``(z_shift, kick)``) and ``jax.random``'s draw on the fleet's key on its
    kicked lanes, and for each JAX step ``(prev, new)`` of ``jax_pairs`` the
    largest difference between its last two warm-start stages' difference
    and the draws' (its stages N-2 and N-1 both shift its last solved
    stage). Asserts that lanes not kicked got no noise; ``None`` where the
    port kicked no lane."""
    from torch_bench_window import kicked

    z_shift, kick = shift
    if not kick.any():
        return None
    want = kick_draw(t, rank, z_shift[..., nx:].shape)
    got = port_new["z_warm"][..., nx:] - z_shift[..., nx:]
    assert np.array_equal(got[~kick], np.zeros_like(got[~kick])), t  # no noise elsewhere
    want_diff = want[:, -1] - want[:, -2]
    errs_jax = []
    for prev, new in jax_pairs:
        kj = kicked(prev, new, kick_after)
        z = new["z_warm"][..., nx:]
        errs_jax.append(float(np.abs((z[:, -1] - z[:, -2])[kj] - want_diff[kj]).max(initial=0)))
    return float(np.abs(got[kick] - want[kick]).max()), errs_jax


def replay_al_iterations(jax_problem, port_problem, cfg_kw, x, params, z0, lam0):
    """The JAX solver replays each outer (AL) iteration of the port's solve
    of one lane: the port solves ``(x, params, z0, lam0)`` (one lane, numpy)
    with its solver configuration replaced by ``cfg_kw``, stopped after 1, 2,
    ... AL iterations (the budget changes only the loop's end, so each is a
    prefix of the whole solve); from the port's state before each AL
    iteration (its trajectory, multipliers and penalty) the JAX package's
    inner iLQR (``_internals["ilqr"]``) runs that iteration, and the JAX
    multiplier update (al_ilqr.py:873-881) follows it on the port's result.
    Returns per AL iteration the largest difference between JAX's
    trajectory and the port's, between JAX's multipliers and the port's
    relative to the penalty, and the port's final control at stage 0."""
    import dataclasses

    tcfg = dataclasses.replace(port_problem.setup.solver, **cfg_kw)
    jcfg = dataclasses.replace(jax_problem.setup.solver, **cfg_kw)
    internals = jax_problem.build_solver(jcfg)._internals
    ilqr = jax.jit(internals["ilqr"])
    stage_ineq = jax.jit(jax.vmap(internals["stage_ineq"]))
    nx = port_problem.dims.nx
    c_off = port_problem.build_solver(tcfg, device="cpu")._internals["C_OFF"].numpy()

    def port_solve(n_al):
        solve = port_problem.build_solver(dataclasses.replace(tcfg, max_al_iterations=n_al), device="cpu")
        res = solve(*(torch.as_tensor(np.asarray(a)[None]) for a in (x, params, z0, lam0)))
        return res.z[0].numpy(), res.lam[0].numpy(), int(res.iterations[0])

    w_lb, w_ub = (np.asarray(v, np.float32) for v in port_problem._w_bounds())
    W0 = np.clip(np.asarray(z0[:, nx:], np.float32), w_lb, w_ub)
    X = np.asarray(internals["rollout"](jnp.asarray(x), jnp.asarray(W0)))
    W, lam, mu, used = W0, np.asarray(lam0, np.float32), np.float32(jcfg.penalty_initial), 0
    out = []
    for j in range(1, jcfg.max_al_iterations + 1):
        z_j, lam_j, used_j = port_solve(j)
        if used_j == used and j > 1:
            break  # the port's solve finished before this iteration
        with jax.default_matmul_precision("float32"):
            Xj, Wj, gn, _ = ilqr(jnp.asarray(x), jnp.asarray(X), jnp.asarray(W), jnp.asarray(params),
                                 jnp.asarray(lam), jnp.asarray(mu))
        gap = float(np.abs(np.concatenate([np.asarray(Xj), np.asarray(Wj)], -1) - z_j).max())
        C = np.asarray(stage_ineq(jnp.asarray(z_j[:, :nx]), jnp.asarray(z_j[:, nx:]), jnp.asarray(params))) + c_off
        viol = float(np.maximum(0.0, -C).max())
        lam_jax = np.maximum(0.0, lam - mu * C)
        out.append({"al_iteration": j, "penalty": float(mu), "inner_iterations": used_j - used,
                    "trajectory_gap": gap, "multiplier_gap_over_penalty": float(np.abs(lam_jax - lam_j).max() / mu),
                    "u0": z_j[0, -port_problem.dims.nu:].tolist()})
        X, W, lam, used = z_j[:, :nx], z_j[:, nx:], lam_j, used_j
        if viol > jcfg.tol_constraint:
            mu = np.float32(min(mu * jcfg.penalty_scale, jcfg.penalty_max))
    return out


def certify_lane(jax_problem, runner, state, params, lane, rescued, next_x):
    """Certify that the port's solve of ``lane`` in a fleet step from
    ``state`` (numpy, the whole batch) is the JAX algorithm's own
    (``replay_al_iterations``): the lane's phase-1 solve by the port's
    ``runner`` (the default runner's budgets), then, if the port's rescue
    tier took it (``rescued``), its tier solve from the phase-1 result,
    each alone; the last solve's stage-0 control through the plant must
    give the fleet's ``next_x`` for the lane (within ``REPLAY_ATOL``).
    Returns ``(certified, line)``."""
    problem = runner.problem
    base = problem.setup.solver
    one = (lambda a: torch.as_tensor(np.asarray(a)[lane:lane + 1]))
    x, p = one(state["x"]), one(params)
    z, lam = one(state["z_warm"]), one(state["lam"])
    kw = dict(max_al_iterations=min(PHASE1_AL, base.max_al_iterations))
    if lane in rescued:
        res = runner._solve(x, p, z, lam)
        z, lam = res.z, res.lam
        _, al_it, ilqr_it, ls = runner._tier_spec[0]
        kw = dict(max_al_iterations=al_it, max_ilqr_iterations=ilqr_it, line_search_steps=ls)
    replay = replay_al_iterations(jax_problem, problem, kw, x[0].numpy(), p[0].numpy(), z[0].numpy(),
                                  lam[0].numpy())
    u0 = torch.as_tensor([replay[-1]["u0"]], dtype=torch.float32)
    x_gap = float(np.abs(runner._plant(x, u0)[0].numpy() - next_x).max())
    worst = max(r["trajectory_gap"] for r in replay)
    worst_lam = max(r["multiplier_gap_over_penalty"] for r in replay)
    ok = worst <= REPLAY_ATOL and worst_lam <= REPLAY_ATOL and x_gap <= REPLAY_ATOL
    return ok, (f"{'rescue tier' if lane in rescued else 'phase 1'} solve of {len(replay)} AL iterations "
                f"(penalties {[r['penalty'] for r in replay]}, inner iterations "
                f"{[r['inner_iterations'] for r in replay]}) replayed by the JAX iLQR from the port's states: "
                f"trajectories within {worst:.3e}, multipliers within {worst_lam:.3e} x penalty; the "
                f"replayed control gives the fleet's plant state within {x_gap:.3e}")
