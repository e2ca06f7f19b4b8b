"""Batched fleet execution (port of ``robot_mpcs_tpu.parallel.fleet``).

One ``FleetRunner.step`` advances every scenario by one control step:
batched AL-iLQR solve, straggler rescue re-solve, action extraction, plant
integration, shift-horizon warm start, metric reduction. All state lives on
the runner's ``device``. The JAX package jits the whole step
(``jax.jit(sharded_step, donate_argnums=(0,))``); here the whole step,
phase 1 and every rescue tier's solve (each at its own batch size) with
their loops as conditional WHILE nodes, the gathers and merges, the
post-step, the kick's draw and the metrics' reductions, is one program
over a carry (``solver/units.py``), captured as one CUDA graph at the first
step and replayed at every later one with no host read. Whatever metrics
the caller reads come back on top.

With a ``mesh`` (``parallel/mesh.py``: one process per card over
``torch.distributed``) each rank holds and steps the contiguous shard
``B/W`` of the global batch, as the JAX package's ``shard_map`` step does:
the solver's masked loops, the rescue gather and the post-step stay
rank-local, and the only cross-rank traffic is one ``all_reduce(SUM)`` and
one ``all_reduce(MAX)`` of the metrics' numerators, denominators and maxima,
after the step's graph, so every rank returns the same global ``FleetMetrics``. Without a mesh (or
with a mesh that has no process group) the step runs no collective.
``export_step(path)`` writes the step's compiled part, the kernel library,
with its fingerprint (``utils/aot.py``); ``FleetRunner(...,
artifact_dir=path)`` registers it, so a process without ``nvcc`` steps the
fleet. Nothing depends on the robot family: holonomic and diff-drive
problems differ only inside the solver (which Riccati sweep) and the
scenario sampler.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from robot_mpcs_tpu_torch.config import SolverConfiguration
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.mesh import Mesh, shard_batch
from robot_mpcs_tpu_torch.solver.types import SolveResult
from robot_mpcs_tpu_torch.solver.units import UnitProgram
from robot_mpcs_tpu_torch.utils import prng
from robot_mpcs_tpu_torch.utils.devices import resolve_device

#: seed of the local-minimum kick noise: rank r draws at step t from
#: ``fold_in(fold_in(PRNGKey(KICK_SEED), t), r)``, the JAX fleet's key
KICK_SEED = 0x5EED


class FleetScenario(NamedTuple):
    """Batched scenario definition: initial states + per-stage parameters."""

    xinit: torch.Tensor  # (B, nx) float32
    params: torch.Tensor  # (B, N, npar) float32, paramMap layout


class FleetState(NamedTuple):
    """Per-scenario state carried across control steps (on the device)."""

    x: torch.Tensor  # (B, nx) plant state
    z_warm: torch.Tensor  # (B, N, nz) warm-start trajectory
    lam: torch.Tensor  # (B, N, n_con) AL multipliers
    step: torch.Tensor  # () int32
    #: (B,) int32 — consecutive control steps each lane has ended unconverged
    #: (exitflag != 1); drives the stall-recovery cold restart
    stall: torch.Tensor
    #: (B,) best goal distance each lane has ever reached (kick reference)
    best_gdist: torch.Tensor
    #: (B,) int32 — consecutive steps without improving best_gdist
    no_improve: torch.Tensor


class FleetMetrics(NamedTuple):
    """Batch reductions of one step, 0-d tensors on the device (see the JAX
    package's ``FleetMetrics`` for what each field guards against)."""

    #: fraction of solves with exitflag == 1 (feasible AND stationary)
    converged_fraction: torch.Tensor
    mean_cost: torch.Tensor
    max_violation: torch.Tensor
    #: violation per exitflag class: converged (1) vs budget-exhausted (0)
    max_violation_converged: torch.Tensor
    max_violation_unconverged: torch.Tensor
    mean_goal_distance: torch.Tensor
    #: fraction of lanes whose plan was unusable this step (brake + cold restart)
    reset_fraction: torch.Tensor
    mean_iterations: torch.Tensor
    max_iterations: torch.Tensor
    #: unconverged lanes the last rescue tier had no slot for, over bad lanes
    rescue_overflow_fraction: torch.Tensor
    #: max RAW stage-0 violation (an in-collision start the solver masks)
    max_violation0_raw: torch.Tensor


class FleetRunner:
    """Runs B scenarios of one problem class in lockstep: on one device, or
    sharded over the ranks of a ``mesh`` (``B/W`` lanes per rank).

    **Straggler compaction** (on by default): phase 1 runs every lane with a
    short outer budget (``phase1_al_iterations``), then the worst unconverged
    lanes are gathered into a ``1/compaction_ratio``-size sub-batch and
    re-solved warm with a richer budget. ``rescue_tiers``, ``stall_reset_after``
    and the ``kick_*`` local-minimum escape follow the JAX package's
    ``FleetRunner`` exactly (fleet.py:114-156 there); each rescue tier's
    slots come from the rank's batch ``B/W``. Runs on the CUDA card unless
    ``device`` says otherwise (``"cpu"``); with a ``mesh``, on its device.
    ``batch_size`` is the global B and must divide by the mesh size.

    ``artifact_dir``: a directory written by ``export_step`` for a runner of
    the same batch, mesh width, tiers, stall and kick knobs (fleet.py:127,
    536-545 of the JAX package). Its kernel library is registered for this
    process, so the first step builds nothing; a mismatched or unreadable
    export warns and the kernel is built from the sources.
    """

    def __init__(
        self,
        problem: MpcProblem,
        batch_size: int,
        device=None,
        solver_cfg: Optional[SolverConfiguration] = None,
        compaction_ratio: int = 8,
        phase1_al_iterations: int = 2,
        rescue_tiers=None,
        stall_reset_after: int = 3,
        kick_after: int = 25,
        kick_gdist: float = 0.15,
        kick_scale: float = 1.0,
        mesh: Optional[Mesh] = None,
        artifact_dir: Optional[str] = None,
    ):
        self.problem = problem
        self.dims = problem.dims
        self.batch = batch_size
        if mesh is None:  # one device, no process group
            mesh = Mesh(1, 0, resolve_device(device if device is not None else "cuda"))
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        local = mesh.local_slice(batch_size)  # raises unless B divides by W
        b_loc = local.stop - local.start
        base_cfg = solver_cfg if solver_cfg is not None else problem.setup.solver
        self._stall_reset_after = int(stall_reset_after)
        self._kick_after = int(kick_after)
        self._kick_gdist = float(kick_gdist)
        self._kick_scale = float(kick_scale)
        if rescue_tiers is None:
            # the JAX package's production default (round-5 sweep): one
            # 1/8-width tier with a 1.25x budget and a 4-deep line search
            rescue_tiers = (
                [(
                    compaction_ratio,
                    max(5, base_cfg.max_al_iterations),
                    max(10, base_cfg.max_ilqr_iterations),
                    max(4, base_cfg.line_search_steps),
                )]
                if compaction_ratio
                else []
            )
        tiers, tier_spec = [], []
        for tier in rescue_tiers:
            ratio, al_it, ilqr_it = tier[:3]
            ls = tier[3] if len(tier) > 3 else base_cfg.line_search_steps
            k = b_loc // int(ratio)
            if k < 8:
                warnings.warn(
                    f"FleetRunner: rescue tier 1/{ratio} disabled — per-rank "
                    f"batch {b_loc} yields {k} < 8 rescue slots. Affected lanes "
                    f"run the remaining tiers (or phase 1 only). Pass "
                    f"compaction_ratio=0 / rescue_tiers=[] to silence.",
                    stacklevel=2,
                )
                continue
            cfg_t = dataclasses.replace(
                base_cfg,
                max_al_iterations=int(al_it),
                max_ilqr_iterations=int(ilqr_it),
                line_search_steps=int(ls),
            )
            tiers.append((k, problem.build_solver(cfg_t, device=self.device)))
            tier_spec.append((int(ratio), int(al_it), int(ilqr_it), int(ls)))
        self._tiers = tiers
        #: the resolved tier schedule (ratio, al, ilqr, line search): part of
        #: the artifact's fingerprint (utils/aot.py)
        self._tier_spec = tier_spec
        cfg1 = (
            dataclasses.replace(
                base_cfg,
                max_al_iterations=min(phase1_al_iterations, base_cfg.max_al_iterations),
            )
            if tiers
            else base_cfg
        )
        self._solve = problem.build_solver(cfg1, device=self.device)
        self._plant = problem.dynamics  # plant = model (kinematic fidelity)
        pm = problem.param_map
        self._goal = pm.entries.get("goal")
        self._kick_key = prng.prng_key(KICK_SEED, device=self.device)
        #: the step's programs, by input shapes (``_step_program``)
        self._programs = {}
        self._last_program: Optional[UnitProgram] = None
        if artifact_dir is not None:
            from robot_mpcs_tpu_torch.utils.aot import load_fleet_step

            load_fleet_step(self, artifact_dir)

    # ------------------------------------------------------------ artifact

    def export_step(self, path: str) -> str:
        """Write this runner's compiled part, the kernel library its solves
        launch, and ``fleet_meta.yaml`` into ``path`` (``utils/aot.py``);
        returns the metadata file's path. A runner of the same configuration
        built with ``artifact_dir=path`` needs no ``nvcc``. The CUDA graphs
        of the solver are captured in each process at its first step."""
        from robot_mpcs_tpu_torch.utils.aot import export_fleet_step

        return export_fleet_step(self, path)

    # ------------------------------------------------------------ pieces

    def _rescue_stragglers(self, x, params, res: SolveResult, solve_fn, k: int):
        """Gather the k worst unconverged lanes into a compact sub-batch,
        re-solve warm with ``solve_fn``'s budget and merge back the lanes
        that were bad (fleet.py:326-402, one group). Returns the merged
        result, the overflow count and the bad count."""
        nx = self.dims.nx
        bad = res.exitflag != 1
        # worst-first: violated lanes first, non-finite lanes before all
        score = bad.to(torch.float32) * (1.0 + torch.clamp(res.violation, max=1e3))
        score = torch.where(torch.isfinite(score), score, 2e3)
        # a stable descending sort takes ties in index order, as lax.top_k does
        idx = torch.sort(score, descending=True, stable=True)[1][:k]
        n_bad = torch.sum(bad.to(torch.int32))
        overflow = torch.clamp(n_bad - k, min=0)
        x_g, z_g, lam_g = x[idx], res.z[idx], res.lam[idx]
        # Sanitize non-finite warm starts: a diverged (NaN) lane re-solved
        # from its NaN z/lam can never accept a step; restart it cold from
        # the plant state with zeroed multipliers.
        finite = torch.isfinite(z_g).all(-1).all(-1) & torch.isfinite(lam_g).all(-1).all(-1)
        z_cold = torch.zeros_like(z_g)
        z_cold[:, :, :nx] = x_g[:, None, :]
        z_g = torch.where(finite[:, None, None], z_g, z_cold)
        lam_g = torch.where(finite[:, None, None], lam_g, 0.0)
        res2 = solve_fn(x_g, params[idx], z_g, lam_g)
        replace = bad[idx]  # only overwrite genuinely bad lanes

        def merge(a, b):
            rep = replace.reshape(replace.shape + (1,) * (b.dim() - 1))
            out = a.clone()
            out[idx] = torch.where(rep, b, a[idx])
            return out

        merged = SolveResult(
            z=merge(res.z, res2.z),
            exitflag=merge(res.exitflag, res2.exitflag),
            cost=merge(res.cost, res2.cost),
            violation=merge(res.violation, res2.violation),
            grad_norm=merge(res.grad_norm, res2.grad_norm),
            lam=merge(res.lam, res2.lam),
            # rescued lanes report phase-1 + rescue iterations
            iterations=merge(res.iterations, res.iterations[idx] + res2.iterations),
            violation0_raw=merge(res.violation0_raw, res2.violation0_raw),
        )
        return merged, overflow, n_bad

    def _goal_distance(self, x_next, params):
        dims = self.dims
        if self._goal is None:
            return x_next.new_zeros(x_next.shape[0])
        start, size = self._goal
        goal = params[:, 0, start : start + size]
        ee = self.problem.kin.fk_pos(x_next[:, : dims.n], self.problem.robot.end_link)
        return torch.linalg.vector_norm(ee[:, : dims.m] - goal[:, : dims.m], dim=-1)

    def _post_step(self, state: FleetState, scenario: FleetScenario, res: SolveResult):
        """Brake, stall reset, shift warm start, goal distance and the kick
        flag (fleet.py:264-324)."""
        dims = self.dims
        nu, nx = dims.nu, dims.nx
        x = state.x
        # a diverged/heavily-violated plan is not executed nor fed back as
        # the next warm start: brake (u = 0) and cold-restart
        ok = (res.exitflag >= 0) & (res.violation < 0.5)
        u = torch.where(ok[:, None], res.z[:, 0, -nu:], 0.0)
        x_next = self._plant(x, u)
        # stall recovery: a lane that keeps ending unconverged is trapped by
        # its own warm start; the action still executes, the NEXT solve
        # starts cold
        stall_next = torch.where(res.exitflag == 1, 0, state.stall + 1)
        stall_reset = (
            stall_next >= self._stall_reset_after
            if self._stall_reset_after > 0
            else torch.zeros_like(ok)
        )
        stall_next = torch.where(stall_reset, 0, stall_next).to(torch.int32)
        keep_warm = (ok & ~stall_reset)[:, None, None]
        # shift-horizon warm start (reference mpcPlanner.py:215-226)
        cold = torch.zeros_like(res.z)
        cold[:, :, :nx] = x_next[:, None, :]
        z_shift = torch.where(
            keep_warm, torch.cat([res.z[:, 1:], res.z[:, -1:]], 1), cold
        )
        lam_shift = torch.where(
            keep_warm, torch.cat([res.lam[:, 1:], res.lam[:, -1:]], 1), 0.0
        )
        gdist = self._goal_distance(x_next, scenario.params)
        # local-minimum escape bookkeeping: solving fine but the goal
        # distance has plateaued short of the goal -> flag a random kick
        improved = gdist < state.best_gdist - 5e-3
        best_new = torch.minimum(state.best_gdist, gdist)
        ni_next = torch.where(improved, 0, state.no_improve + 1)
        if self._goal is not None and self._kick_after > 0 and self._kick_scale > 0.0:
            kick = (ni_next >= self._kick_after) & (gdist > self._kick_gdist)
        else:
            kick = torch.zeros_like(ok)
        ni_next = torch.where(kick, 0, ni_next).to(torch.int32)
        lam_shift = torch.where(kick[:, None, None], 0.0, lam_shift)
        return x_next, z_shift, lam_shift, gdist, ~ok, stall_next, best_new, ni_next, kick

    # ----------------------------------------------------------------- API

    def init_state(self, scenario: FleetScenario) -> FleetState:
        dims = self.dims
        x = torch.as_tensor(scenario.xinit, dtype=torch.float32, device=self.device).clone()
        B = x.shape[0]
        z0 = torch.zeros((B, dims.N, dims.nz), dtype=torch.float32, device=self.device)
        z0[:, :, : dims.nx] = x[:, None, :]
        return FleetState(
            x=x,
            z_warm=z0,
            lam=torch.zeros((B, dims.N, self.problem.n_con), dtype=torch.float32, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            stall=torch.zeros((B,), dtype=torch.int32, device=self.device),
            best_gdist=torch.full((B,), float("inf"), dtype=torch.float32, device=self.device),
            no_improve=torch.zeros((B,), dtype=torch.int32, device=self.device),
        )

    def to_device(self, scenario: FleetScenario) -> FleetScenario:
        return FleetScenario(
            xinit=torch.as_tensor(scenario.xinit, dtype=torch.float32, device=self.device),
            params=torch.as_tensor(scenario.params, dtype=torch.float32, device=self.device),
        )

    def shard_scenario(self, scenario: FleetScenario) -> FleetScenario:
        """This rank's shard of a global scenario (every rank holds all of
        it, e.g. from a shared seed) on the runner's device; at world 1 the
        whole scenario."""
        return self.to_device(shard_batch(self.mesh, scenario))

    def step(self, state: FleetState, scenario: FleetScenario):
        """Advance every lane one control step; returns (new state, metrics).

        The step is a program over a carry (``solver/units.py``): the state's
        seven tensors and the scenario are copied into its static inputs, the
        step runs, and the new state and the metrics' sums and maxima are
        cloned out (the port's ``donate_argnums``: a later step overwrites
        the carry, never what a caller holds). On the card the whole step,
        its solves' loops included, is one CUDA graph replay with no host
        read; with a process group the metrics' two all-reduces follow it."""
        prog = self._step_program(state, scenario)
        prog.load(**state._asdict(), xinit=scenario.xinit, params=scenario.params)
        prog.call(lambda: prog.run("step"))
        c = prog.carry
        new_state = FleetState(**{k: c[f"next_{k}"].clone() for k in FleetState._fields})
        return new_state, self._metrics(c["sums"].clone(), c["maxes"].clone(), state.x.shape[0])

    def _step_program(self, state: FleetState, scenario: FleetScenario) -> UnitProgram:
        """The step's program at these input shapes (one per runner in use)."""
        key = tuple(tuple(t.shape) for t in (*state, scenario.xinit, scenario.params))
        if key not in self._programs:
            # a weak reference: the program (and its graph and pools) dies
            # with the runner, not at a later garbage collection
            step = weakref.WeakMethod(self._step_unit)
            self._programs[key] = UnitProgram({"step": lambda c: step()(c)}, self.device)
        self._last_program = self._programs[key]
        return self._last_program

    def _step_unit(self, c):
        """One step on the carry's inputs: phase 1, each rescue tier's
        gather, solve and merge, the post-step, the kick's draw and the
        metrics' rank-local sums and maxima (fleet.py:405-502 of the JAX
        package). Returns the new state (``next_*``), ``sums``, ``maxes`` and
        the merged exit flags (``exitflag``)."""
        dims = self.dims
        state = FleetState(**{k: c[k] for k in FleetState._fields})
        scenario = FleetScenario(xinit=c["xinit"], params=c["params"])
        res = self._solve(state.x, scenario.params, state.z_warm, state.lam)
        # overflow is reported for the LAST tier: bad lanes the final
        # (widest-budget) pass had no slot for
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        bad_total = torch.zeros((), dtype=torch.int32, device=self.device)
        for k_t, solve_t in self._tiers:
            res, overflow, bad_total = self._rescue_stragglers(
                state.x, scenario.params, res, solve_t, k_t
            )
        (x_next, z_shift, lam_shift, gdist, was_reset, stall_next, best_gdist,
         no_improve, kick) = self._post_step(state, scenario, res)
        if self._kick_scale > 0.0:
            # randomized restart for plateaued lanes: zero-mean noise on the
            # warm start's [s, u] entries — the slack entries too, exactly
            # as fleet.py:457 of the JAX package adds it. The noise is
            # jax.random's draw from the key folded on the step (a device
            # tensor of the carry, no host read) and the rank (JAX's axis_index).
            key = prng.fold_in(prng.fold_in(self._kick_key, state.step), self.mesh.rank)
            noise = self._kick_scale * prng.normal(key, z_shift[..., dims.nx :].shape)
            z_shift = z_shift.clone()
            z_shift[..., dims.nx :] += torch.where(kick[:, None, None], noise, 0.0)
        sums, maxes = self._local_metrics(res, was_reset, gdist, overflow, bad_total)
        new_state = FleetState(
            x=x_next, z_warm=z_shift, lam=lam_shift, step=state.step + 1,
            stall=stall_next, best_gdist=best_gdist, no_improve=no_improve,
        )
        return {**{f"next_{k}": v for k, v in new_state._asdict().items()},
                "sums": sums, "maxes": maxes, "exitflag": res.exitflag}

    def _local_metrics(self, res: SolveResult, was_reset, gdist, overflow, bad_total):
        """The rank-local sums and maxima of the batch reductions
        (fleet.py:460-502), one vector each. Failed lanes are masked out of
        the means so one NaN lane cannot poison the aggregates."""
        ok = ~was_reset
        conv = res.exitflag == 1
        f32 = lambda v: v.to(torch.float32)

        def masked(v, mask):
            return torch.where(mask, v, 0.0)

        v0 = res.violation0_raw
        sums = torch.stack([
            torch.sum(f32(ok)),
            torch.sum(f32(conv)),
            torch.sum(masked(res.cost, ok)),
            torch.sum(masked(gdist, ok)),
            torch.sum(f32(was_reset)),
            torch.sum(f32(res.iterations)),
            f32(overflow),
            f32(bad_total),
        ])
        maxes = torch.stack([
            torch.amax(masked(res.violation, ok)),
            torch.amax(masked(res.violation, conv)),
            torch.amax(masked(res.violation, res.exitflag == 0)),
            f32(torch.amax(res.iterations)),
            torch.amax(torch.where(torch.isfinite(v0), v0, 0.0)),
        ])
        return sums, maxes

    def _metrics(self, sums, maxes, n_local: int) -> FleetMetrics:
        """``FleetMetrics`` from the rank-local sums and maxima of
        ``n_local`` lanes: with a process group, one all_reduce(SUM) and one
        all_reduce(MAX) make them global (outside the step's graph)."""
        if self.mesh.group is not None:
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=self.mesh.group)
            dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=self.mesh.group)
        B = float(n_local * self.mesh.world)
        n_ok = torch.clamp(sums[0], min=1.0)
        return FleetMetrics(
            converged_fraction=sums[1] / B,
            mean_cost=sums[2] / n_ok,
            max_violation=maxes[0],
            max_violation_converged=maxes[1],
            max_violation_unconverged=maxes[2],
            mean_goal_distance=sums[3] / n_ok,
            reset_fraction=sums[4] / B,
            mean_iterations=sums[5] / B,
            max_iterations=maxes[3].to(torch.int32),
            rescue_overflow_fraction=sums[6] / torch.clamp(sums[7], min=1.0),
            max_violation0_raw=maxes[4],
        )

    def run(self, scenario: FleetScenario, n_steps: int):
        """Run the fleet for n_steps from a global scenario; returns (this
        rank's final state, last metrics)."""
        scenario = self.shard_scenario(scenario)
        state = self.init_state(scenario)
        metrics = None
        for _ in range(n_steps):
            state, metrics = self.step(state, scenario)
        return state, metrics


def random_fleet_scenario(
    problem: MpcProblem,
    batch_size: int,
    seed: int = 0,
    goal_box=((-3.0, -3.0, 0.0), (3.0, 3.0, 1.0)),
    obstacle_box=((-2.0, -2.0, 0.0), (2.0, 2.0, 1.0)),
    obstacle_radius=(0.2, 0.6),
    r_body: float = 0.2,
    u_limit: float = 10.0,
    joint_limit: float = 10.0,
    reachable_goals: bool = False,
) -> FleetScenario:
    """Randomized (x0, goal, obstacles, limits) batch — the "batched fleet"
    benchmark configuration, drawn from numpy exactly as the JAX package's
    ``random_fleet_scenario`` draws it (fleet.py:617-808; same seed, same
    numbers), with this package's FK evaluated on the CPU. Returns CPU
    float32 tensors.

    ``reachable_goals``: sample each goal as the end-effector FK image of a
    random joint configuration, rejection-matched into ``goal_box`` (needed
    for fixed-base arms such as panda).
    """
    rng = np.random.default_rng(seed)
    dims = problem.dims
    pm = problem.param_map
    kin = problem.kin
    params = np.zeros((batch_size, dims.N, problem.npar), dtype=np.float32)

    def fk_np(fn, q):
        with torch.no_grad():
            return fn(torch.as_tensor(np.asarray(q, np.float32))).numpy()

    # joint-limit-aware configuration sampling box
    q_lo = np.full((dims.n,), -1.8)
    q_hi = np.full((dims.n,), 1.8)
    n_arm = kin.joint_limits.shape[0]
    if n_arm and dims.n >= n_arm:
        off = dims.n - n_arm
        q_lo[off:] = np.maximum(q_lo[off:], kin.joint_limits[:, 0])
        q_hi[off:] = np.minimum(q_hi[off:], kin.joint_limits[:, 1])

    def set_all(name, values):
        """values: (B, k) broadcast over stages."""
        if name not in pm.entries:
            return
        start, k = pm.entries[name]
        params[:, :, start : start + k] = values[:, None, :]

    weights = problem.mpc.weights
    if "wgoal" in pm.entries:
        set_all("wgoal", np.full((batch_size, pm.size("wgoal")), weights["w"]))
    set_all("wu", np.full((batch_size, pm.size("wu")), weights["wu"]))
    if "ws" in pm.entries and problem.mpc.slack:
        set_all("ws", np.full((batch_size, 1), weights["ws"]))
    if "wconstr" in pm.entries:
        w = np.asarray(weights.get("wconstr", [0.0]), dtype=np.float32)
        set_all("wconstr", np.tile(w, (batch_size, 1)))
    lo, hi = np.asarray(goal_box[0]), np.asarray(goal_box[1])
    goals = rng.uniform(lo, hi, size=(batch_size, 3)).astype(np.float32)
    if reachable_goals and "goal" in pm.entries:
        fk_ee = lambda q: kin.fk_pos(q, problem.robot.end_link)
        q_rand = rng.uniform(q_lo, q_hi, size=(batch_size, dims.n)).astype(np.float32)
        ee = fk_np(fk_ee, q_rand)
        for _ in range(32):
            in_box = np.all((ee >= lo) & (ee <= hi), axis=1)
            if in_box.all():
                break
            n_bad = int((~in_box).sum())
            q_rand[~in_box] = rng.uniform(q_lo, q_hi, size=(n_bad, dims.n))
            ee = fk_np(fk_ee, q_rand)
        goals = ee.astype(np.float32)
    set_all("goal", goals[:, : dims.m])
    if "r_body" in pm.entries:
        set_all("r_body", np.full((batch_size, 1), r_body))
    xinit = np.zeros((batch_size, dims.nx), dtype=np.float32)
    if dims.base_type == "holonomic":
        xinit[:, : dims.n] = rng.uniform(-1.0, 1.0, size=(batch_size, dims.n))
    else:
        xinit[:, :3] = rng.uniform(-1.0, 1.0, size=(batch_size, 3))

    # initial states must satisfy the self-collision constraints at t = 0
    # (x0 is pinned — no solver can repair an initially violated clearance)
    sc_pairs = (
        problem.robot.self_collision_pairs
        if "SelfCollisionAvoidanceConstraints" in problem.mpc.constraints
        else []
    )
    if sc_pairs and dims.base_type == "holonomic":
        pair_links = sorted({l for pair in sc_pairs for l in pair})

        def pair_clearance(q):
            P = kin.fk_pos_links(q, pair_links)
            fk = {l: P[:, i] for i, l in enumerate(pair_links)}
            d = torch.stack(
                [torch.linalg.vector_norm(fk[a] - fk[b], dim=-1) for a, b in sc_pairs], -1
            )
            return torch.amin(d, -1) - 2.0 * r_body

        for _ in range(32):
            bad = fk_np(pair_clearance, xinit[:, : dims.n]) < 0.05
            if not bad.any():
                break
            xinit[bad, : dims.n] = rng.uniform(-1.0, 1.0, size=(int(bad.sum()), dims.n))
        else:
            warnings.warn(
                f"random_fleet_scenario: self-collision rejection sampling "
                f"exhausted after 32 rounds; {int(bad.sum())}/{batch_size} "
                f"scenarios start within 2*r_body of self-collision",
                stacklevel=2,
            )

    if "obst" in pm.entries:
        # rejection-sample obstacles so no scenario starts in collision or
        # has its goal inside an obstacle
        olo, ohi = np.asarray(obstacle_box[0]), np.asarray(obstacle_box[1])
        n_obst = dims.n_obst
        links = list(problem.robot.collision_links)
        fk0 = fk_np(lambda q: kin.fk_pos_links(q, links), xinit[:, : dims.n])  # (B, L, 3)
        pos = rng.uniform(olo, ohi, size=(batch_size, n_obst, 3)).astype(np.float32)
        rad = rng.uniform(*obstacle_radius, size=(batch_size, n_obst, 1)).astype(np.float32)
        for _ in range(32):
            clearance = (
                np.linalg.norm(fk0[:, :, None, :] - pos[:, None, :, :], axis=-1)
                - rad[:, None, :, 0]
                - r_body
            ).min(axis=(1, 2))
            goal_clear = (
                np.linalg.norm(goals[:, None, :] - pos, axis=-1) - rad[:, :, 0] - r_body
            ).min(axis=1)
            bad = (clearance < 0.1) | (goal_clear < 0.1)
            if not bad.any():
                break
            pos[bad] = rng.uniform(olo, ohi, size=(int(bad.sum()), n_obst, 3))
            rad[bad] = rng.uniform(*obstacle_radius, size=(int(bad.sum()), n_obst, 1))
        else:
            warnings.warn(
                f"random_fleet_scenario: obstacle rejection sampling exhausted "
                f"after 32 rounds; {int(bad.sum())}/{batch_size} scenarios keep "
                f"an obstacle within 0.1 of the start pose or goal",
                stacklevel=2,
            )
        set_all("obst", np.concatenate([pos, rad], axis=-1).reshape(batch_size, -1))
    for i in range(dims.n_obst):
        if f"lin_constrs_{i}" in pm.entries:
            plane = np.tile(np.array([1.0, 0.0, 0.0, -100.0], np.float32), (batch_size, 1))
            set_all(f"lin_constrs_{i}", plane)
    set_all("lower_limits", np.full((batch_size, dims.n), -joint_limit, np.float32))
    set_all("upper_limits", np.full((batch_size, dims.n), joint_limit, np.float32))
    set_all("lower_limits_u", np.full((batch_size, dims.nu), -u_limit, np.float32))
    set_all("upper_limits_u", np.full((batch_size, dims.nu), u_limit, np.float32))
    set_all("lower_limits_vel", np.full((batch_size, 2), -u_limit, np.float32))
    set_all("upper_limits_vel", np.full((batch_size, 2), u_limit, np.float32))
    return FleetScenario(
        xinit=torch.as_tensor(xinit, dtype=torch.float32),
        params=torch.as_tensor(params, dtype=torch.float32),
    )
