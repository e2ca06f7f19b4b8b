"""Typed configuration schema for MPC problems.

Mirrors the YAML schema of the reference framework (see reference
``robotmpcs/models/mpcBase.py:7-31`` ``MpcConfiguration``/``RobotConfiguration``
and ``examples/config/*.yaml``) so that existing config files load unchanged,
and adds a solver section (``SolverConfiguration``) that replaces the
ForcesPro ``CodeOptions`` (reference ``robotmpcs/models/mpcModel.py:110-126``).

Port of ``robot_mpcs_tpu.config``: the same schema and defaults, less the
solver's ``psd_projection`` (read by no code) and ``dtype`` (the port
computes in float32 only). ``yaml`` is imported only inside
``parse_setup``, so a machine without PyYAML can still build a problem from
``panda_setup()``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class MpcConfiguration:
    """The ``mpc:`` section of a setup YAML.

    Field-for-field compatible with reference ``mpcBase.py:7-22``.
    """

    time_horizon: int
    time_step: float
    weights: Dict[str, Any]
    slack: bool
    interval: int
    constraints: List[str]
    objectives: List[str]
    number_obstacles: int
    model_name: str
    initialization: str
    n: int
    control_mode: str
    name: str = "mpc"
    debug: bool = False

    def __post_init__(self) -> None:
        if self.time_horizon < 2:
            raise ValueError("time_horizon must be >= 2")
        if self.control_mode not in ("acc", "vel"):
            raise ValueError(f"control_mode must be 'acc' or 'vel', got {self.control_mode!r}")
        if self.initialization not in ("current_state", "previous_plan", "zeros"):
            raise ValueError(f"unknown initialization {self.initialization!r}")


@dataclass
class RobotConfiguration:
    """The ``robot:`` section of a setup YAML (reference ``mpcBase.py:24-31``)."""

    collision_links: List[str]
    selfCollision: Dict[str, Any]
    urdf_file: str
    root_link: str
    end_link: str
    base_type: str

    def __post_init__(self) -> None:
        if self.base_type not in ("holonomic", "diffdrive"):
            raise ValueError(f"base_type must be 'holonomic' or 'diffdrive', got {self.base_type!r}")

    @property
    def self_collision_pairs(self) -> List[List[str]]:
        return list(self.selfCollision.get("pairs", []) or [])


@dataclass
class SolverConfiguration:
    """Solver knobs for the in-house batched AL-iLQR solver.

    This replaces the reference's ForcesPro ``CodeOptions`` block
    (``mpcModel.py:117-126``: ERK2 integrator, Ts, 5 nodes, opt/print level).
    All values have defaults so the section is optional in YAML.
    """

    #: Explicit RK2 (midpoint) integration substeps per control interval.
    #: The reference uses ForcesPro's ERK2 with 5 nodes (mpcModel.py:118-120),
    #: i.e. 4 integration sub-intervals over Ts = dt.
    integrator: str = "erk2"
    integrator_substeps: int = 4
    #: Outer augmented-Lagrangian iterations (multiplier/penalty updates).
    #: Caps are worst-case budgets — the solver's inner/outer while_loops
    #: exit early per lane once feasible + stationary (converged lanes are
    #: frozen and skip all inner work), so these bind only on stragglers.
    #: Defaults tuned on the panda fleet benchmark (round 3): (4, 8) with
    #: penalty_initial=100 reaches exitflag==1 on >= 97% of warm-started
    #: lanes at max violation < 1e-4 (see scripts/profile_round3.py).
    max_al_iterations: int = 4
    #: Inner iLQR iterations per AL iteration.
    max_ilqr_iterations: int = 8
    #: Line-search step candidates (powers of line_search_decay from 1.0).
    #: Default 1: the solver is Levenberg-Marquardt-damped — a rejected full
    #: step escalates reg and retries with a shorter, better-conditioned
    #: step, which on the robot problem families converges as reliably as
    #: merit backtracking while costing one batched merit sweep per
    #: iteration instead of up to 8 (measured on the panda fleet: identical
    #: converged fraction, 3.3x step throughput). Raise for problems whose
    #: merit landscape genuinely needs backtracking.
    line_search_steps: int = 1
    line_search_decay: float = 0.5
    #: Initial / growth / max penalty for the AL method.
    penalty_initial: float = 100.0
    penalty_scale: float = 10.0
    penalty_max: float = 1.0e8
    #: Levenberg-Marquardt regularization bounds for the Riccati sweep.
    reg_initial: float = 1.0e-6
    reg_min: float = 1.0e-9
    reg_max: float = 1.0e8
    #: Largest LM reg at which a small Newton step (max |k_ff| < tol_gradient)
    #: is trusted as evidence of stationarity. A huge reg shrinks k_ff
    #: artificially (k_ff ~ grad/reg), so lanes stuck at reg >> 1 are never
    #: declared converged by the step-size test.
    reg_converged_max: float = 1.0
    #: Convergence tolerances on the Newton-step stationarity measure
    #: max |k_ff| (in control units) and the max constraint violation.
    #: tol_gradient is the clean inner-loop exit; tol_stationarity is the
    #: acceptance bar for exitflag == 1 — it also admits lanes whose line
    #: search can no longer measure progress in f32 (merit noise floor is
    #: ~1e-5 relative, so cost decreases from steps < ~1e-3 are invisible)
    #: once their Newton step is already below it. Consistent with the
    #: < 1e-3 control-error parity target (BASELINE.md; verified against an
    #: independent NLP solver in tests/test_parity.py).
    tol_gradient: float = 1.0e-4
    tol_constraint: float = 1.0e-4
    tol_stationarity: float = 1.0e-3
    #: Riccati backward implementation, same values as the JAX package:
    #: 'auto' and 'pallas' both mean the hand-written CUDA kernel on a CUDA
    #: tensor and its plain PyTorch version on a CPU tensor — the structured
    #: sweep of ``ops/riccati_packed.py`` for holonomic dynamics, the general
    #: sweep of ``ops/riccati_batched.py`` otherwise (diff-drive). 'scan' is
    #: the JAX package's stage scan (``solver.al_ilqr.riccati_backward_scan``)
    #: on any device.
    riccati_backend: str = "auto"

    def __post_init__(self) -> None:
        if self.integrator not in ("erk2", "erk4", "euler"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.riccati_backend not in ("auto", "pallas", "scan"):
            raise ValueError(f"unknown riccati_backend {self.riccati_backend!r}")


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class Setup:
    """A fully parsed setup file: mpc + robot + solver + example sections."""

    mpc: MpcConfiguration
    robot: RobotConfiguration
    solver: SolverConfiguration = field(default_factory=SolverConfiguration)
    example: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Setup":
        return cls(
            mpc=MpcConfiguration(**_filter_kwargs(MpcConfiguration, d["mpc"])),
            robot=RobotConfiguration(**_filter_kwargs(RobotConfiguration, d["robot"])),
            solver=SolverConfiguration(**_filter_kwargs(SolverConfiguration, d.get("solver", {}))),
            example=dict(d.get("example", {})),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "mpc": dataclasses.asdict(self.mpc),
            "robot": dataclasses.asdict(self.robot),
            "solver": dataclasses.asdict(self.solver),
            "example": dict(self.example),
        }


def parse_setup(setup_file: str) -> Dict[str, Any]:
    """Load a raw setup YAML (reference ``robotmpcs/utils/utils.py:5-8``)."""
    import yaml

    with open(setup_file, "r") as stream:
        return yaml.safe_load(stream)


def load_setup(setup_file: str, urdf_dir: Optional[str] = None) -> Setup:
    """Parse a setup YAML into typed configuration objects.

    ``urdf_dir``: optional directory to resolve a relative ``robot.urdf_file``
    against (the reference resolves it relative to its assets dir in
    ``examples/makeSolver.py:16``).
    """
    raw = parse_setup(setup_file)
    setup = Setup.from_dict(raw)
    if urdf_dir is not None and not setup.robot.urdf_file.startswith("/"):
        setup.robot.urdf_file = f"{urdf_dir}/{setup.robot.urdf_file}"
    return setup


def panda_setup() -> Dict[str, Any]:
    """``examples/config/pandaMpc.yaml`` as a plain dict, with the fleet
    benchmark's repulsion override ``wconstr = [0.05, 0, 0, 0]`` (the stock
    0.5 is N-scaled and parks the arm short of its goal; see
    ``objectives.ConstraintAvoidance``). ``Setup.from_dict(panda_setup())``
    builds the panda problem without PyYAML or the config file. The values,
    ``ws`` included (PyYAML reads ``1e10`` as a string), are what
    ``parse_setup`` returns for that file.
    """
    return {
        "type": "mpc",
        "mpc": {
            "model_name": "panda",
            "n": 7,
            "time_horizon": 20,
            "time_step": 0.05,
            "slack": False,
            "interval": 1,
            "initialization": "current_state",
            "constraints": [
                "RadialConstraints",
                "SelfCollisionAvoidanceConstraints",
                "JointLimitConstraints",
                "InputLimitConstraints",
            ],
            "objectives": ["GoalReaching", "ConstraintAvoidance"],
            "weights": {
                "w": 3.0,
                "wvel": [1.0] * 7,
                "ws": "1e10",
                "wu": 0.1,
                "wobst": 0.01,
                "wconstr": [0.05, 0.0, 0.0, 0.0],
            },
            "number_obstacles": 1,
            "control_mode": "acc",
        },
        "robot": {
            "collision_links": ["panda_link3", "panda_link5", "panda_link7"],
            "selfCollision": {"pairs": [["panda_link3", "panda_link7"]]},
            "urdf_file": "panda.urdf",
            "root_link": "panda_link0",
            "end_link": "panda_link7",
            "base_type": "holonomic",
        },
        "example": {"debug": False},
    }


def point_robot_setup() -> Dict[str, Any]:
    """``examples/config/pointRobotMpc.yaml`` as a plain dict, with the fleet
    benchmark's repulsion override ``wconstr = [0.005, 0, 0, 0]``
    (``bench.py:62-69``); see ``panda_setup``."""
    return {
        "type": "mpc",
        "mpc": {
            "model_name": "pointRobot",
            "n": 3,
            "time_horizon": 20,
            "time_step": 0.05,
            "slack": False,
            "interval": 1,
            "initialization": "current_state",
            "constraints": [
                "RadialConstraints",
                "SelfCollisionAvoidanceConstraints",
                "JointLimitConstraints",
                "InputLimitConstraints",
            ],
            "objectives": ["GoalReaching", "ConstraintAvoidance"],
            "weights": {
                "w": 1.0,
                "wvel": [1.0, 1.0, 1.0],
                "ws": "1e10",
                "wu": 0.1,
                "wobst": 0.05,
                "wconstr": [0.005, 0.0, 0.0, 0.0],
            },
            "number_obstacles": 1,
            "control_mode": "acc",
        },
        "robot": {
            "collision_links": ["base_link"],
            "selfCollision": {"pairs": []},
            "urdf_file": "pointRobot.urdf",
            "root_link": "world",
            "end_link": "base_link",
            "base_type": "holonomic",
        },
        "example": {"debug": False},
    }


def boxer_setup() -> Dict[str, Any]:
    """``examples/config/boxerMpc.yaml`` as a plain dict (the fleet benchmark
    uses its weights unchanged, ``bench.py:70-77``); see ``panda_setup``."""
    return {
        "type": "mpc",
        "mpc": {
            "model_name": "boxer",
            "n": 3,
            "time_horizon": 10,
            "time_step": 0.1,
            "slack": False,
            "interval": 1,
            "initialization": "previous_plan",
            "constraints": [
                "LinearConstraints",
                "SelfCollisionAvoidanceConstraints",
                "JointLimitConstraints",
                "InputLimitConstraints",
            ],
            "objectives": ["GoalReaching", "ConstraintAvoidance"],
            "weights": {
                "w": 1.0,
                "wgoal": 1.0,
                "wvel": [0.0, 0.0, 0.0, 1, 0.01],
                "ws": "1e10",
                "wu": 0.01,
                "wobst": 0.5,
                "wconstr": [0.0, 0.0, 0.0, 0.0],
            },
            "number_obstacles": 1,
            "control_mode": "acc",
        },
        "robot": {
            "collision_links": ["ee_link"],
            "selfCollision": {"pairs": []},
            "urdf_file": "boxer_fk.urdf",
            "root_link": "base_link",
            "end_link": "ee_link",
            "base_type": "diffdrive",
        },
        "example": {"debug": False},
    }
