"""MPC problem assembly: port of ``robot_mpcs_tpu.models.problem``.

Mirrors the role of reference ``robotmpcs/models/mpcModel.py`` (and
``diff_drive_mpc_model.py``): given a parsed setup, build

* the kinematics + dimensions,
* the inequality/objective component stacks (in config order — this fixes
  the ``paramMap`` parameter ABI, see ``params.py``),
* the canonical stage functions (``stage_objective``, ``stage_inequalities``)
  and the solver's callbacks in both forms: the JAX package's reference form
  (``solver_callbacks``: ``cost``, ``ineq``, stacked ``values``/``weights``)
  and the two-family split rows (``split_callbacks``) that
  ``MpcProblem.build_solver`` runs,
* the variable bounds (default box +-100 as in ``mpcModel.py:23-27``).

Every stage function is batch-first: ``z (..., nz)`` and ``p (..., npar)``
with the same leading dimensions. The solver-artifact directory
(``generate_solver`` / ``from_solver_dir``) holds the same three YAML files
as the JAX package's and, exported for the card, the kernel library the
solve launches (``utils/aot.py``).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from robot_mpcs_tpu_torch.assets import builtin_model
from robot_mpcs_tpu_torch.config import Setup, SolverConfiguration
from robot_mpcs_tpu_torch.models.components import FkEval, ModelContext, cat_rows, safe_barrier
from robot_mpcs_tpu_torch.models.dimensions import ProblemDimensions
from robot_mpcs_tpu_torch.models.dynamics import (
    constant_dynamics_jacobians,
    make_discrete_dynamics,
)
from robot_mpcs_tpu_torch.models.fk import RobotKinematics
from robot_mpcs_tpu_torch.models.inequalities import INEQUALITY_REGISTRY
from robot_mpcs_tpu_torch.models.objectives import OBJECTIVE_REGISTRY, ConstraintAvoidance
from robot_mpcs_tpu_torch.models.params import ParamMap
from robot_mpcs_tpu_torch.models.urdf import UrdfModel, load_urdf
from robot_mpcs_tpu_torch.utils.devices import resolve_device


class MpcProblem:
    """A fully-assembled MPC problem for one robot/config."""

    def __init__(self, setup: Setup, urdf_model: Optional[UrdfModel] = None):
        self.setup = setup
        self.mpc = setup.mpc
        self.robot = setup.robot
        if urdf_model is None:
            urdf_model = self._resolve_urdf(setup.robot.urdf_file)
        self.urdf_model = urdf_model
        self.kin = RobotKinematics(
            urdf_model, self.robot.root_link, self.robot.end_link, self.robot.base_type
        )
        self.dims = ProblemDimensions.build(
            n_arm=self.kin.n_arm,
            base_type=self.robot.base_type,
            N=self.mpc.time_horizon,
            slack=self.mpc.slack,
            n_obst=self.mpc.number_obstacles,
        )
        if self.dims.n != self.mpc.n:
            raise ValueError(
                f"config mpc.n = {self.mpc.n} does not match URDF-derived n = {self.dims.n}"
            )
        self.ctx = ModelContext(self.dims, self.kin, self.mpc, self.robot)

        # --- components + parameter registration (order = ABI) ------------
        # Reference order (mpcModel.py:29-36 + ObjectiveManager.py:14):
        # constraints (config order) -> "wu" -> objectives (config order).
        self.param_map = ParamMap()
        self.ineq_components = []
        for name in self.mpc.constraints:
            comp = INEQUALITY_REGISTRY[name](self.ctx)
            comp.register_params(self.param_map)
            self.ineq_components.append(comp)
        self.param_map.register("wu", self.dims.nu)
        if self.mpc.slack:
            # ws is read by the objective assembly when ns > 0
            # (ObjectiveManager.py:38-41); registered here since the modern
            # objective set never registers it (reference gap).
            self.param_map.register("ws", 1)
        self.obj_components = []
        for name in self.mpc.objectives:
            cls = OBJECTIVE_REGISTRY[name]
            if cls is ConstraintAvoidance:
                comp = cls(self.ctx, self.ineq_components)
            else:
                comp = cls(self.ctx)
            comp.register_params(self.param_map)
            self.obj_components.append(comp)

        self.n_ineq = sum(c.n_ineq for c in self.ineq_components)

        # --- bounds (mpcModel.py:23-27, 91-104) ----------------------------
        self.limits = {
            "x": {"low": np.full(self.dims.nx, -100.0), "high": np.full(self.dims.nx, 100.0)},
            "u": {"low": np.full(self.dims.nu, -100.0), "high": np.full(self.dims.nu, 100.0)},
            "s": {"low": np.zeros(1), "high": np.full(1, np.inf)},
        }

        self.dt = self.mpc.time_step
        self.dynamics = make_discrete_dynamics(
            self.dims,
            self.dt,
            integrator=setup.solver.integrator,
            substeps=setup.solver.integrator_substeps,
        )

    @staticmethod
    def _resolve_urdf(urdf_file: str) -> UrdfModel:
        """Load a URDF path, or fall back to a builtin robot by stem name."""
        if os.path.exists(urdf_file):
            return load_urdf(urdf_file)
        stem = os.path.splitext(os.path.basename(urdf_file))[0]
        for candidate in (stem, stem.replace("_fk", "")):
            try:
                return builtin_model(candidate)
            except KeyError:
                pass
        raise FileNotFoundError(f"URDF {urdf_file!r} not found and not a builtin robot")

    # ------------------------------------------------------------------ API

    def set_limits(self, limits: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Override variable bounds (reference ``setLimits``, mpcModel.py:62-63)."""
        self.limits.update(limits)

    @property
    def npar(self) -> int:
        return self.param_map.npar

    @property
    def solver_name(self) -> str:
        """Solver directory name, minted exactly like ``mpcModel.py:111-116``
        so reference-named artifacts interoperate."""
        name = (
            f"{self.mpc.model_name}_n{self.dims.n}_"
            f"{str(self.dt).replace('.', '')}_H{self.dims.N}"
        )
        if not self.mpc.slack:
            name += "_noSlack"
        return name

    def properties(self) -> Dict:
        """The properties.yaml payload (reference ``mpcModel.py:134``)."""
        return {
            "nx": self.dims.nx,
            "nu": self.dims.nu,
            "npar": self.npar,
            "ns": self.dims.ns,
            "m": self.dims.m,
            "constraints": list(self.mpc.constraints),
        }

    # --------------------------------------------------- stage functions

    def _fk_all(self, z: torch.Tensor) -> FkEval:
        """Positions (no Jacobians) of every link any component reads, by the
        plain walk: the stage functions built on it are differentiated by
        ``torch.func`` (the ``values`` and generic paths)."""
        links = [l for c in self.obj_components + self.ineq_components for l in c.fk_links()]
        return FkEval(self.kin, z[..., : self.dims.n], links, jac=False, kernel=False)

    @property
    def walk_links(self) -> List[str]:
        """The links the split rows' FK walk computes: every link a q-family
        row reads, then the end link (the fleet's end-effector position,
        ``parallel/fleet.py``), each once. One chain, so the card builds one
        ``fk_walk`` library per problem."""
        ineq_q = [c for c in self.ineq_components if c.q_dependent]
        links = [l for c in self.obj_components + ineq_q for l in c.fk_links()]
        return list(dict.fromkeys(links + [self.robot.end_link]))

    def _stage_rows(self, z: torch.Tensor, p: torch.Tensor):
        """Per objective component, its residual and barrier rows and
        weights in the canonical order (q family, then affine): a list of
        ``(r, w_r, b, w_b)``."""
        pm = self.param_map
        fk = self._fk_all(z)
        out = []
        for c in self.obj_components:
            wrq, wbq, wra, wba = c.weights(p, pm)
            r = torch.cat([c.residuals_q(fk, p, pm)[0], c.residuals_aff(z, p, pm)], -1)
            b = torch.cat([c.barriers_q(fk, p, pm)[0], c.barriers_aff(z, p, pm)], -1)
            out.append((r, torch.cat([wrq, wra], -1), b, torch.cat([wbq, wba], -1)))
        return out

    def stage_objective(self, z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Total stage cost ``(...,)``: modules + u'diag(wu)u + ws s^2
        (reference ``ObjectiveManager.eval_objectives``, :28-42; the terminal
        cost is the same). Barrier rows are clamped at ``BARRIER_EPS``."""
        pm, dims = self.param_map, self.dims
        total = z.new_zeros(z.shape[:-1])
        for r, wr, b, wb in self._stage_rows(z, p):
            total = total + torch.sum(wr * r * r, -1) + torch.sum(wb / safe_barrier(b), -1)
        u = z[..., dims.nx + dims.ns :]
        total = total + torch.sum(pm.get(p, "wu") * u * u, -1)
        if dims.ns:
            total = total + pm.get(p, "ws")[..., 0] * z[..., dims.nx] ** 2
        return total

    def stage_inequalities(self, z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Module inequality rows ``(..., n_ineq)`` in config order,
        slack-shifted when ns > 0 (the documented intent of
        ``InequalityManager.eval_inequalities``)."""
        pm = self.param_map
        fk = self._fk_all(z)
        rows = [
            c.eval_constraint_q(fk, p, pm)[0] if c.q_dependent else c.eval_constraint(z, p, pm)
            for c in self.ineq_components
        ]
        out = torch.cat(rows, -1) if rows else z.new_zeros(z.shape[:-1] + (0,))
        if self.dims.ns:
            out = out + z[..., self.dims.nx, None]
        return out

    # ----------------------------------------------------- solver wiring

    def bound_rows(self) -> List:
        """Static list of finite bound rows folded into the AL constraint
        stack: (index into z, sign, bound). Mirrors the lb/ub stacking of
        ``mpcModel.py:91-104``; infinite bounds are dropped."""
        dims = self.dims
        lb = np.concatenate(
            [self.limits["x"]["low"]]
            + ([self.limits["s"]["low"]] if dims.ns else [])
            + [self.limits["u"]["low"]]
        )
        ub = np.concatenate(
            [self.limits["x"]["high"]]
            + ([self.limits["s"]["high"]] if dims.ns else [])
            + [self.limits["u"]["high"]]
        )
        rows = []
        for i in range(dims.nz):
            if np.isfinite(lb[i]):
                rows.append((i, +1.0, float(lb[i])))  # z_i - lb >= 0
            if np.isfinite(ub[i]):
                rows.append((i, -1.0, float(ub[i])))  # ub - z_i >= 0
        return rows

    @property
    def n_con(self) -> int:
        """Total AL constraint rows per stage (module ineqs + bound rows)."""
        return self.n_ineq + len(self.bound_rows())

    @property
    def n_res(self) -> int:
        """Residual rows per stage: objective residuals + control penalty
        rows (wu) + slack penalty row (ws)."""
        return sum(c.n_res for c in self.obj_components) + self.dims.nu + self.dims.ns

    @property
    def n_bar(self) -> int:
        """Barrier rows per stage (inverse-clearance repulsion terms)."""
        return sum(c.n_bar for c in self.obj_components)

    # ------------------------------------------------ split row families

    def split_callbacks(self):
        """Build the two-family structured stage callbacks for the solver
        (``problem.py:227-341`` of the JAX package).

        Rows are partitioned by what they depend on:

        * **q family** — rows that reach z only through the configuration
          ``q = z[..., :n]`` (forward kinematics): goal residuals, obstacle /
          self-collision / halfplane constraint rows and their barriers.
          ``q_rows(q, p)`` returns them with their analytic q-Jacobian
          ``(..., R_q, n)``, from one FK walk over every link they read.
        * **affine family** — rows affine in z with a *constant* Jacobian
          (limits, bounds, control/slack penalty rows, velocity damping).
          Their Jacobian ``S_aff`` is computed once here at build time.

        Constraint-row order (the multiplier ABI) is ``[q-family module rows
        in config order; affine module rows in config order; bound rows]``.
        """
        dims = self.dims
        pm = self.param_map
        rows = self.bound_rows()
        b_idx = np.array([r[0] for r in rows], dtype=np.int64)
        b_sign = np.array([r[1] for r in rows], dtype=np.float32)
        b_bnd = np.array([r[2] for r in rows], dtype=np.float32)
        consts = {}

        def bound_consts(like):
            key = (like.dtype, like.device)
            if key not in consts:
                consts[key] = (
                    torch.as_tensor(b_idx, device=like.device),
                    torch.as_tensor(b_sign, dtype=like.dtype, device=like.device),
                    torch.as_tensor(b_bnd, dtype=like.dtype, device=like.device),
                )
            return consts[key]

        ineq_q = [c for c in self.ineq_components if c.q_dependent]
        ineq_aff = [c for c in self.ineq_components if not c.q_dependent]
        n_con_q = sum(c.n_ineq for c in ineq_q)
        n_con_aff = sum(c.n_ineq for c in ineq_aff) + len(rows)
        n_res_q = sum(c.n_res_q for c in self.obj_components)
        n_res_aff = (
            sum(c.n_res_aff for c in self.obj_components) + dims.nu + dims.ns
        )
        n_bar_q = sum(c.n_bar_q for c in self.obj_components)
        n_bar_aff = sum(c.n_bar_aff for c in self.obj_components)
        fk_links = self.walk_links

        def q_rows(q, p, jac: bool = True):
            """[res_q; bar_q; con_q] — all FK-dependent rows ``(..., R_q)``
            and, with ``jac``, their q-Jacobian ``(..., R_q, n)`` (else None).

            Constraint rows here are UNSHIFTED; when ns > 0 the solver adds
            the slack variable to them (constant unit Jacobian column). The
            FK walk is ``ops/fk_walk.fk_walk``: the kernel on the card."""
            fk = FkEval(self.kin, q, fk_links, jac, kernel=True)
            res = [c.residuals_q(fk, p, pm) for c in self.obj_components]
            bar = [c.barriers_q(fk, p, pm) for c in self.obj_components]
            con = [c.eval_constraint_q(fk, p, pm) for c in ineq_q]
            return cat_rows(res + bar + con, fk)

        def aff_rows(z, p):
            """[res_aff; bar_aff; con_aff] ``(..., R_aff)`` — rows affine in z
            (slack shift of module constraint rows included; bound rows are
            not shifted, mirroring the reference's lb/ub handling,
            mpcModel.py:91-104)."""
            res = [c.residuals_aff(z, p, pm) for c in self.obj_components]
            res.append(z[..., dims.nx + dims.ns :])  # u rows (weight wu)
            if dims.ns:
                res.append(z[..., dims.nx : dims.nx + dims.ns])  # slack row (ws)
            bar = [c.barriers_aff(z, p, pm) for c in self.obj_components]
            con = [c.eval_constraint(z, p, pm) for c in ineq_aff]
            if dims.ns and con:
                s = z[..., dims.nx, None]
                con = [c + s for c in con]
            if len(rows):
                idx, sign, bnd = bound_consts(z)
                con.append(sign * (z[..., idx] - bnd))
            parts = res + bar + con
            return torch.cat(parts, -1) if parts else z.new_zeros(z.shape[:-1] + (0,))

        def weights_split(p):
            """(w_res_q, w_bar_q, w_res_aff, w_bar_aff), each ``(..., k)``;
            weight vectors depend on p only."""
            ws = [c.weights(p, pm) for c in self.obj_components]
            wrq, wbq, wra, wba = ([w[i] for w in ws] for i in range(4))
            wra = list(wra) + [pm.get(p, "wu")]
            if dims.ns:
                wra.append(pm.get(p, "ws"))
            cat = lambda xs: (
                torch.cat(list(xs), -1) if xs else p.new_zeros(p.shape[:-1] + (0,))
            )
            return cat(wrq), cat(wbq), cat(wra), cat(wba)

        # constant affine Jacobian, computed once in f32 on the CPU (p enters
        # the rows only as offsets)
        p0 = torch.zeros((self.npar,), dtype=torch.float32)
        S_aff = torch.func.jacfwd(lambda z: aff_rows(z, p0))(
            torch.zeros((dims.nz,), dtype=torch.float32)
        ).numpy()

        return {
            "q_rows": q_rows,
            "aff_rows": aff_rows,
            "weights_split": weights_split,
            "S_aff": S_aff,
            "q_seg": (n_res_q, n_bar_q, n_con_q),
            "aff_seg": (n_res_aff, n_bar_aff, n_con_aff),
            "n_q": dims.n,
        }

    def _w_bounds(self):
        """(w_lb, w_ub): the solver's clamp bounds on ``w = [s, u]``."""
        dims = self.dims
        w_lb = np.concatenate(
            ([self.limits["s"]["low"]] if dims.ns else []) + [self.limits["u"]["low"]]
        )
        w_ub = np.concatenate(
            ([self.limits["s"]["high"]] if dims.ns else []) + [self.limits["u"]["high"]]
        )
        return w_lb.astype(np.float32), w_ub.astype(np.float32)

    def solver_callbacks(self):
        """``(StageFunctions, w_lb, w_ub)`` in the JAX package's reference
        form (``problem.py:343-414`` there): ``cost``, ``ineq`` (module rows
        then bound rows), the stacked ``values`` ``[residuals; barriers;
        constraints]`` and ``weights``, the dynamics and ``dyn_jac`` (the
        constant ``(A, B)`` of linear dynamics, else None). Every callback is
        batch-first and functional, so ``build_solver`` can differentiate it
        with ``torch.func``; ``n_res``/``n_bar``/``n_con`` size it."""
        from robot_mpcs_tpu_torch.solver.al_ilqr import StageFunctions

        dims = self.dims
        pm = self.param_map
        rows = self.bound_rows()
        idx = np.array([r[0] for r in rows], np.int64)
        sign = np.array([r[1] for r in rows], np.float32)
        bnd = np.array([r[2] for r in rows], np.float32)
        consts = {}

        def bound_rows(z):
            # copied to the device once: a solve captured as a CUDA graph
            # makes no host-to-device copy
            key = (z.dtype, z.device)
            if key not in consts:
                consts[key] = (
                    torch.as_tensor(idx, device=z.device),
                    torch.as_tensor(sign, dtype=z.dtype, device=z.device),
                    torch.as_tensor(bnd, dtype=z.dtype, device=z.device),
                )
            i, sg, bd = consts[key]
            return sg * (torch.index_select(z, -1, i) - bd)

        def cost(x, w, p):
            return self.stage_objective(torch.cat([x, w], -1), p)

        def ineq(x, w, p):
            z = torch.cat([x, w], -1)
            return torch.cat([self.stage_inequalities(z, p), bound_rows(z)], -1)

        def values(x, w, p):
            z = torch.cat([x, w], -1)
            stage = self._stage_rows(z, p)
            res = [r for r, _, _, _ in stage] + [z[..., dims.nx + dims.ns :]]
            if dims.ns:
                res.append(z[..., dims.nx : dims.nx + dims.ns])  # slack row (weight ws)
            bars = [b for _, _, b, _ in stage]
            return torch.cat(res + bars + [ineq(x, w, p)], -1)

        def weights(p):
            """(w_res, w_bar): the weight vectors depend on p only."""
            z0 = p.new_zeros(p.shape[:-1] + (dims.nz,))
            stage = self._stage_rows(z0, p)
            w_res = [w for _, w, _, _ in stage] + [pm.get(p, "wu")]
            if dims.ns:
                w_res.append(pm.get(p, "ws"))
            return torch.cat(w_res, -1), torch.cat([w for _, _, _, w in stage] + [z0[..., :0]], -1)

        stage = StageFunctions(
            dynamics=self.dynamics,
            cost=cost,
            ineq=ineq,
            values=values,
            weights=weights,
            dyn_jac=constant_dynamics_jacobians(dims, self.dynamics),
        )
        return (stage,) + self._w_bounds()

    def reference_constraint_rows(self):
        """How the split form's constraint rows map onto the reference
        form's: ``(perm, pinned)`` with row ``i`` of ``solver_callbacks``'
        ``ineq`` (module rows in config order, then bound rows) being row
        ``perm[i]`` of the split stack (q-family module rows, affine module
        rows, bound rows), so ``lam_split[..., perm]`` is the same
        multiplier warm start in the reference layout; ``pinned`` are the
        reference rows the split path pins at stage 0, as ``build_solver``'s
        ``pinned_rows`` for a reference-form solve of the same problem."""
        from robot_mpcs_tpu_torch.solver.al_ilqr import split_pinned_rows

        split = self.split_callbacks()
        off = {True: 0, False: split["q_seg"][2]}
        perm = []
        for c in self.ineq_components:
            perm.extend(range(off[c.q_dependent], off[c.q_dependent] + c.n_ineq))
            off[c.q_dependent] += c.n_ineq
        perm = np.asarray(perm + list(range(off[False], self.n_con)), np.int64)
        pinned = split_pinned_rows(
            split["q_seg"], split["aff_seg"], split["S_aff"], self.dims.nx, self.dims.ns
        )
        return perm, pinned[perm]

    def split_solver_callbacks(self):
        """StageFunctions of the two-family split form (``split_callbacks``),
        the layout that ``build_solver`` needs for it, and (w_lb, w_ub).
        ``dyn_jac`` is the constant ``(A, B)`` pair of linear (holonomic)
        dynamics, else None: the solver differentiates the diff-drive
        ``dynamics`` (forward-mode ``dynamics_jacobians``, as the JAX
        package's per-stage jacfwd)."""
        from robot_mpcs_tpu_torch.solver.al_ilqr import StageFunctions

        split = self.split_callbacks()
        stage = StageFunctions(
            dynamics=self.dynamics,
            dyn_jac=constant_dynamics_jacobians(self.dims, self.dynamics),
            q_rows=split["q_rows"],
            aff_rows=split["aff_rows"],
            weights_split=split["weights_split"],
        )
        return (stage, split) + self._w_bounds()

    def build_solver(
        self, cfg: Optional[SolverConfiguration] = None, device="cuda"
    ) -> Callable:
        """Build the batched solve function for this problem on ``device``
        (default the CUDA card; ``"cpu"`` for the CPU)."""
        from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

        stage, split, w_lb, w_ub = self.split_solver_callbacks()
        return build_solver(
            stage,
            nx=self.dims.nx,
            ns=self.dims.ns,
            nu=self.dims.nu,
            N=self.dims.N,
            n_con=self.n_con,
            w_lb=w_lb,
            w_ub=w_ub,
            cfg=cfg or self.setup.solver,
            n_q=split["n_q"],
            q_seg=split["q_seg"],
            aff_seg=split["aff_seg"],
            S_aff=split["S_aff"],
            device=device,
        )

    # ----------------------------------------------------- artifact I/O

    def generate_solver(self, location: str = "./", export: bool = True, device="cuda") -> str:
        """Persist the solver artifact directory (reference
        ``generateSolver``, mpcModel.py:128-141): paramMap.yaml,
        properties.yaml and the full setup, plus (``export=True`` on a CUDA
        ``device``) the kernel library the problem's solve launches and its
        fingerprint (``utils/aot.export_planner_solve``), the analog of the
        compiled solver the reference emits next to its YAML files. Returns
        the artifact path.

        A process that loads the artifact on the card with the export
        (``MPCPlanner(..., solver_dir=path)``) runs its first solve without
        building a kernel. On the CPU (``device="cpu"``) the solve runs the
        kernels' plain versions, so only the three YAML files are written,
        and a warning says so.
        """
        import yaml

        dev = resolve_device(device) if export else None
        path = os.path.join(location, self.solver_name)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "paramMap.yaml"), "w") as f:
            yaml.dump(self.param_map.to_reference_dict(), f, default_flow_style=False)
        with open(os.path.join(path, "properties.yaml"), "w") as f:
            yaml.dump(self.properties(), f, default_flow_style=False)
        with open(os.path.join(path, "setup.yaml"), "w") as f:
            yaml.dump(self.setup.to_dict(), f, default_flow_style=False)
        if export and dev.type == "cuda":
            from robot_mpcs_tpu_torch.utils.aot import export_planner_solve

            export_planner_solve(self, path, device=dev)
        elif export:
            warnings.warn(
                f"{path}: no kernels exported for {dev} (the CPU runs their plain "
                f"versions); only the YAML files were written",
                stacklevel=2,
            )
        return path

    @classmethod
    def from_solver_dir(cls, path: str) -> "MpcProblem":
        """Rebuild a problem from a persisted artifact directory, refusing one
        whose paramMap differs from the rebuilt problem's (the parameter
        ABI)."""
        import yaml

        with open(os.path.join(path, "setup.yaml")) as f:
            setup = Setup.from_dict(yaml.safe_load(f))
        problem = cls(setup)
        with open(os.path.join(path, "paramMap.yaml")) as f:
            persisted = yaml.safe_load(f)
        if persisted != problem.param_map.to_reference_dict():
            raise ValueError(f"paramMap mismatch loading artifact {path}")
        return problem
