"""Continuous robot dynamics and explicit integrators, batch-first.

Port of ``robot_mpcs_tpu.models.dynamics``. Replaces the reference's casadi
dynamics callbacks handed to ForcesPro:

* holonomic double integrator ``xdot = [qdot, u]``
  (reference ``robotmpcs/models/mpcModel.py:65-69``);
* diff-drive unicycle kinematics with velocity-level integration
  (reference ``robotmpcs/models/diff_drive_mpc_model.py:24-41``);
* ERK2 fixed-step integration matching ForcesPro's
  ``integrator.type='ERK2', Ts=dt, nodes=5`` (``mpcModel.py:118-120``).

Every function takes ``x (..., nx)`` and ``u (..., nu)`` with any leading
batch dimensions.
"""

from __future__ import annotations

from typing import Callable

import torch

from robot_mpcs_tpu_torch.models.dimensions import ProblemDimensions

DynamicsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def holonomic_dynamics(dims: ProblemDimensions) -> DynamicsFn:
    """Double integrator: ``d[q, qdot]/dt = [qdot, u]`` (mpcModel.py:65-69)."""

    def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., dims.n : dims.nx], u], dim=-1)

    return f


def diffdrive_dynamics(dims: ProblemDimensions) -> DynamicsFn:
    """Unicycle base + optional arm, velocity-level controls.

    State ``x = [q(n), qdot(n), vel(2)]`` with ``q[:3] = (x, y, theta)`` base
    pose and ``vel = (v_forward, omega)``; control ``u = [a_v, a_omega,
    arm_qddot...]``. The base rows of ``qdot`` are structurally zero and stay
    zero (``diff_drive_mpc_model.py:24-41``).
    """
    n = dims.n

    def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        theta = x[..., 2]
        v, omega = x[..., 2 * n], x[..., 2 * n + 1]
        base_qdot = torch.stack([torch.cos(theta) * v, torch.sin(theta) * v, omega], -1)
        arm_qdot = x[..., n + 3 : 2 * n]  # arm rows of qdot
        zeros3 = torch.zeros(x.shape[:-1] + (3,), dtype=x.dtype, device=x.device)
        return torch.cat([base_qdot, arm_qdot, zeros3, u[..., 2:], u[..., :2]], dim=-1)

    return f


def make_continuous_dynamics(dims: ProblemDimensions) -> DynamicsFn:
    if dims.base_type == "holonomic":
        return holonomic_dynamics(dims)
    return diffdrive_dynamics(dims)


def make_discrete_dynamics(
    dims: ProblemDimensions,
    dt: float,
    integrator: str = "erk2",
    substeps: int = 4,
) -> DynamicsFn:
    """Explicit fixed-step integrator ``x_{k+1} = F(x_k, u_k)``.

    ``erk2`` is the midpoint method; ``substeps`` sub-intervals over one
    control period ``dt`` (ForcesPro's ERK2 with 5 nodes = 4 sub-intervals,
    ``mpcModel.py:118-120``).
    """
    f = make_continuous_dynamics(dims)
    h = dt / substeps

    def step_euler(x, u):
        return x + h * f(x, u)

    def step_erk2(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        return x + h * k2

    def step_erk4(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    step = {"euler": step_euler, "erk2": step_erk2, "erk4": step_erk4}[integrator]

    def F(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        for _ in range(substeps):
            x = step(x, u)
        return x

    if dims.base_type == "holonomic":
        # The double integrator is LINEAR, so any explicit RK scheme is an
        # exact affine map with zero offset: F(x, u) = A_d x + B_d u. Fold
        # the substep chain into two constant matrices once at build time
        # (dynamics.py:107-131 of the JAX package).
        A_d, B_d = _jacobians_at_zero(dims, F)
        cache = {}

        def F_linear(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
            key = (x.dtype, x.device)
            if key not in cache:
                cache[key] = (
                    A_d.to(dtype=x.dtype, device=x.device).T.contiguous(),
                    B_d.to(dtype=x.dtype, device=x.device).T.contiguous(),
                )
            At, Bt = cache[key]
            return x @ At + u @ Bt

        return F_linear

    return F


def _jacobians_at_zero(dims: ProblemDimensions, F: DynamicsFn):
    """(dF/dx, dF/du) at x = 0, u = 0 in f32 on the CPU (build-time constants)."""
    x0 = torch.zeros((dims.nx,), dtype=torch.float32)
    u0 = torch.zeros((dims.nu,), dtype=torch.float32)
    A = torch.func.jacfwd(F, argnums=0)(x0, u0)
    B = torch.func.jacfwd(F, argnums=1)(x0, u0)
    return A, B


def dynamics_jacobians(F: DynamicsFn):
    """Batched Jacobians of discrete dynamics ``F``: returns ``J(x, u) ->
    (A (..., nx, nx), Bu (..., nx, nu))`` for any leading dimensions of
    ``x (..., nx)`` and ``u (..., nu)``. The JAX package takes ``jax.jacfwd``
    per stage and ``vmap``s it (al_ilqr.py:453-464); here one forward-mode
    pass runs over the flattened rows."""
    jac = torch.func.vmap(torch.func.jacfwd(F, argnums=(0, 1)))

    def J(x: torch.Tensor, u: torch.Tensor):
        lead = x.shape[:-1]
        A, Bu = jac(x.reshape(-1, x.shape[-1]), u.reshape(-1, u.shape[-1]))
        return A.reshape(lead + A.shape[-2:]), Bu.reshape(lead + Bu.shape[-2:])

    return J


def constant_dynamics_jacobians(dims: ProblemDimensions, F: DynamicsFn):
    """If the discrete dynamics are linear (holonomic double integrator,
    ``mpcModel.py:65-69``), return the constant Jacobians (A, B) as f32 numpy
    arrays, computed once at build time; None for nonlinear (diffdrive)
    dynamics."""
    if dims.base_type != "holonomic":
        return None
    A, B = _jacobians_at_zero(dims, F)
    return A.numpy(), B.numpy()
