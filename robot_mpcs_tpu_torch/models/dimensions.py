"""Problem dimensions shared by every model/cost/constraint component.

Encodes the stage-variable layout of the reference framework
(``robotmpcs/models/mpcBase.py:54-80``): the stacked stage variable is
``z = [x (nx), s (ns), u (nu)]`` where

* holonomic base: ``n`` dof, ``nx = 2n`` (``x = [q, qdot]``), ``nu = n``;
* diffdrive base: ``n = n_arm + 3``, ``nx = 2n + 2``
  (``x = [q, qdot, (v_forward, omega)]``), ``nu = 2 + n_arm``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProblemDimensions:
    n: int  # configuration dof
    nx: int  # state dimension
    nu: int  # control dimension
    ns: int  # slack dimension (0 or 1)
    N: int  # horizon (number of stages)
    base_type: str  # 'holonomic' | 'diffdrive'
    n_obst: int = 0  # obstacle slots (fixed arity, padded with empty obstacles)
    m: int = 3  # workspace dimension (reference mpcBase.py:52)
    m_obst: int = 3  # obstacle position dimension (reference mpcBase.py:64)

    @property
    def nz(self) -> int:
        """Stage-variable width nx + ns + nu (reference ``mpcModel.py:106``)."""
        return self.nx + self.ns + self.nu

    @property
    def n_arm(self) -> int:
        return self.n - 3 if self.base_type == "diffdrive" else self.n

    @classmethod
    def build(
        cls,
        n_arm: int,
        base_type: str,
        N: int,
        slack: bool = False,
        n_obst: int = 0,
    ) -> "ProblemDimensions":
        if base_type == "holonomic":
            n = n_arm
            nx = 2 * n
            nu = n
        elif base_type == "diffdrive":
            n = n_arm + 3
            nx = 2 * n + 2
            nu = 2 + n_arm
        else:
            raise ValueError(f"unknown base_type {base_type!r}")
        return cls(
            n=n,
            nx=nx,
            nu=nu,
            ns=1 if slack else 0,
            N=N,
            base_type=base_type,
            n_obst=n_obst,
        )

    # --- stage-variable accessors (reference mpcBase.py:73-80) -------------

    def split_z(self, z):
        """``z -> (x, s, u)``."""
        return (
            z[..., : self.nx],
            z[..., self.nx : self.nx + self.ns],
            z[..., self.nx + self.ns :],
        )

    def extract_variables(self, z):
        """``z -> (q, qdot, qddot)`` exactly as reference ``extractVariables``.

        Note: for diffdrive, ``qdot`` (the middle block) includes zero slots
        for the base coordinates; the actual base velocity lives in the
        trailing ``(v, omega)`` pair of x (see ``get_velocity``).
        """
        q = z[..., 0 : self.n]
        qdot = z[..., self.n : self.nx]
        qddot = z[..., self.nx + self.ns : self.nx + self.ns + self.nu]
        return q, qdot, qddot

    def get_velocity(self, z):
        """Reference ``get_velocity``: holonomic -> qdot (``mpcBase.py:73``);
        diffdrive -> the trailing ``nu`` entries ``[arm_qdot..., v, omega]``
        reinterpreted (``diff_drive_mpc_model.py:21-22`` returns
        ``z[2n : 2n + nu]``)."""
        if self.base_type == "diffdrive":
            return z[..., 2 * self.n : 2 * self.n + self.nu]
        return z[..., self.n : self.nx]
