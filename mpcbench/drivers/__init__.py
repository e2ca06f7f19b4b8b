"""One driver per kind of traffic: fleet.py, planner.py."""

from typing import Dict


def setup_of(cfg: Dict, fault=None):
    """The port's ``Setup`` of the configuration; a fault may override
    solver knobs (``control.Fault.solver``)."""
    from robot_mpcs_tpu_torch.config import Setup

    d = {k: cfg[k] for k in ("type", "mpc", "robot", "example", "solver")}
    d["solver"] = {**d["solver"], **(getattr(fault, "solver", None) or {})}
    return Setup.from_dict(d)
