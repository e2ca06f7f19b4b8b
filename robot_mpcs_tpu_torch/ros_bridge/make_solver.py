#!/usr/bin/env python3
"""ROS-side offline solver-artifact generation (port of
``ros_bridge/scripts/make_solver.py``; reference
``ros_bridge/src/robotmpcs_ros/scripts/make_solver.py:14-29``).

    python3 -m robot_mpcs_tpu_torch.ros_bridge.make_solver ros_bridge/config/boxer_mpc_config.yaml [out_dir] [--device cpu]

Builds the MPC problem from a ``<robot>_mpc_config.yaml`` rosparam-style
config (the file ``launch/boxer_mpc.launch`` loads) and writes the solver
artifact directory with the exported kernel
(``robot_mpcs_tpu_torch.examples.make_solver``), so that the node started
with ``_solver_dir:=<out_dir>/<solver name>`` builds no kernel at its first
control tick. ``out_dir`` defaults to ``./solvers/``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Optional, Sequence

from robot_mpcs_tpu_torch.examples.make_solver import generate


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="a <robot>_mpc_config.yaml")
    ap.add_argument("out_dir", nargs="?", default="./solvers/", help="output directory")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    # robot type from `<name>_mpc_config.yaml` (reference regex,
    # ros make_solver.py:27)
    match = re.search(r"([a-zA-Z]+)_mpc_config", os.path.basename(args.config))
    if match:
        print(f"robot type: {match.group(1)}")
    generate(args.config, args.out_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
