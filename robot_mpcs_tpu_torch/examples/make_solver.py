"""Offline solver-artifact generation (port of ``examples/make_solver.py``).

    python -m robot_mpcs_tpu_torch.examples.make_solver examples/config/<robot>Mpc.yaml [output_dir] [--device cpu]

Builds the MPC problem from the config and writes the solver artifact
directory: paramMap.yaml, properties.yaml and setup.yaml (the files the
reference writes next to its ForcesPro solver, ``mpcModel.py:132-141``) and,
on the card, the kernel library the solve launches with its fingerprint
(``MpcProblem.generate_solver(..., export=True)``). Then it runs one B=1
solve on the device and prints how long that first solve took.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from robot_mpcs_tpu_torch.config import load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.utils.devices import resolve_device


def generate(setup_file: str, location: str = "./solvers/", device="cuda") -> Tuple[str, float]:
    """Write the artifact of ``setup_file`` under ``location`` (with the
    kernels on a CUDA ``device``), then time one B=1 solve from zeros on
    ``device``. Returns (artifact path, first-solve seconds)."""
    dev = resolve_device(device)
    problem = MpcProblem(load_setup(setup_file))
    os.makedirs(location, exist_ok=True)
    path = problem.generate_solver(location, export=True, device=dev)
    print(f"solver artifact written to {path}")
    d = problem.dims
    zeros = [np.zeros(s, np.float32) for s in
             ((1, d.nx), (1, d.N, problem.npar), (1, d.N, d.nz), (1, d.N, problem.n_con))]
    t0 = time.perf_counter()
    res = problem.build_solver(device=dev)(*zeros)
    int(res.exitflag[0])  # waits for the solve
    first_s = time.perf_counter() - t0
    print(f"first solve on {dev} took {first_s:.2f} s")
    return path, first_s


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("setup_file", help="a <robot>Mpc.yaml config")
    ap.add_argument("location", nargs="?", default="./solvers/", help="output directory")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    match = re.search(r"([a-zA-Z]+)Mpc", os.path.basename(args.setup_file))
    if match:
        print(f"robot type: {match.group(1)}")
    generate(args.setup_file, args.location, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
