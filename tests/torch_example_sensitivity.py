"""How far an example's closed loop moves when the FK positions move by
rounding, or its start by a little: the example runs with the split rows'
FK walk scaled by 1 + eps (eps 0: the unperturbed run), or with ``--starts``
from ``chip_smoke.offset_start``'s start of each seed given (1e-3 times a
normal draw in every state entry; seed 0: its own start), and prints the
step it reaches its goal at and its tracked point's final distance from the
goal.

    PYTHONPATH=. python tests/torch_example_sensitivity.py [--example boxer_example]
        [--device cpu|cuda] [--plain] [--starts] [--] [EPS or SEED ...]

(``--`` before a negative eps such as -1e-7.) Each value runs in its own
process, all at once (2 threads each); a value given twice runs twice. On
the card the walk and the Gauss-Newton assembly are the kernels
(``ops/fk_walk.py``, ``ops/gn_assemble.py``), or with ``--plain`` their
plain versions; on the CPU they are the plain versions.
The boxer example's solves are budget-bound (exit flag 0 on most), so
rounding-level changes of its rows can move its arrival by hundreds of
steps; this is the measurement behind that statement in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys


def run_one(example: str, eps: float, device: str, plain: bool, starts: bool) -> None:
    import numpy as np
    import torch

    from chip_smoke import offset_start

    torch.set_num_threads(2)
    from robot_mpcs_tpu_torch.models import components
    from robot_mpcs_tpu_torch.ops import fk_walk as fw
    from robot_mpcs_tpu_torch.ops import gn_assemble as ga
    from robot_mpcs_tpu_torch.solver import al_ilqr

    walk = fw.fk_walk_reference if plain else fw.fk_walk
    scale = 1.0 if starts else 1.0 + eps

    def scaled(kin, q, links, jac):
        P, J = walk(kin, q, links, jac)
        return P * scale, J

    components.fk_walk = scaled
    if plain:
        al_ilqr.gn_assemble = ga.gn_assemble_reference
    mod = importlib.import_module(f"robot_mpcs_tpu_torch.examples.{example}")
    ex = mod.make_example(device)
    if starts:
        offset_start(ex, int(eps))
    reached = ex.run(mod.STEPS)
    point = ex.tracked_point(ex.sim.state)
    dist = float(np.linalg.norm(point - np.asarray(ex._goal)[: len(point)]))
    case = f"start seed {int(eps)}" if starts else f"eps {eps:g}"
    print(f"{device}{' plain' if plain else ''} {case}: reached {reached} at step {ex.reached_at} "
          f"of {mod.STEPS}, final distance {dist:.4f} m", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--example", default="boxer_example")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--plain", action="store_true", help="the walk's and the assembly's plain versions")
    ap.add_argument("--starts", action="store_true", help="the values are start seeds, not FK scales")
    ap.add_argument("--one", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("eps", type=float, nargs="*", default=[0.0, 1e-7, -1e-7, 3e-7])
    args = ap.parse_args()
    if args.one is not None:
        run_one(args.example, args.one, args.device, args.plain, args.starts)
        return 0
    flags = ["--example", args.example, "--device", args.device] + (["--plain"] if args.plain else [])
    flags += ["--starts"] if args.starts else []
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *flags, f"--one={e!r}"],
                              stdout=subprocess.PIPE, text=True) for e in args.eps]
    codes = []
    for proc in procs:
        out, _ = proc.communicate()
        sys.stdout.write(out)
        codes.append(proc.returncode)
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
