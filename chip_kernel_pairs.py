#!/usr/bin/env python3
"""Device time of both Riccati kernels at the main paths' shapes, for one or
more checkouts of the port taken in turns on one CUDA card:

    python3 chip_kernel_pairs.py OLD NEW NEW OLD

Each argument is the root of a checkout (a directory holding
``robot_mpcs_tpu_torch/``). Each runs in a fresh process that builds that
checkout's kernels into its own ``build/`` and runs this checkout's
``chip_smoke.time_kernel_shapes`` on them: every kernel held against its
plain version, then timed by ``torch.profiler`` (device ms per launch) and
CUDA events (ms per call) at ``chip_smoke.PACKED_SHAPES`` and
``GENERAL_SHAPES``. Prints the card, each run's records, then one
``pair`` line per shape with every run's device ms in argument order.
Exits non-zero if any run fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_one(root: str) -> int:
    """Time the kernels of the checkout at ``root`` (child process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_pairs: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from robot_mpcs_tpu_torch.ops import riccati_batched as rb
    from robot_mpcs_tpu_torch.ops import riccati_packed as rp

    if not rp.__file__.startswith(root + os.sep):
        print(f"chip_kernel_pairs: no port package under {root}", file=sys.stderr)
        return 2
    try:
        records = smoke.time_kernel_shapes(torch, rp, rb, plain=False)
    except smoke.SmokeFailure as e:
        print(f"chip_kernel_pairs: FAILED in {root}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"root": root, "records": records}), flush=True)
    return 0


def main(roots) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {smi}", flush=True)
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root], capture_output=True, text=True
        )
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"chip_kernel_pairs: the run of {root} exited {proc.returncode}", file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for i, rec in enumerate(runs[0]["records"]):
        print(json.dumps({"pair": {
            "kernel": rec["kernel"], "shape": rec["shape"], "B": rec["B"], "bound_ms": rec["bound_ms"],
            "ms": [[run["root"], run["records"][i]["ms"]] for run in runs],
            "call_ms": [[run["root"], run["records"][i]["call_ms"]] for run in runs],
        }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        sys.exit(run_one(sys.argv[2]))
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
