#!/usr/bin/env python3
"""Device time of the port's kernels at the main paths' shapes, for one or
more checkouts of the port taken in turns on one CUDA card:

    python3 chip_kernel_pairs.py OLD NEW NEW OLD

Each argument is the root of a checkout (a directory holding
``robot_mpcs_tpu_torch/``). Each runs in a fresh process that builds that
checkout's kernels (all at once, one nvcc each) into its own ``build/`` and
runs this checkout's ``chip_smoke.time_kernel_shapes`` (both Riccati sweeps
at ``chip_smoke.PACKED_SHAPES`` and ``GENERAL_SHAPES``) and
``chip_smoke.time_expansion_shapes`` (the FK walk, with its Jacobian and
without, and the Gauss-Newton assembly at ``EXPANSION_SHAPES``) on them:
every kernel held against its plain version on seeded inputs, a digest of
its outputs taken, then timed by ``torch.profiler`` (device ms per launch)
and CUDA events (ms per call). Prints the card, each run's records, then one
``pair`` line per shape with every run's device ms, call ms and digest in
argument order. Exits non-zero if any run fails, or where two runs' digests
differ at a shape (their kernels' outputs are not equal bit for bit) that
``DELIBERATE`` does not list.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: (kernel, shape label) -> why two checkouts' outputs may differ there: a
#: deliberate change of a kernel's arithmetic, held to its tolerance against
#: the plain version instead (none: every kernel is held bit for bit)
DELIBERATE: dict = {}


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
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.utils import aot

    pairs = [("riccati_packed", (2 * n, n + ns, ns)) for _, _, n, ns in smoke.PACKED_SHAPES.values()]
    pairs += [("riccati_batched", (nx, nw)) for _, _, nx, nw, _ in smoke.GENERAL_SHAPES.values()]
    for robot in sorted({robot for robot, _ in smoke.EXPANSION_SHAPES.values()}):
        pairs += aot.expansion_kernels(MpcProblem(Setup.from_dict(smoke.robot_setup(robot))))
    for (stem, shape), (_, log) in _build.build_libraries(pairs).items():
        if log:  # registers, spills, shared memory (-Xptxas -v) of a fresh build
            lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            print(json.dumps({"ptxas": {"root": root, "stem": stem,
                                        "shape": shape if stem != "fk_walk" else shape[0][:60], "lines": lines}}))
    try:
        records = smoke.time_kernel_shapes(torch, rp, rb, plain=False)
        records += smoke.time_expansion_shapes(torch, plain=False)
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
    differ = []
    for i, rec in enumerate(runs[0]["records"]):
        digests = [run["records"][i]["digest"] for run in runs]
        equal = len(set(digests)) == 1
        if not equal and (rec["kernel"], rec["shape"]) not in DELIBERATE:
            differ.append(f"{rec['kernel']} at {rec['shape']}")
        print(json.dumps({"pair": {
            "kernel": rec["kernel"], "shape": rec["shape"], "B": rec["B"], "bound_ms": rec["bound_ms"],
            "ms": [[run["root"], run["records"][i]["ms"]] for run in runs],
            "call_ms": [[run["root"], run["records"][i]["call_ms"]] for run in runs],
            "digest": digests, "equal": equal, "block": [run["records"][i].get("block") for run in runs],
        }}), flush=True)
    if differ:
        print(f"chip_kernel_pairs: outputs differ between checkouts: {'; '.join(differ)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        sys.exit(run_one(sys.argv[2]))
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
