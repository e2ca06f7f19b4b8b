#!/usr/bin/env python3
"""Where an eager panda fleet step's device work goes, by solver region, for
one or more checkouts of the port taken in turns on one CUDA card:

    python3 chip_profile_split.py [ROOT ...]      (default: this checkout)

Each argument is the root of a checkout (a directory holding
``robot_mpcs_tpu_torch/``). Each runs in a fresh process that builds that
checkout's kernel libraries (``utils/aot.libraries`` of the panda problem)
into its own ``build/``, makes the bench's panda fleet at B=4096
(``bench._load_problem`` / ``_scenario_for``, seed 0), runs 2 eager steps,
and then, from that state:

* ``split_profile`` (this script's) over one eager step: its
  device events and busy ms inside ``stage_expansion_blocks`` (the split
  path's Gauss-Newton expansion), inside ``eval_families(jac=False)`` (the
  line search's and the multiplier update's row evaluations) and in the
  rest, each region's calls bracketed by marker kernels on the solver's
  stream (``split_by_markers``);
* ``chip_smoke.profile_windows`` over the same eager step without markers: events,
  busy ms and the device ms of each kernel of the port by name;
* the launches of that step by (kernel, B);
* 4 graphed steps from the same state (the first captures the step's CUDA
  graph): wall ms each, synchronized, and the idle share of the graphed
  step, 1 - busy / the median of the last 3.

Prints the card's name and power limit, then one JSON line per run.
Exits non-zero if any run fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
WARM_STEPS = 2
GRAPHED_STEPS = 4
KERNELS = ["riccati_packed_kernel", "fk_walk_kernel", "gn_assemble_kernel"]


#: the solver's regions ``split_profile`` attributes device work to: a
#: label and the test of a Python call's frame (the split path's functions
#: of ``solver/al_ilqr.py`` by name; ``eval_families`` only without the
#: Jacobian: the line search's and the multiplier update's row evaluations,
#: ``jac=False`` where the function still takes the flag)
SPLIT_REGIONS = {
    "stage_expansion_blocks": lambda f: f.f_code.co_name == "stage_expansion_blocks",
    "eval_families(jac=False)": lambda f: (f.f_code.co_name == "eval_families"
                                           and f.f_locals.get("jac", False) is False),
}


def split_profile(torch, fn, regions=SPLIT_REGIONS):
    """Device events and busy ms of one eager call of ``fn`` (``units._eager``,
    under ``torch.profiler``), split by the solver function that launched
    them: each call of a function of ``solver/al_ilqr.py`` that a test of
    ``regions`` accepts (not nested in another region) is bracketed by two
    marker launches on the current stream (``torch.cuda._sleep(0)``, a spin
    kernel), found through ``sys.setprofile``, so the solver's code is not
    touched. The eager solver runs on that one stream, so in the device's own
    order every event between an opening marker and its closing one is that
    region's, and the rest is ``"rest"`` (``split_by_markers``): no host and
    device clocks are compared. Returns {region: {"device_events",
    "device_busy_ms", "calls"}} with ``"total"`` (markers excluded) and the
    wall ms of the profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robot_mpcs_tpu_torch.solver import units

    open_region, labels = [], []

    def hook(frame, event, arg):
        if event == "call" and not open_region and frame.f_code.co_filename.endswith("al_ilqr.py"):
            for label, test in regions.items():
                if test(frame):
                    torch.cuda._sleep(0)
                    open_region.append(frame)
                    labels.append(label)
                    break
        elif event == "return" and open_region and open_region[0] is frame:
            torch.cuda._sleep(0)
            open_region.pop()

    with units._eager(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sys.setprofile(hook)
        try:
            fn()
        finally:
            sys.setprofile(None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device = [(e.start_ns(), e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    out = split_by_markers(device, labels, list(regions))
    out["wall_ms"] = wall_ms
    return out


def split_by_markers(device, labels, regions, marker="spin_kernel"):
    """``device``: (start ns, name, duration ns) of device events; ``labels``:
    the region of each opening marker, in launch order. Events between an
    opening marker and the next marker are that region's, the others
    ``"rest"``; markers are not counted. Returns {region: {"device_events",
    "device_busy_ms", "calls"}} and ``"total"``."""
    out = {k: {"device_events": 0, "device_busy_ms": 0.0, "calls": labels.count(k)} for k in [*regions, "rest"]}
    label, opened = "rest", 0
    for _, name, ns in sorted(device, key=lambda e: e[0]):
        if marker in name:
            label, opened = (labels[opened], opened + 1) if label == "rest" else ("rest", opened)
            continue
        out[label]["device_events"] += 1
        out[label]["device_busy_ms"] += ns / 1e6
    if opened != len(labels) or label != "rest":
        raise RuntimeError(f"split_profile: {opened} of {len(labels)} regions' markers seen on the device")
    out["total"] = {k: sum(out[r][k] for r in [*regions, "rest"]) for k in ("device_events", "device_busy_ms")}
    return out


def run_one(root: str) -> int:
    """Profile the panda step of the checkout at ``root`` (child process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from robot_mpcs_tpu_torch import bench
    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
    from robot_mpcs_tpu_torch.solver import units

    if not bench.__file__.startswith(root + os.sep):
        print(f"chip_profile_split: no port package under {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    problem, _ = bench._load_problem("panda")
    t = time.perf_counter()
    bench._build_kernels(problem, dev)
    build_s = time.perf_counter() - t
    runner = FleetRunner(problem, BATCH, device="cuda")
    scen = runner.to_device(bench._scenario_for(problem, BATCH, "panda"))
    state = runner.init_state(scen)
    with units._eager():
        for _ in range(WARM_STEPS):
            state, _ = runner.step(state, scen)
    torch.cuda.synchronize()

    def step():
        return runner.step(state, scen)

    before = _build.launch_counts()
    split = split_profile(torch, step)
    launches = {f"{k[0]} B={k[1]}": n - before.get(k, 0) for k, n in _build.launch_counts().items()
                if n != before.get(k, 0)}
    _, whole = smoke.profile_windows(torch, {"step": step}, KERNELS)
    graphed = []
    for _ in range(GRAPHED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        graphed.append((time.perf_counter() - t) * 1e3)
    steady = float(np.median(graphed[1:]))
    print(json.dumps({
        "root": root, "card": smoke.card_label(), "batch": BATCH, "build_s": build_s,
        "split": split, "eager_step": whole, "launches": launches, "graphed_step_ms": graphed,
        "graphed_steady_ms": steady, "idle_share_graphed": 1.0 - whole["device_busy_ms"] / steady,
    }), flush=True)
    return 0


def main(roots) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {smi}", flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"chip_profile_split: the run of {root} exited {proc.returncode}", file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        sys.exit(run_one(sys.argv[2]))
    sys.exit(main(sys.argv[1:] or [HERE]))
