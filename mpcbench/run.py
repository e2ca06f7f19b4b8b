"""Run one cell of the port's benchmark once and print its result.

    python3 mpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m mpcbench.run`` works as well).
``BENCHMARK.json`` names the cell's configuration and traffic mix; this
harness finds them by name (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``, ``metrics/<metric>.py``)
and drives the traffic's driver (``drivers/<driver>.py``). With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``trace.py``). The last line on standard
output is the result, one JSON object; the numbers the comparison judged
(``reference/check.py``) end standard error and the result's line.

The run needs a CUDA card (exit 2 without one) and keeps the program's
kernel cache, ``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` in fixed
directories under the checkout's ``build/``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "robot_mpcs_tpu")


def cache_env(root: Path = ROOT) -> None:
    """Fix every build and kernel cache to a directory of the checkout."""
    build = root / "build"
    os.environ["ROBOT_MPCS_TPU_CACHE"] = str(build / "robot_mpcs_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT):
    """(benchmark, cell, configuration, traffic, limits) of the cell
    ``name``, each found by name under ``mpcbench/``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(root / configs[cell["config"]]["file"])
    traffic = _json(root / "mpcbench" / "traffic" / f"{cell['traffic']}.json")
    limits = _json(root / "mpcbench" / "limits" / f"{name}.json")
    return bench, cell, cfg, traffic, limits


def cell_metrics(bench, cell, section: str):
    """The ``section`` metrics this cell reports: those whose ``workloads``
    name it, or that have none and move (or are) a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else the one of its quantity, ``metrics/<name up to the first dot>.py``
    (``idle_share.fleet`` and ``idle_share.planner`` share ``idle_share.py``;
    their ``moves`` differ, and BENCHMARK.json states it)."""
    own = root / "mpcbench" / "metrics" / f"{name}.py"
    return own if own.is_file() else root / "mpcbench" / "metrics" / f"{name.split('.')[0]}.py"


def load_reader(entry, root: Path = ROOT):
    """The reader of a per-layer metric; its declared layer, unit and
    source must be BENCHMARK.json's."""
    path = reader_path(entry["name"], root)
    spec = importlib.util.spec_from_file_location(f"mpcbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("layer", "unit", "source"):
        if getattr(mod, key.upper()) != entry[key]:
            raise ValueError(f"{path}: {key} {getattr(mod, key.upper())!r} is not BENCHMARK.json's {entry[key]!r}")
    return mod


def end_to_end(name: str, totals, elapsed: float, setup_s: float) -> float:
    """An end-to-end metric from the window: the converged solves over all
    of its time, or the set-up."""
    if name == "converged_solves_per_s":
        return totals["converged"] / elapsed
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", control=None, fault=None,
             overrides=None, root: Path = ROOT, t0: float = T0):
    """Run the cell once; returns (result, compared). ``control`` (a name of
    ``control.CONTROLS``) and ``fault`` (``control.Fault``) are for the
    comparison's control and the fault tests; ``overrides`` replaces traffic
    keys (the tests' small sizes)."""
    import torch

    from mpcbench import control as control_mod
    from mpcbench import readers
    from mpcbench.reference import check
    from mpcbench.reference.model import Robot

    bench, cell, cfg, traffic, limits = load_cell(name, root)
    traffic = {**traffic, **(overrides or {})}
    dev = torch.device(device)
    kind = traffic["driver"]
    drivers = importlib.import_module(f"mpcbench.drivers.{kind}")
    cls = drivers.FleetDriver if kind == "fleet" else drivers.PlannerDriver
    ctl = control_mod.CONTROLS[control]() if control else None
    drv = cls(cfg, traffic, seed, dev, Robot(cfg), control=ctl, fault=fault)
    drv.warmup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    elapsed = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    totals = drv.totals()
    times = drv.step_s if kind == "fleet" else drv.solve_s
    metrics, breakdown, device_extra = {}, None, {}
    if not trace:
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": end_to_end(m["name"], totals, elapsed, setup_s), "unit": m["unit"]}
    else:
        from mpcbench import trace as trace_mod

        problem = drv.problem if kind == "fleet" else drv.planner._problem
        rec = {"kind": kind, "times_s": times, "enqueue_s": getattr(drv, "enqueue_s", None), "totals": totals,
               "batch": int(traffic["batch"]), "profile": None,
               "iteration_flops": trace_mod.iteration_flops(problem)}
        if dev.type == "cuda":
            rec["profile"] = trace_mod.profile_call(drv.profiled_calls(), dev)
            p = rec["profile"]
            breakdown = p["breakdown"]
            device_extra = {"busy_s": p["busy_ms"] / 1e3, "window_s": p["eager_wall_ms"] / 1e3}
            print(f"traced: one {('step' if kind == 'fleet' else 'solve')} profiled eagerly: busy "
                  f"{p['busy_ms']:.3f} ms, {p['device_events']} device events, in a traced window of "
                  f"{p['eager_wall_ms']:.1f} ms (window_s); the graphed call of the same work takes "
                  f"{p['graphed_ms']:.3f} ms (idle_share.* reads busy against it); the breakdown's idle "
                  f"gaps are the eager host's", file=sys.stderr)
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_reader(m, root).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # the program's state goes before the reference runs
    snaps = getattr(drv, "snaps", None)
    records = getattr(drv, "records", None)
    tasks, task_rows = drv.tasks, getattr(drv, "task_rows", None)
    drv.release()
    del drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    robot = Robot(cfg, device=dev)
    t_ref = time.perf_counter()
    if kind == "fleet":
        judged = check.fleet_numbers(robot, cfg, traffic, tasks, task_rows, snaps, totals, seed, dev)
    else:
        judged = check.planner_numbers(robot, cfg, traffic, tasks, records, seed, dev)
    # a number that is not finite has failed: it is written as 1e300
    compared = [(k, float(v) if math.isfinite(float(v)) else 1e300, float(limits[k]))
                for k, v in judged["numbers"].items() if k in limits]
    correct = all(v <= lim for _, v, lim in compared)
    rest = {k: v for k, v in judged["numbers"].items() if k not in limits}
    if rest:
        print(f"judged, not compared: {json.dumps(rest)}", file=sys.stderr)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s; seen {json.dumps(judged['seen'])}; "
          f"window {elapsed:.3f} s, {len(times)} {'steps' if kind == 'fleet' else 'solves'}", file=sys.stderr)
    tenths = [1e3 * sum(c) / len(c) for c in (times[i * len(times) // 10:(i + 1) * len(times) // 10] for i in range(10)) if c]
    print("window ms by tenth: " + " ".join(f"{v:.2f}" for v in tenths), file=sys.stderr)
    print("tail ms: " + " ".join(f"p{q} {readers.percentile_ms(times, q):.3f}" for q in (50, 90, 95, 97, 98, 99)),
          file=sys.stderr)
    if records:
        # the time of a solve by its place in its task: a task's first solves start cold
        P = int(traffic["reset_period"])
        by = [[dt for dt, r in zip(times, records) if r["t"] % P == j] for j in range(5)]
        rest = [dt for dt, r in zip(times, records) if r["t"] % P >= 5]
        print("solve ms by place in its task: " + " ".join(f"{j}: {1e3 * sum(v) / len(v):.2f}" for j, v in enumerate(by) if v)
              + (f" 5-{P - 1}: {1e3 * sum(rest) / len(rest):.2f}" if rest else ""), file=sys.stderr)
    result = {
        "correct": bool(correct), "attempted": int(totals["attempted"]), "failed": int(totals["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak), **device_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if dev.type == "cuda":
        result["card"] = _card()
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    return result, compared


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help="run the comparison's control in the program's place (never a benchmark run)")
    ap.add_argument("--fault", default=None,
                    help="plant one of control.FAULTS under the timed path (never a benchmark run)")
    args = ap.parse_args(argv)
    cache_env()
    import torch

    bench = _json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mpcbench: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from mpcbench.control import Fault

    result, compared = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                control=args.control, fault=Fault(args.fault) if args.fault else None)
    bad = forbidden_modules()
    if bad:
        print(f"mpcbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v, lim in compared:
        print(f"compared {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
