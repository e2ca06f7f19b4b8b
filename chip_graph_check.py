#!/usr/bin/env python3
"""Short card check of the solver's whole-program CUDA graphs against the eager units.

    python3 chip_graph_check.py

The first call to make on the card after a change to the solver's units or
loops (``robot_mpcs_tpu_torch/solver/units.py``, ``solver/al_ilqr.py``,
``ops/graph_cond.py``, ``parallel/fleet.py``): it builds the kernel shapes it
needs and the WHILE-node library, prints the CUDA runtime and driver
versions, then prints one JSON line per case:

* ``while_probe``: a toy program of two nested loops (3 x (4 - b0) trips,
  a temporary allocated in each body) captured with WHILE nodes after a
  warm-up in which the inner body never ran, replayed at two other b0:
  its counts are the loops' trip counts;
* solves, eager (``units._eager()``) and graphed (the first call warms up
  and captures, the second replays): panda at B=64 and 1, boxer at B=16 and
  1 (``torch.func`` dynamics Jacobians), the panda ``values`` path at B=64
  and the pointRobot generic path at B=64. Results equal bit for bit,
  launches by (kernel, B) equal, the replay one graph replay with no host
  read; the graph's node count, WHILE bodies and capture / instantiate
  seconds;
* a lifetime case: a captured solver dies (collected, the allocator's
  cache emptied) while another replays and a third captures, each equal to
  its eager solve; and no bytes left allocated in a program's WHILE-body
  pools after its capture;
* a panda fleet at B=512 for 3 steps with the kick after 2 (kicked lanes go
  through the graph) and a mixed ``FleetGroup`` step, eager and graphed:
  states, exit flags and metrics equal, launches equal, one replay per
  runner step and no host read after the first.

About a minute of command time on one H100; ``chip_smoke.py``'s graph
phase is the full-width check. Exits 1 if a case differs or raises.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def while_probe(torch, units):
    """Two nested loops, 3 outer trips of ``4 - b0`` inner ones, as a
    program. The first call (the warm-up) starts at b0 = 4, so the inner
    body never runs in it and is set up on a scratch carry; the replays
    start at b0 = 0 and 2."""
    dev = torch.device("cuda")

    def init(c):
        a = torch.zeros((), dtype=torch.int32, device=dev)
        return dict(a=a, n=torch.zeros((), dtype=torch.int32, device=dev), any_a=a < 3)

    def outer_head(c):
        b = c["b0"].clone()
        return dict(b=b, any_b=b < 4)

    def inner(c):
        tmp = (torch.arange(5, device=dev).sum() - 9).to(torch.int32)  # a body temporary: 1
        b = c["b"] + 1
        return dict(b=b, n_new=c["n"] + tmp, any_b=b < 4)

    def inner_tail(c):
        return dict(n=c["n_new"])

    def outer_tail(c):
        a = c["a"] + 1
        return dict(a=a, any_a=a < 3)

    prog = units.UnitProgram({"init": init, "outer_head": outer_head, "inner": inner,
                              "inner_tail": inner_tail, "outer_tail": outer_tail}, dev)

    def drive():
        prog.run("init")
        for _ in prog.loop("any_a"):
            prog.run("outer_head")
            for _ in prog.loop("any_b"):
                prog.run("inner")
                prog.run("inner_tail")
            prog.run("outer_tail")

    counts = []
    for b0 in (4, 0, 2):  # warm-up and capture, replay, replay
        prog.load(b0=torch.tensor(b0, dtype=torch.int32, device=dev))
        prog.call(drive)
        torch.cuda.synchronize()
        counts.append((int(prog.carry["a"]), int(prog.carry["n"])))
    print(json.dumps({"while_probe": counts, "stats": prog.stats}), flush=True)
    return counts == [(3, 0), (3, 12), (3, 6)]


def body_pool_live_bytes(torch, prog):
    """Bytes still allocated in a captured program's WHILE-body pools: 0, or
    something outlives the bodies in memory that dies with the graph."""
    ids = {tuple(pool.id) for pool in prog._capture.pools}
    return sum(block["size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids
               for block in seg["blocks"] if block["state"] == "active_allocated")


def lifetime_case(torch, units, cs, make_solver, args_a, args_b):
    """Programs that die while others live: solver A captured, solver B
    captured, A deleted and collected, the allocator's cache emptied, then
    B replayed twice and a new solver C (A's shape) captured and replayed:
    each equal to its eager solve."""
    import gc

    with units._eager():
        want_a, want_b = make_solver()(*args_a), make_solver()(*args_b)
    a, b = make_solver(), make_solver()
    a(*args_a)
    b(*args_b)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    got = [b(*args_b), b(*args_b)]
    c = make_solver()
    got += [c(*args_a), c(*args_a)]
    torch.cuda.synchronize()
    wants = [want_b, want_b, want_a, want_a]
    same = all(torch.equal(x, y) for w, g in zip(wants, got) for x, y in zip(w, g))
    print(json.dumps({"lifetime": "solver A dies, B replays, C captures", "equal": same}), flush=True)
    return same


def main() -> int:
    import torch

    import chip_smoke as cs
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.ops import _build, graph_cond
    from robot_mpcs_tpu_torch.parallel import FleetGroup, mixed_fleet_scenarios
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.solver import units
    from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

    if not torch.cuda.is_available():
        print("chip_graph_check: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(torch.__version__, torch.version.cuda, smi, flush=True)
    t0 = time.perf_counter()
    _build.build_libraries([("riccati_packed", (14, 7, 0)), ("riccati_packed", (6, 3, 0)),
                            ("riccati_batched", (8, 2)), ("graph_cond", ())])
    print(json.dumps({"build_s": time.perf_counter() - t0, "versions": graph_cond.versions(),
                      "missing": graph_cond.missing(torch.device("cuda"))}), flush=True)
    ok = True
    try:
        ok &= while_probe(torch, units)
    except Exception as e:  # noqa: BLE001 - report every case
        print(json.dumps({"while_probe": "raised", "error": repr(e)[:3000]}), flush=True)
        return 1

    def solve_case(kind, setup, B, path="split"):
        p = MpcProblem(Setup.from_dict(setup()))
        sc = random_fleet_scenario(p, B, seed=0, **cs.sampler(kind))
        d = p.dims
        z0 = torch.zeros((B, d.N, d.nz))
        z0[:, :, : d.nx] = sc.xinit[:, None]
        lam0 = torch.zeros((B, d.N, p.n_con))
        if path == "split":
            make = lambda: p.build_solver(device="cuda")  # noqa: E731
        else:
            stage, w_lb, w_ub = p.solver_callbacks()
            if path == "generic":
                stage = stage._replace(values=None, weights=None)
            make = lambda: build_solver(  # noqa: E731
                stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=p.n_con, n_res=p.n_res,
                n_bar=p.n_bar, w_lb=w_lb, w_ub=w_ub, cfg=p.setup.solver,
                pinned_rows=p.reference_constraint_rows()[1], device="cuda")
            lam0 = lam0[..., torch.as_tensor(p.reference_constraint_rows()[0])]
        args = [t.cuda() for t in (sc.xinit, sc.params, z0, lam0)]

        def timed(solver, ctx):
            replays = units.replays
            with ctx, cs.launches_by_batch(1) as tally, cs.host_reads() as reads:
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = solver(*args)
                torch.cuda.synchronize()
                s = time.perf_counter() - t
            return res, s, dict(tally), reads[0], units.replays - replays

        graphed = make()
        runs = {"eager": timed(make(), units._eager()),
                "capture": timed(graphed, contextlib.nullcontext()),  # warm-up and capture
                "replay": timed(graphed, contextlib.nullcontext())}
        want = runs["eager"][0]
        same = {r: all(torch.equal(a, b) for a, b in zip(want, runs[r][0])) for r in ("capture", "replay")}
        launches = {r: {f"{k[0]}@{k[1]}": n for k, n in runs[r][2].items()} for r in runs}
        prog = graphed._program(args[0], args[1])
        live = body_pool_live_bytes(torch, prog)
        print(json.dumps({"case": f"{kind} {path}", "B": B, "equal": same, "launches": launches,
                          "body_pool_live_bytes": live,
                          "host_reads": {r: runs[r][3] for r in runs},
                          "replays": {r: runs[r][4] for r in runs},
                          "s": {r: runs[r][1] for r in runs}, "stats": prog.stats}), flush=True)
        return (all(same.values()) and runs["eager"][2] == runs["capture"][2] == runs["replay"][2]
                and runs["replay"][3] == 0 and runs["replay"][4] == 1 and live == 0)

    cases = (("panda", panda_setup, 64, "split"), ("panda", panda_setup, 1, "split"),
             ("boxer", boxer_setup, 16, "split"), ("boxer", boxer_setup, 1, "split"),
             ("panda", panda_setup, 64, "values"), ("pointRobot", point_robot_setup, 64, "generic"))
    for case in cases:
        try:
            ok &= solve_case(*case)
        except Exception as e:  # noqa: BLE001 - report every case
            print(json.dumps({"case": f"{case[0]} {case[3]}", "B": case[2], "raised": repr(e)[:3000]}),
                  flush=True)
            ok = False

    def cold(kind, setup, B):
        p = MpcProblem(Setup.from_dict(setup()))
        sc = random_fleet_scenario(p, B, seed=1, **cs.sampler(kind))
        z0 = torch.zeros((B, p.dims.N, p.dims.nz))
        z0[:, :, : p.dims.nx] = sc.xinit[:, None]
        return p, [t.cuda() for t in (sc.xinit, sc.params, z0, torch.zeros((B, p.dims.N, p.n_con)))]

    try:
        pa, args_a = cold("panda", panda_setup, 64)
        _, args_b = cold("panda", panda_setup, 16)
        ok &= lifetime_case(torch, units, cs, lambda: pa.build_solver(device="cuda"), args_a, args_b)
    except Exception as e:  # noqa: BLE001
        print(json.dumps({"lifetime": "raised", "error": repr(e)[:3000]}), flush=True)
        ok = False

    def fleet_case(label, make, scenarios, steps):
        out = {}
        for mode in ("eager", "graphed"):
            runner = make()
            scen = runner.to_device(scenarios)
            state = (runner.init_states if isinstance(runner, FleetGroup) else runner.init_state)(scen)
            ms, reads, flags, reps = [], [], [], []
            with (units._eager() if mode == "eager" else contextlib.nullcontext()), \
                    cs.launches_by_batch(steps) as tally:
                for _ in range(steps):
                    torch.cuda.synchronize()
                    r0 = units.replays
                    with cs.host_reads() as n:
                        t = time.perf_counter()
                        state, m = runner.step(state, scen)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t) * 1e3)
                    reads.append(n[0])
                    reps.append(units.replays - r0)
                    rs = runner.runners.values() if isinstance(runner, FleetGroup) else [runner]
                    flags.append([r._last_program.carry["exitflag"].cpu() for r in rs])
            states = state if isinstance(state, dict) else {"": state}
            metrics = m.per_class if isinstance(runner, FleetGroup) else {"": m}
            out[mode] = dict(states={k: [t.cpu() for t in v] for k, v in states.items()},
                             metrics={k: [float(t) for t in v] for k, v in metrics.items()},
                             flags=flags, ms=ms, reads=reads, replays=reps, launches=dict(tally))
        e, g = out["eager"], out["graphed"]
        same = (e["states"].keys() == g["states"].keys()
                and all(torch.equal(a, b) for k in e["states"] for a, b in zip(e["states"][k], g["states"][k]))
                and e["metrics"] == g["metrics"]
                and all(torch.equal(a, b) for fe, fg in zip(e["flags"], g["flags"]) for a, b in zip(fe, fg)))
        print(json.dumps({"fleet": label, "steps": steps, "equal": same,
                          "launches_equal": e["launches"] == g["launches"],
                          "launches": {f"{k[0]}@{k[1]}": n for k, n in g["launches"].items()},
                          "eager_ms": e["ms"], "graphed_ms": g["ms"], "eager_host_reads": e["reads"],
                          "graphed_host_reads": g["reads"], "graphed_replays": g["replays"]}), flush=True)
        return same and e["launches"] == g["launches"] and not any(g["reads"][1:])

    p = MpcProblem(Setup.from_dict(panda_setup()))
    try:
        ok &= fleet_case("panda B=512 kick_after=2",
                         lambda: FleetRunner(p, 512, device="cuda", kick_after=2),
                         random_fleet_scenario(p, 512, seed=0, **cs.sampler("panda")), 3)
        probs = {"pointRobot": (MpcProblem(Setup.from_dict(point_robot_setup())), 256),
                 "boxer": (MpcProblem(Setup.from_dict(boxer_setup())), 128)}
        ok &= fleet_case("group pointRobot 256 + boxer 128", lambda: FleetGroup(probs, device="cuda"),
                         mixed_fleet_scenarios(probs, sampler_kwargs={k: cs.sampler(k) for k in probs}), 2)
    except Exception as e:  # noqa: BLE001
        print(json.dumps({"fleet": "raised", "error": repr(e)[:3000]}), flush=True)
        ok = False
    print(json.dumps({"ok": bool(ok), "s": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
