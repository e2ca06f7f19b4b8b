#!/usr/bin/env python3
"""Short card check of the solver's CUDA graphs against its eager units.

    python3 chip_graph_check.py

The first call to make on the card after a change to the solver's units
(``robot_mpcs_tpu_torch/solver/units.py``, ``solver/al_ilqr.py``): it
builds the three kernel shapes it needs, then solves cold at small shapes
eagerly (``units._eager()``) and graphed (the first call captures, the
second replays) and prints one JSON line per case: results equal bit for
bit, launches of each run, wall seconds. Cases: panda at B=64 and 1, boxer
at B=16 and 1 (``torch.func`` dynamics Jacobians), the panda ``values``
path at B=64 and the pointRobot generic path at B=64; then a panda fleet at
B=512 for 3 steps, eager and graphed, states and metrics compared. About
35 s of command time on one H100; ``chip_smoke.py``'s graph phase is the
full-width check. Exits 1 if a case differs or raises.
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    import chip_smoke as cs
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.solver import units
    from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

    if not torch.cuda.is_available():
        print("chip_graph_check: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    _build.build_libraries([("riccati_packed", (14, 7, 0)), ("riccati_packed", (6, 3, 0)),
                            ("riccati_batched", (8, 2))])
    ok = True

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
            with ctx, cs.launches_by_batch(1) as tally:
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = solver(*args)
                torch.cuda.synchronize()
            return res, time.perf_counter() - t, dict(tally)

        graphed = make()
        runs = {"eager": timed(make(), units._eager()),
                "capture": timed(graphed, contextlib.nullcontext()),  # warm-up and capture
                "replay": timed(graphed, contextlib.nullcontext())}
        want = runs["eager"][0]
        same = {r: all(torch.equal(a, b) for a, b in zip(want, runs[r][0])) for r in ("capture", "replay")}
        launches = {r: sum(runs[r][2].values()) for r in runs}
        print(json.dumps({"case": f"{kind} {path}", "B": B, "equal": same, "launches": launches,
                          "s": {r: runs[r][1] for r in runs}}), flush=True)
        return all(same.values()) and len(set(launches.values())) == 1

    cases = (("panda", panda_setup, 64, "split"), ("panda", panda_setup, 1, "split"),
             ("boxer", boxer_setup, 16, "split"), ("boxer", boxer_setup, 1, "split"),
             ("panda", panda_setup, 64, "values"), ("pointRobot", point_robot_setup, 64, "generic"))
    for case in cases:
        try:
            ok &= solve_case(*case)
        except Exception as e:  # noqa: BLE001 - report every case
            print(json.dumps({"case": f"{case[0]} {case[3]}", "B": case[2], "raised": repr(e)[:2000]}),
                  flush=True)
            ok = False

    p = MpcProblem(Setup.from_dict(panda_setup()))
    sc = random_fleet_scenario(p, 512, seed=0, **cs.sampler("panda"))
    out = {}
    for mode in ("eager", "graphed"):
        runner = FleetRunner(p, 512, device="cuda")
        scen = runner.to_device(sc)
        state, ms = runner.init_state(scen), []
        with units._eager() if mode == "eager" else contextlib.nullcontext():
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = runner.step(state, scen)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
        out[mode] = (state, m, ms)
    same = (all(torch.equal(a, b) for a, b in zip(out["eager"][0], out["graphed"][0]))
            and all(torch.equal(a, b) for a, b in zip(out["eager"][1], out["graphed"][1])))
    print(json.dumps({"fleet": "panda B=512", "steps": 3, "equal": same,
                      "eager_ms": out["eager"][2], "graphed_ms": out["graphed"][2]}), flush=True)
    return 0 if ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
