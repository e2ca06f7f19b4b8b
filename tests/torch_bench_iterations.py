"""Per-lane solver iterations and exit flags of the two packages' panda
fleets over the benchmark's window, on the CPU.

    PYTHONPATH=. python tests/torch_bench_iterations.py [--batch 32] [--steps 5]

Both fleets start from ``bench._scenario_for(..., "panda")`` with
``bench.py``'s runner defaults, as ``tests/test_torch_bench.py`` steps them.
Before each step, each package's solver is called on its own fleet's state
(the solve that the step makes), and the port's solver also on the JAX
fleet's state, which separates a difference of the solvers from one of the
trajectories. One JSON line per step: the mean iterations of the three
solves, their converged counts, the lanes whose exit flags differ, and the
per-lane iterations.
"""

import argparse
import json
import warnings

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

import bench
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from robot_mpcs_tpu_torch import bench as tbench
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
from robot_mpcs_tpu_torch.parallel.mesh import make_mesh


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    warnings.simplefilter("ignore")
    b = args.batch

    jp, _ = bench._load_problem("panda")
    mesh = jax_make_mesh(devices=jax.devices()[:1])
    jr = JaxRunner(jp, b, mesh=mesh)
    jsc = jr.shard_scenario(bench._scenario_for(jp, b, "panda"))
    js = jr.init_state(jsc)
    js = js._replace(step=jax.device_put(js.step, NamedSharding(mesh, PartitionSpec())))
    tp, _ = tbench._load_problem("panda")
    tr = FleetRunner(tp, batch_size=b, mesh=make_mesh(torch.device("cpu")))
    tsc = tr.shard_scenario(tbench._scenario_for(tp, b, "panda"))
    ts = tr.init_state(tsc)

    for k in range(1, args.steps + 1):
        # the JAX step donates its state: copy it to the host first
        jx, jz, jl = (np.array(a) for a in (js.x, js.z_warm, js.lam))
        jres = jax.vmap(jr._solve)(jx, jsc.params, jz, jl)
        tres = tr._solve(ts.x, tsc.params, ts.z_warm, ts.lam)
        xres = tr._solve(torch.from_numpy(jx), tsc.params, torch.from_numpy(jz),
                         torch.from_numpy(jl))
        js, _ = jr.step(js, jsc)
        ts, _ = tr.step(ts, tsc)
        it = {"jax": np.asarray(jres.iterations), "port": tres.iterations.numpy(),
              "port_on_jax_state": xres.iterations.numpy()}
        flag = {"jax": np.asarray(jres.exitflag), "port": tres.exitflag.numpy(),
                "port_on_jax_state": xres.exitflag.numpy()}
        print(json.dumps({
            "step": k,
            "mean_iterations": {n: round(float(v.mean()), 3) for n, v in it.items()},
            "converged": {n: int((v == 1).sum()) for n, v in flag.items()},
            "flags_differ": {n: np.flatnonzero(v != flag["jax"]).tolist()
                             for n, v in flag.items() if n != "jax"},
            "iterations": {n: v.tolist() for n, v in it.items()},
        }), flush=True)


if __name__ == "__main__":
    main()
