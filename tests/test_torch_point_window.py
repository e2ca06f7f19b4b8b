"""The port's pointRobot fleet held to the JAX fleet over the benchmark's
window at the benchmark's width (slow; not in tier-1): ``bench.py``'s
pointRobot extra, ``tests/torch_bench_window.py --robot pointRobot`` at
B=1024 for 38 steps on the CPU, the runner's defaults (the 1/8 rescue tier,
the kick after 25 steps without improvement), the JAX solver on the Pallas
kernel its fleet runs on its accelerator (interpret mode), as
``tests/test_torch_group_window.py`` takes it. About 2.5 min: the JAX step
~30 s to compile, then ~1.5 s; the port ~1.2 s.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_point_window.py -m slow -s -q

Tolerances, and why (those of ``tests/test_torch_bench_window.py``):

* noise of the lanes both packages kick at a step: equal within 1e-5 (the
  draws agree to 3 ulp, ``tests/test_torch_prng.py``);
* kicked lanes per step: within 3 of JAX's count (f32 order decides which
  lanes plateau at the 5e-3 threshold). Where neither package kicks a lane
  in the run, that is printed and not held: the kick itself is held lane
  for lane by ``tests/test_torch_point_fleet.py``;
* over the window of steps 8-37: mean converged fraction within 0.005,
  mean iterations within 1%, mean goal distance within 0.5%. Per-step
  values are printed, one JSON line a step, not held.
"""

import json

import numpy as np
import pytest
import torch

import torch_bench_window as window

B = 1024
STEPS = window.WINDOW[1]


@pytest.mark.slow
def test_point_window_matches_jax():
    torch.set_num_threads(4)
    records = []
    for rec in window.run(B, STEPS, robot="pointRobot", jax_riccati="pallas"):
        records.append(rec)
        print(json.dumps(rec), flush=True)
    s = window.summary(records)
    print("WINDOW " + json.dumps(s))
    if not s["kicked_both"]:
        print(f"no lane kicked by both packages in {STEPS} steps (kicked JAX "
              f"{sum(r['jax']['kicked'] for r in records)}, port {sum(r['port']['kicked'] for r in records)})")
    for rec in records:
        assert abs(rec["jax"]["kicked"] - rec["port"]["kicked"]) <= 3, rec
        if rec["kicked_both"]:
            assert rec["noise_max_abs_diff"] <= 1e-5, rec
    j, p = s["jax"], s["port"]
    assert abs(j["converged_fraction"] - p["converged_fraction"]) <= 0.005, s
    assert abs(j["mean_iterations"] - p["mean_iterations"]) <= 0.01 * j["mean_iterations"], s
    assert abs(j["mean_goal_distance"] - p["mean_goal_distance"]) <= 0.005 * j["mean_goal_distance"], s
    assert all(np.isfinite(v) for pkg in (j, p) for v in pkg.values())
