"""The port's mixed fleet held to the JAX package's ``FleetGroup`` at full
width (slow; not in tier-1): ``tests/torch_group_window.py``, pointRobot
1024, panda 2048 and boxer 1024 at the default runner (each class's 1/8
rescue tier, the kick after 25 steps), 8 steps on the CPU, as
``chip_smoke.group_phase`` runs it on the card. The JAX solver runs its
Pallas kernels (interpret mode), as its fleet does on its accelerator and
as the port's CUDA kernels do: its CPU stage scan takes ~0.8% fewer
iterations on the panda, a spread of the reference itself (``PERF.md``
§5). About 20 min: the JAX step ~5 min to compile, then ~85 s; the port
20-25 s a step.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_group_window.py -m slow -s -q

Tolerances, and why (those of ``tests/test_torch_bench_window.py``): per
class and over the group (``GroupMetrics.overall``), the means over steps
2-7 (steps 0 and 1 start cold) of the converged fraction within 0.005, of
the iterations within 1% and of the goal distance within 0.5%. Per step,
lanes at the tolerance's edge flip their exit flags and compound through
the overflowing rescue tiers, so per-step values are printed, one JSON line
a step, not held.
"""

import json

import numpy as np
import pytest
import torch

import torch_group_window as window
from chip_smoke import GROUP_SIZES


@pytest.mark.slow
def test_group_window_matches_jax():
    torch.set_num_threads(4)
    records = []
    for rec in window.run(GROUP_SIZES, window.WINDOW[1]):
        records.append(rec)
        print(json.dumps(rec), flush=True)
    s = window.summary(records)
    print("WINDOW " + json.dumps(s))
    assert set(s["jax"]) == set(GROUP_SIZES) | {"overall"}
    for c, j in s["jax"].items():
        p = s["port"][c]
        assert abs(j["converged_fraction"] - p["converged_fraction"]) <= 0.005, (c, s)
        assert abs(j["mean_iterations"] - p["mean_iterations"]) <= 0.01 * j["mean_iterations"], (c, s)
        assert abs(j["mean_goal_distance"] - p["mean_goal_distance"]) <= 0.005 * j["mean_goal_distance"], (c, s)
        assert all(np.isfinite(v) for pkg in (j, p) for v in pkg.values()), (c, s)
