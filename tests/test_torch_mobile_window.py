"""The mobile panda's fleet held to the JAX fleet at its full width (slow; not
in tier-1): ``tests/torch_mobile_window.py`` at B=1024 for 6 steps on the
CPU, the default runner (the 1/8 rescue tier, overflowing until step 5), no
kick, as ``chip_smoke.mobile_phase`` runs it on the card. About 2 min for the
JAX fleet (one compile, ~110 s) and 3 min for the port (~30 s a step on 4
threads).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mobile_window.py -m slow -s -q

Tolerances, and why (those of ``tests/test_torch_bench_window.py``): over
steps 2-5 (steps 0 and 1 converge no lane in either package), mean converged
fraction within 0.005, mean iterations within 1%, mean goal distance within
0.5%. Per step, lanes at the tolerance's edge flip their exit flags and
compound through the overflowing rescue tier, so per-step values are
printed side by side, not held.
"""

import numpy as np
import pytest
import torch

import torch_mobile_window as window

B = 1024
STEPS = window.WINDOW[1]


@pytest.mark.slow
def test_mobile_window_matches_jax():
    torch.set_num_threads(4)
    records = []
    for rec in window.run(B, STEPS):
        records.append(rec)
        j, p = rec["jax"], rec["port"]
        print(f"step {rec['step']}: converged {j['converged_fraction']:.4f} / {p['converged_fraction']:.4f}, "
              f"iterations {j['mean_iterations']:.3f} / {p['mean_iterations']:.3f}, "
              f"goal distance {j['mean_goal_distance']:.5f} / {p['mean_goal_distance']:.5f}, "
              f"overflow {j['rescue_overflow_fraction']:.4f} / {p['rescue_overflow_fraction']:.4f} (JAX / port)",
              flush=True)
    s = window.summary(records)
    print(s)
    j, p = s["jax"], s["port"]
    assert abs(j["converged_fraction"] - p["converged_fraction"]) <= 0.005, s
    assert abs(j["mean_iterations"] - p["mean_iterations"]) <= 0.01 * j["mean_iterations"], s
    assert abs(j["mean_goal_distance"] - p["mean_goal_distance"]) <= 0.005 * j["mean_goal_distance"], s
    assert all(np.isfinite(v) for pkg in (j, p) for v in pkg.values())
