#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``robot_mpcs_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit from ``nvidia-smi``; no CUDA
   device (or no port package beside this script) exits non-zero.
2. build: the four CUDA sources (``csrc/riccati_packed.cu``,
   ``csrc/riccati_batched.cu``, ``csrc/gn_assemble.cu``, each including
   ``csrc/riccati_common.cuh``, and ``csrc/fk_walk.cu``) compiled for every
   shape this script runs (``kernel_pairs``: the Riccati shapes, and the
   split expansion's FK walk per robot chain and link set and Gauss-Newton
   assembly per row segments of every problem it solves), one ``nvcc`` per
   shape, all at once, with each library's registers, spills and stack
   (``-Xptxas -v``) printed.
3. kernels, each held against its plain PyTorch version on the same CUDA
   tensors, the structured sweep at rtol 2e-3 / atol 2e-5, the general one
   at rtol 2e-3 / atol 2e-4 (``tests/test_riccati_pallas.py:70-75``):

   * at every shape the main paths launch them at (``PACKED_SHAPES``:
     panda's and pointRobot's phase 1 and rescue tier, alone and in the
     group, their planners' B=1, the bench's panda B=64 with its rescue
     tier, the kick fleet's B=1024 with its rescue tier, holonomic arms
     of 2, 6 and 15 dof with and without slack, the 6-dof chain's B=64 and
     17 dof with slack; ``GENERAL_SHAPES``: boxer's
     phase 1, planner (B=1) and rescue tier, boxer at B=4096 with per-lane
     and batch-constant A/B, (14, 7, 20) at B=4096, the mobile panda (22,
     9) and with slack (22, 10) at B=1024, 128 and 1 with per-lane and
     batch-constant A/B, (36, 16) at B=128), each also timed and printed as
     a ``kernel_shape`` line;
   * the structured sweep at the test dims (3, 0, 6), (3, 1, 5) and panda
     with a slack column (nw=8); a NaN-poisoned lane must be the only
     failed lane;
   * the general sweep at (nx, nw, N, B) = (6, 3, 5, 5), (14, 7, 20, 64)
     and (8, 3, 10, 64); a lane with negative-definite ``lww`` and a
     NaN-poisoned lane must each fail alone, the first with all-zero gains;
     a shape of which one lane does not fit a block (``OVERSIZED``) must
     raise naming ``riccati_backend="scan"`` and launch nothing.

   The split expansion's kernels (``ops/fk_walk.py``, the JAX package's
   batch rule ``_walk_scalar``; ``ops/gn_assemble.py``, its
   ``_gn_assemble_vmap``) at every main-path shape (``EXPANSION_SHAPES``:
   panda's phase 1, rescue tier and planner, the group's three classes at
   phase 1 and rescue, the mobile panda's phase 1 and rescue; the walk also
   without its Jacobian at panda's and the mobile panda's phase 1), each
   held against its plain version on the same CUDA tensors (the walk at
   1e-5 absolute; the assembly with each entry within 1e-4 of its own term
   scale, ``gn_excess``, live barrier rows near the clamp and away from it,
   H exactly symmetric) and timed, then a CUDA call counts its launch and
   the walk refuses another chain's width (``expansion_kernel_phase``).

   A kernel's time (``ms``) is its device time per launch from
   ``torch.profiler`` over 20 launches (10 for the expansion's kernels); ``call_ms`` and ``plain_ms`` are
   CUDA events around one wrapper call (host launch path included), median
   after warm-up. Each kernel's bound is the larger of its bytes over
   3.35 TB/s and its fp32 flops over 67 TFLOP/s. The kernels line carries
   each kernel at its phase-1 shape (panda B=4096; the mobile panda
   B=1024 for the general sweep).
4. panda path: the panda fleet (``examples/config/pandaMpc.yaml`` with the
   fleet benchmark's repulsion weight), B=4096 random scenarios from seed 0,
   through ``FleetRunner(..., device="cuda")`` for 6 closed-loop steps with
   the default rescue tier and kick. The launch counts of the structured
   kernel and of the split expansion's two kernels, each set to 0 before,
   must grow, every metric must be finite and the last step's converged
   fraction must be >= 0.9 (a floor under the 0.956-0.971 the JAX package
   reaches). Launches per step are printed by kernel and batch size. Each
   step is one CUDA graph replay (its loops WHILE nodes) after the first.
   Two eager steps then split a step's wall time into phase-1 solve,
   rescue-tier solve and the rest, and ``program_record`` gives the
   device's busy time and kernel count (the same step profiled eagerly),
   the graph's span on the device (CUDA events) and the idle share of the
   graphed step without the profiler.
5. group path: ``FleetGroup`` of pointRobot 1024, panda 2048 and boxer 1024
   lanes (``mixed_fleet_scenarios(seed=0)`` with bench.py's per-class
   samplers and weights) at the default runner for 8 closed-loop steps
   (launches per step printed by kernel and batch size). Both kernels'
   launch counts must grow (the structured one from panda and pointRobot,
   the general one from boxer), every per-class metric must be finite and
   each class's last-step converged fraction >= 0.9. Each step is printed
   per class and over the group beside the JAX package's ``FleetGroup`` on a
   CPU (``GROUP_JAX_CPU``, from ``tests/torch_group_window.py``), whose
   means over steps 2-7 the card's must meet within ``WINDOW_BARS`` per
   class and overall. Prints each class's synchronized wall time per step
   and one profiled call of the solver's diff-drive Jacobians (forward-mode
   autodiff, ``dynamics_jacobians``).
5d. pointRobot path: bench.py's pointRobot extra (the port's
   ``bench._scenario_for``, ``FleetRunner`` defaults: the 1/8 rescue tier,
   the kick after 25 steps) at B=1024 for the bench's window, 38 graphed
   steps with their own launch counts, each printed beside the JAX package's
   on a CPU (``POINT_JAX_CPU``, from ``tests/torch_bench_window.py --robot
   pointRobot --jax-riccati pallas``): the means over steps 8-37 within
   ``WINDOW_BARS``, each step's kicked lanes within 3 of the JAX package's,
   every metric finite, converged lanes feasible to 1e-4 at every step, the
   structured kernel launched at B=1024 and 128.
5b. mobile panda path: the panda arm on a diff-drive base
   (``mobile_panda_setup``: nx = 22, nu = 9) as a fleet of 1024 lanes from
   seed 0 (``MOBILE_SAMPLER``, rescue tier at 1/8, no kick) for 6 steps,
   with their own launch counts: the general kernel must launch at B=1024
   and 128, every metric be finite, the last step's converged fraction >=
   0.9 and its converged lanes feasible to 1e-4. Prints each step's wall
   ms, converged fraction, goal distance, mean iterations and overflow
   beside the JAX package's on a CPU (``MOBILE_JAX_CPU``, from
   ``tests/torch_mobile_window.py``), whose means over steps 2-5 the card's
   must meet within ``WINDOW_BARS`` (0.005 converged, 1% iterations, 0.5%
   goal distance); then launches by batch size, its ``program_record``, and
   64 lanes of the last state solved on the card and on the CPU at phase
   9's bars.
5a. graph phase (``graph_phase``): each program captured whole as one CUDA
   graph, its loops conditional WHILE nodes (``ops/graph_cond.py``), held
   to the same units run eagerly (``units._eager``) from one state, bit for
   bit (else within 1e-6, flags equal), launches by (kernel, B) equal, no
   host read in a graphed call after the first, one replay a fleet step
   (three a group step) or a solve: the panda fleet at B=4096 for 6 steps,
   boxer, the mobile panda and the kick fleet (``kick_after`` = 2) at
   B=1024, the mixed group, both planners for 20 solves; per program its
   nodes, WHILE bodies, warm-up / capture / instantiate seconds, peak
   memory, step ms and ``program_record``; then the panda runner's
   ``export_step`` stepped by a child process without ``nvcc``.
5c. kick path: the fleet's local-minimum kick noise (``utils/prng.py``,
   ``jax.random``'s threefry draw) on the card equals the CPU's bit for bit
   (key, bits, uniforms, normals) at (4096, 20, 7) for steps 0 and 25 and
   ranks 0 and 1; one draw's device events and call time are printed. Then
   the bench's panda scenario (the port's ``bench._scenario_for``) at
   B=1024 with the default rescue tier and ``kick_after=2`` for 4 steps,
   eagerly (so that each step's unkicked shift can be read; phase 5a holds
   the graphed kick fleet to the eager one), read with its own launch
   counts: lanes are kicked, each kicked lane's noise (its warm start less
   the unkicked shift) is the CPU's draw for the
   same key within 1e-5, every number is finite, the last step's converged
   fraction >= 0.9 with converged lanes feasible to 1e-4, and the
   structured kernel launched at B=1024 and 128. Then the same for the
   bench's boxer scenario (``BOXER_KICK_STEPS`` = 15 steps, the first 12
   graphed, as its lanes are first kicked at step 12; the draw at the
   boxer's (1024, 10, 2) also held bit for bit), through the general kernel
   at B=1024 and 128.
6. planner path: the single-robot receding-horizon planner (``MPCPlanner``
   with ``KinematicSim``, ``FreeSpaceDecomposition``, ``GlobalPlanner``) on
   the card, each run read with its own launch counts (set to 0 before it):
   panda reaching a workspace goal (<= 150 solves, goal within 0.05 m),
   pointRobot around a sphere (<= 250 solves, goal within 0.15 m, clearance
   > -0.05 m) and boxer through lidar free-space half-planes (10 solves;
   the boxer example of phase 7 drives this path to its goal);
   every exit flag >= 0, the robot's Riccati kernel and the split
   expansion's ``fk_walk`` and ``gn_assemble`` launched, every launch at
   B=1. Prints per-solve wall ms (p50 /
   p90 / max of solves 2..., the first apart), launches per solve
   (``planner_launches``) and one solve each profiled eagerly. The first 10 solves
   of each run are repeated by a ``device="cpu"`` planner
   from the same observations, half-planes and warm starts: flags equal,
   actions within 1e-3 (2 x tol_stationarity where the two solves took a
   different number of inner iterations, see ``PLANNER_ATOL``), converged
   true costs within 1e-5 relative. ``solve_batch`` of 64 perturbed panda
   observations equals 64 B=1 solves (flags, z under the same bars). The
   global planner's obstacle enlargement on the card equals the CPU's on a
   seeded 128 x 128 map, and A* finds a path on it.
7. examples: the port's five examples (``robot_mpcs_tpu_torch.examples``:
   pointRobot, panda, boxer, boxer-global, supermarket) for their full
   episodes within the JAX examples' step limits (500 / 500 / 300 / 400 /
   500), through ``make_example`` and ``run`` as their command line runs
   them, each read with its own launch counts: each reaches its goal (the
   boxer example, whose arrival is chaotic in f32, from at least 4 of 7
   starts: its own and 6 offset by 1e-3, ``EXAMPLE_STARTS``) and launches
   its robot's kernel and the split expansion's two, only at B=1. Prints
   the step to the goal beside the JAX example's on a CPU, the exit-flag
   counts, per-solve p50 / p90, FSD ms per step (boxer), A* ms and
   waypoints (global, supermarket) and launches per solve.
8. deploy: ``make_solver`` exports the panda, boxer and mobile-panda
   artifacts with their kernel libraries (each compiled for its robot's
   shape); a fresh process with ``nvcc`` unreachable (not on
   ``PATH``, ``CUDA_HOME`` nowhere, ``_build.nvcc`` raising) loads each
   through ``MPCPlanner.from_solver_dir(..., device="cuda")``, builds nothing
   and solves the example's first step as this process does (within
   ``solve_bar``); a panda or boxer artifact with an altered
   ``export_meta.yaml`` is declined with a warning and its kernel rebuilt
   from the sources (within ``solve_bar`` again); each child's construction, first and second solve
   are timed. ``MpcRosLogic`` on ``ros_bridge/config/boxer_mpc_config.yaml``
   runs the 8 ticks of ``tests/test_ros_bridge.py`` on the card and ends
   with a forward velocity above 0.05.
9. reference: 64 lanes solved on the card and on the CPU (plain Riccati
   versions), for panda, for boxer and for the 6-dof chain (``chain6_setup``:
   the structured kernel at (12, 6, 0), launched at B=64 only): exit flags
   agree on >= 60 of 64, true costs of lanes both converge within 1e-4
   relative, converged violation <= 1e-4.
10. distributed: the panda fleet (B=4096, 1 step, no kick) over a
   ``torch.distributed`` process group. NCCL at world 1 (``mesh=make_mesh()``,
   the two metric all-reduces run) must equal the plain step: states within
   1e-6, metrics and exit flags equal. Two ranks on the one card, each its
   own process (this script with ``--dist-rank``; gloo over CUDA tensors,
   since NCCL refuses two ranks on one card), 2048 lanes each: both print
   the same metrics, each rank's shard equals a world-1 runner on its half
   (flags equal, states within 1e-6), launches per rank by batch size and
   each rank's step times (the ranks share one card and host: no scaling
   is read from them). The W=2 checkpoint loaded at W=1 equals the
   concatenated shards. The kernels were built in phase 2, so the ranks
   load the cached libraries. Then the kicked two-rank run of
   ``tests/torch_distributed_worker.py`` (``kick``: the pointRobot fleet at
   B=32, 16 lanes a rank, ``kick_after=2``, 5 eager steps; gloo, both ranks
   on the card): identical metrics on both ranks at every step, lanes of
   both ranks kicked, each rank's kicked lanes carrying the CPU's draw for
   (step, its rank) within 1e-5 and not the other rank's, no noise on lanes
   not kicked.
11. reference form, at a warm panda iterate of the rescue shape (B=512,
   the path phase's state): the stacked ``values`` expansion equals the
   split path's (every block within 1e-4 relative); the two solves' flags
   agree on >= 97% of lanes, converged lanes are feasible to 1e-4, true
   costs agree within 1e-5 relative where both converged in the same number
   of inner iterations (see ``hold_solves``), and the structured kernel
   launched. A pointRobot B=64 solve through the generic (``cost``/``ineq``
   only) path: cold on the card against the CPU (flags on >= B - 4 lanes,
   costs 1e-5), warm (after 2 fleet steps) against the values path (costs
   of lanes both converge within 1e-4, ``tests/test_solver.py``'s bar).
12. bench: ``python -m robot_mpcs_tpu_torch.bench`` in a child process at
   B=4096 (3 warm-up steps at most, 3 timed, both extras on: panda latency
   at B=1 and 64, pointRobot and boxer at B=1024), loading the kernels of
   phase 2: it exits 0; its last line carries the headline's and the
   extras' fields, every number finite, converged >= 0.9 and converged
   violation <= 1e-4; the structured kernel and the split expansion's two
   launched in the panda window and the general one in boxer's; ``nvcc``,
   wrapped by a logging script on
   the child's ``PATH``, was asked only ``--version`` (the cache key),
   never to compile. The enriched line is printed.

Output: the kernels JSON line (each kernel's ``launches`` from the panda
fleet, the general sweep's from the mobile panda fleet, and
``launches_by_path`` for every path that launched it, from the same
tallies for every kernel), then the card's ``name, power.limit`` line, then the result line
``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 4096
STEPS = 6
GROUP_STEPS = 8
GROUP_SIZES = {"pointRobot": 1024, "panda": 2048, "boxer": 1024}
#: the steps of the group whose means are held (steps 0 and 1 start cold)
GROUP_WINDOW = (2, 8)
#: the mobile panda's fleet (``mobile_panda_setup``): B lanes from seed 0,
#: the default rescue tier (1/8 width), no kick, bench.py's boxer-like
#: sampler (goals around the base, obstacles out of the way)
MOBILE_BATCH = 1024
MOBILE_STEPS = 6
MOBILE_SAMPLER = dict(goal_box=((-1.5, -1.5, 0.3), (1.5, 1.5, 1.0)),
                      obstacle_box=((4.0, 4.0, 0.2), (5.0, 5.0, 1.0)))
#: the JAX package's mobile-panda fleet of ``mobile_phase`` (the JAX draw of
#: the same scenario, the same runner) on a CPU, per step 0-5: printed by
#: ``tests/torch_mobile_window.py`` at B=1024 (JAX 0.9.0); the port on the
#: CPU agrees with it over steps 2-5 at the bars below
MOBILE_JAX_CPU = {
    "converged_fraction": (0.0, 0.0, 0.1171875, 0.2451171875, 0.46484375, 0.9755859375),
    "mean_iterations": (18.2373046875, 14.9833984375, 14.3876953125, 13.6943359375, 9.9375, 7.390625),
    "mean_goal_distance": (1.4329121112823486, 1.415941596031189, 1.3891513347625732, 1.353181004524231,
                           1.3085904121398926, 1.2562544345855713),
    "rescue_overflow_fraction": (0.875, 0.875, 0.8584070801734924, 0.8344113826751709, 0.7664233446121216, 0.0),
}
#: the steps whose means are held (steps 0 and 1 converge no lane), and the
#: bars on those means, absolute for the converged fraction and relative
#: otherwise (``tests/test_torch_mobile_window.py``, itself
#: ``tests/test_torch_bench_window.py``'s). Not widened for the card's f32
#: order: ``tests/test_torch_mobile_fleet.py`` shows two f32 orders (the JAX
#: package's and the port's, at B=64) flip no phase-1 exit flag and rescue
#: the same lanes at every step, so the card's order is held to the bars the
#: port on the CPU is held to
MOBILE_WINDOW = (2, 6)
#: (the bars of every window ``hold_window`` holds, not only the mobile panda's)
WINDOW_BARS = {"converged_fraction": 0.005, "mean_iterations": 0.01, "mean_goal_distance": 0.005}
#: the bench's pointRobot extra (``robot_mpcs_tpu_torch/bench.py``): the
#: class's scenario at POINT_BATCH lanes with the bench's runner (the
#: defaults: the 1/8 rescue tier, the kick after 25 steps without
#: improvement), for the bench's window: up to 8 warm-up steps, then 30
#: timed; the means over POINT_WINDOW are held at WINDOW_BARS, and each
#: step's kicked lanes within POINT_KICKED_BAR of the JAX package's count
POINT_BATCH = 1024
POINT_STEPS = 38
POINT_WINDOW = (8, 38)
POINT_KICKED_BAR = 3
#: the JAX package's pointRobot fleet of ``point_phase`` (the JAX draw of the
#: bench's scenario, the same runner) on a CPU, per step 0-37, its solver on
#: the Pallas kernel its fleet runs on its accelerator (interpret mode): printed
#: by ``tests/torch_bench_window.py --robot pointRobot --jax-riccati pallas``
#: at B=1024 (JAX 0.9.0); the port on the CPU agrees with it over steps 8-37
#: at the bars above
POINT_JAX_CPU = {
    "converged_fraction": (1.0,) * 38,
    "mean_iterations": (5.4833984375, 3.7314453125, 3.580078125, 3.3134765625, 3.103515625, 2.90234375,
                        2.607421875, 2.439453125, 2.5927734375, 2.5947265625, 2.6259765625, 2.6337890625,
                        2.6630859375, 2.6435546875, 2.634765625, 2.6455078125, 2.65625, 2.6220703125,
                        2.6064453125, 2.6328125, 2.62109375, 2.595703125, 2.5966796875, 2.568359375,
                        2.5517578125, 2.564453125, 2.552734375, 2.5556640625, 2.541015625, 2.5322265625,
                        2.5107421875, 2.51171875, 2.5224609375, 2.50390625, 2.494140625, 2.505859375,
                        2.5107421875, 2.4697265625),
    "mean_goal_distance": (1.6849247217178345, 1.6682515144348145, 1.6416419744491577, 1.606092095375061,
                           1.5625823736190796, 1.512068510055542, 1.4554803371429443, 1.393713116645813,
                           1.3276267051696777, 1.258042335510254, 1.185739278793335, 1.1114537715911865,
                           1.0358771085739136, 0.9596551060676575, 0.8833885192871094, 0.8076331615447998,
                           0.7329022884368896, 0.65966796875, 0.5883637070655823, 0.5193890333175659,
                           0.45311328768730164, 0.3898846209049225, 0.33004555106163025, 0.27396926283836365,
                           0.22211696207523346, 0.17508386075496674, 0.1340414583683014, 0.10204172134399414,
                           0.09666943550109863, 0.11947853863239288, 0.14418242871761322, 0.16808642446994781,
                           0.1903112530708313, 0.21045762300491333, 0.22832946479320526, 0.24384300410747528,
                           0.25698423385620117, 0.2677866220474243),
    "rescue_overflow_fraction": (0.0,) * 38,
    # one lane kicked at steps 25 and 37
    "kicked": (0,) * 25 + (1,) + (0,) * 11 + (1,),
}
#: the JAX package's ``FleetGroup`` of ``group_phase`` (GROUP_SIZES, the JAX
#: draw of ``mixed_fleet_scenarios(seed=0)``, the default runner) on a CPU,
#: per class and over the group, per step 0-7, its solvers on the Pallas
#: kernels (interpret mode): printed by ``tests/torch_group_window.py`` (JAX
#: 0.9.0); the means over GROUP_WINDOW are held at WINDOW_BARS. The Pallas
#: path, not the CPU's stage scan, because the port's CUDA kernels are its
#: kernels' ports and the reference's own two paths differ by 0.90% in the
#: panda's mean iterations over steps 2-7 (8.1602 with the scan), near the 1% bar
GROUP_JAX_CPU = {
    "pointRobot": {
        "converged_fraction": (1.0,) * 8,
        "mean_iterations": (5.4833984375, 3.7314453125, 3.580078125, 3.3134765625,
                            3.103515625, 2.90234375, 2.607421875, 2.439453125),
        "mean_goal_distance": (1.6849247217178345, 1.6682515144348145, 1.6416419744491577, 1.606092095375061,
                               1.5625823736190796, 1.512068510055542, 1.4554803371429443, 1.393713116645813),
        "rescue_overflow_fraction": (0.0,) * 8,
    },
    "panda": {
        "converged_fraction": (0.87158203125, 0.99609375, 0.9990234375, 0.998046875,
                               0.99951171875, 0.9970703125, 0.99560546875, 0.99267578125),
        "mean_iterations": (12.78515625, 9.40234375, 8.8271484375, 8.431640625,
                            8.0458984375, 7.9326171875, 7.95361328125, 8.208984375),
        "mean_goal_distance": (0.6279032230377197, 0.6228806972503662, 0.6149303317070007, 0.6043643951416016,
                               0.5914586782455444, 0.57646644115448, 0.5596300959587097, 0.54119473695755),
        "rescue_overflow_fraction": (0.5009746551513672, 0.0, 0.0, 0.0,
                                     0.0, 0.0, 0.0, 0.0),
    },
    "boxer": {
        "converged_fraction": (0.439453125, 0.7529296875, 0.9892578125, 0.9990234375,
                               1.0, 1.0, 1.0, 1.0),
        "mean_iterations": (16.791015625, 13.076171875, 10.3212890625, 7.49609375,
                            7.1318359375, 7.2529296875, 7.4521484375, 7.576171875),
        "mean_goal_distance": (1.679547667503357, 1.5891116857528687, 1.4522720575332642, 1.280713677406311,
                               1.0875405073165894, 0.8865941762924194, 0.6911067962646484, 0.5121190547943115),
        "rescue_overflow_fraction": (0.8142235279083252, 0.6512261629104614, 0.0, 0.0,
                                     0.0, 0.0, 0.0, 0.0),
    },
    "overall": {
        "converged_fraction": (0.795654296875, 0.936279296875, 0.996826171875, 0.998779296875,
                               0.999755859375, 0.99853515625, 0.997802734375, 0.996337890625),
        "mean_iterations": (11.961181640625, 8.903076171875, 7.888916015625, 6.918212890625,
                            6.581787109375, 6.505126953125, 6.49169921875, 6.6083984375),
        "mean_goal_distance": (1.1550697088241577, 1.1257811784744263, 1.0809437036514282, 1.023883581161499,
                               0.9582600593566895, 0.8878989219665527, 0.8164618015289307, 0.7470554113388062),
        "rescue_overflow_fraction": (0.4540432095527649, 0.16280654072761536, 0.0, 0.0,
                                     0.0, 0.0, 0.0, 0.0),
    },
}
#: the kick fleet: the bench's panda scenario at B lanes with the default
#: rescue tier and the kick after KICK_AFTER steps without improvement, so
#: that lanes are kicked within its steps; the card's draw is held to the
#: CPU's at KICK_DRAW for these (step, rank)
KICK_BATCH = 1024
KICK_STEPS = 4
KICK_AFTER = 2
KICK_DRAW = (4096, 20, 7)
KICK_KEYS = ((0, 0), (0, 1), (25, 0), (25, 1))
#: the boxer kick fleet: bench.py's boxer scenario at KICK_BATCH lanes, the
#: same runner. A boxer lane drives straight at its goal and improves at every
#: step until it parks, so the JAX fleet on the CPU first kicks lanes at step
#: 12 (3 lanes), then 45, 127, 91 at steps 13-15 (``tests/test_torch_boxer_kick.py``
#: shows the same from step 13 at B=64): steps 0-11 run graphed, 12-14 eagerly,
#: where the noise is held to the CPU's draw. Its draw is (B, N, nz - nx) =
#: (1024, 10, 2), held bit for bit at (step 12, rank 0)
BOXER_KICK_STEPS = 15
BOXER_KICK_EAGER_FROM = 12
BOXER_KICK_KEY = (12, 0, (KICK_BATCH, 10, 2))


def sampler(name):
    """The benchmark's scenario sampler of one problem class (``CLASS_SPECS``
    of ``robot_mpcs_tpu_torch/bench.py``; the weights are in the config dicts)."""
    from robot_mpcs_tpu_torch.bench import CLASS_SPECS

    return CLASS_SPECS[name]["sampler"]
#: the device kernels of a panda fleet step, by the names ``torch.profiler``
#: sees
EXPANSION_KERNELS = ["riccati_packed_kernel", "fk_walk_kernel", "gn_assemble_kernel"]
#: the shapes the main paths launch the structured kernel at, (B, N, n, ns):
#: each fleet's phase 1 at full width and its rescue tier at 1/8 width, the
#: single-robot planner's B=1 (also the bench's B=1 latency) and the bench's
#: B=64 latency fleet with its rescue tier
PACKED_SHAPES = {
    "panda phase 1": (BATCH, 20, 7, 0),
    "panda planner": (1, 20, 7, 0),
    "pointRobot planner": (1, 20, 3, 0),
    "panda rescue": (BATCH // 8, 20, 7, 0),
    "group panda phase 1": (GROUP_SIZES["panda"], 20, 7, 0),
    "group panda rescue": (GROUP_SIZES["panda"] // 8, 20, 7, 0),
    "group pointRobot phase 1": (GROUP_SIZES["pointRobot"], 20, 3, 0),
    "group pointRobot rescue": (GROUP_SIZES["pointRobot"] // 8, 20, 3, 0),
    "bench panda B=64": (64, 20, 7, 0),
    "bench panda B=64 rescue": (8, 20, 7, 0),
    # any holonomic shape: 2, 6 and 15 dof, with and without slack;
    # the 6-dof chain's 64-lane solve; 17 dof, past the old one-thread-per-
    # column cap (1 + nx = 35 columns on a 32-thread team)
    "holonomic n=2": (1024, 20, 2, 0),
    "holonomic n=2 slack": (1024, 20, 2, 1),
    "holonomic n=6": (1024, 20, 6, 0),
    "holonomic n=6 slack": (1024, 20, 6, 1),
    "holonomic n=15": (1024, 20, 15, 0),
    "holonomic n=15 slack": (1024, 20, 15, 1),
    "6-dof chain B=64": (64, 20, 6, 0),
    "holonomic n=17 slack": (128, 20, 17, 1),
    # the kick fleet's phase 1 and rescue tier
    "kick fleet phase 1": (KICK_BATCH, 20, 7, 0),
    "kick fleet rescue": (KICK_BATCH // 8, 20, 7, 0),
}
#: ... and the general kernel, (B, N, nx, nw, per-lane A/B): boxer's phase 1,
#: its planner (B=1) and rescue tier, then boxer at B=4096 with per-lane and batch-constant
#: A/B, and (14, 7) with per-lane A/B (no robot model runs it); the mobile
#: panda (22, 9) and with slack (22, 10) at its fleet's phase 1 and rescue
#: tier and a planner's B=1, per lane and batch-constant; (36, 16), a 14-dof
#: arm on a diff-drive base, past the old one-thread-per-column cap
GENERAL_SHAPES = {
    "group boxer phase 1": (GROUP_SIZES["boxer"], 10, 8, 2, True),
    "boxer planner": (1, 10, 8, 2, True),
    "group boxer rescue": (GROUP_SIZES["boxer"] // 8, 10, 8, 2, True),
    "boxer B=4096": (BATCH, 10, 8, 2, True),
    "boxer B=4096 batch-constant": (BATCH, 10, 8, 2, False),
    "(14, 7) B=4096": (BATCH, 20, 14, 7, True),
    **{f"mobile panda{' slack' if nw == 10 else ''} {where}{'' if per_lane else ' batch-constant'}":
       (B, 20, 22, nw, per_lane)
       for nw in (9, 10) for per_lane in (True, False)
       for where, B in (("phase 1", MOBILE_BATCH), ("rescue", MOBILE_BATCH // 8), ("B=1", 1))},
    "(36, 16) B=128": (128, 20, 36, 16, True),
    "(36, 16) B=128 batch-constant": (128, 20, 36, 16, False),
}
#: the kernel-phase test dims beside the main paths' shapes: structured
#: (n, ns), general (nx, nw)
TEST_PACKED, TEST_GENERAL = ((3, 0), (3, 1), (7, 1)), ((6, 3), (14, 7), (8, 3), (8, 2))
#: a shape of which not one lane fits a block's 227 KB: a 31-dof arm on a
#: diff-drive base with slack (nx = 70, nw = 34)
OVERSIZED = (70, 34)
RTOL, ATOL = 2e-3, 2e-5
GEN_RTOL, GEN_ATOL = 2e-3, 2e-4
#: H100 SXM datasheet peaks: HBM bytes/s, fp32 flop/s
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


class SmokeFailure(RuntimeError):
    pass


def mobile_panda_setup():
    """The panda arm on a diff-drive base: ``examples/config/pandaMpc.yaml``
    (``panda_setup()`` with the file's ``wconstr``) with ``robot.base_type:
    diffdrive``, ``mpc.n: 10`` and nine ``wvel`` weights. x = [x, y, theta,
    q_arm (7), their rates, v, omega]: nx = 22, nu = 9, the general sweep
    at (22, 9) with per-lane A/B."""
    from robot_mpcs_tpu_torch.config import panda_setup

    d = panda_setup()
    d["mpc"]["weights"].update(wconstr=[0.5, 0.0, 0.0, 0.0], wvel=[1.0] * 9)
    d["mpc"]["n"] = 10
    d["robot"]["base_type"] = "diffdrive"
    return d


def chain6_setup():
    """A 6-dof holonomic chain: ``panda_setup()`` cut at ``panda_link6``,
    collision links 3 and 5, the self-collision pair (3, 6). nx = 12, nu =
    6: the structured sweep at (12, 6, 0)."""
    from robot_mpcs_tpu_torch.config import panda_setup

    d = panda_setup()
    d["mpc"]["n"] = 6
    d["mpc"]["weights"]["wvel"] = [1.0] * 6
    d["robot"].update(end_link="panda_link6", collision_links=["panda_link3", "panda_link5"],
                      selfCollision={"pairs": [["panda_link3", "panda_link6"]]})
    return d


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def random_sweep_inputs(B, N, nx, nw, seed=0):
    """Random SPD stage data (tests/test_riccati_packed.py:34-46)."""
    rng = np.random.default_rng(seed)

    def spd(sz, scale):
        M = rng.normal(size=(B, N, sz, sz)).astype(np.float32)
        return scale * (M @ M.transpose(0, 1, 3, 2)) + np.eye(sz, dtype=np.float32)

    lx = rng.normal(size=(B, N, nx)).astype(np.float32)
    lw = rng.normal(size=(B, N, nw)).astype(np.float32)
    lxx, lww = spd(nx, 0.1), spd(nw, 0.1)
    lxw = 0.1 * rng.normal(size=(B, N, nx, nw)).astype(np.float32)
    reg = np.full((B,), 1e-6, np.float32)
    return lx, lw, lxx, lxw, lww, reg


def random_general_inputs(B, N, nx, nw, batched_dyn=True, seed=0):
    """Random LQR data with dynamics Jacobians (tests/test_riccati_pallas.py:18-37):
    ``(lx, lw, lxx, lxw, lww, A, Bm, reg)``, A/Bm per lane or, with
    ``batched_dyn=False``, one (N, ...) block for the batch; stage N-1 has
    A = B = 0."""
    lx, lw, lxx, lxw, lww, reg = random_sweep_inputs(B, N, nx, nw, seed)
    rng = np.random.default_rng(seed + 1)
    lead = (B, N) if batched_dyn else (N,)
    A = np.eye(nx, dtype=np.float32) + 0.05 * rng.normal(size=lead + (nx, nx)).astype(np.float32)
    Bm = 0.1 * rng.normal(size=lead + (nx, nw)).astype(np.float32)
    A[..., -1, :, :] = 0.0
    Bm[..., -1, :, :] = 0.0
    return lx, lw, lxx, lxw, lww, A, Bm, reg


def sweep_bound(B, N, nx, nw, dyn):
    """(bound_ms, bound_by) of one Riccati sweep: each input read once, each
    output written once, against the flops of the kernel's arithmetic.
    ``dyn``: "packed" (A/B baked in), "batched" (per-lane A/B) or "constant"
    (one (N, ...) A/B block)."""
    words = nx + nw + nx * nx + nx * nw + nw * nw + nw + nw * nx  # stage in + gains out
    m = 1 + nx
    solve = 2 * nw ** 3 // 3 + 2 * nw * nw * m
    if dyn == "packed":
        n = nx // 2
        flops = 3 * nx * nx + 5 * nx * n + 3 * n * n + solve + nx * (nx + 1) * nw + 2 * nx * nw
    else:
        words += (nx * nx + nx * nw) if dyn == "batched" else 0
        flops = (
            4 * nx ** 3 + 4 * nx * nx * nw + 2 * nx * nw * nw + 2 * nx * nx + 2 * nx * nw
            + solve + 2 * nw * nw * m + 6 * nx * nw + 6 * nw * nx * (nx + 1)
        )
    nbytes = 4 * B * N * words + 5 * B
    if dyn == "constant":
        nbytes += 4 * N * (nx * nx + nx * nw)
    t_bytes, t_ops = nbytes / HBM_BPS, B * N * flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_device_ms(torch, fn, kernel_name, reps=20, windows=3):
    """Device time of one launch of the kernel whose name contains
    ``kernel_name``: its CUDA time summed by ``torch.profiler`` over ``reps``
    calls of ``fn``, over ``reps``. Unlike CUDA events around a call, this
    leaves out the host's launch path, which a kernel of tens of
    microseconds is shorter than. A window in which the profiler recorded
    no event of the kernel (no device event at all, seen once in ~400
    windows on an H100, or other events but none of the kernel's, seen once
    in ~100) is taken again, up to ``windows`` times."""
    fn()
    for _ in range(windows):
        _, total = profile_windows(torch, {kernel_name: lambda: [fn() for _ in range(reps)]}, [kernel_name])
        if total[f"{kernel_name}_ms"] > 0:
            break
    ms = total[f"{kernel_name}_ms"] / reps
    check(ms > 0, f"the profiler saw no {kernel_name} launches")
    return ms


def time_ms(fn, torch, reps=20, warmup=3):
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_kernel_shapes(torch, rp, rb, plain=True):
    """Each kernel at each of its main-path shapes (``PACKED_SHAPES``,
    ``GENERAL_SHAPES``): held against its plain version on the same CUDA
    tensors (rtol 2e-3, atol 2e-5 structured / 2e-4 general), then timed:
    ``ms`` device time per launch (``torch.profiler``, 20 launches),
    ``call_ms`` CUDA events around one wrapper call, ``plain_ms`` the plain
    version (median of 5 calls; skipped with ``plain=False``), ``bound_ms`` from
    ``sweep_bound``, ``digest`` of the sweep's outputs on these seeded
    inputs. Prints and returns one record per shape."""
    a, b1, b2 = 0.05, 0.00125, 0.05  # panda's dt = 0.05 double integrator

    def cases():  # (module, label, inputs, keywords, dynamics), inputs made one shape at a time
        for label, (B, N, n, ns) in PACKED_SHAPES.items():
            yield (rp, label, random_sweep_inputs(B, N, 2 * n, ns + n, seed=1),
                   dict(N=N, nx=2 * n, nw=ns + n, ns=ns, a=a, b1=b1, b2=b2), "packed")
        for label, (B, N, nx, nw, per_lane) in GENERAL_SHAPES.items():
            yield (rb, label, random_general_inputs(B, N, nx, nw, per_lane, seed=1),
                   dict(N=N, nx=nx, nw=nw), "batched" if per_lane else "constant")

    records = []
    for module, label, arrays, kw, dyn in cases():
        name = "riccati_backward_packed" if module is rp else "riccati_backward_batched"
        sweep, reference = getattr(module, name), getattr(module, f"{name}_reference")
        kernel, atol = ("riccati_packed_kernel", ATOL) if module is rp else ("riccati_batched_kernel", GEN_ATOL)
        args = [torch.as_tensor(v, device="cuda") for v in arrays]
        B = args[0].shape[0]
        k, K, f = sweep(*args, **kw)
        k_ref, K_ref, f_ref = reference(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((k - k_ref).abs().max()), float((K - K_ref).abs().max()))
        check(torch.allclose(k, k_ref, rtol=RTOL, atol=atol) and torch.allclose(K, K_ref, rtol=RTOL, atol=atol),
              f"{name} differs from its plain version at {label}, B={B}: max abs err {err:.3e}")
        check(not bool(f.any()) and not bool(f_ref.any()), f"{name}: spurious failed lanes at {label}")
        call = lambda: sweep(*args, **kw)  # noqa: E731
        bound_ms, bound_by = sweep_bound(B, kw["N"], kw["nx"], kw["nw"], dyn)
        rec = {
            "kernel": name, "shape": label, "B": B, "N": kw["N"], "nx": kw["nx"], "nw": kw["nw"],
            "dyn": dyn, "max_abs_err": err, "digest": digest((k, K, f)), "ms": kernel_device_ms(torch, call, kernel),
            "call_ms": time_ms(call, torch),
            "plain_ms": time_ms(lambda: reference(*args, **kw), torch, reps=5, warmup=1) if plain else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(json.dumps({"kernel_shape": rec}), flush=True)
        records.append(rec)
    return records


def kernel_pairs():
    """Every (stem, shape) the smoke launches: the main paths' shapes
    (``PACKED_SHAPES``, ``GENERAL_SHAPES``, which hold every robot's) and
    the kernel phases' test dims, the split expansion's kernels of every
    problem it solves (``expansion_pairs``), and the library of the solver
    graphs' WHILE nodes (``csrc/graph_cond.cu``, no shape)."""
    packed = {(2 * n, n + ns, ns) for n, ns in TEST_PACKED}
    packed |= {(2 * n, n + ns, ns) for _, _, n, ns in PACKED_SHAPES.values()}
    general = set(TEST_GENERAL) | {(nx, nw) for _, _, nx, nw, _ in GENERAL_SHAPES.values()}
    return ([("riccati_packed", s) for s in sorted(packed)] + [("riccati_batched", s) for s in sorted(general)]
            + sorted(expansion_pairs()) + [("graph_cond", ())])


def build_phase():
    """Compile every kernel shape the smoke runs at once (one nvcc each, in
    parallel) and print what ``-Xptxas -v`` says about each: registers,
    spills, shared memory."""
    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.ops.fk_walk import WalkTable

    t0 = time.perf_counter()
    results = _build.build_libraries(kernel_pairs())
    print(f"kernel build ({len(results)} shapes, parallel): {time.perf_counter() - t0:.1f} s", flush=True)
    for (stem, shape), (path, log) in results.items():
        if stem == "fk_walk":  # its shape is its chain's defines: name the chain's size
            t = WalkTable(0, 0, shape[0])
            shape = "(n, nodes, links, diffdrive) = " + str(tuple(
                t.define(k) for k in ("FK_N", "FK_S", "FK_L", "FK_DIFFDRIVE")))
        print(f"{stem} {shape}: {path.name}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)


def kernel_record(name, source, replaces, shapes, label):
    """The kernels-line entry of one kernel: its numbers at ``label`` (the
    phase-1 shape), its largest error over every shape it was compared at."""
    rec = next(r for r in shapes if r["kernel"] == name and r["shape"] == label)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in shapes if r["kernel"] == name),
        "ms": rec["ms"],
        "kernel_ms": rec["ms"],
        "call_ms": rec["call_ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a sweep, the walk or the assembly
        # the assembly's entries span ten decades (curvatures up to 2w / b^3):
        # its largest error over each entry's own term scale (``gn_excess``)
        **({"max_rel_err": max(r["max_rel_err"] for r in shapes if r["kernel"] == name)}
           if name == "gn_assemble" else {}),
    }


def packed_kernel_phase(torch, rp, shapes):
    """The structured Riccati kernel at the test dims and with a slack column
    (the main path's shapes are compared in ``time_kernel_shapes``) and its
    NaN-lane contract; returns its kernels-line record."""
    a, b1, b2 = 0.05, 0.00125, 0.05  # panda's dt = 0.05 double integrator
    for n, ns, N, B in ((3, 0, 6, 5), (3, 1, 5, 5), (7, 1, 20, 64)):
        nx, nw = 2 * n, ns + n
        args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(B, N, nx, nw)]
        kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=a, b1=b1, b2=b2)
        k, K, f = rp.riccati_backward_packed(*args, **kw)
        k_ref, K_ref, f_ref = rp.riccati_backward_packed_reference(*args, **kw)
        torch.cuda.synchronize()
        for name, got, want in (("k_ff", k, k_ref), ("K", K, K_ref)):
            err = float((got - want).abs().max())
            check(
                torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                f"packed kernel {name} differs from the plain version at dims {(n, ns, N)}, "
                f"B={B}: max abs err {err:.3e}",
            )
        check(not bool(f.any()) and not bool(f_ref.any()), f"spurious failed lanes at {(n, ns, N)}")
        print(f"packed kernel vs plain at (n, ns, N, B)={(n, ns, N, B)}: max abs err "
              f"k_ff {float((k - k_ref).abs().max()):.3e}, K {float((K - K_ref).abs().max()):.3e}",
              flush=True)
    # NaN-poisoned lane: only that lane fails, healthy lanes stay finite
    args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(4, 4, 6, 3, seed=3)]
    args[2][2, 1] = float("nan")
    k, K, f = rp.riccati_backward_packed(*args, N=4, nx=6, nw=3, ns=0, a=0.1, b1=0.005, b2=0.1)
    check(f.tolist() == [False, False, True, False], f"NaN lane contract: failed = {f.tolist()}")
    check(bool(torch.isfinite(k[[0, 1, 3]]).all()), "NaN lane leaked into healthy lanes")
    print("packed NaN-lane contract: only lane 2 failed", flush=True)
    return kernel_record("riccati_backward_packed", "robot_mpcs_tpu_torch/csrc/riccati_packed.cu",
                         "robot_mpcs_tpu/ops/riccati_packed.py:238", shapes, "panda phase 1")


def batched_kernel_phase(torch, rb, shapes):
    """The general Riccati kernel at the test dims and with a slack column
    (the main path's shapes are compared in ``time_kernel_shapes``), its
    bad-lane contracts and the refusal of a shape whose lane does not fit
    (``OVERSIZED``); returns its kernels-line record."""
    for nx, nw, N, B in ((6, 3, 5, 5), (14, 7, 20, 64), (8, 3, 10, 64)):
        args = [torch.as_tensor(v, device="cuda") for v in random_general_inputs(B, N, nx, nw)]
        kw = dict(N=N, nx=nx, nw=nw)
        k, K, f = rb.riccati_backward_batched(*args, **kw)
        k_ref, K_ref, f_ref = rb.riccati_backward_batched_reference(*args, **kw)
        torch.cuda.synchronize()
        for name, got, want in (("k_ff", k, k_ref), ("K", K, K_ref)):
            err = float((got - want).abs().max())
            check(
                torch.allclose(got, want, rtol=GEN_RTOL, atol=GEN_ATOL),
                f"general kernel {name} differs from the plain version at "
                f"(nx, nw, N, B)={(nx, nw, N, B)}: max abs err {err:.3e}",
            )
        check(not bool(f.any()) and not bool(f_ref.any()),
              f"spurious failed lanes at {(nx, nw, N, B)}")
        print(f"general kernel vs plain at (nx, nw, N, B)={(nx, nw, N, B)}, per-lane A/B: max abs err "
              f"k_ff {float((k - k_ref).abs().max()):.3e}, K {float((K - K_ref).abs().max()):.3e}",
              flush=True)
    # a negative-definite lww lane fails alone with zero gains; so does a NaN lane
    for bad_lane, poison in ((1, "negdef"), (2, "nan")):
        args = [torch.as_tensor(v, device="cuda") for v in random_general_inputs(4, 4, 8, 2, seed=5)]
        if poison == "negdef":
            args[4][bad_lane] = -10.0 * torch.eye(2, device="cuda")
        else:
            args[2][bad_lane, 1] = float("nan")
        k, K, f = rb.riccati_backward_batched(*args, N=4, nx=8, nw=2)
        want = [i == bad_lane for i in range(4)]
        check(f.tolist() == want, f"general {poison} lane contract: failed = {f.tolist()}")
        good = [i for i in range(4) if i != bad_lane]
        check(bool(torch.isfinite(k[good]).all() and torch.isfinite(K[good]).all()),
              f"{poison} lane leaked into healthy lanes")
        if poison == "negdef":
            check(bool((k[bad_lane] == 0).all() and (K[bad_lane] == 0).all()),
                  "negative-definite lane has non-zero gains")
        print(f"general {poison}-lane contract: only lane {bad_lane} failed", flush=True)
    # a shape of which one lane does not fit a block raises, naming the
    # scan, before anything is built or launched
    nx, nw = OVERSIZED
    wide = [torch.as_tensor(v, device="cuda") for v in random_general_inputs(2, 2, nx, nw)]
    before = rb.riccati_backward_batched.launches
    try:
        rb.riccati_backward_batched(*wide, N=2, nx=nx, nw=nw)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and 'riccati_backend="scan"' in raised and "bytes" in raised,
          f"the oversized shape {OVERSIZED} did not raise naming the scan: {raised}")
    check(rb.riccati_backward_batched.launches == before, "the oversized shape launched")
    print(f"oversized general shape {OVERSIZED} refused: {raised}", flush=True)
    return kernel_record("riccati_backward_batched", "robot_mpcs_tpu_torch/csrc/riccati_batched.cu",
                         "robot_mpcs_tpu/ops/riccati_pallas.py:189", shapes, "mobile panda phase 1")


#: the split expansion's kernels (``ops/fk_walk.py``, ``ops/gn_assemble.py``):
#: the robot of each main path and the batch it solves at, over the robot's
#: horizon: each fleet's phase 1 and 1/8 rescue tier, alone and in the
#: group, and the planner's B=1
EXPANSION_SHAPES = {
    "panda phase 1": ("panda", BATCH),
    "panda rescue": ("panda", BATCH // 8),
    "panda planner": ("panda", 1),
    "group panda phase 1": ("panda", GROUP_SIZES["panda"]),
    "group panda rescue": ("panda", GROUP_SIZES["panda"] // 8),
    "group pointRobot phase 1": ("pointRobot", GROUP_SIZES["pointRobot"]),
    "group pointRobot rescue": ("pointRobot", GROUP_SIZES["pointRobot"] // 8),
    "group boxer phase 1": ("boxer", GROUP_SIZES["boxer"]),
    "group boxer rescue": ("boxer", GROUP_SIZES["boxer"] // 8),
    "mobile panda phase 1": ("mobilePanda", MOBILE_BATCH),
    "mobile panda rescue": ("mobilePanda", MOBILE_BATCH // 8),
}
#: ... and the shapes the FK walk is also timed at without the Jacobian
#: (the line search's and the multiplier update's rows, the goal distance:
#: at the panda's rescue tier most of the walk's launches)
FK_POSITION_SHAPES = ("panda phase 1", "panda rescue", "group panda rescue", "mobile panda phase 1")
#: the tolerances of the expansion's kernels against their plain versions:
#: the walk 1e-5 absolute on P and J (f32, one sin/cos pair per joint); the
#: assembly 1e-4 of each entry's own term scale (``gn_excess``: row sums in
#: another order)
FK_ATOL, GN_RTOL = 1e-5, 1e-4


def robot_setup(robot):
    """The setup dict of a robot the smoke runs: the bench's three classes,
    the mobile panda and the 6-dof chain."""
    from robot_mpcs_tpu_torch.config import boxer_setup, panda_setup, point_robot_setup

    return {"panda": panda_setup, "pointRobot": point_robot_setup, "boxer": boxer_setup,
            "mobilePanda": mobile_panda_setup, "chain6": chain6_setup}[robot]()


def expansion_pairs():
    """The split expansion's (stem, shape) of every problem the smoke solves
    (``utils/aot.expansion_kernels``): the five robots, the example configs
    and the ROS node's."""
    from robot_mpcs_tpu_torch.config import Setup, load_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.utils import aot

    root = os.path.dirname(os.path.abspath(__file__))
    setups = [Setup.from_dict(robot_setup(r)) for r in ("panda", "pointRobot", "boxer", "mobilePanda", "chain6")]
    setups += [load_setup(os.path.join(root, "examples", "config", f"{k}Mpc.yaml"))
               for k in ("panda", "pointRobot", "boxer")]
    setups.append(load_setup(os.path.join(root, "ros_bridge", "config", "boxer_mpc_config.yaml")))
    return {pair for s in setups for pair in aot.expansion_kernels(MpcProblem(s))}


def random_gn_inputs(problem, B, N, seed=0, near_clamp=False):
    """Inputs of a split expansion's assembly at (B, N), as numpy arrays:
    ``(vq, Jq, va, wrq, wbq, wra, wba, lam, mu, W)`` and the stage-0 pins'
    offsets ``c_off (N, n_con)`` the solver adds. Random rows and q
    Jacobian, weights from 1e-2 to 1e1, about a third of the multipliers
    non-zero, penalties from 1e1 to 1e5 over the lanes, about a fifth of the
    barrier rows dead (at or below ``BARRIER_EPS``) and the rest live from
    0.02 to 0.5, or, with ``near_clamp``, live just above the clamp (up to
    3 x ``BARRIER_EPS``), where a row's curvature 2w/b^3 reaches ~1e10 and
    outweighs every other term of the entries it feeds."""
    from robot_mpcs_tpu_torch.models.components import BARRIER_EPS
    from robot_mpcs_tpu_torch.solver.al_ilqr import split_pinned_rows

    split = problem.split_callbacks()
    d = problem.dims
    qr, qb, qc = split["q_seg"]
    ar, ab, ac = split["aff_seg"]
    n_con = qc + ac
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=(B, N) + shape)).astype(np.float32)

    def barriers(k):
        low, high = (BARRIER_EPS, 3 * BARRIER_EPS) if near_clamp else (0.02, 0.5)
        live = rng.uniform(low, high, (B, N, k))
        return np.where(rng.random((B, N, k)) < 0.2, rng.uniform(-0.01, BARRIER_EPS, (B, N, k)), live)

    vq, Jq, va = normal(qr + qb + qc), normal(qr + qb + qc, split["n_q"]), normal(ar + ab + ac)
    vq[..., qr:qr + qb] = barriers(qb)
    va[..., ar:ar + ab] = barriers(ab)
    weights = [(10.0 ** rng.uniform(-2, 1, size=(B, N, k))).astype(np.float32) for k in (qr, qb, ar, ab)]
    lam = (np.abs(rng.normal(size=(B, N, n_con))) * (rng.random((B, N, n_con)) < 0.3)).astype(np.float32)
    mu = (10.0 ** rng.uniform(1, 5, size=(B,))).astype(np.float32)
    W = normal(d.nu + d.ns, scale=0.3)
    c_off = np.zeros((N, n_con), np.float32)
    c_off[0, split_pinned_rows(split["q_seg"], split["aff_seg"], split["S_aff"], d.nx, d.ns)] = 1e6
    return (vq, Jq, va, *weights, lam, mu, W), c_off


def gn_excess(got, want, scale, rtol=GN_RTOL):
    """The largest ``|got - want| / (rtol x scale)`` over the entries of the
    five blocks, ``scale`` the entry's own term scale
    (``ops.gn_assemble.gn_term_scale`` on the same inputs): at most 1 passes.
    An entry with no terms must be equal; a NaN counts as inf."""
    import torch

    worst = 0.0
    for g, w, s in zip(got, want, scale):
        diff = (g.double() - w.double()).abs()
        ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / (rtol * s.double()))
        if ratio.numel():
            worst = max(worst, float(torch.nan_to_num(ratio, nan=float("inf")).max()))
    return worst


def gn_layout(problem, c_off):
    """The problem's ``GnLayout`` with ``c_off`` (a tensor) as its pins."""
    from robot_mpcs_tpu_torch.ops.gn_assemble import GnLayout

    split = problem.split_callbacks()
    d = problem.dims
    return GnLayout(split["q_seg"], split["aff_seg"], split["S_aff"], nx=d.nx, ns=d.ns, n_q=split["n_q"],
                    c_off=c_off)


def fk_bound(M, table, want_jac):
    """(bound_ms, bound_by) of one FK walk over ``M`` rows: q read once, P
    (and J) written once, against the walk's flops counted from its chain
    without the folds (each node's transform 72, a joint's axis 15, a
    revolute joint's Rodrigues product and sin/cos 80; per link and column
    a cross product, 9)."""
    kinds = [int(v) for v in table.define("FK_NODE")[3::3]][: table.define("FK_S")]
    n, L = table.n, table.n_links
    flops = sum(72 + (15 if k else 0) + (80 if k == 1 else 0) for k in kinds) + (9 * L * n if want_jac else 0)
    nbytes = 4 * M * (n + 3 * L + (3 * L * n if want_jac else 0))
    t_bytes, t_ops = nbytes / HBM_BPS, M * flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def digest(tensors):
    """sha256 (first 16 hex digits) of the bytes of ``tensors`` (None
    skipped), read to the host: equal digests, equal outputs bit for bit."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def gn_bound(B, N, layout):
    """(bound_ms, bound_by) of one assembly at (B, N): each input read once
    (rows, q Jacobian, weights, multipliers, the slack column, the lanes'
    penalties, the pins), the five blocks written once, against its flops
    (per row ~10 for its coefficients; per entry the q rows' products for
    i, j < n_q, the slack column's and the CSR tables' terms)."""
    qr, qb, qc = layout.q_seg
    ar, ab, ac = layout.aff_seg
    nx, nw, nq, ns = layout.nx, layout.nw, layout.n_q, layout.ns
    rq, ra = qr + qb + qc, ar + ab + ac
    words_in = rq + rq * nq + ra + qr + qb + ar + ab + qc + ac + ns
    words_out = nx + nw + nx * nx + nx * nw + nw * nw
    nnz = (layout.S != 0).sum(1).tolist()  # S_aff's non-zeros a row: k gradient and k (k + 1) / 2 upper terms
    pairs = sum(k + k * (k + 1) // 2 for k in nnz)
    flops = 10 * (rq + ra) + 2 * rq * nq + 3 * rq * nq * (nq + 1) // 2 + 2 * pairs + (3 * qc * (nq + 2) if ns else 0)
    nbytes = 4 * (B * N * (words_in + words_out) + B + N * (qc + ac))
    t_bytes, t_ops = nbytes / HBM_BPS, B * N * flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_expansion_shapes(torch, plain=True):
    """The split expansion's two kernels at each main-path shape
    (``EXPANSION_SHAPES``; the walk with its Jacobian, and also without at
    ``FK_POSITION_SHAPES``): each held against its plain version on the same
    CUDA tensors (``FK_ATOL``; ``gn_excess``, with live barriers near the
    clamp and away from it), then timed as
    the Riccati kernels are (``time_kernel_shapes``). The walk reads q in
    place from states of width nx, as the solver's rows do. Each record
    carries ``digest``, of the kernel's outputs on these seeded inputs (P and
    J; the five blocks of both assemblies), so that two checkouts' kernels
    can be held equal bit for bit (``chip_kernel_pairs.py``). Prints and
    returns one record per shape."""
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.ops import fk_walk as fw
    from robot_mpcs_tpu_torch.ops import gn_assemble as ga

    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.utils import aot

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def geometry(stem, problem, M, jac=True):
        """(threads, blocks, shared bytes) of a block at M rows / items, from
        this checkout's ``_build`` figures (None for a checkout without
        them: ``chip_kernel_pairs.py`` times earlier checkouts too)."""
        shape = dict(aot.expansion_kernels(problem))[stem]
        if stem == "fk_walk" and hasattr(_build, "fk_rows_per_block"):
            row = 4 * _build.fk_row_floats(shape, jac)
            rows = _build.fk_rows_per_block(M, row, sms=sms)
            return [rows, -(-M // rows), rows * row]
        if stem == "gn_assemble" and hasattr(_build, "gn_grid"):
            block = 4 * _build.gn_block_floats(shape, _build.stage_depth(stem, shape))
            return [_build.GN_THREADS, _build.gn_grid(M, block, sms), block]
        return None

    problems, records = {}, []
    for label, (robot, B) in EXPANSION_SHAPES.items():
        if robot not in problems:
            problems[robot] = MpcProblem(Setup.from_dict(robot_setup(robot)))
        problem = problems[robot]
        d, kin, links = problem.dims, problem.kin, problem.walk_links
        rng = np.random.default_rng(7)
        X = torch.as_tensor(rng.uniform(-np.pi, np.pi, size=(B, d.N, d.nx)).astype(np.float32), device="cuda")
        q = X[..., : d.n]
        cases = [(label, True)] + ([(f"{label} positions", False)] if label in FK_POSITION_SHAPES else [])
        for fk_label, jac in cases:
            call = lambda: fw.fk_walk(kin, q, links, jac)  # noqa: E731
            plain_call = lambda: fw.fk_walk_reference(kin, q, links, jac)  # noqa: E731
            got, want = call(), plain_call()
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want) if w is not None)
            check(err <= FK_ATOL, f"fk_walk differs from its plain version at {fk_label}: max abs err {err:.3e}")
            records.append(timed_record(torch, "fk_walk", "fk_walk_kernel", fk_label, B, d.N, err, None, call,
                                        plain_call if plain else None,
                                        fk_bound(B * d.N, fw.walk_table(kin, links), jac), digest(got),
                                        geometry("fk_walk", problem, B * d.N, jac)))
        errs, excesses, outputs = [], [], []
        for near_clamp in (True, False):  # the last, live barriers away from the clamp, is timed
            arrays, c_off = random_gn_inputs(problem, B, d.N, seed=B, near_clamp=near_clamp)
            inputs = [torch.as_tensor(a, device="cuda") for a in arrays]
            layout = gn_layout(problem, torch.as_tensor(c_off, device="cuda"))
            call = lambda: ga.gn_assemble(*inputs, layout=layout)  # noqa: E731
            plain_call = lambda: ga.gn_assemble_reference(*inputs, layout=layout)  # noqa: E731
            got, want = call(), plain_call()
            excess = gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            case = f"{label}{' near the clamp' if near_clamp else ''}"
            check(excess <= 1.0, f"gn_assemble differs from its plain version at {case}: max abs err {err:.3e}, "
                                 f"{excess:.3g} x the bar of {GN_RTOL:g} of each entry's term scale")
            check(torch.equal(got[2], got[2].transpose(-1, -2)) and torch.equal(got[4], got[4].transpose(-1, -2)),
                  f"gn_assemble: lxx or lww not symmetric at {case}")
            errs.append(err)
            excesses.append(excess)
            outputs += got
        records.append(timed_record(torch, "gn_assemble", "gn_assemble_kernel", label, B, d.N, max(errs),
                                    max(excesses) * GN_RTOL, call, plain_call if plain else None,
                                    gn_bound(B, d.N, layout), digest(outputs),
                                    geometry("gn_assemble", problem, B * d.N)))
    return records


def timed_record(torch, name, kernel, label, B, N, err, rel_err, call, plain_call, bound, out_digest=None,
                 block=None):
    """One ``kernel_shape`` record: device ms per launch (``torch.profiler``),
    call ms and plain ms (CUDA events), the bound, the outputs' digest, the
    launch's (threads, blocks, shared bytes) a block; printed and
    returned."""
    rec = {"kernel": name, "shape": label, "B": B, "N": N, "max_abs_err": err, "max_rel_err": rel_err,
           "ms": kernel_device_ms(torch, call, kernel, reps=10), "call_ms": time_ms(call, torch),
           "plain_ms": time_ms(plain_call, torch, reps=5, warmup=1) if plain_call else None,
           "bound_ms": bound[0], "bound_by": bound[1], "digest": out_digest, "block": block}
    print(json.dumps({"kernel_shape": rec}), flush=True)
    return rec


def expansion_kernel_phase(torch, shapes):
    """The expansion kernels' contracts beside their main-path shapes
    (``shapes``, from ``time_expansion_shapes``): a CUDA call of either
    launches and counts once (it never takes the plain version), and the
    walk refuses a configuration width other than its chain's. Returns
    their kernels-line records."""
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.ops import fk_walk as fw
    from robot_mpcs_tpu_torch.ops import gn_assemble as ga

    problem = MpcProblem(Setup.from_dict(robot_setup("panda")))
    q = torch.zeros((3, 2, problem.kin.n), device="cuda")
    before = fw.fk_walk.launches
    fw.fk_walk(problem.kin, q, problem.walk_links, True)
    check(fw.fk_walk.launches == before + 1, "fk_walk did not count its launch")
    try:
        fw.fk_walk(problem.kin, torch.zeros((3, problem.kin.n + 1), device="cuda"), problem.walk_links, False)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and fw.fk_walk.launches == before + 1, f"fk_walk took another width: {raised}")
    arrays, c_off = random_gn_inputs(problem, 2, problem.dims.N, seed=3)
    before = ga.gn_assemble.launches
    ga.gn_assemble(*(torch.as_tensor(a, device="cuda") for a in arrays),
                   layout=gn_layout(problem, torch.as_tensor(c_off, device="cuda")))
    check(ga.gn_assemble.launches == before + 1, "gn_assemble did not count its launch")
    print("expansion kernels: each CUDA call launched and counted; another width refused", flush=True)
    return [kernel_record("fk_walk", "robot_mpcs_tpu_torch/csrc/fk_walk.cu", "robot_mpcs_tpu/models/fk.py:289",
                          shapes, "panda phase 1"),
            kernel_record("gn_assemble", "robot_mpcs_tpu_torch/csrc/gn_assemble.cu",
                          "robot_mpcs_tpu/solver/al_ilqr.py:228", shapes, "panda phase 1")]


@contextlib.contextmanager
def launches_by_batch(steps):
    """Tally the kernel wrappers' launches by kernel and batch size while the
    block runs (``_build.launch_counts`` before and after it: eager launches
    and those a CUDA graph's replays count on the device alike; reading them
    synchronizes once, at the block's end), and print them per step. The
    tally is filled when the block ends."""
    from robot_mpcs_tpu_torch.ops import _build

    tally = collections.Counter()
    before = _build.launch_counts()
    yield tally
    for key, n in _build.launch_counts().items():
        if n != before.get(key, 0):
            tally[key] = n - before.get(key, 0)
    per_step = collections.defaultdict(dict)
    for (name, B), count in sorted(tally.items()):
        per_step[name][str(B)] = count / steps
    print(json.dumps({"launches_per_step_by_batch": per_step}), flush=True)


#: the ways a tensor's value reaches the host
HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "cpu", "numpy")


@contextlib.contextmanager
def host_reads():
    """Count the reads of a CUDA tensor's value on the host while the block
    runs (``Tensor.__bool__``, ``.item``, ``.tolist``, ``.cpu`` ...: a
    loop's guard outside a graph reads its flag through ``__bool__``);
    yields a one-entry list holding the count."""
    import torch

    count = [0]
    originals = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def counting(fn):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return fn(self, *args, **kwargs)
        return read

    for name, fn in originals.items():
        setattr(torch.Tensor, name, counting(fn))
    try:
        yield count
    finally:
        for name, fn in originals.items():
            setattr(torch.Tensor, name, fn)


def profile_windows(torch, fns, kernel_names):
    """Run each of ``fns`` under its own ``torch.profiler`` window, with the
    solver's programs run eagerly (``units._eager``: the same kernels as
    their graphs, with the host's dispatch and loop-flag reads back in the
    wall); returns per-window and total (wall ms, device events, device busy
    ms, per-kernel ms) and the idle share over all windows, an eager one.
    Eagerly, because CUPTI's tracing of a graph with conditional WHILE nodes
    is not usable on the card: in a first profiler session it saw only the
    top-level nodes, and a later session's traced replay faulted (an illegal
    address) where the same replay untraced did not. The device events are
    read from the profiler's raw (kineto) records: building its Python
    event list (``prof.events()``) instead takes minutes for a fleet step of
    300k device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robot_mpcs_tpu_torch.solver import units

    out, total = {}, {"wall_ms": 0.0, "device_events": 0, "device_busy_ms": 0.0}
    total.update({f"{k}_ms": 0.0 for k in kernel_names})
    for name, fn in fns.items():
        with units._eager(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        device = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        rec = {
            "wall_ms": wall_ms,
            "device_events": len(device),
            "device_busy_ms": sum(ns for _, ns in device) / 1e6,
        }
        for k in kernel_names:
            rec[f"{k}_ms"] = sum(ns for n, ns in device if k in n) / 1e6
        out[name] = rec
        for k in total:
            total[k] += rec[k]
    total["idle_share"] = (
        1.0 - total["device_busy_ms"] / total["wall_ms"] if total["device_events"] else None
    )
    if not total["device_events"]:
        print("profiler recorded no device events: device time not measured", flush=True)
    return out, total


def path_phase(torch, rp):
    """Drive the panda fleet on the card; returns (problem, scenario,
    {kernel: launches} of the structured sweep and the split expansion's
    two kernels, the state after the counted steps, the scenario on the
    card)."""
    from robot_mpcs_tpu_torch.ops.fk_walk import fk_walk
    from robot_mpcs_tpu_torch.ops.gn_assemble import gn_assemble
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

    t0 = time.perf_counter()
    problem = panda_problem()
    scenario = random_fleet_scenario(problem, BATCH, seed=0, **sampler("panda"))
    runner = FleetRunner(problem, BATCH, device="cuda")
    scen = runner.to_device(scenario)
    state = runner.init_state(scen)
    torch.cuda.synchronize()
    print(f"path set-up: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = (rp.riccati_backward_packed, fk_walk, gn_assemble)
    for fn in kernels:
        fn.launches = 0
    step_s = []
    metrics = None
    with launches_by_batch(STEPS):
        for i in range(STEPS):
            t1 = time.perf_counter()
            state, metrics = runner.step(state, scen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            m = {k: float(v) for k, v in metrics._asdict().items()}
            print(f"step {i}: {step_s[-1] * 1e3:.1f} ms, converged {m['converged_fraction']:.4f}, "
                  f"max_violation_converged {m['max_violation_converged']:.3e}, "
                  f"mean_goal_distance {m['mean_goal_distance']:.4f}, "
                  f"mean_iterations {m['mean_iterations']:.2f}", flush=True)
            check(all(np.isfinite(v) for v in m.values()), f"non-finite metrics at step {i}: {m}")
    launches = {fn.__name__: fn.launches for fn in kernels}
    for name, n in launches.items():
        check(n > 0, f"the fleet step never launched {name}")
    check(tuple(state.z_warm.shape) == (BATCH, problem.dims.N, problem.dims.nz), "state shape")
    check(bool(torch.isfinite(state.x).all()), "non-finite plant state")
    m = {k: float(v) for k, v in metrics._asdict().items()}
    check(m["converged_fraction"] >= 0.9, f"converged_fraction {m['converged_fraction']} < 0.9")
    steady = float(np.median(step_s[1:]))
    print(json.dumps({
        "fleet": "panda", "batch": BATCH, "steps": STEPS, "kernel_launches": launches,
        "step_ms": [s * 1e3 for s in step_s], "steady_step_ms": steady * 1e3,
        "solves_per_s": BATCH / steady, **m,
    }), flush=True)
    step_breakdown(torch, runner, state, scen, steady * 1e3)
    return problem, scenario, launches, state, scen


def step_breakdown(torch, runner, state, scen, steady_ms, steps=2):
    """Where a fleet step's time goes, from further steps after the counted
    run. The graphed step is one replay and cannot be split on the host, so
    the split into the phase-1 solve, the rescue tier's solve and the rest
    (gather/merge of stragglers, post-step, kick, metrics), each
    synchronized, is taken from ``steps`` eager steps (``units._eager``, the
    plain version: host reads and launch gaps included). Then one graphed
    step's ``program_record`` gives the device's busy time and kernel
    count, the graph's span and the idle share without the profiler against
    ``steady_ms``, the counted run's median graphed step."""
    from robot_mpcs_tpu_torch.solver import units

    def timed(fn, key, acc):
        def wrapped(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t
            return out
        return wrapped

    solve, tiers = runner._solve, runner._tiers
    with units._eager():
        for i in range(steps):
            acc = {"phase1": 0.0, "rescue": 0.0}
            runner._solve = timed(solve, "phase1", acc)
            runner._tiers = [(k, timed(fn, "rescue", acc)) for k, fn in tiers]
            t = time.perf_counter()
            runner.step(state, scen)
            torch.cuda.synchronize()
            total = time.perf_counter() - t
            print(json.dumps({
                "eager_breakdown_step": i, "step_ms": total * 1e3, "phase1_solve_ms": acc["phase1"] * 1e3,
                "rescue_solve_ms": acc["rescue"] * 1e3,
                "rest_ms": (total - acc["phase1"] - acc["rescue"]) * 1e3,
            }), flush=True)
    runner._solve, runner._tiers = solve, tiers
    program_record(torch, "panda fleet step B=4096 (path)", lambda: runner.step(state, scen), steady_ms,
                   EXPANSION_KERNELS)


def group_phase(torch, rp, rb):
    """Drive the mixed fleet on the card; returns (boxer problem, boxer
    scenario, each kernel's launches)."""
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel import FleetGroup, mixed_fleet_scenarios

    t0 = time.perf_counter()
    setups = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}
    problems = {k: (MpcProblem(Setup.from_dict(setups[k]())), b) for k, b in GROUP_SIZES.items()}
    samplers = {k: sampler(k) for k in GROUP_SIZES}
    scenarios = mixed_fleet_scenarios(problems, seed=0, sampler_kwargs=samplers)
    group = FleetGroup(problems, device="cuda")
    scen = group.to_device(scenarios)
    states = group.init_states(scen)
    torch.cuda.synchronize()
    print(f"group set-up: {time.perf_counter() - t0:.1f} s", flush=True)

    # per-class synchronized wall time: each class's step, timed on its own
    class_s = {k: [] for k in group.runners}
    steps = {k: r.step for k, r in group.runners.items()}

    def timed_step(name):
        def fn(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = steps[name](*args)
            torch.cuda.synchronize()
            class_s[name].append(time.perf_counter() - t)
            return out
        return fn

    for name, runner in group.runners.items():
        runner.step = timed_step(name)
    rp.riccati_backward_packed.launches = 0
    rb.riccati_backward_batched.launches = 0
    metrics = None
    records = {k: [] for k in (*group.runners, "overall")}
    with launches_by_batch(GROUP_STEPS) as tally:
        for i in range(GROUP_STEPS):
            states, metrics = group.step(states, scen)
            per = {k: {f: float(v) for f, v in m._asdict().items()}
                   for k, m in (*metrics.per_class.items(), ("overall", metrics.overall))}
            for k, m in per.items():
                records[k].append(m)
            print(json.dumps({
                "group_step": i,
                **{f"{k}_step_ms": class_s[k][-1] * 1e3 for k in group.runners},
                **{k: {f: m[f] for f in WINDOW_BARS} for k, m in per.items()},
                "jax_cpu": {k: {f: v[i] for f, v in ref.items()} for k, ref in GROUP_JAX_CPU.items()},
            }), flush=True)
            for k, m in per.items():
                check(all(np.isfinite(v) for v in m.values()),
                      f"non-finite {k} metrics at group step {i}: {m}")
    packed_launches = rp.riccati_backward_packed.launches
    batched_launches = rb.riccati_backward_batched.launches
    for name, runner in group.runners.items():
        runner.step = steps[name]
    check(packed_launches > 0, "the group step never launched the structured Riccati kernel")
    check(batched_launches > 0, "the group step never launched the general Riccati kernel")
    for k, m in metrics.per_class.items():
        cf = float(m.converged_fraction)
        check(cf >= 0.9, f"{k}: last-step converged_fraction {cf} < 0.9")
    for k, recs in records.items():
        hold_window(f"group {k}", recs, GROUP_JAX_CPU[k], GROUP_WINDOW)
    last = {k: {f: float(v) for f, v in m._asdict().items()} for k, m in metrics.per_class.items()}
    print(json.dumps({
        "group": GROUP_SIZES, "steps": GROUP_STEPS,
        "packed_launches": packed_launches, "batched_launches": batched_launches,
        **{f"{k}_median_step_ms": float(np.median(class_s[k][1:])) * 1e3 for k in group.runners},
        "group_median_step_ms": float(np.median(
            [sum(class_s[k][i] for k in group.runners) for i in range(1, GROUP_STEPS)]
        )) * 1e3,
        "last_step": last,
    }), flush=True)

    # one profiled call of the solver's diff-drive Jacobians at the group
    # shape (forward-mode autodiff of the dynamics, models.dynamics_jacobians)
    nx = group.runners["boxer"].dims.nx
    z = states["boxer"].z_warm
    jac = problems["boxer"][0].build_solver(device="cuda")._internals["all_dyn_jacobians"]
    jac(z[..., :nx], z[..., nx:])  # warm-up
    _, jt = profile_windows(torch, {"jac": lambda: jac(z[..., :nx], z[..., nx:])}, [])
    print(json.dumps({"boxer_dyn_jacobians_call": jt}), flush=True)
    launches = kernel_launches(tally)
    for kernel in ("fk_walk", "gn_assemble"):
        check(launches.get(kernel, 0) > 0, f"the group step never launched {kernel}")
    return problems["boxer"][0], scenarios["boxer"], launches


def mobile_phase(torch, rb):
    """The mobile panda (``mobile_panda_setup``) fleet on the card:
    ``MOBILE_BATCH`` lanes from seed 0 with the default rescue tier (1/8
    width) and no kick, ``MOBILE_STEPS`` steps read with their own launch
    counts, one profiled step, then 64 lanes of its last state solved on the
    card and on the CPU (``reference_phase``). Returns each kernel's
    launches in the counted steps, {kernel: n}."""
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

    t0 = time.perf_counter()
    problem = MpcProblem(Setup.from_dict(mobile_panda_setup()))
    scenario = random_fleet_scenario(problem, MOBILE_BATCH, seed=0, **MOBILE_SAMPLER)
    runner = FleetRunner(problem, MOBILE_BATCH, device="cuda", kick_scale=0.0)
    scen = runner.to_device(scenario)
    state = runner.init_state(scen)
    torch.cuda.synchronize()
    print(f"mobile panda set-up: {time.perf_counter() - t0:.1f} s", flush=True)
    rb.riccati_backward_batched.launches = 0
    step_ms, records = [], []
    t0 = time.perf_counter()
    with launches_by_batch(MOBILE_STEPS) as tally:
        for i in range(MOBILE_STEPS):
            t = time.perf_counter()
            state, metrics = runner.step(state, scen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            m = {k: float(v) for k, v in metrics._asdict().items()}
            records.append(m)
            print(json.dumps({"mobile_step": i, "step_ms": step_ms[-1], **{k: m[k] for k in (
                "converged_fraction", "mean_goal_distance", "mean_iterations", "max_violation_converged",
                "rescue_overflow_fraction")}, "jax_cpu": {k: v[i] for k, v in MOBILE_JAX_CPU.items()}}),
                flush=True)
            check(all(np.isfinite(v) for v in m.values()), f"non-finite mobile panda metrics at step {i}: {m}")
    launches = kernel_launches(tally)
    hold_window("mobile panda", records, MOBILE_JAX_CPU, MOBILE_WINDOW)
    check(launches.get("riccati_backward_batched", 0) == rb.riccati_backward_batched.launches > 0,
          "the mobile panda fleet never launched the general kernel")
    for kernel in ("riccati_backward_batched", "fk_walk", "gn_assemble"):
        batches = {B for name, B in tally if name == kernel}
        check({MOBILE_BATCH, MOBILE_BATCH // 8} <= batches,
              f"the mobile panda fleet launched {kernel} at B = {sorted(batches)}")
    check(tuple(state.z_warm.shape) == (MOBILE_BATCH, problem.dims.N, problem.dims.nz), "mobile state shape")
    check(bool(torch.isfinite(state.x).all()), "non-finite mobile panda plant state")
    check(m["converged_fraction"] >= 0.9, f"mobile panda converged_fraction {m['converged_fraction']} < 0.9")
    check(m["max_violation_converged"] <= 1e-4, "mobile panda: converged lanes violate constraints")
    t1 = time.perf_counter()
    print(json.dumps({
        "fleet": "mobile panda", "batch": MOBILE_BATCH, "steps": MOBILE_STEPS, "kernel_launches": launches,
        "step_ms": step_ms, "steady_step_ms": float(np.median(step_ms[1:])),
    }), flush=True)
    program_record(torch, "mobile panda fleet step B=1024 (mobile phase)", lambda: runner.step(state, scen),
                   float(np.median(step_ms[1:])), ["riccati_batched_kernel", "fk_walk_kernel", "gn_assemble_kernel"])
    t2 = time.perf_counter()
    reference_phase(torch, "mobile panda (warm, after the fleet's steps)", problem, scenario,
                    warm=(state.x, state.z_warm, state.lam))
    print(json.dumps({"mobile_phase_s": {"steps": t1 - t0, "profiled_step": t2 - t1,
                                         "card_vs_cpu": time.perf_counter() - t2}}), flush=True)
    return launches


def hold_window(label, records, reference, window):
    """A card fleet's per-step metrics (``records``) against the JAX
    package's on a CPU (``reference``: per field, per step): the means over
    the steps of ``window`` within ``WINDOW_BARS``, absolute for the
    converged fraction and relative otherwise."""
    lo, hi = window
    out = {}
    for k, bar in WINDOW_BARS.items():
        card, ref = float(np.mean([r[k] for r in records[lo:hi]])), float(np.mean(reference[k][lo:hi]))
        limit = bar if k == "converged_fraction" else bar * ref
        out[k] = {"card": card, "jax_cpu": ref, "gap": abs(card - ref), "limit": limit}
    print(json.dumps({"window_vs_jax_cpu": out, "fleet": label, "steps": list(window)}), flush=True)
    for k, v in out.items():
        check(v["gap"] <= v["limit"], f"{label}: the mean {k} over steps {lo}-{hi - 1} is {v['card']}, "
                                      f"the JAX package's on a CPU {v['jax_cpu']} (limit {v['limit']})")


def point_phase(torch, rp):
    """The bench's pointRobot extra on the card: the port's
    ``bench._scenario_for`` at ``POINT_BATCH`` lanes with the bench's runner
    (``FleetRunner`` defaults), ``POINT_STEPS`` graphed steps read with their
    own launch counts. Each step is printed beside ``POINT_JAX_CPU``; the
    means over ``POINT_WINDOW`` are held (``hold_window``), each step's
    kicked lanes within ``POINT_KICKED_BAR`` of the JAX package's, every
    metric finite and converged lanes feasible to 1e-4 at every step, and
    the structured kernel and the split expansion's two launched at B and
    at its rescue tier's B/8. Returns each kernel's launches in these
    steps."""
    from robot_mpcs_tpu_torch import bench as tbench
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner

    t0 = time.perf_counter()
    problem, _ = tbench._load_problem("pointRobot")
    runner = FleetRunner(problem, POINT_BATCH, device="cuda")
    scen = runner.to_device(tbench._scenario_for(problem, POINT_BATCH, "pointRobot"))
    state = runner.init_state(scen)
    torch.cuda.synchronize()
    print(f"pointRobot set-up: {time.perf_counter() - t0:.1f} s", flush=True)
    rp.riccati_backward_packed.launches = 0
    step_ms, records = [], []
    t0 = time.perf_counter()
    with launches_by_batch(POINT_STEPS) as tally:
        for i in range(POINT_STEPS):
            prev = state
            t = time.perf_counter()
            state, metrics = runner.step(state, scen)
            m = {k: float(v) for k, v in metrics._asdict().items()}  # synchronizes
            step_ms.append((time.perf_counter() - t) * 1e3)
            m["kicked"] = int(kicked_lanes(prev, state, runner._kick_after).sum())
            records.append(m)
            print(json.dumps({"point_step": i, "step_ms": step_ms[-1], **{k: m[k] for k in (
                "converged_fraction", "mean_goal_distance", "mean_iterations", "max_violation_converged",
                "rescue_overflow_fraction", "kicked")}, "jax_cpu": {k: v[i] for k, v in POINT_JAX_CPU.items()}}),
                flush=True)
            check(all(np.isfinite(v) for v in m.values()), f"non-finite pointRobot metrics at step {i}: {m}")
            check(m["max_violation_converged"] <= 1e-4, f"pointRobot step {i}: converged lanes violate constraints")
            check(abs(m["kicked"] - POINT_JAX_CPU["kicked"][i]) <= POINT_KICKED_BAR,
                  f"pointRobot step {i}: {m['kicked']} lanes kicked, the JAX package's on a CPU "
                  f"{POINT_JAX_CPU['kicked'][i]}")
    launches = rp.riccati_backward_packed.launches
    hold_window(f"pointRobot fleet (B={POINT_BATCH})", records, POINT_JAX_CPU, POINT_WINDOW)
    check(launches > 0, "the pointRobot fleet never launched the structured kernel")
    for kernel in ("riccati_backward_packed", "fk_walk", "gn_assemble"):
        batches = {B for name, B in tally if name == kernel}
        check({POINT_BATCH, POINT_BATCH // 8} <= batches,
              f"the pointRobot fleet launched {kernel} at B = {sorted(batches)}")
    check(bool(torch.isfinite(state.x).all() and torch.isfinite(state.z_warm).all()),
          "non-finite pointRobot fleet state")
    print(json.dumps({
        "fleet": "pointRobot", "batch": POINT_BATCH, "steps": POINT_STEPS, "kernel_launches": launches,
        "kicked": sum(r["kicked"] for r in records), "steady_step_ms": float(np.median(step_ms[1:])),
        "window_step_ms": float(np.mean(step_ms[POINT_WINDOW[0]:])), "point_phase_s": time.perf_counter() - t0,
    }), flush=True)
    return kernel_launches(tally)


def kick_draw(torch, step, rank, device, shape=KICK_DRAW):
    """The fleet's kick noise for (step, rank) at ``shape``: the key folded
    as ``FleetRunner.step`` folds it, then the bits, uniforms and normals of
    ``utils/prng.py``."""
    from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED
    from robot_mpcs_tpu_torch.utils import prng

    step = torch.tensor(step, dtype=torch.int32, device=device)
    key = prng.fold_in(prng.fold_in(prng.prng_key(KICK_SEED, device=device), step), rank)
    return key, prng.random_bits(key, shape), prng.uniform(key, shape), prng.normal(key, shape)


def cpu_kick_noise(step, rank, shape):
    """The CPU's draw of the kick noise for (step, rank) at ``shape``."""
    from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED
    from robot_mpcs_tpu_torch.utils import prng

    return prng.normal(prng.fold_in(prng.fold_in(prng.prng_key(KICK_SEED), step), rank), tuple(shape))


def kicked_lanes(prev, new, kick_after=KICK_AFTER):
    """Lanes kicked by the step from fleet state ``prev`` to ``new``: its
    ``no_improve`` reached ``kick_after`` and fell to 0 without an
    improvement of the best goal distance (fleet.py:309-319)."""
    improved = new.best_gdist < prev.best_gdist - 5e-3
    return (prev.no_improve + 1 >= kick_after) & (new.no_improve == 0) & ~improved


def kick_fleet_run(torch, device, kind="panda", batch=KICK_BATCH, steps=KICK_STEPS, eager_from=0):
    """The bench's ``kind`` scenario (the port's ``bench._scenario_for``) at
    ``batch`` lanes, the default rescue tier and the kick after
    ``KICK_AFTER`` steps, for ``steps`` steps on ``device``: the first
    ``eager_from`` as the runner runs them (graphed on the card), the rest
    eagerly (``units._eager``) so that each step's unkicked shift can be read
    from its post-step; ``graph_phase`` holds the graphed panda kick fleet to
    the eager one bit for bit. Returns per step its metrics, its kicked
    lanes and, for an eager step, the largest difference between the noise a
    kicked lane got (its warm start less the unkicked shift) and the CPU's
    draw for the same key."""
    from robot_mpcs_tpu_torch import bench as tbench
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
    from robot_mpcs_tpu_torch.solver import units

    problem, _ = tbench._load_problem(kind)
    runner = FleetRunner(problem, batch, device=device, kick_after=KICK_AFTER)
    scen = runner.to_device(tbench._scenario_for(problem, batch, kind))
    state = runner.init_state(scen)
    post_step, shifts = runner._post_step, []

    def recording_post_step(*args):
        out = post_step(*args)
        shifts.append((out[1].clone(), out[-1].clone()))  # (z_shift, kick) before the noise
        return out

    nx, records = problem.dims.nx, []
    for i in range(steps):
        eager = i >= eager_from
        runner._post_step = recording_post_step if eager else post_step
        prev = state
        t = time.perf_counter()
        with units._eager() if eager else contextlib.nullcontext():
            state, metrics = runner.step(state, scen)
        m = {k: float(v) for k, v in metrics._asdict().items()}  # synchronizes
        step_ms = (time.perf_counter() - t) * 1e3
        kick = kicked_lanes(prev, state)
        noise_err = None
        if eager:
            z_shift, flags = shifts[-1]
            check(torch.equal(flags, kick), f"{kind} kick fleet step {i}: its kick flags are not what its states show")
            if int(kick.sum()):
                want = cpu_kick_noise(i, 0, z_shift[..., nx:].shape)
                got = (state.z_warm[..., nx:] - z_shift[..., nx:]).cpu()
                k = kick.cpu()
                noise_err = float((got[k] - want[k]).abs().max())
                check(bool((got[~k] == 0).all()), f"{kind} kick fleet step {i}: noise on lanes not kicked")
        records.append({"kick_fleet": kind, "kick_step": i, "eager": eager, "step_ms": step_ms,
                        "kicked": int(kick.sum()), "noise_vs_cpu_draw": noise_err, **{k: m[k] for k in (
                            "converged_fraction", "mean_goal_distance", "mean_iterations",
                            "max_violation_converged", "rescue_overflow_fraction")}})
        print(json.dumps(records[-1]), flush=True)
        check(all(np.isfinite(v) for v in m.values()), f"non-finite {kind} kick fleet metrics at step {i}: {m}")
    runner._post_step = post_step
    check(bool(torch.isfinite(state.x).all() and torch.isfinite(state.z_warm).all()),
          f"non-finite {kind} kick fleet state")
    return records


def hold_kick_fleet(kind, records, tally, kernel, batch):
    """A kick fleet's checks: lanes kicked in its eager steps, each kicked
    lane's noise the CPU's draw within 1e-5, converged >= 0.9 at the last
    step with its converged lanes feasible to 1e-4, ``kernel`` launched at
    ``batch`` and its rescue tier's ``batch // 8``."""
    batches = {B for name, B in tally if name == kernel}
    kicked = sum(r["kicked"] for r in records if r["eager"])
    errs = [r["noise_vs_cpu_draw"] for r in records if r["noise_vs_cpu_draw"] is not None]
    check(kicked > 0 and errs, f"no lane of the {kind} kick fleet was kicked in its eager steps")
    check(max(errs) <= 1e-5, f"{kind} kicked lanes' noise differs from the CPU draw by {max(errs):.3e}")
    check(records[-1]["converged_fraction"] >= 0.9,
          f"{kind} kick fleet converged_fraction {records[-1]['converged_fraction']} < 0.9")
    check(records[-1]["max_violation_converged"] <= 1e-4, f"{kind} kick fleet: converged lanes violate constraints")
    check({batch, batch // 8} <= batches, f"the {kind} kick fleet launched {kernel} at B = {sorted(batches)}")
    return kicked, max(errs)


def kick_phase(torch):
    """The kick's noise on the card: ``utils/prng.py``'s draw on the card
    equal to the CPU's bit for bit at ``KICK_DRAW`` for ``KICK_KEYS`` and at
    the boxer's ``BOXER_KICK_KEY``, the device events and time of one fleet
    step's draw at ``KICK_DRAW``; then the panda kick fleet and the boxer
    kick fleet (``kick_fleet_run``), each read with its own launch counts
    and held by ``hold_kick_fleet``. Returns each fleet's launches by
    kernel."""
    t0 = time.perf_counter()
    for step, rank, shape in [(s, r, KICK_DRAW) for s, r in KICK_KEYS] + [BOXER_KICK_KEY]:
        card = [v.cpu() for v in kick_draw(torch, step, rank, "cuda", shape)]
        host = kick_draw(torch, step, rank, "cpu", shape)
        for name, a, b in zip(("key", "bits", "uniform", "normal"), card, host):
            same = torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)
            check(same, f"kick draw (step {step}, rank {rank}, {shape}): the card's {name} differ from the CPU's")
    print(f"kick draw on the card equals the CPU's bit for bit at {KICK_DRAW} for (step, rank) in "
          f"{KICK_KEYS} and at the boxer's {BOXER_KICK_KEY[2]} for {BOXER_KICK_KEY[:2]}", flush=True)
    from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED
    from robot_mpcs_tpu_torch.utils import prng

    # what a fleet step of B=4096 draws: the key folded on the step and the
    # rank, then the normals
    key, step = prng.prng_key(KICK_SEED, device="cuda"), torch.tensor(25, dtype=torch.int32, device="cuda")
    draw = lambda: prng.normal(prng.fold_in(prng.fold_in(key, step), 0), KICK_DRAW)  # noqa: E731
    draw()
    _, total = profile_windows(torch, {"kick draw": draw}, [])
    draw_ms = time_ms(draw, torch)
    print(json.dumps({"kick_draw": list(KICK_DRAW), "device_events": total["device_events"],
                      "device_busy_ms": total["device_busy_ms"], "call_ms": draw_ms}), flush=True)
    out = {}
    for kind, kernel, steps, eager_from in (
            ("panda", "riccati_backward_packed", KICK_STEPS, 0),
            ("boxer", "riccati_backward_batched", BOXER_KICK_STEPS, BOXER_KICK_EAGER_FROM)):
        t1 = time.perf_counter()
        with launches_by_batch(steps) as tally:
            records = kick_fleet_run(torch, "cuda", kind, steps=steps, eager_from=eager_from)
        out[kind] = kernel_launches(tally)
        for k in ("fk_walk", "gn_assemble"):
            check(out[kind].get(k, 0) > 0, f"the {kind} kick fleet never launched {k}")
        kicked, err = hold_kick_fleet(kind, records, tally, kernel, KICK_BATCH)
        print(json.dumps({"kick_fleet": kind, "kicked_in_eager_steps": kicked, "noise_vs_cpu_draw": err,
                          "launches": out[kind], "fleet_s": time.perf_counter() - t1}), flush=True)
    print(json.dumps({"kick_phase_s": time.perf_counter() - t0}), flush=True)
    return out


def chain_phase(torch, rp):
    """The 6-dof chain (``chain6_setup``): 64 lanes solved cold on the card
    (the structured kernel at (12, 6, 0), B=64 only) and on the CPU
    (``reference_phase``). Returns each kernel's launches."""
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel.fleet import random_fleet_scenario

    problem = MpcProblem(Setup.from_dict(chain6_setup()))
    scenario = random_fleet_scenario(problem, 64, seed=0, **sampler("panda"))
    rp.riccati_backward_packed.launches = 0
    with launches_by_batch(1) as tally:
        reference_phase(torch, "6-dof chain (cold)", problem, scenario)
    launches = rp.riccati_backward_packed.launches
    check(launches > 0, "the 6-dof chain's solve never launched the structured kernel")
    check(set(tally) == {(k, 64) for k in ("riccati_backward_packed", "fk_walk", "gn_assemble")},
          f"the 6-dof chain launched {dict(tally)}")
    return kernel_launches(tally)


#: closed-loop solve caps of the planner runs, and the number of their first
#: observations replayed on a CPU planner
PLANNER_REPLAY = 10
#: boxer's planner run stops after its replayed solves: the boxer example
#: (``examples_phase``) drives the same path to its goal
PLANNER_CAPS = {"panda": 150, "pointRobot": 250, "boxer": PLANNER_REPLAY}
SOLVE_BATCH = 64
#: goal radius (m) of each planner run: panda's end effector
#: (tests/test_planner_behavior.py), pointRobot's base (the verify recipe),
#: boxer's end effector (examples/boxer_example.py)
PLANNER_GOAL_TOL = {"panda": 0.05, "pointRobot": 0.15, "boxer": 0.4}
#: card-vs-CPU control bar (tests/test_parity.py) and solve_batch lane bar,
#: for two solves that took the same number of inner iterations. A solve
#: stops once its Newton step falls below tol_stationarity (1e-3, control
#: units) and the f32 merit test finds no gain; where one side takes one
#: more such step than the other, the two differ by that step, so solves
#: whose iteration counts differ are held to 2 x tol_stationarity instead.
PLANNER_ATOL = 1e-3
#: true-cost bar of converged card-vs-CPU solves (tests/test_torch_fleet.py)
PLANNER_COST_RTOL = 1e-5


class Sphere:
    """A sphere obstacle in the planner's ``position()``/``radius()`` API."""

    def __init__(self, position, radius):
        self._position, self._radius = list(position), float(radius)

    def position(self):
        return self._position

    def radius(self):
        return self._radius

    def dimension(self):
        return 3


def planner_scenario(kind, device):
    """The planner, sim, initial state, goal and obstacles of one scenario,
    through the port's entry points on ``device``:

    * panda: tests/test_planner_behavior.py::test_panda_reaches_goal
      (pandaMpc.yaml with wconstr = [0.05, 0, 0, 0], one sphere, self
      collision, the URDF's joint limits, inputs +-5);
    * pointRobot: the verify recipe (pointRobotMpc.yaml with wconstr =
      [0.005, 0, 0, 0], a sphere on the line to the goal);
    * boxer: examples/boxer_example.py (boxerMpc.yaml, two spheres seen only
      through the lidar's free-space half-planes, r_body 0.6).
    """
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.perception import FreeSpaceDecomposition
    from robot_mpcs_tpu_torch.planner import MPCPlanner
    from robot_mpcs_tpu_torch.sim import KinematicSim

    setup = Setup.from_dict({"panda": panda_setup, "pointRobot": point_robot_setup,
                             "boxer": boxer_setup}[kind]())
    problem = MpcProblem(setup)
    planner = MPCPlanner(problem, device=device)
    dims = problem.dims
    x0 = np.zeros(dims.nx, np.float32)
    sc = {"kind": kind, "problem": problem, "planner": planner,
          "sim": KinematicSim(dims, setup.mpc.time_step, device=device), "x0": x0}
    if kind == "panda":
        sc.update(goal=[0.4, 0.3, 0.6], obstacles=[Sphere([0.2, -0.4, 0.8], 0.15)], r_body=0.1)
        x0[: dims.n] = [0.0, -0.8, 0.0, -2.0, 0.0, 1.5, 0.0]
        lim = problem.kin.joint_limits
        limits, limits_u, r_self = (lim[:, 0], lim[:, 1]), ([-5.0] * 7, [5.0] * 7), 0.05
    elif kind == "pointRobot":
        sc.update(goal=[3.0, 0.5, 0.0], obstacles=[Sphere([1.5, 0.25, 0.05], 0.4)], r_body=0.2)
        limits, limits_u, r_self = ([-10.0] * 3, [10.0] * 3), ([-5.0] * 3, [5.0] * 3), 0.2
    else:
        sc.update(goal=[7.2, -2.2], obstacles=[Sphere([4.0, -1.5, 0.0], 1.0), Sphere([2.4, -0.7, 0.0], 0.3)],
                  r_body=0.6, fsd=FreeSpaceDecomposition(dims.n_obst, max_radius=5.0, device=device))
        limits, limits_u, r_self = ([-10.0] * 3, [10.0] * 3), ([-10.0] * 2, [10.0] * 2), 0.6
    planner.setGoalReaching(sc["goal"])
    planner.setConstraintAvoidance()
    if kind != "boxer":
        planner.setRadialConstraints(sc["obstacles"], sc["r_body"])
    planner.setSelfCollisionAvoidanceConstraints(r_self)
    planner.setJointLimits(limits)
    planner.setInputLimits(limits_u)
    planner.concretize()
    return sc


def boxer_halfplanes(sc, q, exitflag, output):
    """Per-stage half-planes from one lidar scan (examples/boxer_example.py
    :70-89): one decomposition around each stage of the previous plan when
    the last solve succeeded, else around the current pose."""
    from robot_mpcs_tpu_torch.examples.boxer_example import simulate_lidar

    planner, fsd = sc["planner"], sc["fsd"]
    cloud = simulate_lidar(q, sc["obstacles"])
    lin = []
    for j in range(planner._N):
        if exitflag >= 0 and output:
            stage = output[planner._stage_key(j + 1)]
            fsd.set_position(np.array([stage[0], stage[1], 0.0]))
        else:
            fsd.set_position(np.array([q[0], q[1], 0.0]))
        if cloud.size:
            fsd.compute_constraints(cloud)
            lin.append(fsd.aslist())
        else:
            lin.append(np.tile(np.array([1.0, 0.0, 0.0, -100.0]), (planner._dims.n_obst, 1)))
    return lin


def goal_distance(sc, state):
    """Distance (m) of the scenario's tracked point from its goal."""
    import torch

    if sc["kind"] == "panda":
        q = torch.from_numpy(np.asarray(state[: sc["problem"].dims.n], np.float32))
        ee = sc["problem"].kin.fk_pos(q).numpy()
        return float(np.linalg.norm(ee - np.asarray(sc["goal"])))
    if sc["kind"] == "pointRobot":
        return float(np.linalg.norm(state[:2] - np.asarray(sc["goal"][:2])))
    ee = state[:2] + 0.4 * np.array([np.cos(state[2]), np.sin(state[2])])
    return float(np.linalg.norm(ee - np.asarray(sc["goal"])))


def planner_run(kind, device, cap, replay=PLANNER_REPLAY):
    """One closed loop of the scenario ``kind`` on ``device`` for at most
    ``cap`` solves, stopping at the goal (panda, pointRobot). Every exit flag
    must be >= 0. Returns the scenario and a record: per-solve wall ms (the
    whole ``computeAction``, its host copies included), FSD ms per step
    (boxer), the steps to the goal, the final distance, the pointRobot's
    least clearance, and the first ``replay`` solves: observation,
    half-planes, the planner's warm start before the solve, and the solve's
    action, flag, inner iterations and true cost."""
    sc = planner_scenario(kind, device)
    planner, sim = sc["planner"], sc["sim"]
    state = sim.reset(sc["x0"])
    rec = {"solve_ms": [], "fsd_ms": [], "flags": [], "actions": [], "replay": [], "reached_at": None,
           "min_clearance": None}
    exitflag, output = -1, {}
    for step in range(cap):
        obs = tuple(np.array(o) for o in sim.observation())
        lin = None
        if kind == "boxer":
            t = time.perf_counter()
            lin = boxer_halfplanes(sc, obs[0], exitflag, output)
            rec["fsd_ms"].append((time.perf_counter() - t) * 1e3)
            planner.setLinearConstraints(lin, sc["r_body"])
        if step < replay:  # the warm start this solve starts from
            warm = (planner._lam.copy(), np.array(getattr(planner, "_z_prev", planner._x0)),
                    planner._initial_step)
        t = time.perf_counter()
        action, output, exitflag = planner.computeAction(*obs)
        rec["solve_ms"].append((time.perf_counter() - t) * 1e3)
        rec["flags"].append(exitflag)
        rec["actions"].append(np.asarray(action))
        check(exitflag >= 0, f"{kind} planner on {device}: exitflag {exitflag} at step {step}")
        check(bool(np.all(np.isfinite(action))), f"{kind} planner: non-finite action at step {step}")
        if step < replay:
            info = planner._last_info
            rec["replay"].append((obs, lin, warm, np.array(action), exitflag, int(info.iterations),
                                  float(info.cost)))
        state = sim.step(action)
        if kind == "pointRobot":
            obst = sc["obstacles"][0]
            clear = (np.linalg.norm(np.array([state[0], state[1], 0.05]) - np.asarray(obst.position()))
                     - obst.radius() - sc["r_body"])
            rec["min_clearance"] = clear if rec["min_clearance"] is None else min(rec["min_clearance"], clear)
        if goal_distance(sc, state) < PLANNER_GOAL_TOL[kind] and kind != "boxer":
            rec["reached_at"] = step
            break
    rec["final_distance"] = goal_distance(sc, state)
    return sc, rec


def solve_bar(problem, iterations_a, iterations_b):
    """Control bar between two solves of the same inputs (``PLANNER_ATOL``)."""
    if iterations_a == iterations_b:
        return PLANNER_ATOL
    return 2.0 * problem.setup.solver.tol_stationarity


def replay_on(kind, device, rec):
    """The recorded solves of a run repeated by a fresh planner on
    ``device``: the same observations and half-planes, each from the
    recorded planner's warm start (the closed loop's history is the card's,
    so each solve is compared from the same inputs). Returns one record per
    solve: |action difference|, its bar, both flags, both iteration counts,
    the relative true-cost difference, and the solve's wall ms."""
    sc = planner_scenario(kind, device)
    planner = sc["planner"]
    out = []
    for obs, lin, (lam, z_prev, initial), action, flag, iters, cost in rec["replay"]:
        if lin is not None:
            planner.setLinearConstraints(lin, sc["r_body"])
        planner._lam, planner._z_prev, planner._initial_step = lam.copy(), z_prev.copy(), initial
        t = time.perf_counter()
        a, _, f = planner.computeAction(*obs)
        ms = (time.perf_counter() - t) * 1e3
        info = planner._last_info
        out.append({"diff": float(np.abs(a - action).max()),
                    "bar": solve_bar(sc["problem"], iters, int(info.iterations)),
                    "flags": (flag, f), "iterations": (iters, int(info.iterations)),
                    "cost_rel": abs(float(info.cost) - cost) / max(abs(cost), 1e-6), "ms": ms})
    return out


def percentiles(ms):
    """p50 / p90 / max of solves 2... and the first solve, in ms."""
    rest = ms[1:] or ms
    return {"first_ms": ms[0], "p50_ms": float(np.percentile(rest, 50)),
            "p90_ms": float(np.percentile(rest, 90)), "max_ms": float(max(rest)), "solves": len(ms)}


def planner_phase(torch):
    """Drive the port's single-robot planner on the card (panda, pointRobot,
    boxer with lidar and free-space half-planes), replay their first
    observations on a CPU planner, check ``solve_batch`` against single
    solves and the global planner against the CPU. Each run must launch its
    robot's Riccati kernel and the split expansion's two, all at B=1.
    Returns each kernel's launches per planner run."""
    counters = kernel_counters()
    needs = {"panda": "riccati_backward_packed", "pointRobot": "riccati_backward_packed",
             "boxer": "riccati_backward_batched"}
    by_path = {name: {} for name in counters}
    per_solve, runs = {}, {}
    for kind, cap in PLANNER_CAPS.items():
        for fn in counters.values():
            fn.launches = 0
        with launches_by_batch(1) as tally:
            sc, rec = planner_run(kind, "cuda", cap)
        launches = {name: fn.launches for name, fn in counters.items()}
        solves = len(rec["solve_ms"])
        for kernel in (needs[kind], "fk_walk", "gn_assemble"):
            check(launches[kernel] > 0, f"{kind} planner never launched {kernel}")
        check(all(B == 1 for _, B in tally), f"{kind} planner launched at B != 1: {dict(tally)}")
        per_solve[kind] = {name: n / solves for name, n in launches.items() if n}
        for name, n in launches.items():
            if n:
                by_path[name][f"{kind} planner (B=1)"] = n
        if kind != "boxer":
            check(rec["reached_at"] is not None,
                  f"{kind} planner did not reach its goal in {cap} solves: {rec['final_distance']:.3f} m")
        if kind == "pointRobot":
            check(rec["min_clearance"] > -0.05, f"pointRobot clearance {rec['min_clearance']:.3f} m")
        # one profiled solve from the final state
        planner = sc["planner"]
        obs = np.concatenate([np.asarray(o) for o in sc["sim"].observation()])
        _, prof = profile_windows(torch, {"solve": lambda: planner.solve(obs)},  # eagerly
                                  ["riccati_packed_kernel", "riccati_batched_kernel", *EXPANSION_KERNELS[1:]])
        runs[kind] = (sc, rec)
        print(json.dumps({
            "planner": kind, "device": "cuda", "steps_to_goal": rec["reached_at"],
            "final_distance_m": rec["final_distance"], "min_clearance_m": rec["min_clearance"],
            **percentiles(rec["solve_ms"]),
            "fsd_ms_per_step": float(np.median(rec["fsd_ms"])) if rec["fsd_ms"] else None,
            "launches_per_solve": per_solve[kind], "flags": collections.Counter(rec["flags"]),
            "eager_profiled_solve": prof,
        }), flush=True)
    print(json.dumps({"planner_launches": per_solve}), flush=True)

    # the first solves of each run, repeated on the CPU
    for kind in PLANNER_CAPS:
        rec = runs[kind][1]
        rows = replay_on(kind, "cpu", rec)
        same_it = [r for r in rows if r["iterations"][0] == r["iterations"][1]]
        conv = [r for r in rows if r["flags"] == (1, 1)]
        print(json.dumps({
            "planner_card_vs_cpu": kind, "solves": len(rows),
            "max_action_diff": max(r["diff"] for r in rows),
            "max_action_diff_same_iterations": max((r["diff"] for r in same_it), default=None),
            "solves_with_other_iteration_count": len(rows) - len(same_it),
            "flags_equal": all(a == b for a, b in (r["flags"] for r in rows)),
            "max_cost_rel_converged": max((r["cost_rel"] for r in conv), default=None),
            "card_ms": percentiles(rec["solve_ms"][: len(rows)]), "cpu_ms": percentiles([r["ms"] for r in rows]),
            "per_solve": [{k: r[k] for k in ("diff", "flags", "iterations", "cost_rel")} for r in rows],
        }), flush=True)
        for i, r in enumerate(rows):
            check(r["flags"][0] == r["flags"][1], f"{kind} planner solve {i}: exit flags {r['flags']} (card, CPU)")
            check(r["diff"] <= r["bar"], f"{kind} planner solve {i}: card and CPU actions differ by "
                  f"{r['diff']:.3e} > {r['bar']:.0e} (iterations {r['iterations']})")
            if r["flags"] == (1, 1):
                check(r["cost_rel"] <= PLANNER_COST_RTOL,
                      f"{kind} planner solve {i}: true costs differ by {r['cost_rel']:.2e} relative")

    solve_batch_phase(runs["panda"])
    global_planner_phase()
    return by_path


def solve_batch_phase(run):
    """``solve_batch`` of SOLVE_BATCH perturbed panda observations at once
    against a B=1 solve of each: exit flags equal, z within ``solve_bar``."""
    sc, rec = run
    planner, dims = sc["planner"], sc["problem"].dims
    rng = np.random.default_rng(0)
    base = np.concatenate(rec["replay"][-1][0])
    B = SOLVE_BATCH
    xinit = np.repeat(base[None], B, 0).astype(np.float32)
    xinit[:, : dims.n] += rng.normal(0.0, 0.02, size=(B, dims.n)).astype(np.float32)
    params = np.repeat(planner.params[None], B, 0)
    z0 = np.zeros((B, dims.N, dims.nz), np.float32)
    z0[:, :, : dims.nx] = xinit[:, None]
    lam0 = np.repeat(planner._lam[None], B, 0)
    t = time.perf_counter()
    batch = planner.solve_batch(xinit, params, z0, lam0)
    flags, z = batch.exitflag.cpu().numpy(), batch.z.cpu().numpy()
    batch_ms = (time.perf_counter() - t) * 1e3
    iters = batch.iterations.cpu().numpy()
    err, same_err, differ, over = 0.0, 0.0, [], []
    for i in range(B):
        one = planner.solve_batch(xinit[i : i + 1], params[i : i + 1], z0[i : i + 1], lam0[i : i + 1])
        if int(one.exitflag[0]) != int(flags[i]):
            differ.append(i)
        d = float(np.abs(one.z[0].cpu().numpy() - z[i]).max())
        err = max(err, d)
        if int(one.iterations[0]) == int(iters[i]):
            same_err = max(same_err, d)
        if d > solve_bar(sc["problem"], int(one.iterations[0]), int(iters[i])):
            over.append(i)
    print(json.dumps({"solve_batch": B, "batch_ms": batch_ms, "flags": collections.Counter(flags.tolist()),
                      "lanes_with_other_flag": differ, "max_z_diff": err,
                      "max_z_diff_same_iterations": same_err, "lanes_over_bar": over}), flush=True)
    check(not differ, f"solve_batch: lanes {differ} end with another exit flag than their B=1 solve")
    check(not over, f"solve_batch: lanes {over} differ from their B=1 solves beyond the bar (max {err:.3e})")


def global_planner_phase():
    """``GlobalPlanner`` on a seeded random 128x128 occupancy map with a wall:
    the obstacle enlargement on the card equals the CPU's exactly (0/1 map:
    a blurred cell is a count, no rounding reaches the threshold), and A*
    (native library when built, else the Python fallback) finds a path."""
    from robot_mpcs_tpu_torch.global_planner import GlobalPlanner
    from robot_mpcs_tpu_torch.global_planner import astar
    from robot_mpcs_tpu_torch.global_planner.global_planner import enlarge_obstacles

    gp = GlobalPlanner([128, 128, 1], [-6.4, -6.4, 0.0], [6.4, 6.4, 1.0], device="cuda")
    occ = (np.random.default_rng(0).random((128, 128, 1)) < 0.1).astype(np.float32)
    occ[30:100, 62:66, 0] = 1.0
    gp.get_occupancy_map(None, occ)
    t = time.perf_counter()
    card = gp.get_enlarged_obstacles()
    card_ms = (time.perf_counter() - t) * 1e3
    k = int(np.ceil(0.4 / gp.cell_size))
    cpu = enlarge_obstacles(gp.occupancy_map_2d / max(gp.occupancy_map_2d.max(), 1e-6), k, gp.threshold,
                            device="cpu")
    check(np.array_equal(card, cpu), f"enlarge_obstacles: card and CPU differ in {int((card != cpu).sum())} cells")
    t = time.perf_counter()
    path, _ = gp.get_global_path_astar(np.array([-5.0, -5.0, 0.0]), np.array([5.0, 5.0, 0.0]))
    astar_ms = (time.perf_counter() - t) * 1e3
    check(len(path) > 0, "global planner found no path")
    print(json.dumps({"global_planner": "128x128", "enlarge_ms_card": card_ms, "occupied_after_enlarge":
                      int(card.sum()), "path_nodes": len(path), "astar_ms": astar_ms,
                      "astar": "native" if astar._NATIVE is not None else "python fallback"}), flush=True)


def reference_phase(torch, label, problem, scenario, warm=None):
    """One batched solve of 64 lanes on the card vs the same solve on the
    CPU: cold from the scenario, or from ``warm`` = (x, z, lam), a fleet
    state's first 64 lanes."""
    B = 64
    dims = problem.dims
    xinit, params = scenario.xinit[:B], scenario.params[:B]
    z0 = torch.zeros((B, dims.N, dims.nz))
    z0[:, :, : dims.nx] = xinit[:, None, :]
    lam0 = torch.zeros((B, dims.N, problem.n_con))
    if warm is not None:
        xinit, z0, lam0 = (t[:B].cpu() for t in warm)
    t = time.perf_counter()
    res_gpu = problem.build_solver(device="cuda")(xinit, params, z0, lam0)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    res_cpu = problem.build_solver(device="cpu")(xinit, params, z0, lam0)
    t_cpu = time.perf_counter() - t - t_card
    check(tuple(res_gpu.z.shape) == (B, dims.N, dims.nz), f"{label}: solve output shape")
    check(bool(torch.isfinite(res_gpu.z).all()), f"{label}: non-finite solve output")
    flag_gpu, flag_cpu = res_gpu.exitflag.cpu(), res_cpu.exitflag
    agree = int((flag_gpu == flag_cpu).sum())
    both = (flag_gpu == 1) & (flag_cpu == 1)
    check(bool(both.any()), f"{label}: no lane converged on both card and CPU")
    rel = ((res_gpu.cost.cpu() - res_cpu.cost).abs() / res_cpu.cost.abs().clamp(min=1e-6))[both]
    viol = res_gpu.violation.cpu()[flag_gpu == 1]
    print(f"{label} card vs CPU solve (B={B}): exit flags agree {agree}/{B}, converged on both "
          f"{int(both.sum())}, max rel cost diff {float(rel.max()):.3e}, "
          f"max violation (converged) {float(viol.max()):.3e}; solve {t_card:.2f} s on the card, "
          f"{t_cpu:.2f} s on the CPU", flush=True)
    # f32 sums in another order can flip a borderline line-search accept
    check(agree >= B - 4, f"{label}: exit flags agree on only {agree}/{B} lanes")
    check(float(rel.max()) <= 1e-4, f"{label}: true costs of converged lanes disagree")
    check(float(viol.max()) <= 1e-4, f"{label}: converged lanes violate constraints")


#: the distributed phase: the panda fleet over a process group for 1 step
#: from a cold start, without the kick (its noise depends on the rank)
DIST_STEPS = 1
DIST_TIMEOUT_S = 480
#: the reference-form phase: a warm panda solve at the rescue tier's shape,
#: and a pointRobot solve through the generic (cost/ineq-only) path
REF_BATCH = 512
GENERIC_BATCH = 64


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_steps(torch, runner, scen, steps):
    """``steps`` synchronized fleet steps from a cold start; returns (state,
    per-step metrics, per-step ms, per-step exit flags (steps, B))."""
    flags = []
    state = runner.init_state(scen)
    metrics, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = runner.step(state, scen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        flags.append(runner._last_program.carry["exitflag"].clone())  # the merged result's
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return state, metrics, ms, torch.stack(flags)


def state_diff(torch, a, b):
    """Largest |a - b| over the float fields of two fleet states; None when
    an integer field differs."""
    for k in ("step", "stall", "no_improve"):
        if not torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu()):
            return None
    return max(float((getattr(a, k).cpu() - getattr(b, k).cpu()).abs().max())
               for k in ("x", "z_warm", "lam"))


def panda_problem():
    from robot_mpcs_tpu_torch.config import Setup, panda_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem

    return MpcProblem(Setup.from_dict(panda_setup()))


def dist_worker(torch, outdir):
    """One rank of the two-rank panda fleet on one card (``--dist-rank OUTDIR``,
    rendezvous from the ``ROBOT_MPCS_*`` variables): gloo over CUDA tensors,
    since NCCL refuses two ranks on one card. Steps its shard, saves a W=2
    checkpoint from both ranks, writes its state, flags and metrics."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from robot_mpcs_tpu_torch import interop
    from robot_mpcs_tpu_torch.parallel import distributed
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.parallel.mesh import make_mesh
    from robot_mpcs_tpu_torch.utils.checkpoint import save_fleet_state

    check(distributed.initialize(backend="gloo", device="cuda:0"), "no rendezvous variables")
    mesh = make_mesh()
    problem = panda_problem()
    scenario = random_fleet_scenario(problem, BATCH, seed=0, **sampler("panda"))
    runner = FleetRunner(problem, BATCH, mesh=mesh, kick_scale=0.0)
    scen = runner.shard_scenario(scenario)
    distributed.barrier()  # both ranks set up: the timed steps start together
    with launches_by_batch(DIST_STEPS) as tally:
        state, metrics, ms, flags = run_steps(torch, runner, scen, DIST_STEPS)
    launches = kernel_launches(tally)
    save_fleet_state(os.path.join(outdir, "w2.npz"), state, extra={"world": 2}, mesh=mesh)
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), flags=flags.cpu().numpy(),
             **interop.state_to_numpy(state))
    print(json.dumps({"rank": mesh.rank, "batch": BATCH // mesh.world, "step_ms": ms,
                      "kernel_launches": launches, "metrics": metrics}), flush=True)
    with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({"metrics": metrics, "launches": launches}, f)
    distributed.shutdown()
    return 0


def distributed_phase(torch, problem, scenario):
    """The sharded fleet: NCCL at world 1 against the plain step, two gloo
    ranks on the one card against world-1 runners on their halves, and a
    W=2 checkpoint loaded at W=1. Returns each kernel's launches per
    path."""
    import shutil
    import tempfile

    from robot_mpcs_tpu_torch import interop
    from robot_mpcs_tpu_torch.parallel import distributed
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario
    from robot_mpcs_tpu_torch.parallel.mesh import make_mesh
    from robot_mpcs_tpu_torch.utils.checkpoint import load_fleet_state

    # 1. NCCL at world 1: the two all_reduces run, the rest is the plain step
    check(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                                 device="cuda:0"), "NCCL world 1 did not initialize")
    runner = FleetRunner(problem, BATCH, mesh=make_mesh(), kick_scale=0.0)
    with launches_by_batch(DIST_STEPS) as tally:
        s1, m1, ms1, f1 = run_steps(torch, runner, runner.shard_scenario(scenario), DIST_STEPS)
    nccl_launches = kernel_launches(tally)
    distributed.shutdown()
    plain = FleetRunner(problem, BATCH, device="cuda", kick_scale=0.0)
    s0, m0, ms0, f0 = run_steps(torch, plain, plain.to_device(scenario), DIST_STEPS)
    diff = state_diff(torch, s1, s0)
    print(json.dumps({"nccl_world1_step_ms": ms1, "plain_step_ms": ms0, "state_max_abs_diff": diff,
                      "kernel_launches": nccl_launches, "metrics": m1}), flush=True)
    check(diff is not None and diff <= 1e-6, f"NCCL world 1 state differs from the plain step: {diff}")
    check(m1 == m0, f"NCCL world 1 metrics differ from the plain step: {m1} vs {m0}")
    check(torch.equal(f1, f0), "NCCL world 1 exit flags differ from the plain step")

    # 2. two ranks on the one card, each a process of its own
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", tmp],
            env=dict(os.environ, ROBOT_MPCS_COORDINATOR=f"127.0.0.1:{port}",
                     ROBOT_MPCS_NUM_PROCESSES="2", ROBOT_MPCS_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=DIST_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-20:]:
            print(f"[rank {r}] {line}", flush=True)
        check(p.returncode == 0, f"rank {r} exited with {p.returncode}")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(ranks[0]["metrics"] == ranks[1]["metrics"], "the two ranks report other metrics")
    print("two ranks on one card: step times above share one card and its host, "
          "so no scaling is read from them", flush=True)
    half = BATCH // 2
    shards = []
    for r in range(2):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as data:
            got = {k: data[k] for k in data.files}
        rows = slice(r * half, (r + 1) * half)
        w1 = FleetRunner(problem, half, device="cuda", kick_scale=0.0)
        want, _, _, flags = run_steps(torch, w1, w1.to_device(FleetScenario(
            scenario.xinit[rows], scenario.params[rows])), DIST_STEPS)
        shard = interop.state_from_numpy(got, device="cuda")
        diff = state_diff(torch, shard, want)
        same_flags = bool(np.array_equal(got["flags"], flags.cpu().numpy()))
        print(json.dumps({"rank": r, "vs_world1_half_max_abs_diff": diff,
                          "flags_equal": same_flags}), flush=True)
        check(same_flags, f"rank {r}: exit flags differ from a world-1 runner on its half")
        check(diff is not None and diff <= 1e-6, f"rank {r}: state differs from its half: {diff}")
        shards.append(shard)

    # 3. the W=2 checkpoint resumes at W=1
    loaded, extra = load_fleet_state(os.path.join(tmp, "w2.npz"), problem=problem,
                                     batch_size=BATCH, device="cuda")
    check(extra == {"world": 2}, f"checkpoint extra {extra}")
    for k in ("x", "z_warm", "lam", "stall", "best_gdist", "no_improve"):
        whole = torch.cat([getattr(s, k) for s in shards])
        check(torch.equal(getattr(loaded, k), whole), f"W=2 checkpoint loaded at W=1: {k} differs")
    print("W=2 checkpoint loaded at W=1 equals the concatenated shards", flush=True)
    shutil.rmtree(tmp)
    kicked = kicked_ranks_run(torch)
    paths = {"nccl world 1": nccl_launches, **{f"rank {r} of 2": ranks[r]["launches"] for r in range(2)}}
    for path, counts in paths.items():
        for kernel in ("riccati_backward_packed", "fk_walk", "gn_assemble"):
            check(counts.get(kernel, 0) > 0, f"{path} never launched {kernel}")
    by_path = {k: {path: c[k] for path, c in paths.items() if c.get(k)} for k in kernel_counters()}
    by_path["riccati_backward_packed"].update(
        {f"kicked pointRobot rank {r} of 2 (eager)": kicked[r] for r in range(2)})
    return by_path


def kicked_ranks_run(torch):
    """The kicked two-rank run of ``tests/torch_distributed_worker.py``
    (``kick``: the pointRobot fleet at B=32 from its ``KICK_SEED``, 16 lanes
    a rank, the kick after 2 steps, eagerly) with both ranks on the card
    (gloo over CUDA tensors): the ranks report identical metrics at every
    step, lanes of both ranks are kicked, and rank r's kicked lanes carry the
    CPU's draw for (step, r) within 1e-5, not rank 1 - r's, with no noise on
    lanes not kicked. Returns each rank's structured-kernel launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(root, "tests", "torch_distributed_worker.py")
    check(os.path.exists(worker), f"{worker} is missing")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kick_ranks_")
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, tmp, "cuda:0", "kick"],
            env=dict(os.environ, ROBOT_MPCS_COORDINATOR=f"127.0.0.1:{port}", ROBOT_MPCS_NUM_PROCESSES="2",
                     ROBOT_MPCS_PROCESS_ID=str(r), PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=DIST_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-10:]:
            print(f"[kicked rank {r}] {line}", flush=True)
        check(p.returncode == 0, f"kicked rank {r} exited with {p.returncode}")
    ranks = []
    for r in range(2):
        with np.load(os.path.join(tmp, f"kick_rank{r}.npz")) as data:
            ranks.append({k: data[k] for k in data.files})
    shutil.rmtree(tmp)
    steps = len([k for k in ranks[0] if k.startswith("kick")])
    nx = int(ranks[0]["s0_x"].shape[-1])
    kicked, errs, off = [0, 0], [], []
    for t in range(steps):
        metrics = [{k: float(v) for k, v in rank.items() if k.startswith(f"m{t}_")} for rank in ranks]
        check(metrics[0] == metrics[1] and metrics[0], f"kicked ranks: other metrics at step {t}")
        check(all(np.isfinite(v) for v in metrics[0].values()), f"kicked ranks: non-finite metrics at step {t}")
        for r, rank in enumerate(ranks):
            z_shift, kick = rank[f"shift{t}"], rank[f"kick{t}"]
            got = rank[f"s{t}_z_warm"][..., nx:] - z_shift[..., nx:]
            check(bool((got[~kick] == 0).all()), f"kicked rank {r} step {t}: noise on lanes not kicked")
            if not kick.any():
                continue
            want = cpu_kick_noise(t, r, z_shift[..., nx:].shape).numpy()
            other = cpu_kick_noise(t, 1 - r, z_shift[..., nx:].shape).numpy()
            errs.append(float(np.abs(got[kick] - want[kick]).max()))
            off.append(float(np.abs(got[kick] - other[kick]).max()))
            kicked[r] += int(kick.sum())
    launches = [int(rank["launches"]) for rank in ranks]
    print(json.dumps({"kicked_ranks": {"steps": steps, "kicked_per_rank": kicked,
                                       "noise_vs_own_rank_draw": max(errs, default=None),
                                       "noise_vs_other_rank_draw_min": min(off, default=None),
                                       "launches": launches, "phase_s": time.perf_counter() - t0}}), flush=True)
    check(min(kicked) > 0, f"kicked ranks: lanes kicked per rank {kicked}")
    check(max(errs) <= 1e-5, f"kicked ranks: noise differs from the CPU draw of its rank by {max(errs):.3e}")
    check(min(off) > 1e-2, f"kicked ranks: a rank's noise is the other rank's draw ({min(off):.3e})")
    check(min(launches) > 0, f"kicked ranks: structured kernel launches {launches}")
    return launches


def hold_solves(torch, label, res_a, res_b, min_agree=4, rtol=1e-5, warm=False):
    """Path a against path b on the same inputs: flags agree on all but
    ``min_agree`` lanes, a's converged lanes feasible to 1e-4, true costs of
    lanes both converge within ``rtol``. ``warm``: costs are held only where
    both took the same number of inner iterations. A warm solve stops once
    its Newton step is below tol_stationarity (1e-3) and the f32 merit sees
    no gain, so two expansions equal to f32 rounding can stop at different
    points inside that tolerance; those lanes' costs are printed, not held."""
    B = res_a.exitflag.shape[0]
    fa, fb = res_a.exitflag.cpu(), res_b.exitflag.cpu()
    agree = int((fa == fb).sum())
    both = (fa == 1) & (fb == 1)
    same = res_a.iterations.cpu() == res_b.iterations.cpu()
    held = both & same if warm else both
    rel = (res_a.cost.cpu() - res_b.cost.cpu()).abs() / res_b.cost.cpu().abs().clamp(min=1e-6)
    viol = res_a.violation.cpu()[fa == 1]
    print(json.dumps({
        "compare": label, "batch": B, "flags_agree": agree, "converged_a": int((fa == 1).sum()),
        "converged_b": int((fb == 1).sum()), "converged_both": int(both.sum()),
        "held_lanes": int(held.sum()), "max_rel_cost_held": float(rel[held].max()),
        "max_rel_cost_both": float(rel[both].max()), "max_violation_converged": float(viol.max()),
    }), flush=True)
    check(bool(held.any()), f"{label}: no lane to hold")
    check(agree >= B - min_agree, f"{label}: flags agree on only {agree}/{B} lanes")
    check(float(rel[held].max()) <= rtol, f"{label}: true costs of converged lanes disagree")
    check(float(viol.max()) <= 1e-4, f"{label}: converged lanes violate constraints")


def reference_form_phase(torch, rp, problem, state, scen):
    """The JAX package's reference-form solver API on the card: at a warm
    panda iterate of the rescue shape, the stacked ``values`` Gauss-Newton
    expansion against the split path's, then the two solves; a pointRobot
    solve through the generic (cost/ineq-only, exact-Hessian) path. Returns
    the structured kernel's launches per path."""
    from robot_mpcs_tpu_torch.config import Setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

    def reference_solver(prob, generic=False, device="cuda"):
        """The reference form, pinned at stage 0 like the split path."""
        stage, w_lb, w_ub = prob.solver_callbacks()
        if generic:
            stage = stage._replace(values=None, weights=None)
        d = prob.dims
        return build_solver(stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=prob.n_con,
                            n_res=prob.n_res, n_bar=prob.n_bar, w_lb=w_lb, w_ub=w_ub,
                            cfg=prob.setup.solver, pinned_rows=prob.reference_constraint_rows()[1],
                            device=device)

    def timed(solve, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    B = REF_BATCH
    perm = torch.as_tensor(problem.reference_constraint_rows()[0], device=state.lam.device)
    x, params, z, lam = state.x[:B], scen.params[:B], state.z_warm[:B], state.lam[:B]
    split_solve, values_solve = problem.build_solver(device="cuda"), reference_solver(problem)
    # the expansions at the warm iterate: the same Gauss-Newton model
    nx = problem.dims.nx
    mu = torch.full((B,), 100.0, device="cuda")
    blocks = [f._internals["stage_expansion_blocks"](z[..., :nx], z[..., nx:], params, lam_f, mu)
              for f, lam_f in ((values_solve, lam[..., perm]), (split_solve, lam))]
    err = max(float(((a - b).abs() / (1.0 + b.abs())).max()) for a, b in zip(*blocks))
    print(json.dumps({"expansion_blocks_values_vs_split": B, "max_rel_err": err}), flush=True)
    check(err <= 1e-4, f"values-path expansion differs from the split path's: {err}")
    res_split, split_ms = timed(split_solve, x, params, z, lam)
    rp.riccati_backward_packed.launches = 0
    res_values, values_ms = timed(values_solve, x, params, z, lam[..., perm])
    values_launches = rp.riccati_backward_packed.launches
    print(json.dumps({"values_solve": B, "values_ms": values_ms, "split_ms": split_ms,
                      "kernel_launches": values_launches}), flush=True)
    check(values_launches > 0, "the values-path solve never launched the structured kernel")
    hold_solves(torch, "panda values path vs split path (warm)", res_values, res_split,
                min_agree=B * 3 // 100, warm=True)

    pr = MpcProblem(Setup.from_dict(point_robot_setup()))
    Bg = GENERIC_BATCH
    sc = random_fleet_scenario(pr, Bg, seed=0, **sampler("pointRobot"))
    d = pr.dims
    z0 = torch.zeros((Bg, d.N, d.nz))
    z0[:, :, : d.nx] = sc.xinit[:, None, :]
    cold = (sc.xinit, sc.params, z0, torch.zeros((Bg, d.N, pr.n_con)))
    rp.riccati_backward_packed.launches = 0
    res_gen, gen_ms = timed(reference_solver(pr, generic=True), *cold)
    generic_launches = rp.riccati_backward_packed.launches
    check(generic_launches > 0, "the generic-path solve never launched the structured kernel")
    hold_solves(torch, "pointRobot generic path, card vs CPU (cold)", res_gen,
                reference_solver(pr, generic=True, device="cpu")(*cold))
    # the exact-Hessian model leaves lanes budget-bound (flag 0) that the
    # Gauss-Newton paths converge, in the JAX package too: against the
    # values path its flags are printed, and the optimum of lanes both
    # converge is held at tests/test_solver.py's generic-vs-structured bar
    fleet = FleetRunner(pr, Bg, device="cuda", kick_scale=0.0)
    warm, _, _, _ = run_steps(torch, fleet, fleet.to_device(sc), 2)
    args = (warm.x, fleet.to_device(sc).params, warm.z_warm, warm.lam)
    res_gen_w, gen_w_ms = timed(reference_solver(pr, generic=True), *args)
    res_val_w, val_w_ms = timed(reference_solver(pr), *args)
    print(json.dumps({"generic_solve": Bg, "cold_ms": gen_ms, "warm_ms": gen_w_ms,
                      "values_warm_ms": val_w_ms, "kernel_launches_cold": generic_launches}),
          flush=True)
    hold_solves(torch, "pointRobot generic path vs values path (warm)", res_gen_w, res_val_w,
                min_agree=Bg, rtol=1e-4)
    return {"values solve (panda, B=512)": values_launches,
            "generic solve (pointRobot, B=64, cold)": generic_launches}


#: the port's examples (``robot_mpcs_tpu_torch.examples``): module, the kernel
#: their robot's solve launches, and the step at which the JAX package's
#: example reached its goal on a CPU (the JAX package, CPU backend, full
#: episodes: the yardstick, not a bar; the boxer loops are chaotic)
EXAMPLES = {
    "pointRobot": ("point_robot_example", "riccati_backward_packed", 66),
    "panda": ("panda_example", "riccati_backward_packed", 24),
    "boxer": ("boxer_example", "riccati_backward_batched", 44),
    "boxer-global": ("boxer_example_global", "riccati_backward_batched", 71),
    "supermarket": ("boxer_example_supermarket", "riccati_backward_batched", 45),
}


#: examples run from more than their own start: the boxer example's solves
#: are budget-bound (exit flag 0 on most) and its arrival step is chaotic
#: in f32 (a rounding-level change of its rows or a 1e-3 change of its
#: start moves it from ~30 to ~280 steps, or sends the robot off: 3 of 31
#: such runs on the card and on the CPU; ``tests/
#: torch_example_sensitivity.py``, ``PERF.md`` §7): it runs from its own
#: start and from 6 starts offset by ``START_OFFSET`` (seeds 1-6), and must
#: arrive within its limit from most (4 of 7)
EXAMPLE_STARTS = {"boxer": 7}
START_OFFSET = 1e-3


def offset_start(example, seed, scale=START_OFFSET):
    """Start ``example``'s episodes at its own start plus ``scale`` times a
    normal draw of ``seed`` in every state entry (seed 0: its own start)."""
    base = example.initial_state()
    if seed:
        offset = scale * np.random.default_rng(seed).normal(size=base.shape)
        example.initial_state = lambda: base + offset
    return example


def examples_phase(torch):
    """Each example of the port on the card for its full episode (its
    module's ``STEPS``, the JAX example's limit), through ``make_example``
    and ``run`` as its ``main`` runs them, each read with its own launch
    counts: it must reach its goal (from most of its starts where it has
    several, ``EXAMPLE_STARTS``), launch its robot's kernel, and launch only
    at B=1, the split expansion's two kernels among them. Returns each
    kernel's launches per example run."""
    import importlib

    counters = kernel_counters()
    by_path = {name: {} for name in counters}
    for name, (module, kernel, jax_step) in EXAMPLES.items():
        mod = importlib.import_module(f"robot_mpcs_tpu_torch.examples.{module}")
        starts = EXAMPLE_STARTS.get(name, 1)
        arrivals = []
        for seed in range(starts):
            t = time.perf_counter()
            example = offset_start(mod.make_example("cuda"), seed)
            setup_s = time.perf_counter() - t
            for fn in counters.values():
                fn.launches = 0
            with launches_by_batch(1) as tally:
                reached = example.run(mod.STEPS)
            launches = {k: fn.launches for k, fn in counters.items()}
            solves = len(example.solve_ms)
            arrivals.append(example.reached_at if reached else None)
            print(json.dumps({
                "example": name, "device": "cuda", "start_seed": seed, "reached": reached,
                "steps_to_goal": example.reached_at, "jax_cpu_steps_to_goal": jax_step, "step_limit": mod.STEPS,
                "set_up_s": setup_s, "flags": collections.Counter(example.exitflags), **percentiles(example.solve_ms),
                "fsd_ms_per_step_p50": float(np.median(example.fsd_ms)) if hasattr(example, "fsd_ms") else None,
                "astar_ms": getattr(example, "astar_ms", None),
                "waypoints": len(example.path) if hasattr(example, "path") else None,
                "launches_per_solve": {k: n / solves for k, n in launches.items() if n},
            }), flush=True)
            for k in (kernel, "fk_walk", "gn_assemble"):
                check(launches[k] > 0, f"example {name} never launched {k}")
            check(all(B == 1 for _, B in tally), f"example {name} launched at B != 1: {dict(tally)}")
            label = f"example {name}" + (f" (start {seed})" if starts > 1 else "")
            for k, n in launches.items():
                if n:
                    by_path[k][label] = n
        arrived = sum(a is not None for a in arrivals)
        check(2 * arrived > starts, f"example {name} reached its goal in {mod.STEPS} steps from {arrived} of "
                                    f"{starts} starts: {arrivals}")
    return by_path


#: the artifacts ``deploy_phase`` writes with ``make_solver``, and each one's
#: kernel library (the mobile panda's config is written from
#: ``mobile_panda_setup``: it has no file in the repo)
DEPLOY = {"panda": "riccati_packed", "boxer": "riccati_batched", "mobilePanda": "riccati_batched"}
DEPLOY_TIMEOUT_S = 300


def deploy_scene(kind, planner):
    """The first solve of the ``kind`` example's scene (goal, obstacles,
    limits; boxer's half-planes from one lidar scan) on ``planner``, from the
    example's initial state. Returns (action, exit flag, inner iterations)."""
    from robot_mpcs_tpu_torch.examples.boxer_example import simulate_lidar
    from robot_mpcs_tpu_torch.perception.free_space_decomposition import free_space_halfplanes

    nx = planner._dims.nx
    x0 = np.zeros(nx, np.float32)
    planner.setConstraintAvoidance()
    if kind == "panda":
        x0[:7] = [0.0, -0.8, 0.0, -1.5, 0.0, 1.0, 0.0]
        lim = planner._problem.kin.joint_limits
        planner.setGoalReaching([0.4, 0.3, 0.6])
        planner.setRadialConstraints([Sphere([0.6, -0.3, 0.5], 0.2)], 0.1)
        planner.setSelfCollisionAvoidanceConstraints(0.1)
        planner.setJointLimits((lim[:, 0], lim[:, 1]))
        planner.setInputLimits(([-10.0] * 7, [10.0] * 7))
        obs = (x0[:7], x0[7:])
    elif kind == "mobilePanda":  # the arm as panda's scene, on a base at the origin
        x0[3:10] = [0.0, -0.8, 0.0, -1.5, 0.0, 1.0, 0.0]
        lim = planner._problem.kin.joint_limits
        planner.setGoalReaching([1.0, 0.5, 0.6])
        planner.setRadialConstraints([Sphere([4.0, 4.0, 0.5], 0.2)], 0.1)
        planner.setSelfCollisionAvoidanceConstraints(0.1)
        planner.setJointLimits(([-10.0] * 3 + list(lim[:, 0]), [10.0] * 3 + list(lim[:, 1])))
        planner.setInputLimits(([-10.0] * 9, [10.0] * 9))
        obs = (x0[:10], x0[10:20], x0[20:])
    else:
        import torch

        cloud = torch.from_numpy(simulate_lidar(x0[:3], [Sphere([4.0, -1.5, 0.0], 1.0),
                                                        Sphere([2.4, -0.7, 0.0], 0.3)]))
        planes = free_space_halfplanes(cloud.expand(planner._N, -1, -1), torch.zeros(planner._N, 3),
                                       number_constraints=planner._dims.n_obst, max_radius=5.0)
        planner.setGoalReaching([7.2, -2.2])
        planner.setLinearConstraints(planes.numpy(), 0.6)
        planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
        planner.setInputLimits(([-10.0] * 2, [10.0] * 2))
        obs = (x0[:3], x0[3:6], x0[6:])
    planner.concretize()
    action, _, flag = planner.computeAction(*obs)
    return np.asarray(action), int(flag), int(planner._last_info.iterations)


def deploy_child(torch, solver_dir, kind, out):
    """A fresh process that loads the artifact ``solver_dir`` through
    ``MPCPlanner.from_solver_dir(..., device="cuda")`` and solves ``deploy_scene``
    once (``--deploy-child``). ``ROBOT_MPCS_DEPLOY_NVCC=none``: ``nvcc`` must
    be unreachable (the caller strips it from ``PATH`` and points
    ``CUDA_HOME`` nowhere; ``_build.nvcc`` raises here too). Writes the
    solve, the kernel libraries loaded, any warnings, and the seconds of the
    CUDA context's start, of the planner's construction, of its first solve
    and of a second solve of the same state."""
    import warnings

    t0 = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.planner import MPCPlanner

    block_nvcc()
    mpc = MpcProblem.from_solver_dir(solver_dir).setup.mpc
    times = [time.perf_counter()]
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    times.append(time.perf_counter())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        planner = MPCPlanner.from_solver_dir(
            mpc.model_name, os.path.dirname(solver_dir), device="cuda", n=mpc.n,
            time_step=mpc.time_step, time_horizon=mpc.time_horizon, slack=mpc.slack)
        times.append(time.perf_counter())
        action, flag, iterations = deploy_scene(kind, planner)
        times.append(time.perf_counter())
        planner.solve(planner._xinit.copy())
        times.append(time.perf_counter())
    cuda_init_s, construct_s, first_s, second_s = np.diff(times).tolist()
    with open(out, "w") as f:
        json.dump({"action": action.tolist(), "flag": flag, "iterations": iterations,
                   "libraries": {stem: lib._name for (stem, _), lib in _build._libs.items()},
                   "warnings": [str(w.message) for w in caught], "cuda_init_s": cuda_init_s,
                   "construct_s": construct_s,
                   "first_solve_s": first_s, "second_solve_s": second_s,
                   "process_s": time.perf_counter() - t0}, f)
    return 0


def block_nvcc():
    """In a child started with ``no_nvcc_env``: check that ``nvcc`` is not
    on ``PATH`` and make ``_build.nvcc`` raise."""
    import shutil

    from robot_mpcs_tpu_torch.ops import _build

    if os.environ.get("ROBOT_MPCS_DEPLOY_NVCC") == "none":
        def unreachable():
            raise SmokeFailure("nvcc was called")

        check(shutil.which("nvcc") is None, "nvcc is on PATH")
        _build.nvcc = unreachable


def no_nvcc_env(tmp, cache):
    """A child's environment with the kernel cache ``cache`` and ``nvcc``
    unreachable: not on ``PATH``, ``CUDA_HOME`` nowhere, ``block_nvcc`` on."""
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    return dict(os.environ, ROBOT_MPCS_TPU_CACHE=cache, PATH=os.pathsep.join(path),
                CUDA_HOME=os.path.join(tmp, "no_cuda_home"), ROBOT_MPCS_DEPLOY_NVCC="none")


def run_deploy_child(solver_dir, kind, tmp, label, nvcc):
    """Run ``deploy_child`` in a process of its own with an empty kernel
    cache; ``nvcc=False`` strips it from the process. Returns its record
    and the cache directory."""
    cache = os.path.join(tmp, f"cache_{label}")
    env = dict(os.environ, ROBOT_MPCS_TPU_CACHE=cache) if nvcc else no_nvcc_env(tmp, cache)
    out = os.path.join(tmp, f"{label}.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--deploy-child", solver_dir, kind, out],
                          env=env, capture_output=True, text=True, timeout=DEPLOY_TIMEOUT_S)
    for line in (proc.stdout + proc.stderr).splitlines()[-10:]:
        print(f"[{label}] {line}", flush=True)
    check(proc.returncode == 0, f"deploy child {label} exited with {proc.returncode}")
    with open(out) as f:
        return json.load(f), cache


def artifact_libraries(path, stem):
    """What a process loads from an artifact at ``path``: its Riccati
    kernel, the split expansion's two kernels and the WHILE-node library,
    {stem: absolute path}."""
    return {name: os.path.abspath(os.path.join(path, f"lib{name}.so"))
            for name in (stem, "fk_walk", "gn_assemble", "graph_cond")}


def deploy_check(kind, tmp, altered=True):
    """Steps 1-3 of ``deploy_phase`` for the ``kind`` artifact, in ``tmp``
    (step 3 with ``altered``); returns its record."""
    import yaml

    from robot_mpcs_tpu_torch.examples import make_solver
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.planner import MPCPlanner

    stem = DEPLOY[kind]
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    config = os.path.join(root, "examples", "config", f"{kind}Mpc.yaml")
    if kind == "mobilePanda":
        config = os.path.join(tmp, "mobilePandaMpc.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(mobile_panda_setup(), f)
    path, first_s = make_solver.generate(config, os.path.join(tmp, "solvers"), "cuda")
    make_s = time.perf_counter() - t
    check(os.path.isfile(os.path.join(path, f"lib{stem}.so")), f"{kind}: no exported library")
    problem = MpcProblem.from_solver_dir(path)
    parent = deploy_scene(kind, MPCPlanner(problem, device="cuda"))
    loaded, cache = run_deploy_child(path, kind, tmp, f"{kind}_export", nvcc=False)
    check(loaded["libraries"] == artifact_libraries(path, stem),
          f"{kind}: the child loaded {loaded['libraries']}, not the artifact's libraries")
    check(not os.path.exists(cache) or not os.listdir(cache), f"{kind}: the child built a kernel")
    rec = {"deploy": kind, "make_solver_s": make_s, "make_solver_first_solve_s": first_s}
    children = [("export", loaded)]
    if altered:
        children.append(("altered", altered_child(kind, path, stem, tmp)))
    for label, child in children:
        diff = float(np.abs(np.asarray(child["action"]) - parent[0]).max())
        bar = solve_bar(problem, parent[2], child["iterations"])
        rec[label] = {"action_diff": diff, "bar": bar, "flags": (parent[1], child["flag"]),
                      "iterations": (parent[2], child["iterations"]),
                      **{k: child[k] for k in ("cuda_init_s", "construct_s", "first_solve_s",
                                               "second_solve_s", "process_s")}}
        check(child["flag"] == parent[1] and parent[1] >= 0,
              f"{kind} {label}: exit flags {(parent[1], child['flag'])} (parent, child)")
        check(diff <= bar, f"{kind} {label}: the child's action differs by {diff:.3e} > {bar:.0e}")
    print(json.dumps(rec), flush=True)
    return rec


def altered_child(kind, path, stem, tmp):
    """The artifact at ``path`` with an altered fingerprint, loaded by a
    fresh process: declined with a warning, its kernel rebuilt from the
    sources into an empty cache. Returns the child's record."""
    import shutil

    import yaml

    with open(os.path.join(path, "export_meta.yaml")) as f:
        meta = yaml.safe_load(f)
    altered = os.path.join(tmp, "altered", os.path.basename(path))
    shutil.copytree(path, altered)
    meta["torch"] = "0.0.0"
    with open(os.path.join(altered, "export_meta.yaml"), "w") as f:
        yaml.safe_dump(meta, f)
    rebuilt, cache = run_deploy_child(altered, kind, tmp, f"{kind}_altered", nvcc=True)
    check(any("declining the exported kernels" in w for w in rebuilt["warnings"]),
          f"{kind}: the altered artifact was not declined with a warning: {rebuilt['warnings']}")
    check(os.path.dirname(rebuilt["libraries"].get(stem, "")) == cache,
          f"{kind}: the kernel was not rebuilt from the sources: {rebuilt['libraries']}")
    return rebuilt


def ros_ticks(device, ticks=8):
    """``MpcRosLogic`` on ``ros_bridge/config/boxer_mpc_config.yaml`` for the
    ticks of ``tests/test_ros_bridge.py`` on ``device``; returns the last
    command and each tick's wall ms."""
    from robot_mpcs_tpu_torch.config import load_setup
    from robot_mpcs_tpu_torch.ros_bridge.mpc_planner_node import MpcRosLogic

    root = os.path.dirname(os.path.abspath(__file__))
    logic = MpcRosLogic(load_setup(os.path.join(root, "ros_bridge", "config", "boxer_mpc_config.yaml")),
                        device=device)
    logic.update_goal([3.0, 0.0])
    logic.update_obstacles([Sphere([10.0, 10.0, 0.0], 0.3)], r_body=0.5)
    logic.planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
    logic.planner.setInputLimits(([-5.0, -5.0], [5.0, 5.0]))
    logic.update_odometry(0.0, 0.0, 0.0, 0.0, 0.0)
    v, tick_ms = np.zeros(2), []
    for step in range(ticks):
        t = time.perf_counter()
        v = np.asarray(logic.compute_velocity_command())
        tick_ms.append((time.perf_counter() - t) * 1e3)
        logic.update_odometry(step * 0.05, 0.0, 0.0, v[0], v[1])
    return v, tick_ms


def deploy_phase(torch):
    """The solver artifact and the ROS node on the card:

    1. ``make_solver`` writes the panda, boxer and mobile-panda artifacts
       with their kernel libraries (each compiled for its robot's shape)
       into a temporary directory;
    2. a fresh process with ``nvcc`` unreachable loads each through
       ``MPCPlanner.from_solver_dir`` and solves the example's first step:
       the artifact's library is the one loaded, nothing is built, and the
       action equals this process's solve of the same inputs within
       ``solve_bar``;
    3. (panda and boxer) an artifact whose ``export_meta.yaml`` was altered
       is declined with a warning and the kernel is built from the sources
       (``nvcc`` into an empty cache), the action again within ``solve_bar``;
    4. ``MpcRosLogic`` runs ``ros_ticks`` on the card and ends with a forward
       velocity above 0.05.

    Returns each kernel's launches in the ROS node's ticks."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    for kind in DEPLOY:  # the mobile panda: export only (its own shape's library)
        deploy_check(kind, tmp, altered=kind != "mobilePanda")
    shutil.rmtree(tmp)

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    v, tick_ms = ros_ticks("cuda")
    launches = {k: fn.launches for k, fn in counters.items()}
    print(json.dumps({"ros_node": "boxer_mpc_config.yaml", "ticks": len(tick_ms), "final_command": v.tolist(),
                      "tick_ms": tick_ms, "launches": launches}), flush=True)
    check(v[0] > 0.05, f"ROS node: forward velocity {v[0]:.3f} after {len(tick_ms)} ticks")
    for k in ("riccati_backward_batched", "fk_walk", "gn_assemble"):
        check(launches[k] > 0, f"ROS node never launched {k}")
    return {k: {"ros node": n} for k, n in launches.items() if n}


#: the graph phase: each program (a fleet step, a planner solve) captured
#: whole, held to its eager run from one state: the panda fleet, boxer's and
#: the mobile panda's, the kick fleet, a mixed group, the planners' B=1
#: solves, and the fleet artifact's child (``--fleet-child``)
GRAPH_STEPS = 6
GRAPH_SIDE_STEPS = 2
GRAPH_SIDE_BATCH = 1024
GRAPH_KICK_STEPS = 4
GRAPH_GROUP_STEPS = 2
GRAPH_PLANNER_SOLVES = 20
FLEET_CHILD_TIMEOUT_S = 300


@contextlib.contextmanager
def program_calls():
    """Record each top-level program call (``UnitProgram.call``, a fleet step
    or a solve) made in the block: (program, host reads inside the call,
    graph replays it made, its driver). Yields the list it fills."""
    from robot_mpcs_tpu_torch.solver import units

    calls, call = [], units.UnitProgram.call

    def recorded(self, driver):
        if units._mode is not None:  # nested: part of the enclosing call
            return call(self, driver)
        replays = units.replays
        with host_reads() as reads:
            call(self, driver)
        calls.append((self, reads[0], units.replays - replays, driver))

    units.UnitProgram.call = recorded
    try:
        yield calls
    finally:
        units.UnitProgram.call = call


def fleet_trace(torch, runner, scen, steps, eager):
    """``steps`` synchronized steps of ``runner`` (a ``FleetRunner`` or a
    ``FleetGroup``) from the scenario's initial state, each step one CUDA
    graph replay after the first or, with ``eager``, its units run eagerly
    (the solver's private switch). Returns per step the state and the merged
    exit flags of every class (on the CPU), the metrics, the wall ms, the
    host reads in the step and the replays; the
    launches by (kernel, B), the peak memory allocated and reserved, and the
    programs' capture stats."""
    from robot_mpcs_tpu_torch.parallel import FleetGroup
    from robot_mpcs_tpu_torch.solver import units

    group = isinstance(runner, FleetGroup)
    runners = runner.runners if group else {"": runner}
    state = runner.init_states(scen) if group else runner.init_state(scen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    out = {k: [] for k in ("states", "flags", "metrics", "ms", "host_reads", "replays")}
    with (units._eager() if eager else contextlib.nullcontext()), launches_by_batch(steps) as tally:
        for _ in range(steps):
            torch.cuda.synchronize()
            with program_calls() as calls, host_reads() as reads:
                t = time.perf_counter()
                state, m = runner.step(state, scen)
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t) * 1e3)
            out["host_reads"].append(reads[0])
            out["replays"].append(sum(c[2] for c in calls))
            states = state if group else {"": state}
            out["states"].append({f"{c}{k}": v.cpu() for c, st in states.items() for k, v in st._asdict().items()})
            out["flags"].append(torch.cat([r._last_program.carry["exitflag"].cpu() for r in runners.values()]))
            metrics = m.per_class if group else {"": m}
            out["metrics"].append({f"{c}{k}": float(v) for c, mc in metrics.items() for k, v in mc._asdict().items()})
    out.update(launches=dict(tally), peak_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
               peak_reserved_mb=torch.cuda.max_memory_reserved() / 2**20,
               reserved_growth_mb=(torch.cuda.memory_reserved() - reserved) / 2**20, state=state,
               stats={c: r._last_program.stats for c, r in runners.items()})
    return out


def hold_traces(torch, label, eager, graphed):
    """The graphed run against the eager one, step by step: states, exit
    flags and metrics bit for bit, else within 1e-6 with every flag equal;
    launches by (kernel, B) equal; no host read inside a graphed step after
    the first (its warm-up and capture). Returns the largest state difference."""
    worst, bitwise = 0.0, True
    for i, (se, sg) in enumerate(zip(eager["states"], graphed["states"])):
        check(torch.equal(eager["flags"][i], graphed["flags"][i]), f"{label}: exit flags differ at step {i}")
        for k in se:
            if not torch.equal(se[k], sg[k]):
                bitwise = False
                check(se[k].dtype.is_floating_point, f"{label}: {k} differs at step {i}")
                worst = max(worst, float((se[k] - sg[k]).abs().max()))
        me, mg = eager["metrics"][i], graphed["metrics"][i]
        if me != mg:
            bitwise = False
            worst = max(worst, max(abs(me[k] - mg[k]) for k in me))
    check(worst <= 1e-6, f"{label}: graphed and eager runs differ by {worst:.3e}")
    check(eager["launches"] == graphed["launches"],
          f"{label}: launches {graphed['launches']} graphed, {eager['launches']} eager")
    check(not any(graphed["host_reads"][1:]), f"{label}: host reads in graphed steps {graphed['host_reads']}")
    print(json.dumps({"graphs_vs_eager": label, "bit_for_bit": bitwise, "max_abs_diff": worst,
                      "eager_step_ms": eager["ms"], "graphed_step_ms": graphed["ms"],
                      "eager_host_reads": eager["host_reads"], "graphed_host_reads": graphed["host_reads"],
                      "graphed_replays": graphed["replays"],
                      "eager_peak_allocated_mb": eager["peak_allocated_mb"],
                      "graphed_peak_allocated_mb": graphed["peak_allocated_mb"],
                      "eager_peak_reserved_mb": eager["peak_reserved_mb"],
                      "graphed_peak_reserved_mb": graphed["peak_reserved_mb"],
                      "eager_reserved_growth_mb": eager["reserved_growth_mb"],
                      "graphed_reserved_growth_mb": graphed["reserved_growth_mb"],
                      "programs": graphed["stats"], "last_metrics": graphed["metrics"][-1]}), flush=True)
    return worst


def kernel_counters():
    """Every kernel wrapper of the port by its kernels-line name."""
    from robot_mpcs_tpu_torch.ops import fk_walk, gn_assemble, riccati_batched, riccati_packed

    return {"riccati_backward_packed": riccati_packed.riccati_backward_packed,
            "riccati_backward_batched": riccati_batched.riccati_backward_batched,
            "fk_walk": fk_walk.fk_walk, "gn_assemble": gn_assemble.gn_assemble}


def kernel_launches(tally):
    """{kernel: launches} of a tally by (kernel, B)."""
    out = collections.Counter()
    for (name, _), n in tally.items():
        out[name] += n
    return dict(out)


def graph_fleet(torch, label, make, scenario, steps):
    """One fleet (``make()``: a runner or a group), eager then graphed from
    the same scenario (each its own, so the graphed one captures at its
    first step); held by ``hold_traces``. Returns (graphed trace, graphed
    runner, scenario on the card)."""
    import gc

    traces = {}
    for mode in ("eager", "graphed"):
        runner = make()
        scen = runner.to_device(scenario)
        traces[mode] = fleet_trace(torch, runner, scen, steps, eager=mode == "eager")
        if mode == "eager":
            del runner
            gc.collect()
            torch.cuda.empty_cache()
    hold_traces(torch, label, traces["eager"], traces["graphed"])
    return traces["graphed"], runner, scen


def program_record(torch, label, step, steady_ms, kernel_names=()):
    """Where a graphed program's call (``step``: a fleet step or a solve,
    one replay) spends its time, beside the card: the device's busy time and
    events from one profiled call of the same work run eagerly (the same
    kernels, ``profile_windows``); the graph's span on the device, CUDA
    events around three graphed calls (median); and the idle share without
    the profiler, 1 - busy / ``steady_ms`` (the median unprofiled wall of
    the graphed call). Prints and returns the record."""
    _, total = profile_windows(torch, {label: step}, list(kernel_names))
    spans = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    busy = total["device_busy_ms"]
    rec = {"program": label, "steady_ms": steady_ms, "graph_span_ms": float(np.median(spans)),
           "eager_profiled_ms": total["wall_ms"], "device_events": total["device_events"],
           "device_busy_ms": busy, "idle_share_unprofiled": 1.0 - busy / steady_ms if total["device_events"] else None,
           "card": card_label(), **{f"{k}_ms": total[f"{k}_ms"] for k in kernel_names}}
    print(json.dumps(rec), flush=True)
    return rec


def card_label():
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def fleet_child(torch, artifact, out):
    """A fresh process (``--fleet-child``) that steps the bench's panda fleet
    once from ``FleetRunner(..., artifact_dir=artifact)`` with ``nvcc``
    unreachable (``ROBOT_MPCS_DEPLOY_NVCC=none``); writes its state, the
    libraries loaded, any warnings and the seconds to the first step."""
    import warnings

    t0 = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from robot_mpcs_tpu_torch import bench as tbench
    from robot_mpcs_tpu_torch import interop
    from robot_mpcs_tpu_torch.ops import _build
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner

    block_nvcc()
    problem, _ = tbench._load_problem("panda")
    times = [time.perf_counter()]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner = FleetRunner(problem, BATCH, device="cuda", artifact_dir=artifact)
        scen = runner.to_device(tbench._scenario_for(problem, BATCH, "panda"))
        state = runner.init_state(scen)
        times.append(time.perf_counter())
        state, metrics = runner.step(state, scen)
        torch.cuda.synchronize()
        times.append(time.perf_counter())
    np.savez(out + ".npz", **interop.state_to_numpy(state))
    with open(out, "w") as f:
        json.dump({"libraries": {stem: lib._name for (stem, _), lib in _build._libs.items()},
                   "warnings": [str(w.message) for w in caught],
                   "metrics": {k: float(v) for k, v in metrics._asdict().items()},
                   "import_s": times[0] - t0, "construct_s": times[1] - times[0],
                   "first_step_s": times[2] - times[1], "to_first_step_s": times[2] - t0}, f)
    return 0


def fleet_artifact_check(torch, runner, first):
    """``export_step`` of the graphed panda runner, then ``fleet_child`` with
    ``nvcc`` unreachable: it loads the exported library, builds nothing, and
    its first step equals ``first`` (this process's graphed first step) bit
    for bit. Returns the child's record."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    artifact = os.path.join(tmp, "fleet")
    t = time.perf_counter()
    meta = runner.export_step(artifact)
    export_s = time.perf_counter() - t
    stem = runner._solve.riccati_kernel
    check(os.path.isfile(os.path.join(artifact, f"lib{stem}.so")), "export_step wrote no library")
    cache = os.path.join(tmp, "cache")
    out = os.path.join(tmp, "child.json")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--fleet-child", artifact, out],
                          env=no_nvcc_env(tmp, cache), capture_output=True, text=True,
                          timeout=FLEET_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t
    for line in (proc.stdout + proc.stderr).splitlines()[-10:]:
        print(f"[fleet child] {line}", flush=True)
    check(proc.returncode == 0, f"fleet child exited with {proc.returncode}")
    with open(out) as f:
        rec = json.load(f)
    with np.load(out + ".npz") as data:
        got = {k: data[k] for k in data.files}
    check(rec["libraries"] == artifact_libraries(artifact, stem),
          f"the fleet child loaded {rec['libraries']}, not the artifact's libraries")
    check(not os.path.exists(cache) or not os.listdir(cache), "the fleet child built a kernel")
    check(not rec["warnings"] or not any("declining" in w for w in rec["warnings"]),
          f"the fleet child declined the export: {rec['warnings']}")
    same = all(np.array_equal(got[k], first[k].numpy()) for k in ("x", "z_warm", "lam", "stall",
                                                                  "best_gdist", "no_improve"))
    print(json.dumps({"fleet_artifact": os.path.basename(meta), "export_s": export_s, "child_process_s": child_s,
                      "first_step_equal": same, **rec, "libraries": list(rec["libraries"])}), flush=True)
    check(same, "the fleet child's first step differs from this process's")
    shutil.rmtree(tmp)
    return rec


def graph_phase(torch, rp, rb):
    """Each program captured whole as one CUDA graph, its loops WHILE nodes,
    against the same units run eagerly (``units._eager``), at the main
    paths' widths:

    1. the bench's panda fleet (B=4096, default rescue tier and kick) for
       ``GRAPH_STEPS`` steps: states, exit flags and metrics bit for bit
       (else within 1e-6 with flags equal), launches by (kernel, B) equal and
       printed a step (16 at 4096 + 50 at 512 where every loop runs to its
       budget), no host read in a graphed step after the first, one replay
       a step; wall ms, peak memory, the graph's nodes and WHILE bodies,
       warm-up, capture and instantiate seconds, then one profiled graphed
       step (device busy, idle share without the profiler);
    2. the bench's boxer fleet and the mobile panda fleet at B=1024 for
       ``GRAPH_SIDE_STEPS`` steps each, the same checks (the general kernel);
    3. the kick fleet (the bench's panda scenario at B=1024, ``kick_after``
       = 2) for ``GRAPH_KICK_STEPS`` steps, so that kicked lanes go through
       the graph, and the mixed ``FleetGroup`` (``GROUP_SIZES``) for
       ``GRAPH_GROUP_STEPS`` steps: three replays a group step;
    4. the panda and boxer planners at B=1, ``GRAPH_PLANNER_SOLVES`` solves
       of one closed loop each: actions and flags equal, one replay and no
       host read inside each graphed solve after the first, p50 / p90 ms of
       both, one profiled solve;
    5. ``FleetRunner.export_step`` of the graphed panda runner, then a child
       process without ``nvcc`` that steps from ``artifact_dir``
       (``fleet_artifact_check``).

    Returns each kernel's launches in the graphed panda fleet, the kick
    fleet and the group."""
    from robot_mpcs_tpu_torch import bench as tbench
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel import FleetGroup, mixed_fleet_scenarios
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.solver import units

    def fleet(problem, batch, **kw):
        return lambda: FleetRunner(problem, batch, device="cuda", **kw)

    def steady(trace):
        return float(np.median(trace["ms"][1:]))

    t0 = time.perf_counter()
    problem, _ = tbench._load_problem("panda")
    scenario = tbench._scenario_for(problem, BATCH, "panda")
    trace, runner, scen = graph_fleet(torch, "panda fleet B=4096", fleet(problem, BATCH), scenario, GRAPH_STEPS)
    # equal to the eager run's (hold_traces); at scale every loop runs to its
    # budget: 16 launches a step at B=4096 (2 AL x 8 iLQR) and 50 at 512 (5 x 10)
    check(set(trace["launches"]) == {(k, B) for k in ("riccati_backward_packed", "fk_walk", "gn_assemble")
                                     for B in (BATCH, BATCH // 8)},
          f"graphed panda fleet launched at {sorted(trace['launches'])}")
    check(trace["metrics"][-1]["converged_fraction"] >= 0.9, "graphed panda fleet: converged < 0.9")
    check(trace["replays"][1:] == [1] * (GRAPH_STEPS - 1), f"panda fleet replays a step: {trace['replays']}")
    launches = {"panda fleet (graph phase)": kernel_launches(trace["launches"])}
    fleet_artifact_check(torch, runner, trace["states"][0])
    del runner
    t1 = time.perf_counter()

    boxer, _ = tbench._load_problem("boxer")
    tr, r, sc = graph_fleet(torch, "boxer fleet B=1024", fleet(boxer, GRAPH_SIDE_BATCH),
                            tbench._scenario_for(boxer, GRAPH_SIDE_BATCH, "boxer"), GRAPH_SIDE_STEPS)
    program_record(torch, "boxer fleet step B=1024", lambda: r.step(tr["state"], sc), steady(tr))
    mobile = MpcProblem(Setup.from_dict(mobile_panda_setup()))
    tr, r, sc = graph_fleet(torch, "mobile panda fleet B=1024", fleet(mobile, GRAPH_SIDE_BATCH, kick_scale=0.0),
                            random_fleet_scenario(mobile, GRAPH_SIDE_BATCH, seed=0, **MOBILE_SAMPLER),
                            GRAPH_SIDE_STEPS)
    tr, r, sc = graph_fleet(torch, "kick fleet B=1024", fleet(problem, KICK_BATCH, kick_after=KICK_AFTER),
                            tbench._scenario_for(problem, KICK_BATCH, "panda"), GRAPH_KICK_STEPS)
    program_record(torch, "kick fleet step B=1024", lambda: r.step(tr["state"], sc), steady(tr))
    launches["kick fleet (graph phase)"] = kernel_launches(tr["launches"])
    setups = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}
    problems = {k: (MpcProblem(Setup.from_dict(setups[k]())), b) for k, b in GROUP_SIZES.items()}
    scenarios = mixed_fleet_scenarios(problems, seed=0, sampler_kwargs={k: sampler(k) for k in GROUP_SIZES})
    tr, r, sc = graph_fleet(torch, "mixed group", lambda: FleetGroup(problems, device="cuda"), scenarios,
                            GRAPH_GROUP_STEPS)
    check(tr["replays"][1:] == [len(GROUP_SIZES)] * (GRAPH_GROUP_STEPS - 1),
          f"group replays a step: {tr['replays']}")
    program_record(torch, "mixed group step", lambda: r.step(tr["state"], sc), steady(tr),
                   EXPANSION_KERNELS + ["riccati_batched_kernel"])
    group_launches = kernel_launches(tr["launches"])
    del r
    t2 = time.perf_counter()

    for kind in ("panda", "boxer"):
        runs = {}
        for mode in ("eager", "graphed"):
            with (units._eager() if mode == "eager" else contextlib.nullcontext()), program_calls() as calls:
                runs[mode] = planner_run(kind, "cuda", GRAPH_PLANNER_SOLVES, replay=0)[1]
            runs[mode]["calls"] = calls
        e, g = runs["eager"], runs["graphed"]
        same = len(e["actions"]) == len(g["actions"]) and all(
            np.array_equal(a, b) for a, b in zip(e["actions"], g["actions"]))
        prog, driver = g["calls"][-1][0], g["calls"][-1][3]
        reads = [c[1] for c in g["calls"]]
        replays = [c[2] for c in g["calls"]]
        print(json.dumps({"planner_graphs_vs_eager": kind, "solves": len(g["actions"]),
                          "actions_equal": same, "flags_equal": e["flags"] == g["flags"],
                          "eager_ms": percentiles(e["solve_ms"]), "graphed_ms": percentiles(g["solve_ms"]),
                          "eager_host_reads_per_solve": [c[1] for c in e["calls"]][:3],
                          "graphed_host_reads_per_solve": reads, "graphed_replays_per_solve": replays,
                          "program": prog.stats}), flush=True)
        check(same and e["flags"] == g["flags"], f"{kind} planner: graphed and eager actions differ")
        check(not any(reads[1:]) and replays[1:] == [1] * (len(replays) - 1),
              f"{kind} planner: host reads {reads}, replays {replays} in graphed solves")
        program_record(torch, f"{kind} planner solve B=1", lambda: prog.call(driver),
                       float(np.percentile(g["solve_ms"][1:], 50)))
    print(json.dumps({"graph_phase_s": {"panda": t1 - t0, "side_fleets_group": t2 - t1,
                                        "planners": time.perf_counter() - t2}}), flush=True)
    return launches, group_launches


#: the benchmark child's settings: panda at full width, few steps, both
#: extras on under a budget they fit in
BENCH_ENV = dict(BENCH_BATCH=str(BATCH), BENCH_STEPS="3", BENCH_WARMUP_MAX="3",
                 BENCH_TIME_BUDGET="600", BENCH_LATENCY="1", BENCH_MULTICLASS="1")
BENCH_TIMEOUT_S = 600


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


def bench_phase(torch):
    """``python -m robot_mpcs_tpu_torch.bench`` in a child process (``BENCH_ENV``),
    with ``nvcc`` on its ``PATH`` replaced by a script that logs each call
    and runs the real one: the child loads the kernels phase 2 built and may
    ask ``nvcc --version`` (part of the cache key), never compile. Its last
    line must carry every field, converged >= 0.9, converged violation <=
    1e-4, finite numbers, and launches of the structured kernel and the
    split expansion's two in the headline's window and of the general one
    in boxer's. Returns each
    kernel's launches in the child, summed over its timed windows."""
    import shutil
    import tempfile

    from robot_mpcs_tpu_torch import bench
    from robot_mpcs_tpu_torch.ops import _build

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    log = os.path.join(tmp, "nvcc.log")
    shim = os.path.join(tmp, "bin", "nvcc")
    os.makedirs(os.path.dirname(shim))
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\necho "$*" >> "{log}"\nexec "{_build.nvcc()}" "$@"\n')
    os.chmod(shim, 0o755)
    env = dict(os.environ, **BENCH_ENV, PATH=os.path.dirname(shim) + os.pathsep + os.environ["PATH"])
    for k in ("ROBOT_MPCS_COORDINATOR", "MASTER_ADDR"):  # world 1
        env.pop(k, None)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "robot_mpcs_tpu_torch.bench"], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    wall_s = time.perf_counter() - t
    for line in proc.stderr.splitlines()[-10:]:
        print(f"[bench] {line}", flush=True)
    check(proc.returncode == 0, f"bench exited with {proc.returncode}")
    lines = [s for s in proc.stdout.splitlines() if s.startswith("{")]
    check(len(lines) == 2, f"bench printed {len(lines)} JSON lines, not 2")
    print(lines[-1], flush=True)
    res = json.loads(lines[-1])
    extra = res["extra"]
    missing = [k for k in bench.HEADLINE_FIELDS + bench.EXTRA_FIELDS if k not in extra]
    check(res.get("metric") == "panda_H20_mpc_solves_per_s_per_chip" and not missing,
          f"bench line lacks {missing}")
    check(json.loads(lines[0])["value"] == res["value"], "headline and enriched line disagree")
    check(all(np.isfinite(v) for v in _numbers(res)), "non-finite number in the bench line")
    check(extra["converged_fraction"] >= 0.9, f"bench converged {extra['converged_fraction']} < 0.9")
    check(extra["max_violation_converged"] <= 1e-4,
          f"bench max_violation_converged {extra['max_violation_converged']:.3e}")
    launches = extra["riccati_launches"]
    check(launches["riccati_backward_packed"]["panda"] > 0,
          "the bench's panda window launched no structured kernel")
    check(launches["riccati_backward_batched"]["boxer"] > 0,
          "the bench's boxer window launched no general kernel")
    for kernel in ("fk_walk", "gn_assemble"):
        check(launches[kernel]["panda"] > 0, f"the bench's panda window never launched {kernel}")
    calls = []
    if os.path.exists(log):
        with open(log) as f:
            calls = f.read().splitlines()
    check(all(c.strip() == "--version" for c in calls), f"the bench child compiled: nvcc {calls}")
    shutil.rmtree(tmp)
    print(json.dumps({"bench_phase_s": wall_s, "nvcc_calls": calls,
                      "launches": launches}), flush=True)
    return {k: {"bench": sum(v.values())} for k, v in launches.items()}


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--dist-rank":
        return dist_worker(torch, sys.argv[2])
    if len(sys.argv) > 1 and sys.argv[1] == "--deploy-child":
        return deploy_child(torch, *sys.argv[2:5])
    if len(sys.argv) > 1 and sys.argv[1] == "--fleet-child":
        return fleet_child(torch, *sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from robot_mpcs_tpu_torch.ops import riccati_batched as rb
        from robot_mpcs_tpu_torch.ops import riccati_packed as rp
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()

    build_phase()
    shapes = time_kernel_shapes(torch, rp, rb)
    packed = packed_kernel_phase(torch, rp, shapes)
    batched = batched_kernel_phase(torch, rb, shapes)
    expansion = expansion_kernel_phase(torch, time_expansion_shapes(torch))
    print(f"kernel phases done at {time.perf_counter() - t0:.1f} s", flush=True)
    panda, panda_scenario, panda_launches, panda_state, panda_scen = path_phase(torch, rp)
    packed["launches"] = panda_launches["riccati_backward_packed"]
    for rec in expansion:
        rec["launches"] = panda_launches[rec["name"]]
    print(f"panda path done at {time.perf_counter() - t0:.1f} s", flush=True)
    graphs, graph_group = graph_phase(torch, rp, rb)
    print(f"graph phase done at {time.perf_counter() - t0:.1f} s", flush=True)
    boxer, boxer_scenario, group = group_phase(torch, rp, rb)
    print(f"group path done at {time.perf_counter() - t0:.1f} s", flush=True)
    point = point_phase(torch, rp)
    print(f"pointRobot path done at {time.perf_counter() - t0:.1f} s", flush=True)
    mobile = mobile_phase(torch, rb)
    batched["launches"] = mobile["riccati_backward_batched"]
    print(f"mobile panda path done at {time.perf_counter() - t0:.1f} s", flush=True)
    kick = kick_phase(torch)
    print(f"kick path done at {time.perf_counter() - t0:.1f} s", flush=True)
    planners = planner_phase(torch)
    print(f"planner path done at {time.perf_counter() - t0:.1f} s", flush=True)
    examples = examples_phase(torch)
    print(f"examples done at {time.perf_counter() - t0:.1f} s", flush=True)
    deploy = deploy_phase(torch)
    print(f"deploy done at {time.perf_counter() - t0:.1f} s", flush=True)
    reference_phase(torch, "panda", panda, panda_scenario)
    reference_phase(torch, "boxer", boxer, boxer_scenario)
    chain = chain_phase(torch, rp)
    print(f"card vs CPU done at {time.perf_counter() - t0:.1f} s", flush=True)
    sharded = distributed_phase(torch, panda, panda_scenario)
    print(f"distributed path done at {time.perf_counter() - t0:.1f} s", flush=True)
    reference_form = reference_form_phase(torch, rp, panda, panda_state, panda_scen)
    print(f"reference form done at {time.perf_counter() - t0:.1f} s", flush=True)
    bench = bench_phase(torch)
    print(f"all phases done at {time.perf_counter() - t0:.1f} s", flush=True)

    # launches is the main path's count; each path's own beside it, from the
    # same tallies for every kernel
    fleets = {"group": group, f"pointRobot fleet (B={POINT_BATCH})": point, "6-dof chain (B=64)": chain,
              "kick fleet (B=1024, eager)": kick["panda"], "boxer kick fleet (B=1024)": kick["boxer"],
              "mobile panda fleet": mobile, **graphs, "graph phase, mixed group": graph_group}
    for rec in (packed, batched, *expansion):
        name = rec["name"]
        main_path = "mobile panda fleet" if name == "riccati_backward_batched" else "panda fleet"
        rec["launches_by_path"] = {
            main_path: rec["launches"], **{path: c[name] for path, c in fleets.items() if c.get(name)},
            **planners[name], **sharded[name], **examples[name], **deploy.get(name, {}), **bench.get(name, {}),
            **(reference_form if name == "riccati_backward_packed" else {})}
    print(json.dumps({"kernels": [packed, batched, *expansion]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
