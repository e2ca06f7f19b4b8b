"""Matplotlib visualizer for planned trajectories and constraints (the port's
own copy of ``robot_mpcs_tpu.planner.visualizer``; host code, matplotlib is
imported only inside ``render``).

The reference's ``robotmpcs/planner/visualizer.py`` is an unimplemented stub
(its examples draw through pybullet instead); this is a working headless
renderer: predicted plan, goal, sphere obstacles, halfplane constraints and
the executed trace, saved to a file (no display required).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class Visualizer:
    def __init__(self, xlim=(-2.0, 9.0), ylim=(-6.0, 5.0)):
        self._xlim = xlim
        self._ylim = ylim
        self._trace: List[np.ndarray] = []

    def add_trace_point(self, position) -> None:
        self._trace.append(np.asarray(position[:2], dtype=float))

    def render(
        self,
        plan_xy: Optional[np.ndarray] = None,
        goal: Optional[Sequence[float]] = None,
        obstacles: Sequence = (),
        halfplanes: Optional[np.ndarray] = None,
        r_body: float = 0.0,
        path: Optional[Sequence] = None,
        save_to: str = "mpc_frame.png",
    ) -> str:
        """Render one frame to ``save_to`` and return the path.

        ``plan_xy``: (N, 2) predicted positions; ``obstacles``: objects with
        ``position()``/``radius()``; ``halfplanes``: (K, 4) rows [a,b,c,d];
        ``path``: global-planner waypoints.
        """
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 6))
        ax.set_xlim(*self._xlim)
        ax.set_ylim(*self._ylim)
        ax.set_aspect("equal")
        for obst in obstacles:
            pos = obst.position()
            ax.add_patch(plt.Circle(pos[:2], obst.radius(), color="crimson", alpha=0.5))
        if path is not None and len(path):
            p = np.asarray([w[:2] for w in path])
            ax.plot(p[:, 0], p[:, 1], "c--", lw=1, label="global path")
        if self._trace:
            t = np.asarray(self._trace)
            ax.plot(t[:, 0], t[:, 1], "k-", lw=1.5, label="executed")
        if plan_xy is not None and len(plan_xy):
            plan = np.asarray(plan_xy)
            ax.plot(plan[:, 0], plan[:, 1], "o-", color="tab:blue", ms=3,
                    lw=1, alpha=0.8, label="plan")
            if r_body > 0:
                ax.add_patch(plt.Circle(plan[0], r_body, fill=False, color="tab:blue"))
        if halfplanes is not None:
            xs = np.linspace(*self._xlim, 2)
            for plane in np.asarray(halfplanes):
                a, b, _, d = plane
                if abs(b) > 1e-9:
                    ax.plot(xs, (-d - a * xs) / b, color="gray", lw=0.5, alpha=0.6)
                elif abs(a) > 1e-9:
                    ax.axvline(-d / a, color="gray", lw=0.5, alpha=0.6)
        if goal is not None:
            ax.plot(goal[0], goal[1], "g*", ms=14, label="goal")
        ax.legend(loc="upper right", fontsize=8)
        fig.savefig(save_to, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return save_to
