"""Checkpoint / resume for long-running fleet rollouts (port of
``robot_mpcs_tpu.utils.checkpoint``; the same ``.npz`` format, so a
checkpoint written by either package loads in the other).

The reference has no checkpointing at all (SURVEY §5). For a production
fleet the device-resident :class:`~robot_mpcs_tpu_torch.parallel.fleet.FleetState`
(plant state, warm-start trajectories, AL multipliers, step counter) IS the
job state — losing it on preemption forfeits the warm starts and every
scenario's progress. The state is copied to the host once per field
(``interop.state_to_numpy``) and written through a temporary file,
``fsync`` and ``os.replace``, so a crash mid-write never leaves a torn
checkpoint. Single device: the port has no mesh yet.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np

#: v2 adds the per-lane ``stall`` counter (fleet stall-recovery state);
#: v1 checkpoints load with ``stall`` reset to zeros (safe: the counter is
#: a heuristic that re-accumulates within a few steps).
_FORMAT_VERSION = 2


def save_fleet_state(path: str, state, extra: Optional[dict] = None) -> None:
    """Write ``state`` (a ``FleetState`` on any device) to ``path`` (.npz)
    atomically.

    ``extra`` is an optional JSON-serializable dict (e.g. scenario seed,
    config digest) stored alongside the arrays for provenance checks at
    restore time.
    """
    from robot_mpcs_tpu_torch.interop import state_to_numpy

    host = state_to_numpy(state)
    x, z_warm, lam = host["x"], host["z_warm"], host["lam"]
    meta = {
        "version": _FORMAT_VERSION,
        # problem-shape provenance, validated at load time: restoring a
        # checkpoint from a different problem class must fail with a clear
        # error instead of a shape error at the first step
        "dims": {
            "batch": int(x.shape[0]),
            "nx": int(x.shape[1]),
            "N": int(z_warm.shape[1]),
            "nz": int(z_warm.shape[2]),
            "n_con": int(lam.shape[2]),
        },
        "extra": extra or {},
    }
    payload = dict(host, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            # flush through to stable storage BEFORE the rename: os.replace
            # is atomic against process death, but a machine-level crash can
            # still tear an unsynced file over the previous good checkpoint
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the directory so the rename itself is durable
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_fleet_state(path: str, problem=None, batch_size=None, device="cuda"):
    """Load a fleet checkpoint onto ``device``; returns ``(state, extra)``.

    With ``problem`` (an :class:`MpcProblem`) and/or ``batch_size`` given,
    the checkpoint's recorded shape provenance is validated against the
    target problem and a clear ``ValueError`` is raised on mismatch.
    """
    from robot_mpcs_tpu_torch.interop import state_from_numpy
    from robot_mpcs_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta.get("version") not in (1, _FORMAT_VERSION):
            raise ValueError(
                f"unsupported fleet checkpoint version {meta.get('version')!r}"
            )
        arrays = {k: data[k] for k in ("x", "z_warm", "lam", "step")}
        B = arrays["x"].shape[0]
        # fields absent in older checkpoints get neutral defaults (zero stall
        # counter, never-improved-from-infinity, zero plateau counter)
        defaults = {
            "stall": np.zeros((B,), np.int32),
            "best_gdist": np.full((B,), np.inf, np.float32),
            "no_improve": np.zeros((B,), np.int32),
        }
        for k, v in defaults.items():
            arrays[k] = data[k] if k in data else v
    dims_meta = meta.get("dims")
    if dims_meta is not None and (problem is not None or batch_size is not None):
        expect = {}
        if problem is not None:
            d = problem.dims
            expect.update(nx=d.nx, N=d.N, nz=d.nz, n_con=problem.n_con)
        if batch_size is not None:
            expect["batch"] = int(batch_size)
        bad = {
            k: (dims_meta.get(k), v) for k, v in expect.items()
            if dims_meta.get(k) != v
        }
        if bad:
            raise ValueError(
                "fleet checkpoint shape mismatch (checkpoint vs target): "
                + ", ".join(f"{k}: {a} vs {b}" for k, (a, b) in bad.items())
            )
    return state_from_numpy(arrays, device=dev), meta["extra"]
