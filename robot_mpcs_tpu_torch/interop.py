"""Carry state between the JAX package and this port, as numpy arrays.

The JAX package runs with x64 off, so its arrays are float32 / int32 and
numpy arrays built from them are too — but a numpy array made by hand
defaults to float64, which torch would keep. Every conversion here names
its dtype. Nothing here imports JAX: callers pass ``np.asarray(jax_array)``
and get numpy back for the JAX side.

Layouts are the JAX package's, batch-first: a scenario is ``xinit (B, nx)``
and ``params (B, N, npar)`` in the paramMap layout (``models/params.py``).
Tensors land on the card unless ``device`` says otherwise (``"cpu"``), as at
every entry point of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from robot_mpcs_tpu_torch.parallel.fleet import FleetScenario, FleetState
from robot_mpcs_tpu_torch.utils.devices import resolve_device

_FLOAT_STATE = ("x", "z_warm", "lam", "best_gdist")
_INT_STATE = ("step", "stall", "no_improve")


def _f32(a, device) -> torch.Tensor:
    # torch.tensor copies: arrays from JAX are read-only views of its buffers
    return torch.tensor(np.asarray(a, dtype=np.float32), dtype=torch.float32, device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.int32), dtype=torch.int32, device=device)


def scenario_from_numpy(xinit, params, device="cuda") -> FleetScenario:
    """A JAX ``FleetScenario``'s ``(xinit (B, nx), params (B, N, npar))``."""
    device = resolve_device(device)
    return FleetScenario(xinit=_f32(xinit, device), params=_f32(params, device))


def scenario_to_numpy(scenario: FleetScenario) -> Dict[str, np.ndarray]:
    return {
        "xinit": scenario.xinit.detach().cpu().numpy().astype(np.float32),
        "params": scenario.params.detach().cpu().numpy().astype(np.float32),
    }


def state_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> FleetState:
    """A JAX ``FleetState`` given as a dict of numpy arrays (its field names)."""
    device = resolve_device(device)
    return FleetState(
        **{k: _f32(arrays[k], device) for k in _FLOAT_STATE},
        **{k: _i32(arrays[k], device) for k in _INT_STATE},
    )


def state_to_numpy(state: FleetState) -> Dict[str, np.ndarray]:
    out = {}
    for k in _FLOAT_STATE:
        out[k] = getattr(state, k).detach().cpu().numpy().astype(np.float32)
    for k in _INT_STATE:
        out[k] = getattr(state, k).detach().cpu().numpy().astype(np.int32)
    return out


def solver_inputs_from_numpy(xinit, params, z0, lam0, device="cuda"):
    """The solver's ``(xinit (B, nx), params (B, N, npar), z0 (B, N, nz),
    lam0 (B, N, n_con))`` as float32 tensors."""
    device = resolve_device(device)
    return tuple(_f32(a, device) for a in (xinit, params, z0, lam0))
