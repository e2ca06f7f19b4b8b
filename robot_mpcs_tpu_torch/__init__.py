"""robot_mpcs_tpu_torch — the PyTorch / CUDA port of ``robot_mpcs_tpu``.

The module tree mirrors the JAX package (``config``, ``models/*``,
``ops/*``, ``solver/*``, ``parallel/*``) so each module's counterpart is
easy to find. The port imports ``torch`` and numpy and never JAX: the JAX
package is the reference the port is tested against, and the machines
that run the port carry no JAX.

Inside, the port is batch-first: every per-stage tensor is ``[B, N, ...]``
where the JAX package writes a single stage and ``vmap``s it, and every JAX
``lax.while_loop`` is a Python loop over a per-lane ``done`` mask. The
hand-written kernels are the two Riccati sweeps: the structured holonomic
one (``ops/riccati_packed.py`` + ``csrc/riccati_packed.cu``) and the general
one (``ops/riccati_batched.py`` + ``csrc/riccati_batched.cu``).
"""

import torch

# The port computes in full f32. Lower-precision (bf16) dots stalled the JAX
# solver's convergence, which is why it forces f32 dots (its
# al_ilqr.py:944-953); TF32 is such a lower precision, so it is switched off
# once, when the package is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from robot_mpcs_tpu_torch.config import (  # noqa: E402
    MpcConfiguration,
    RobotConfiguration,
    Setup,
    SolverConfiguration,
    boxer_setup,
    load_setup,
    panda_setup,
    point_robot_setup,
)

__version__ = "0.1.0"
