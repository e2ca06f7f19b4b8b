"""Hand-written CUDA kernels for the solver's hot loops, each beside its
plain PyTorch version (the CPU path and the kernel's test oracle)."""

from robot_mpcs_tpu_torch.ops.riccati_batched import riccati_backward_batched
from robot_mpcs_tpu_torch.ops.riccati_packed import riccati_backward_packed

__all__ = ["riccati_backward_batched", "riccati_backward_packed"]
