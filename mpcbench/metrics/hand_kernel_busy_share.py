"""hand_kernel_busy_share: the four hand-written kernels' device time over the device busy time of one profiled step (.fleet) or solve (.planner)."""

from mpcbench import readers

LAYER = "kernels (ops/*, csrc/*)"
UNIT = "%"
SOURCE = "device_trace"


def read(rec):
    return readers.hand_kernel_busy_share(rec)
