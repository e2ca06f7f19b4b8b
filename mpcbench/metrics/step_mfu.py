"""step_mfu: the profiled call's solver work (iterations x flops an iteration, trace.iteration_flops, a lower bound) over the graphed wall, against the card's float32 peak."""

from mpcbench import readers

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"


def read(rec):
    return readers.step_mfu(rec)
