"""fk_walk_roofline: fk_walk's share of its roofline over one profiled step (.fleet) or solve (.planner): its launches' least times (bounds.py) over their device time."""

from mpcbench import readers

LAYER = "kernels (ops/*, csrc/*)"
UNIT = "%"
SOURCE = "device_trace"


def read(rec):
    return readers.roofline(rec, "fk_walk")
