"""idle_share: 1 - the eager call's device busy time over the graphed call's wall, for a fleet step (.fleet) or a planner solve (.planner); may read below 0."""

from mpcbench import readers

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"


def read(rec):
    return readers.idle_share(rec)
