"""step_ms_p90: the 90th percentile of every step of the window, from its issue (resets merged) to its new plant state on the host."""

from mpcbench import readers

LAYER = "fleet step (parallel/fleet.py FleetRunner.step)"
UNIT = "ms"
SOURCE = "host_clock"


def read(rec):
    return readers.percentile_ms(rec["times_s"], 90)
