"""step_enqueue_ms: the median host time of a FleetRunner.step call, from the call to its return (the static inputs copied, the graph replay enqueued)."""

from mpcbench import readers

LAYER = "fleet step (parallel/fleet.py FleetRunner.step)"
UNIT = "ms"
SOURCE = "host_clock"


def read(rec):
    return readers.median_ms(rec.get('enqueue_s'))
