"""device_events: the device operations of one fleet step (.fleet) or planner solve (.planner), run eagerly under the profiler (its graph replays the same launches)."""

from mpcbench import readers

LAYER = "whole-program graphs (solver/units.py, ops/graph_cond.py)"
UNIT = "events"
SOURCE = "device_trace"


def read(rec):
    return readers.device_events(rec)
