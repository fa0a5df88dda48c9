"""frame_p95_s.still: the 95th percentile (nearest rank) of the walls of every
still frame the window completed, render to file written, read per layer
in the cells where ``frame_p95_s`` spreads too widely between runs to hold
a bound end to end."""

import math


def read(run):
    walls = sorted(item.seconds for item in run.rec.items)
    return walls[math.ceil(0.95 * len(walls)) - 1] if walls else None
