"""frame_p95_s: the 95th percentile (nearest rank) of the walls of every
still frame the window completed, render to file written."""

import math


def read(run):
    walls = sorted(item.seconds for item in run.rec.items)
    return walls[math.ceil(0.95 * len(walls)) - 1] if walls else None
