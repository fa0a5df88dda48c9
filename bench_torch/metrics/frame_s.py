"""frame_s: seconds a still frame takes, render to file written, over
every frame the window completed (their walls' sum over their count)."""


def read(run):
    walls = [item.seconds for item in run.rec.items]
    return sum(walls) / len(walls) if walls else None
