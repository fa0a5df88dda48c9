"""seq_frames_per_s: frames written a second, over the time of every whole
sequence the window completed, render to last file written."""


def read(run):
    seconds = sum(item.seconds for item in run.rec.items)
    return run.frames / seconds if seconds > 0 else None
