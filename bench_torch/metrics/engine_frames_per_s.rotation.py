"""engine_frames_per_s.rotation: frames a second of the sequence engine,
every frame over the time of the ``engine`` spans (render, tone map and
the host copy of each whole sequence)."""


def read(run):
    seconds = run.rec.seconds("engine")
    return run.frames / seconds if seconds > 0 else None
