"""write_frames_per_s.rotation: frames a second of the frame writers
(``cli._write_frames`` on the CLI's encoder threads), every frame over the
time of the ``write`` spans."""


def read(run):
    seconds = run.rec.seconds("write")
    return run.frames / seconds if seconds > 0 else None
