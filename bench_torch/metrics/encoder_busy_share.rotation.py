"""encoder_busy_share.rotation: the percent of the encoder threads' time
spent writing frames: the seconds of the program's ``image.write`` spans on
the encoder threads over ``cli.ENCODERS`` times the seconds of the harness's
``write`` spans (``cli._write_frames``, which never runs more than
``ENCODERS`` writes at once). Below 100 the pool waits on its submitter.
None unless the window recorded one span a frame."""

from bench_torch import program_spans as ps
from bench_torch.harness import program


def read(run):
    spans = ps.named(ps.fetch(run), "image.write", off_thread=True)
    seconds = run.rec.seconds("write")
    if not spans or len(spans) != run.frames or seconds <= 0:
        return None
    return 100.0 * sum(s.seconds for s in spans) / (program("cli").ENCODERS * seconds)
