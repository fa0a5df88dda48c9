"""render_iters_per_s.still: map iterations a second of ``render.render``,
the iterations of every frame over the time of the ``render`` spans (each
ends in a synchronize)."""


def read(run):
    seconds = run.rec.seconds("render")
    return len(run.rec.items) * run.info["iterations"] / seconds if seconds > 0 else None
