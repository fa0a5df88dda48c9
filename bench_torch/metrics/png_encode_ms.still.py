"""png_encode_ms.still: milliseconds of ``utils.export.write_image`` a
frame, the mean ``encode`` span: the host's filter, deflate and write."""


def read(run):
    n = sum(1 for s in run.rec.spans if s.name == "encode")
    return 1e3 * run.rec.seconds("encode") / n if n else None
