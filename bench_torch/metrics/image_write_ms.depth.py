"""image_write_ms.depth: milliseconds to write a depth frame's file, the
mean of the program's ``image.write`` spans (``utils.export.write_image``:
for a PAM the header, the join and the file's write). None unless the
window recorded one a frame, each of a PAM."""

from bench_torch import program_spans as ps


def read(run):
    spans = ps.named(ps.fetch(run), "image.write")
    if not spans or len(spans) != run.frames or any(s.attrs.get("fmt") != "pam" for s in spans):
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
