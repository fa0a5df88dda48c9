"""host_copy_pinned_share.rotation: the percentage of the sequence engine's
``deliver.copy`` spans with ``pinned`` = 1, those whose batch landed in
page-locked host memory (``deliver.host_frames`` on a card) rather than
pageable pages. None unless the window recorded such spans and every one
carries the attribute (a program before page-locked sequences records
none)."""

from bench_torch.program_spans import fetch, named


def read(run):
    spans = named(fetch(run), "deliver.copy")
    if not spans or any("pinned" not in s.attrs for s in spans):
        return None
    return 100.0 * sum(s.attrs["pinned"] == 1 for s in spans) / len(spans)
