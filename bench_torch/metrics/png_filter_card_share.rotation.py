"""png_filter_card_share.rotation: the percentage of the ``png.filter`` spans
recorded on the encoder threads (off the window's thread) with ``card`` =
1, those whose scanlines the card filtered from the frame's device copy
(``utils.export._filter_scanlines``) rather than the host. None unless the
window recorded such spans and every one carries the attribute (a program
before the card filter records none)."""

from bench_torch.program_spans import fetch, named


def read(run):
    spans = named(fetch(run), "png.filter", off_thread=True)
    if not spans or any("card" not in s.attrs for s in spans):
        return None
    return 100.0 * sum(s.attrs["card"] == 1 for s in spans) / len(spans)
