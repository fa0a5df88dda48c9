"""Animation frame sequencing: angles and zero-padded output names (a
stdlib-only copy of ``strange_attractor_tpu.utils.sequencing``, which the
port cannot import without JAX).

Mirrors the reference's ``AngleIter`` (src/bin/main.rs:107-176): frames step
from ``start`` toward ``end`` (degrees) while ``curr + step/2 < end``, file
names get ``ceil(log10(count))`` zero-padded frame digits, and a degenerate
single-frame sequence emits the plain name.

Fixed (not replicated): the reference's single-frame fallback yields the
angle *unconverted* (main.rs:169-171), so the CLI's degrees ``-a`` flag was
consumed as radians for single frames. Here degrees are always degrees.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Iterator


def angle_iter(start_deg: float, end_deg: float, step_deg: float) -> Iterator[float]:
    """Yield frame angles in degrees (reference: main.rs:135-175).

    Accumulates ``curr += step`` exactly like the reference so the frame
    count and values match; yields ``start`` once if no frame fits.
    """
    curr = float(start_deg)
    step = float(step_deg)
    emitted = 0
    while curr + step / 2.0 < end_deg:
        yield curr
        curr += step
        emitted += 1
    if emitted == 0:
        yield curr


def needed_digits(start_deg: float, end_deg: float, step_deg: float) -> int:
    """Zero-pad width for frame numbers (reference: main.rs:116-133).

    Note: the reference's estimate ``(end-start-step/2)/step`` can undercount
    (e.g. start=0 end=5 step=3 gives 1.17 -> 0 digits for 2 frames), making
    distinct frames share one filename and overwrite each other.
    :func:`frame_sequence` therefore derives the width from the actual frame
    count; this function is kept for reference-formula parity checks.
    """
    count = (end_deg - start_deg - step_deg / 2.0) / step_deg
    if int(count) <= 1:
        return 0
    return math.ceil(math.log10(count))


def frame_path(base: Path, frame_index: int, digits: int) -> Path:
    """Output path for one frame: ``attractor007.png`` style
    (reference: main.rs:143-162)."""
    base = Path(base)
    stem = base.stem or "attractor"
    if digits > 0:
        stem = f"{stem}{frame_index:0>{digits}}"
    out = Path(stem)
    if base.suffix:
        out = out.with_suffix(base.suffix)
    return base.with_name(out.name)


def frame_sequence(
    start_deg: float, end_deg: float, step_deg: float, base: Path
) -> Iterator[tuple[float, Path]]:
    """(angle_degrees, output_path) pairs for a sequence run.

    The pad width comes from the actual frame count (fixes the reference's
    undercounting estimate — see :func:`needed_digits`); a single frame keeps
    the plain name like the reference (main.rs:169-174).
    """
    angles = list(angle_iter(start_deg, end_deg, step_deg))
    if len(angles) == 1:
        yield angles[0], Path(base)
        return
    digits = len(str(len(angles) - 1))
    for k, angle in enumerate(angles):
        yield angle, frame_path(Path(base), k, digits)
