"""Per-frame rotations: the loop of ``drivers/sequence.py`` for a mix with
``--orbit per-frame`` (upstream's ``sequence``: every frame its own render,
with fresh seeds and a fresh warm-up). One user in a closed loop renders
whole rotations back to back through the CLI's batched ``sequence`` path,
``render.render_sequence_batched``, which calls ``render.render`` once a
frame; ``cli._write_frames`` writes the frames on the CLI's encoder threads.
Spans ``engine`` and ``write``, the set-up, the window and the numbers
compared are ``drivers/sequence.py``'s.

Only the check's reference is laid out differently. ``drivers/sequence.py``
renders a per-frame rotation with one :func:`reference.render` a frame,
which on a card captures a graph of a chunk's map steps a frame: 120 frames
take some 160 s. Here the lanes of a batch's frames run side by side as one
orbit, frame ``f``'s seed points (from its own generator, as the program
draws them) in columns ``f * lanes`` to ``(f + 1) * lanes``, and each chunk
is binned frame by frame from that frame's columns at its own angle. Every
operation of the orbit is elementwise, so each lane's points are the bits
:func:`reference.render` gives them; the images equal
``drivers/sequence.py``'s reference bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from bench_torch import images, reference
from bench_torch.harness import item_seed, load_module

seq = load_module(Path(__file__).with_name("sequence.py"), "bench_torch_driver_sequence")

SPANS = seq.SPANS
LIMITS = seq.LIMITS
Session = seq.Session
window = seq.window


def plan(ctx) -> Session:
    """The sequence loop's plan; the mix has to ask for a per-frame orbit."""
    s = seq.plan(ctx)
    if s.args.orbit != "per-frame":
        raise ValueError("the per-frame sequence driver runs `sequence --orbit per-frame`")
    return s


def setup(ctx) -> Session:
    """The sequence loop's set-up (the kernel library, ``render.precompile``,
    a two-frame sequence) of a per-frame mix."""
    plan(ctx)
    return seq.setup(ctx)


def reference_frames(s: Session, seed: int, dtype=torch.float32) -> torch.Tensor:
    """The plain reference's 8-bit images of one per-frame sequence, (F, H,
    W, 3): frame ``i`` is :func:`reference.render` of the generator of
    ``fold(seed, i)`` at the frame's angle, a batch's frames rendered side
    by side."""
    dep = reference.Deployment.from_config(s.ctx.cell.config)
    rad = np.radians(np.asarray(s.angles, np.float64))
    dev, per, lanes = s.ctx.device, s.args.frames_per_batch, s.info["lanes"]
    out = []
    for lo in range(0, len(rad), per):
        frames = range(lo, min(lo + per, len(rad)))
        p1 = torch.cat([reference.seed_points(torch.Generator().manual_seed(seq.fold(seed, i)),
                                              lanes, dtype, dev) for i in frames], dim=1)
        cams = [reference.Camera(dep, float(rad[i]), dtype) for i in frames]
        planes = [reference.Planes(dep.npix, dev) for _ in frames]
        for new, old in reference.orbit_chunks(dep, p1, s.info["chunk_steps"],
                                               s.info["nchunks"]):
            for f, (cam, plane) in enumerate(zip(cams, planes)):
                cols = slice(f * lanes, (f + 1) * lanes)
                plane.bin(*reference.project(dep, cam, *reference.shared_operands(
                    dep, cam, new[:, :, cols], old[:, :, cols])))
        out.extend(reference.tonemap8(dep, p) for p in planes)
    return torch.stack(out)


def control(s: Session, index: int, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place for sequence ``index``; its images stand for the files."""
    seed = item_seed(s.ctx.seed, index)
    low = reference_frames(s, seed, dtype)
    return seq.compare({"image": low, "file": low}, reference_frames(s, seed))


def check(s: Session) -> tuple:
    """(numbers compared with their limits, what the check learned, frames
    that failed) over the kept sequences."""
    totals = dict.fromkeys(LIMITS, 0)
    failed, dev = 0, s.ctx.device
    for k, (frames, paths, _) in sorted(s.sample.kept.items()):
        ref = reference_frames(s, item_seed(s.ctx.seed, k))
        answer = {"image": torch.from_numpy(frames).to(dev),
                  "file": images.read_images(paths, s.fmt, dev)}
        off = seq._off(answer["image"], ref) | seq._off(answer["file"], ref)
        failed += int(off.flatten(1).any(1).sum())
        for name, value in seq.compare(answer, ref).items():
            totals[name] += value
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in totals.items()}
    checks["none_checked"] = {"value": int(not s.sample.kept), "limit": 0}
    return checks, {}, failed
