"""Time design variants of kernel T's Gas pass on a card, to see which of
its operations holds it.

Each variant is ``csrc/tonemap.cu`` with a few text edits (:data:`VARIANTS`),
built into a library of its own with the package's nvcc flags, all builds
at once. They tone-map one state, the flagship (poisson-saturne, seed 1,
brightness offset -0.25) rendered at 10^8 iterations over 1920x1080, as
chip_smoke.py's phase 32 does: Gas from its PACKED planes to 8-bit RGB, the
CLI's delivery, the reduction and the pass of a frame. The variants:

- ``kernel``: the source as it stands;
- ``log1p(max) per pixel``: every thread takes log1p of the max count
  again, as the first design did, where the source takes it once a frame;
- ``fraction by floorf``: the lerp's fraction as ``v - floorf(v)``, not
  ``fmodf(v, 1)`` (the same value for every v >= 0 and for NaN);
- ``no log1p``: the brightness as count / max, no double ``log1p``;
- ``no sqrt``: the palette lerp without its square roots.

The first three give the kernel's image byte for byte (the tool checks it);
the last two do not, and say what an operation costs. Each variant's ms a
frame is timed by CUDA events, the variants in turns (order reversed every
other turn), with a spin kernel queued first so that the frames run back to
back on the device. Run on a card::

    python -m strange_attractor_tpu_torch.tools.tonemap_variants [--turns T] [--reps R]

It prints, per variant, whether its image equals the kernel's and the
min-max of its ms over the turns, with the card's name and power limit, and
exits non-zero when a variant that should give the kernel's image does not.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

# (text in csrc/tonemap.cu, its replacement)
PER_PIXEL_LOG1P = (" / f.stats[1];", " / (float)log1p((double)f.stats[0]);")
FLOOR_FRACTION = ("const float frac = fmodf(v, 1.0f);", "const float frac = v - floorf(v);")
NO_LOG1P = ("(float)log1p((double)(float)f.count[i]) / f.stats[1]",
            "(float)f.count[i] / f.stats[0]")
NO_SQRT = ("sqrtf(hi[ch] * frac + lo[ch] * (1.0f - frac))",
           "(hi[ch] * frac + lo[ch] * (1.0f - frac))")
# name -> (edits, whether the image stays the kernel's byte for byte)
VARIANTS = {
    "kernel": ((), True),
    "log1p(max) per pixel": ((PER_PIXEL_LOG1P,), True),
    "fraction by floorf": ((FLOOR_FRACTION,), True),
    "no log1p": ((NO_LOG1P,), False),
    "no sqrt": ((NO_SQRT,), False),
}
ITERATIONS = 100_000_000


def variant_source(name: str, source: str) -> str:
    """``source`` (the text of ``csrc/tonemap.cu``) with variant ``name``'s
    edits; raises unless each edit's text occurs exactly once."""
    for old, new in VARIANTS[name][0]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} occurs {source.count(old)} times "
                             f"in tonemap.cu")
        source = source.replace(old, new)
    return source


def _build(work: Path) -> dict:
    """Every variant's library, built in parallel under ``work``."""
    from ..ops import cuda_lib

    source = (cuda_lib.CSRC / "tonemap.cu").read_text()
    nvcc, procs = cuda_lib.nvcc(), {}
    for i, name in enumerate(VARIANTS):
        src, lib = work / f"variant{i}.cu", work / f"variant{i}.so"
        src.write_text(variant_source(name, source))
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, f"-I{cuda_lib.CSRC}", "-shared", "-o", str(lib),
               str(src)]
        procs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, cmd, proc) in procs.items():
        cuda_lib.check_run(cmd, proc)
        libs[name] = ctypes.CDLL(str(lib))
        for fn in ("sat_tonemap_stats", "sat_tonemap"):
            entry = getattr(libs[name], fn)
            entry.argtypes = [*cuda_lib.ARGTYPES[fn], ctypes.c_void_p]
            entry.restype = ctypes.c_int
    return libs


def _card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "card's name and power limit not read"


def time_variants(turns: int = 3, reps: int = 200, device="cuda") -> dict:
    """name -> {"same_image": bool, "ms": [ms a frame, one a turn]}."""
    import numpy as np
    import torch

    import strange_attractor_tpu_torch as sat
    from ..ops import cuda_lib

    dev = torch.device(device)
    cfg = sat.presets.poisson_saturne(
        iterations=ITERATIONS, width=1920, height=1080, seed=1, transparent=False,
        colors=sat.Colors(brightness=sat.BrightnessConstants(offset=-0.25)))
    state = sat.render(cfg, device=dev)
    stops = torch.from_numpy(cfg.colors.palette.stops.astype(np.float32)).to(dev)
    npix, bk = cfg.width * cfg.height, cfg.colors.brightness
    words = torch.empty(6, dtype=torch.int32, device=dev)
    stats = words[4:].view(torch.float32)
    img = torch.empty((cfg.height, cfg.width, 3), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_lib.library()  # the package's build dir exists and nvcc works
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        libs = _build(Path(tmp))

        def frame(lib) -> None:
            cuda_lib.check_launch(lib.sat_tonemap_stats(
                state.count.data_ptr(), 0, state.packed.data_ptr(), npix, 0, words.data_ptr(),
                stats.data_ptr(), stream), "sat_tonemap_stats")
            cuda_lib.check_launch(lib.sat_tonemap(
                state.count.data_ptr(), 0, 0, state.packed.data_ptr(), stats.data_ptr(),
                stops.data_ptr(), stops.shape[0] - 1, bk.offset, bk.factor, npix, 0, 0, 3, 1,
                img.data_ptr(), stream), "sat_tonemap")

        frame(libs["kernel"])
        want = img.clone()
        out = {}
        for name, lib in libs.items():
            frame(lib)
            out[name] = {"same_image": bool(torch.equal(img, want)), "ms": []}
        for turn in range(turns):
            for name in (list(libs) if turn % 2 == 0 else list(libs)[::-1]):
                frame(libs[name])
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(20_000_000)
                start.record()
                for _ in range(reps):
                    frame(libs[name])
                end.record()
                torch.cuda.synchronize(dev)
                out[name]["ms"].append(start.elapsed_time(end) / reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3, help="turns over the variants (default 3)")
    ap.add_argument("--reps", type=int, default=200, help="frames timed a turn (default 200)")
    ap.add_argument("--device", default="cuda", help="CUDA device (default cuda)")
    args = ap.parse_args(argv)
    card = _card_line()
    results = time_variants(args.turns, args.reps, args.device)
    failed = []
    for name, r in results.items():
        print(f"{name}: image {'equals' if r['same_image'] else 'differs from'} the kernel's; "
              f"{min(r['ms']):.4f}-{max(r['ms']):.4f} ms a 1920x1080 Gas 8-bit RGB frame "
              f"({', '.join(f'{ms:.5f}' for ms in r['ms'])}) on {card}")
        if r["same_image"] != VARIANTS[name][1]:
            failed.append(name)
    if failed:
        print(f"FAIL: {failed} did not give the image they should")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
