"""Decoders of the image files a run writes, written from the formats'
specifications (PNG: ISO/IEC 15948, sections 9-11; PAM: netpbm's P7) with
the standard library's zlib and torch. The comparison reads every file it
checks back through these, never through the program's own reader."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_rows(data: bytes) -> tuple:
    """(filtered scanlines as (h, 1 + w*bpp) uint8, w, bpp, 16-bit) of a
    non-interlaced 8- or 16-bit RGB or RGBA PNG; raises on anything else."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in (2, 6) or depth not in (8, 16) or interlace:
        raise ValueError(f"PNG colour type {color_type}, depth {depth}, interlace "
                         f"{interlace}: only non-interlaced 8/16-bit RGB(A) is read")
    bpp = (4 if color_type == 6 else 3) * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{raw.size} bytes of image data for {w}x{h}")
    return raw.reshape(h, 1 + w * bpp), w, bpp, depth == 16


def unfilter(rows: torch.Tensor, w: int, bpp: int) -> torch.Tensor:
    """Undo the scanline filters of N images at once: ``rows`` is (N, h,
    1 + w*bpp) uint8, the result (N, h, w, bpp) uint8.

    A byte's predictor reads the decoded bytes one pixel left (a), up (b)
    and up-left (c) of it, so all pixels on one anti-diagonal ``row +
    column`` decode together from the diagonals before it. Types: 0 none,
    1 a, 2 b, 3 floor((a + b) / 2), 4 Paeth (a, then b, then c on ties)."""
    n, h = rows.shape[0], rows.shape[1]
    kinds = rows[:, :, 0].to(torch.int16)
    if h and int(kinds.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    filt = rows[:, :, 1:].reshape(n, h, w, bpp).to(torch.int16)
    out = torch.zeros((n, h + 1, w + 1, bpp), dtype=torch.int16, device=rows.device)
    for d in range(h + w - 1):
        r = torch.arange(max(0, d - w + 1), min(h, d + 1), device=rows.device)
        c = d - r
        a, b, ul = out[:, r + 1, c], out[:, r, c + 1], out[:, r, c]
        k = kinds[:, r][..., None]
        p = a + b - ul
        pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - ul).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, ul))
        pred = torch.where(k == 1, a, torch.where(k == 2, b, torch.where(
            k == 3, (a + b) >> 1, torch.where(k == 4, paeth, torch.zeros_like(a)))))
        out[:, r + 1, c + 1] = (filt[:, r, c] + pred) & 0xFF
    return out[:, 1:, 1:].to(torch.uint8)


def read_pngs(paths, device="cpu") -> torch.Tensor:
    """The 8-bit images of PNG files of one geometry, (N, h, w, channels)
    uint8 on ``device``."""
    parsed = [png_rows(Path(p).read_bytes()) for p in paths]
    _, w, bpp, wide = parsed[0]
    if wide or any(q[1:] != parsed[0][1:] or q[0].shape != parsed[0][0].shape for q in parsed):
        raise ValueError("the files are not 8-bit images of one geometry")
    rows = torch.from_numpy(np.stack([q[0] for q in parsed])).to(device)
    return unfilter(rows, w, bpp)


def read_pam(path) -> np.ndarray:
    """An 8-bit PAM (P7) file's (h, w, depth) uint8 image."""
    data = Path(path).read_bytes()
    end = data.find(b"ENDHDR\n")
    if not data.startswith(b"P7\n") or end < 0:
        raise ValueError("not a PAM file")
    fields = dict(line.split(" ", 1) for line in data[3:end].decode().splitlines() if line)
    w, h, depth = int(fields["WIDTH"]), int(fields["HEIGHT"]), int(fields["DEPTH"])
    if int(fields["MAXVAL"]) != 255:
        raise ValueError("only 8-bit PAM is read")
    pixels = np.frombuffer(data, np.uint8, offset=end + 7)
    if pixels.size != h * w * depth:
        raise ValueError(f"{pixels.size} bytes of PAM data for {w}x{h}x{depth}")
    return pixels.reshape(h, w, depth)


def read_images(paths, fmt: str, device="cpu") -> torch.Tensor:
    """The written files ``paths`` of format ``fmt`` as one (N, h, w, c)
    uint8 tensor on ``device``."""
    if fmt == "png":
        return read_pngs(paths, device)
    if fmt == "pam":
        return torch.from_numpy(np.stack([read_pam(p) for p in paths])).to(device)
    raise ValueError(f"no reader for {fmt!r} files")
