"""Image export (port of ``strange_attractor_tpu.utils.export``): the
(transparent, 8-bit) conversion on the device, then PNG (8/16-bit), animated
PNG, BMP (8-bit) and PAM (8/16-bit) writers on the host.

Mirrors the reference CLI's export matrix (src/bin/main.rs:27-104). The
writers are numpy + stdlib (zlib, struct) only. 16-bit PNG samples are
big-endian per the PNG spec.
"""

from __future__ import annotations

import struct
import zlib
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch


def convert_format(image_u16: np.ndarray, transparent: bool, eight_bit: bool) -> np.ndarray:
    """Apply the (transparent, 8-bit) conversion matrix on the host
    (main.rs:52-57): drop alpha unless transparent; 8-bit scales with
    rounding, ``round(v * 255 / 65535)``. Input already converted by
    :func:`convert_format_device` passes through unchanged."""
    img = image_u16 if (transparent or image_u16.shape[-1] == 3) else image_u16[..., :3]
    if eight_bit and img.dtype != np.uint8:
        img = ((img.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)
    return img


def convert_format_device(image_u16: torch.Tensor, transparent: bool, eight_bit: bool):
    """Torch twin of :func:`convert_format`, run on the device before the
    single host copy. For v in [0, 65535], ``(v*255 + 32767) // 65535 ==
    ((v + 128) * 65281) >> 24`` exactly (the JAX package's strength
    reduction, derived at strange_attractor_tpu/utils/export.py:42-51);
    the product needs more than 31 bits, so it runs in int64."""
    img = image_u16 if transparent else image_u16[..., :3]
    if eight_bit:
        img = (((img.to(torch.int64) + 128) * 65281) >> 24).to(torch.uint8)
    return img


def to_host(image: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of a converted image."""
    return image.contiguous().cpu().numpy()


# ---------------------------------------------------------------- PNG ----


def _png_geometry(arr: np.ndarray):
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
    h, w, ch = arr.shape
    if arr.dtype == np.uint8:
        depth, raw = 8, arr
    elif arr.dtype == np.uint16:
        depth, raw = 16, arr.astype(">u2")
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    color_type = 6 if ch == 4 else 2
    return h, w, depth, color_type, raw


def _filter_scanlines(raw: np.ndarray, h: int) -> bytes:
    """Adaptive per-row PNG filtering (``FilterType::Adaptive``, like the
    reference encoder, src/bin/main.rs:84-88): each scanline keeps the
    filter of the five (None/Sub/Up/Average/Paeth) with the smallest sum of
    absolute signed residuals."""
    raw = np.ascontiguousarray(raw)
    rows = raw.reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = raw.shape[-1] * raw.itemsize
    h, stride = rows.shape
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]

    cand = np.empty((5, h, stride), np.uint8)
    cand[0] = rows
    cand[1] = rows - left
    cand[2] = rows - up
    cand[3] = rows - ((left.astype(np.uint16) + up) >> 1).astype(np.uint8)
    p = left.astype(np.int16) + up - upleft
    pa, pb, pc = (np.abs(p - t) for t in (left, up, upleft))
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cand[4] = rows - pred

    mag = np.empty((5, h), np.int64)
    for i in range(5):
        c = cand[i].astype(np.int32)
        mag[i] = np.minimum(c, 256 - c).sum(axis=1)
    pick = mag.argmin(axis=0)

    filtered = np.empty((h, 1 + stride), np.uint8)
    filtered[:, 0] = pick
    filtered[:, 1:] = np.take_along_axis(cand, pick[None, :, None], axis=0)[0]
    return filtered.tobytes()


def _chunk(tag: bytes, payload: bytes) -> bytes:
    out = struct.pack(">I", len(payload)) + tag + payload
    return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)


def png_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8/uint16 as a PNG byte string."""
    h, w, depth, color_type, raw = _png_geometry(arr)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    idat = zlib.compress(_filter_scanlines(raw, h), 6)
    return b"".join(
        [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", ihdr), _chunk(b"IDAT", idat), _chunk(b"IEND", b"")]
    )


def _apng_delay(fps: float) -> tuple[int, int]:
    """(delay_num, delay_den): the exact rational frame delay ``1/fps`` s in
    the fcTL's two u16 fields; 0/den ("as fast as possible") for rates
    beyond their resolution."""
    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps!r}")
    s = 1.0 / fps
    den = Fraction(s).limit_denominator(65535).denominator
    if round(s * den) > 65535:
        den = max(1, int(65535 // s))
    return min(65535, round(s * den)), den


def apng_bytes(frames: np.ndarray, fps: float = 30.0, loops: int = 0) -> bytes:
    """Encode (F, H, W, 3|4) uint8/uint16 frames as an animated PNG (the JAX
    package's layout: IHDR, acTL, then per frame an fcTL and the frame's
    IDAT, or fdAT after the first; full-canvas frames, dispose none, blend
    source). ``loops=0`` loops forever. Deflated by the stdlib's zlib at
    level 6, so the compressed bytes may differ from the JAX package's
    parallel deflate; the decompressed frames do not."""
    if frames.ndim != 4 or frames.shape[0] < 1:
        raise ValueError(f"expected (F, H, W, C) frames, got {frames.shape}")
    h, w, depth, color_type, _ = _png_geometry(frames[0])
    delay_num, delay_den = _apng_delay(fps)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)),
           _chunk(b"acTL", struct.pack(">II", frames.shape[0], loops))]
    seq = 0
    for f, frame in enumerate(frames):
        raw = _png_geometry(frame)[4]
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, delay_num,
                                               delay_den, 0, 0)))
        seq += 1
        data = zlib.compress(_filter_scanlines(raw, h), 6)
        if f == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_apng(path, frames: np.ndarray, fps: float = 30.0) -> Path:
    """Write :func:`apng_bytes` of ``frames`` to ``path``; returns the path."""
    path = Path(path)
    path.write_bytes(apng_bytes(frames, fps))
    return path


# ---------------------------------------------------------------- BMP ----


def bmp_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8 as BMP (24/32 bpp, bottom-up, BGR[A])."""
    if arr.dtype != np.uint8:
        raise ValueError("BMP export requires 8-bit data (reference CLI constraint)")
    h, w, ch = arr.shape
    if ch == 4:
        row_bytes = arr[..., [2, 1, 0, 3]][::-1].tobytes()
        bpp, compression = 32, 3  # BI_BITFIELDS
        extra = struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
        header_size = 40 + 16
    else:
        bgr = arr[..., [2, 1, 0]]
        pad = (-(w * 3)) % 4
        row_bytes = b"".join(bgr[y].tobytes() + b"\x00" * pad for y in range(h - 1, -1, -1))
        bpp, compression = 24, 0
        extra = b""
        header_size = 40
    pixel_offset = 14 + header_size
    file_size = pixel_offset + len(row_bytes)
    file_header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, pixel_offset)
    info = struct.pack(
        "<IiiHHIIiiII", header_size, w, h, 1, bpp, compression, len(row_bytes), 2835, 2835, 0, 0
    )
    return file_header + info + extra + row_bytes


# ---------------------------------------------------------------- PAM ----


def pam_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8/uint16 as PAM (P7, reference: main.rs:64-70)."""
    h, w, ch = arr.shape
    maxval = 255 if arr.dtype == np.uint8 else 65535
    tupltype = "RGB_ALPHA" if ch == 4 else "RGB"
    header = (
        f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {ch}\nMAXVAL {maxval}\n"
        f"TUPLTYPE {tupltype}\nENDHDR\n"
    ).encode()
    data = arr.tobytes() if arr.dtype == np.uint8 else arr.astype(">u2").tobytes()
    return header + data


_ENCODERS = {"png": png_bytes, "bmp": bmp_bytes, "pam": pam_bytes}


def write_image(base_path, image: np.ndarray, *, fmt: str = "png", transparent: bool = True,
                eight_bit: bool = False, silent: bool = True) -> Path:
    """Convert + write; returns the final path with extension
    (reference: main.rs:40-100). "Wrote image to ..." prints even when
    silent, as in the reference (main.rs:99)."""
    if fmt not in _ENCODERS:
        raise ValueError(f"unknown format {fmt!r} (png, bmp, pam)")
    if not silent:
        print("Converting image format.")
    arr = convert_format(image, transparent, eight_bit)
    path = Path(base_path).with_suffix("." + fmt)
    if not silent:
        print("Rendering complete. Writing file.")
    path.write_bytes(_ENCODERS[fmt](arr))
    print(f"Wrote image to '{path}'.")
    return path
