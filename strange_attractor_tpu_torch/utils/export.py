"""Image export (port of ``strange_attractor_tpu.utils.export``): the
(transparent, 8-bit) conversion on the device, then PNG (8/16-bit), animated
PNG, BMP (8-bit) and PAM (8/16-bit) writers on the host, and a PNG reader
(:func:`read_png`) for the tools that compare images.

Mirrors the reference CLI's export matrix (src/bin/main.rs:27-104). PNG
scanlines are filtered and deflated by the native host library of
:mod:`utils.native` (``csrc/fastdeflate.cpp``: a multi-threaded adaptive
filter and a parallel deflate), and by numpy and the stdlib's zlib where it
cannot be built. 16-bit PNG samples are big-endian per the PNG spec.

An image delivered from a card keeps its device copy until it is written.
``render`` records each host array it fills from a card against the device
tensor it was copied from (:func:`_record_device_copy`), keyed on the
array's exact layout (data address, shape, strides, dtype), and sets the
array read-only. A PNG of such an array, while it reads read-only, is
filtered on the card (:func:`ops.png_filter.png_filter`, kernel F) and its
filtered scanlines come back in one copy; the host then only deflates. A
record goes at the array's first :func:`write_image` (a BMP or PAM has no
use for it), with the array that owns the memory, or, oldest first, once
the records of a device hold more than ``_DEVICE_COPY_BUDGET`` bytes of
its memory (a long sequence the host keeps): its PNG then takes the host
filter, as does any other array (a CPU render, a slice, a converted layout,
a copy, an APNG frame, an array that is writable when it is written). An
array made writable, changed and set read-only again cannot be told from
one never changed: copy it instead.

Spans (:func:`utils.profiling.span`, recorded under a profiler only):
``deliver.copy`` (:func:`to_host`; ``bytes``), ``image.write``
(:func:`write_image`, whole; ``fmt``, ``bytes`` of the file),
``png.filter`` (``bytes_in``, ``bytes_out``, ``native`` 1 or 0, ``card``
1 where the device filtered, else 0),
``png.deflate`` (``bytes_in``, ``bytes_out``, ``threads``, ``stripes``) and
``file.write`` (``bytes``). ``image.write``'s time outside its children
is the host's format pass, the CRC and the join.
"""

from __future__ import annotations

import itertools
import struct
import threading
import weakref
import zlib
from collections import OrderedDict
from fractions import Fraction
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops.png_filter import png_filter
from .native import deflate_stripes, deflate_threads, png_filter_adaptive, zlib_compress_parallel
from .profiling import span


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
    with span("deliver.copy") as sp:
        out = image.contiguous().cpu().numpy()
        if sp:
            sp.set(bytes=out.nbytes)
    return out


# ------------------------------------------------- delivered device copies ----

# the device memory the records of one device may hold: the sequence
# engines' budget for a batch (render._auto_frames_per_batch)
_DEVICE_COPY_BUDGET = 2_000_000_000
# layout key -> (token, weak reference to the owning array, device tensor,
# its storage's key), oldest first
_DEVICE_COPIES: OrderedDict = OrderedDict()
# (device, storage address) -> [records that hold the storage, its bytes]
_HELD: dict = {}
# reentrant: a record's finalizer may run inside the lock, on any thread
_DEVICE_COPIES_LOCK = threading.RLock()
_TOKENS = itertools.count()


def _layout(arr: np.ndarray) -> tuple:
    return arr.__array_interface__["data"][0], arr.shape, arr.strides, arr.dtype.str


def _owner(arr: np.ndarray) -> np.ndarray:
    """The array at the root of ``arr``'s views: the one whose death frees
    (or lets go of) the memory."""
    while isinstance(arr.base, np.ndarray):
        arr = arr.base
    return arr


def _record_device_copy(host: np.ndarray, device: torch.Tensor) -> None:
    """Record that ``host`` holds the bytes of ``device``, a contiguous
    tensor of its shape and dtype that nothing writes again (a view keeps
    its whole storage). The record lives until its array's first write,
    until the array that owns ``host``'s memory dies, or until newer
    records push its device's held bytes past ``_DEVICE_COPY_BUDGET``."""
    if tuple(device.shape) != host.shape or device.element_size() != host.itemsize:
        raise ValueError(f"a {tuple(device.shape)} {device.dtype} tensor cannot be the copy "
                         f"of a {host.shape} {host.dtype} array")
    owner, key, token = _owner(host), _layout(host), next(_TOKENS)
    storage = device.untyped_storage()
    where = str(device.device)
    held_key = (where, storage.data_ptr())
    with _DEVICE_COPIES_LOCK:
        _drop_device_copy(key)
        _DEVICE_COPIES[key] = (token, weakref.ref(owner), device, held_key)
        _HELD.setdefault(held_key, [0, storage.nbytes()])[0] += 1
        while sum(b for (d, _), (_, b) in _HELD.items() if d == where) > _DEVICE_COPY_BUDGET:
            _drop_device_copy(next(k for k, r in list(_DEVICE_COPIES.items())
                                   if r[3][0] == where))
    weakref.finalize(owner, _forget_device_copy, key, token)


def _drop_device_copy(key: tuple) -> Optional[tuple]:
    """Remove the record of ``key``, if any, and return it; under the lock."""
    record = _DEVICE_COPIES.pop(key, None)
    if record is not None:
        held = _HELD[record[3]]
        held[0] -= 1
        if not held[0]:
            del _HELD[record[3]]
    return record


def _forget_device_copy(key: tuple, token: int) -> None:
    with _DEVICE_COPIES_LOCK:
        record = _DEVICE_COPIES.get(key)
        if record is not None and record[0] == token:
            _drop_device_copy(key)


def _take_device_copy(arr: np.ndarray) -> Optional[torch.Tensor]:
    """The device copy recorded for exactly ``arr``'s layout, dropping the
    record; None without one, or once ``arr`` or its owner is writable."""
    with _DEVICE_COPIES_LOCK:
        record = _drop_device_copy(_layout(arr))
    if record is None:
        return None
    owner = record[1]()
    if owner is None or arr.flags.writeable or owner.flags.writeable:
        return None
    return record[2]


def _filter_on_device(image: torch.Tensor) -> np.ndarray:
    """The filtered scanlines of a delivered image's device copy as a flat
    uint8 host array. On a card kernel F runs on a stream of its own (the
    copy is complete: its host copy has returned) and the bytes come back
    in one copy into pinned memory, which the deflate then reads."""
    if image.device.type != "cuda":
        return png_filter(image).reshape(-1).numpy()
    stream = torch.cuda.Stream(image.device)
    with torch.cuda.stream(stream):
        filtered = png_filter(image)
        host = torch.empty(filtered.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(filtered.reshape(-1), non_blocking=True)
    stream.synchronize()
    return host.numpy()


# ---------------------------------------------------------------- PNG ----


def _png_geometry(arr: np.ndarray, samples: bool = True):
    """(h, w, bit depth, colour type, samples): the samples as the PNG
    stores them (16-bit big-endian), or None unless ``samples``."""
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
    h, w, ch = arr.shape
    if arr.dtype == np.uint8:
        depth, raw = 8, arr
    elif arr.dtype == np.uint16:
        depth, raw = 16, arr.astype(">u2") if samples else None
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    color_type = 6 if ch == 4 else 2
    return h, w, depth, color_type, raw


def _filter_scanlines(raw: Optional[np.ndarray], h: int, device: Optional[torch.Tensor] = None):
    """Adaptive per-row PNG filtering (``FilterType::Adaptive``, like the
    reference encoder, src/bin/main.rs:84-88): each scanline keeps the
    filter of the five (None/Sub/Up/Average/Paeth) with the smallest sum of
    absolute signed residuals. ``device``, a delivered image's device copy,
    is filtered there (:func:`_filter_on_device`; ``raw`` is not read);
    else the native filter runs on the host, or
    :func:`_filter_scanlines_numpy`. Returns the filtered bytes (bytes or a
    flat uint8 array)."""
    if device is not None:
        with span("png.filter", bytes_in=device.numel() * device.element_size()) as sp:
            out = _filter_on_device(device)
            if sp:
                sp.set(bytes_out=out.nbytes, native=0, card=1)
        return out
    raw = np.ascontiguousarray(raw)
    rows = raw.reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = raw.shape[-1] * raw.itemsize
    with span("png.filter", bytes_in=rows.nbytes) as sp:
        out = png_filter_adaptive(rows, bpp) if h > 0 else None
        native = out is not None
        if not native:
            out = _filter_scanlines_numpy(rows, bpp)
        if sp:
            sp.set(bytes_out=len(out), native=int(native), card=0)
    return out


def _filter_scanlines_numpy(rows: np.ndarray, bpp: int) -> bytes:
    """The numpy adaptive filter of (h, stride) uint8 scanlines: the
    fallback, and the reference the native filter is held to byte for
    byte."""
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


def _deflate(filtered) -> bytes:
    """The zlib stream of a frame's filtered scanlines, at level 6."""
    with span("png.deflate", bytes_in=len(filtered)) as sp:
        out = zlib_compress_parallel(filtered, 6)
        if sp:
            n = len(filtered)
            sp.set(bytes_out=len(out), threads=deflate_threads(n), stripes=deflate_stripes(n))
    return out


def png_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8/uint16 as a PNG byte string; a delivered
    image's scanlines are filtered on its device (module docstring)."""
    device = _take_device_copy(arr)
    h, w, depth, color_type, raw = _png_geometry(arr, samples=device is None)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    idat = _deflate(_filter_scanlines(raw, h, device))
    return b"".join(
        [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", ihdr), _chunk(b"IDAT", idat), _chunk(b"IEND", b"")]
    )


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters of ``data``, ``h`` rows of a filter
    byte and ``w * bpp`` bytes: (h, w, bpp) uint8.

    A byte depends on the decoded bytes one pixel left, up and up-left of
    it (PNG spec 9.2-9.4; "left" is ``bpp`` bytes back), so every pixel of
    one anti-diagonal ``row + column = d`` can be decoded at once from the
    diagonals before it: h + w - 1 vector steps, whatever the rows'
    filters. Paeth (type 4) takes a, then b, then c on ties, in integers,
    as the spec's PaethPredictor does."""
    rows = data.reshape(h, 1 + w * bpp)
    kinds = rows[:, 0].astype(np.int64)
    if h and kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown scanline filter type {int(kinds.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int16)
    # one zero row above and one zero column left of the image
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        k = kinds[r][:, None]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(k == 3, (a + b) >> 1,
                                                                  np.where(k == 4, paeth, 0))))
        out[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode a PNG file to an (H, W, 3|4) uint8 or uint16 array, with the
    stdlib's zlib and numpy only.

    Reads 8- and 16-bit RGB and RGBA (colour types 2 and 6), every
    scanline filter, and image data split over any number of IDAT chunks.
    An animated PNG gives its default image, the IDAT data (its fdAT
    frames are skipped). Palette, greyscale and interlaced images, and
    other bit depths, raise a ``ValueError`` that names the case."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = header
    names = {0: "greyscale", 3: "palette", 4: "greyscale with alpha"}
    if color_type in names:
        raise ValueError(f"{path}: {names[color_type]} PNG images are not supported "
                         f"(RGB and RGBA only)")
    if color_type not in (2, 6):
        raise ValueError(f"{path}: unknown PNG colour type {color_type}")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 and 16 only)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG images are not supported")
    ch = 4 if color_type == 6 else 3
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * bpp)} for {w}x{h}")
    pixels = _unfilter(raw, h, w, bpp)
    if depth == 16:
        return pixels.view(">u2").reshape(h, w, ch).astype(np.uint16)
    return pixels.reshape(h, w, ch)


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
    source). ``loops=0`` loops forever. Deflated at level 6 as
    :func:`png_bytes` is."""
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
        data = _deflate(_filter_scanlines(raw, h))
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


def write_png(path, arr: np.ndarray) -> None:
    """Write :func:`png_bytes` of ``arr`` to ``path``."""
    Path(path).write_bytes(png_bytes(arr))


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


def write_bmp(path, arr: np.ndarray) -> None:
    """Write :func:`bmp_bytes` of ``arr`` to ``path``."""
    Path(path).write_bytes(bmp_bytes(arr))


# ---------------------------------------------------------------- PAM ----


def _pam_parts(arr: np.ndarray) -> tuple:
    """A PAM's header and its samples as a flat view of ``arr``'s buffer:
    an 8-bit image is not copied, a 16-bit one once, to big-endian."""
    h, w, ch = arr.shape
    maxval = 255 if arr.dtype == np.uint8 else 65535
    tupltype = "RGB_ALPHA" if ch == 4 else "RGB"
    header = (
        f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {ch}\nMAXVAL {maxval}\n"
        f"TUPLTYPE {tupltype}\nENDHDR\n"
    ).encode()
    data = np.ascontiguousarray(arr if arr.dtype == np.uint8 else arr.astype(">u2"))
    return header, memoryview(data).cast("B")


def pam_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8/uint16 as PAM (P7, reference: main.rs:64-70)."""
    header, data = _pam_parts(arr)
    return header + data


def write_pam(path, arr: np.ndarray) -> None:
    """Write :func:`pam_bytes` of ``arr`` to ``path``, header then samples,
    without joining them."""
    _write_parts(path, _pam_parts(arr))


def _write_parts(path, parts) -> None:
    with open(path, "wb") as f:
        for part in parts:
            f.write(part)


_ENCODERS = {"png": png_bytes, "bmp": bmp_bytes, "pam": pam_bytes}


def write_image(base_path, image: np.ndarray, *, fmt: str = "png", transparent: bool = True,
                eight_bit: bool = False, silent: bool = True, announce: bool = True) -> Path:
    """Convert + write; returns the final path with extension
    (reference: main.rs:40-100). "Wrote image to ..." prints even when
    silent, as in the reference (main.rs:99), unless ``announce`` is False
    (the CLI's previews)."""
    if fmt not in _ENCODERS:
        raise ValueError(f"unknown format {fmt!r} (png, bmp, pam)")
    with span("image.write", fmt=fmt) as sp:
        if not silent:
            print("Converting image format.")
        arr = convert_format(image, transparent, eight_bit)
        if fmt != "png":
            _take_device_copy(image)  # a BMP or PAM has no use for the device copy
        path = Path(base_path).with_suffix("." + fmt)
        if not silent:
            print("Rendering complete. Writing file.")
        parts = _pam_parts(arr) if fmt == "pam" else (_ENCODERS[fmt](arr),)
        nbytes = sum(len(part) for part in parts)
        with span("file.write", bytes=nbytes):
            _write_parts(path, parts)
        if sp:
            sp.set(bytes=nbytes)
    if announce:
        print(f"Wrote image to '{path}'.")
    return path
