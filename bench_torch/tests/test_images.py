"""The benchmark's file readers against the PNG specification's filters,
written out byte by byte here, and against the program's writers."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest
import torch

from bench_torch import harness, images


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(kind: int, row: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((x - pred) & 0xFF)
    return bytes([kind]) + bytes(out)


def _png(img: np.ndarray, kinds) -> bytes:
    h, w, ch = img.shape
    rows, prev = [], bytes(w * ch)
    for y in range(h):
        row = img[y].tobytes()
        rows.append(_filter_row(kinds[y % len(kinds)], row, prev, ch))
        prev = row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if ch == 4 else 2, 0, 0, 0)
    return (images.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [4, 0, 3, 1, 2]])
def test_png_reader_undoes_every_filter(tmp_path, channels, kinds):
    rng = np.random.default_rng(channels * 10 + len(kinds) + kinds[0])
    img = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    img[:3] = 250  # runs that make ties in the Paeth predictor
    path = tmp_path / "f.png"
    path.write_bytes(_png(img, kinds))
    got = images.read_images([path, path], "png")
    assert got.shape == (2, 9, 13, channels)
    assert torch.equal(got[1], torch.from_numpy(img))


@pytest.mark.parametrize("fmt", ["png", "pam"])
def test_readers_read_the_programs_files(tmp_path, fmt):
    export = harness.program("utils.export")
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (27, 48, 3), dtype=np.uint8)
    img[:, :20] = 0  # the dark background of a render
    path = export.write_image(tmp_path / "frame", img, fmt=fmt, transparent=False,
                              eight_bit=True, silent=True, announce=False)
    assert torch.equal(images.read_images([path], fmt)[0], torch.from_numpy(img))
