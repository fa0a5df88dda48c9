"""The adaptive PNG scanline filter of an image on its device: kernel F,
``csrc/png_filter.cu``, behind :func:`png_filter`, and its plain twin
:func:`png_filter_plain`.

Both give the bytes of :func:`utils.export._filter_scanlines_numpy` on the
image's PNG scanlines (16-bit samples big-endian): per row the filter type
of the five (None, Sub, Up, Average, Paeth) whose residuals, each a byte,
cost least by sum(min(c, 256 - c)), ties to the lowest index, then that
filter's residuals. A PNG write runs it on the device copy of a delivered
image (:func:`deliver.filtered_scanlines`), so the host only deflates. :func:`png_filter`
runs the twin for an image on the CPU; for one on a card it launches the
kernel, adds one to ``png_filter.launches`` and raises when it cannot
launch, never falling back to the twin there.
"""

from __future__ import annotations

import threading

import torch

from . import cuda_lib


def _geometry(image: torch.Tensor) -> tuple:
    """(rows, bytes a row, bytes a pixel) of an (H, W, 3|4) u8/u16 image."""
    if image.dim() != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {tuple(image.shape)}")
    if image.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"expected uint8 or uint16 samples, got {image.dtype}")
    h, w, ch = image.shape
    bpp = ch * image.element_size()
    return h, w * bpp, bpp


def png_filter_plain(image: torch.Tensor) -> torch.Tensor:
    """The filtered scanlines of ``image`` as an (H, 1 + stride) uint8
    tensor on its device: the plain torch twin of kernel F."""
    h, stride, bpp = _geometry(image)
    x = image.to(torch.int32)
    if image.dtype == torch.uint16:
        x = torch.stack([x >> 8, x & 0xFF], dim=-1)  # big-endian bytes
    rows = x.reshape(h, stride)
    left = torch.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = torch.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = torch.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = (p - left).abs(), (p - up).abs(), (p - upleft).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), left, torch.where(pb <= pc, up, upleft))
    cand = torch.stack([rows, rows - left, rows - up, rows - ((left + up) >> 1),
                        rows - paeth]) & 0xFF
    cost = torch.minimum(cand, 256 - cand).sum(dim=-1)
    pick = torch.zeros(h, dtype=torch.int64, device=image.device)
    best = cost[0]
    for f in range(1, 5):  # strict <: a tie keeps the lower index
        better = cost[f] < best
        pick = torch.where(better, f, pick)
        best = torch.where(better, cost[f], best)
    kept = torch.gather(cand, 0, pick.view(1, h, 1).expand(1, h, stride))[0]
    return torch.cat([pick.view(h, 1), kept], dim=1).to(torch.uint8)


def png_filter(image: torch.Tensor) -> torch.Tensor:
    """The filtered PNG scanlines of an (H, W, 3|4) uint8 or uint16 image,
    an (H, 1 + W * C * itemsize) uint8 tensor on the image's device: the
    twin on the CPU, kernel F on a card (on the current stream)."""
    h, stride, bpp = _geometry(image)
    if image.device.type == "cpu":
        return png_filter_plain(image)
    cuda_lib.check_tensor(image, (torch.uint8, torch.uint16), "image")
    out = torch.empty((h, 1 + stride), dtype=torch.uint8, device=image.device)
    cuda_lib.launch("sat_png_filter", image.device, image.data_ptr(), h, stride, bpp,
                    int(image.dtype == torch.uint16), out.data_ptr())
    with _LAUNCHES_LOCK:  # the encoder threads launch at once
        png_filter.launches += 1
    return out


png_filter.launches = 0
_LAUNCHES_LOCK = threading.Lock()
