"""Kernel-strategy binning (PyTorch port of the entry points of
``strange_attractor_tpu.ops.kernel_binning``): KERNEL, DEPTH_KERNEL,
EXACT_KERNEL and EXACT16_KERNEL.

On the TPU each entry point runs a section sort and a Pallas row apply
whose int8 one-hot matrix products dodge the scalar-scatter floor. Hopper
has native atomics in global and in shared memory, and the Hopper kernels
use them two ways:

- ``csrc/bin_packed.cu`` (:func:`bin_chunk_kernel`): count and packed max
  straight into the planes, one thread per point, the pixel-0 flood reduced
  inside each block first;
- ``csrc/bin_depth.cu`` (:func:`bin_chunk_kernel_depth`): the mono-u32 max
  of the depth, in place on the float32 plane, one thread per point, the
  plane read through L1 and an atomic only where a point raises its pixel,
  the pixel-0 flood reduced inside each block first;
- ``csrc/bin_exact.cu`` (:func:`bin_chunk_kernel_exact`) and
  ``csrc/bin_exact16.cu`` (:func:`bin_chunk_kernel_exact16`): the tile bin
  of ``csrc/bin_tile.cuh``. A counting sort partitions the chunk by canvas
  tile (runs of 32 pixels dealt round-robin over the tiles), a block
  aggregates its tile's hit counts and winner keys in shared memory and
  merges them into the EXACT planes with plain loads and stores. No point
  issues a global atomic; the pixel-0 flood leaves the stream in the
  partition, reduced by warp votes to one atomic pair a block. The work
  buffers are a :class:`BinWork` (:func:`new_work`).

Every reduction commutes, so the planes come out deterministic and
bit-identical to the plain twins in :mod:`ops.binning`. A wrapper runs its
twin for CPU tensors and returns new planes; for CUDA tensors it launches
its kernel on the current stream, updates the planes IN PLACE, returns
them and adds one to its ``launches`` count (one wrapper call is one
launch of the count, whatever number of CUDA kernels it starts: the tile
bin starts five a band of the canvas). It raises when it cannot launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import cuda_lib
from .binning import bin_chunk_depth, bin_chunk_exact, bin_chunk_exact16, bin_chunk_packed


def _check(npix: int, m: int, planes, stream) -> None:
    """Raise unless the planes are (npix,) and the stream tensors (m,), all
    contiguous 1-D tensors of the given dtypes on the first plane's card."""
    device = planes[0][0].device
    for group, size in ((planes, npix), (stream, m)):
        for t, dtype, name in group:
            cuda_lib.check_tensor(t, dtype, name)
            if tuple(t.shape) != (size,):
                raise ValueError(f"{name} must have shape ({size},), got {tuple(t.shape)}")
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, the planes on {device}")


# int32 words of the tile bin's control block (csrc/bin_tile.cuh struct
# Control): the pixel-0 aggregate
CONTROL_WORDS = 4
# the tile bin's partition (csrc/bin_tile.cuh MAX_TILES, MAX_SPANS,
# SPAN_BITS): the most tiles of a band of the canvas, the least columns of
# the table of record counts by tile and stream span, and the bits of a
# point's offset in its span (a chunk of more than MAX_SPANS << SPAN_BITS
# points gets one column a span of 2^SPAN_BITS)
MAX_TILES, MAX_SPANS, SPAN_BITS = 1024, 1024, 17


class BinWork(NamedTuple):
    """The tile bin's work buffers (EXACT and EXACT16 kernels)."""

    # (record_words(points),) int32: the chunk partitioned by tile (a record
    # is 8 bytes), then the partition's table; contents free
    records: torch.Tensor
    control: torch.Tensor  # (CONTROL_WORDS,) int32: all zero between launches


def table_words(points: int) -> int:
    """int32 words behind the records of a chunk of ``points`` points
    (csrc/bin_tile.cuh tile_bin): the table of record counts by tile and
    span, the tiles' totals and the buckets' first records."""
    return (max(MAX_SPANS, -(-points >> SPAN_BITS)) + 2) * MAX_TILES


def record_words(points: int) -> int:
    """int32 words of the records (two a point) and the table of a chunk of
    ``points`` points."""
    return 2 * points + table_words(points)


def new_work(points: int, device) -> BinWork:
    """Work buffers for chunks of up to ``points`` points. Each launch
    leaves the control words zero again and needs nothing of the records'
    old contents, so a render allocates one and hands it to every chunk
    (and to every frame of a sequence)."""
    return BinWork(torch.empty(record_words(points), dtype=torch.int32, device=device),
                   torch.zeros(CONTROL_WORDS, dtype=torch.int32, device=device))


def _work(m: int, work: Optional[BinWork], device) -> BinWork:
    if work is None:
        return new_work(m, device)
    cuda_lib.check_tensor(work.records, torch.int32, "work.records")
    cuda_lib.check_tensor(work.control, torch.int32, "work.control")
    if work.records.numel() < record_words(m) or work.control.numel() != CONTROL_WORDS \
            or work.records.device != device or work.control.device != device:
        raise ValueError(f"work must hold {record_words(m)} record and {CONTROL_WORDS} "
                         f"control words on {device}, got {work.records.numel()} on "
                         f"{work.records.device} and {work.control.numel()} on "
                         f"{work.control.device}")
    return work


def bin_chunk_kernel(count, packed, flat, packed_update):
    """Accumulate one point chunk into PACKED planes.

    ``count``/``packed``: (npix,) int32 planes of u32 bits. ``flat``: (M,)
    int32 pixel indices, ``npix`` (or anything outside [0, npix)) marks an
    out-of-bounds point. ``packed_update``: (M,) int32 u32 bits of
    :func:`ops.binning.pack_zv`. A CUDA launch runs ``csrc/bin_packed.cu``;
    the CPU twin is :func:`ops.binning.bin_chunk_packed`.
    """
    if count.device.type == "cpu":
        return bin_chunk_packed(count, packed, flat, packed_update)
    npix, m = count.shape[0], flat.shape[0]
    _check(npix, m, [(count, torch.int32, "count"), (packed, torch.int32, "packed")],
           [(flat, torch.int32, "flat"), (packed_update, torch.int32, "packed_update")])
    if m:
        cuda_lib.launch("sat_bin_packed", count.device, count.data_ptr(), packed.data_ptr(),
                        flat.data_ptr(), packed_update.data_ptr(), m, npix)
        bin_chunk_kernel.launches += 1
    return count, packed


def bin_chunk_kernel_depth(zbuf, flat, z):
    """Accumulate one point chunk into the DEPTH plane: the per-pixel max
    depth in mono-u32 order, the stream's zeros as +0.0.

    ``zbuf``: (npix,) float32 plane with the -1.0 sentinel. ``flat``: (M,)
    int32 pixel indices (``npix`` = out of bounds); ``z``: (M,) float32.
    Returns ``(zbuf,)``. A CUDA launch runs ``csrc/bin_depth.cu``; the CPU
    twin is :func:`ops.binning.bin_chunk_depth`.
    """
    if zbuf.device.type == "cpu":
        return bin_chunk_depth(zbuf, flat, z)
    npix, m = zbuf.shape[0], flat.shape[0]
    _check(npix, m, [(zbuf, torch.float32, "zbuf")],
           [(flat, torch.int32, "flat"), (z, torch.float32, "z")])
    if m:
        cuda_lib.launch("sat_bin_depth", zbuf.device, zbuf.data_ptr(), flat.data_ptr(),
                        z.data_ptr(), m, npix)
        bin_chunk_kernel_depth.launches += 1
    return (zbuf,)


def _exact_check(count, steps, zbuf, flat, z, val):
    npix, m = count.shape[0], flat.shape[0]
    if m >= 1 << 31:  # the winner keys hold a 31-bit stream index
        raise ValueError(f"a chunk holds fewer than 2^31 points, got {m}")
    _check(npix, m, [(count, torch.int32, "count"), (steps, torch.float32, "steps"),
                     (zbuf, torch.float32, "zbuf")],
           [(flat, torch.int32, "flat"), (z, torch.float32, "z"),
            (val, torch.float32, "val")])
    return npix, m


def bin_chunk_kernel_exact(count, steps, zbuf, flat, z, val, *, work=None):
    """Accumulate one point chunk into EXACT planes with EXACT_KERNEL's
    semantics (see :func:`ops.binning.bin_chunk_exact`, its CPU twin):
    full float32 z and value, the strict z-test, the earliest point on an
    equal (pixel, z) pair inside the chunk.

    ``count`` (int32 u32 bits), ``steps``, ``zbuf`` (float32): (npix,)
    planes. ``flat`` (int32), ``z``, ``val`` (float32): the (M,) stream.
    ``work``: a :func:`new_work` to reuse (one is allocated if None). A CUDA
    launch runs ``csrc/bin_exact.cu``.
    """
    if count.device.type == "cpu":
        return bin_chunk_exact(count, steps, zbuf, flat, z, val)
    npix, m = _exact_check(count, steps, zbuf, flat, z, val)
    if m:
        work = _work(m, work, count.device)
        cuda_lib.launch("sat_bin_exact", count.device, count.data_ptr(), steps.data_ptr(),
                        zbuf.data_ptr(), work.control.data_ptr(), work.records.data_ptr(),
                        flat.data_ptr(), z.data_ptr(), val.data_ptr(), m, npix)
        bin_chunk_kernel_exact.launches += 1
    return count, steps, zbuf


def bin_chunk_kernel_exact16(count, steps, zbuf, flat, z, val, *, ties: str = "value",
                             work=None):
    """Accumulate one point chunk into EXACT planes with EXACT16_KERNEL's
    contract (see :func:`ops.binning.bin_chunk_exact16`, its CPU twin): z
    at 16-bit bucket granularity, the value through float16, bucket ties by
    the smallest float16 value (``ties="value"``) or the earliest point
    (``ties="earliest"``).

    Arguments as :func:`bin_chunk_kernel_exact`. A CUDA launch runs
    ``csrc/bin_exact16.cu``.
    """
    if ties not in ("value", "earliest"):
        raise ValueError(f"ties must be 'value' or 'earliest', got {ties!r}")
    if count.device.type == "cpu":
        return bin_chunk_exact16(count, steps, zbuf, flat, z, val, ties)
    npix, m = _exact_check(count, steps, zbuf, flat, z, val)
    if m:
        work = _work(m, work, count.device)
        cuda_lib.launch("sat_bin_exact16", count.device, count.data_ptr(), steps.data_ptr(),
                        zbuf.data_ptr(), work.control.data_ptr(), work.records.data_ptr(),
                        flat.data_ptr(), z.data_ptr(), val.data_ptr(), m, npix,
                        int(ties == "earliest"))
        bin_chunk_kernel_exact16.launches += 1
    return count, steps, zbuf


bin_chunk_kernel.launches = 0
bin_chunk_kernel_depth.launches = 0
bin_chunk_kernel_exact.launches = 0
bin_chunk_kernel_exact16.launches = 0
