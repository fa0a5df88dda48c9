"""KERNEL-strategy binning (PyTorch port of the entry point
``strange_attractor_tpu.ops.kernel_binning.bin_chunk_kernel``).

On the TPU that entry point runs a section sort and a Pallas row apply
whose int8 one-hot matrix products dodge the scalar-scatter floor. Hopper
has native atomics, so its kernel, ``csrc/bin_packed.cu``, adds and maxes
straight into the planes: one thread per point. The planes come out
bit-identical to :func:`ops.binning.bin_chunk_packed`, its plain twin,
because add and max commute.

The TPU path's pixel-0 flood eviction is a TPU device and is not carried;
on the GPU the flood is a hot-pixel atomic contention (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .binning import bin_chunk_packed


def bin_chunk_kernel(count, packed, flat, packed_update):
    """Accumulate one point chunk into PACKED planes.

    ``count``/``packed``: (npix,) int32 planes of u32 bits. ``flat``: (M,)
    int32 pixel indices, ``npix`` (or anything outside [0, npix)) marks an
    out-of-bounds point. ``packed_update``: (M,) int32 u32 bits of
    :func:`ops.binning.pack_zv`.

    For CUDA tensors this launches ``csrc/bin_packed.cu`` on the current
    stream, updates ``count`` and ``packed`` IN PLACE and returns them
    (counted in ``bin_chunk_kernel.launches``). For CPU tensors it returns
    :func:`ops.binning.bin_chunk_packed`'s new planes.
    """
    if count.device.type == "cpu":
        return bin_chunk_packed(count, packed, flat, packed_update)
    for t, name in ((count, "count"), (packed, "packed"), (flat, "flat"),
                    (packed_update, "packed_update")):
        cuda_lib.check_tensor(t, torch.int32, name)
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if t.device != count.device:
            raise ValueError(f"{name} is on {t.device}, count on {count.device}")
    npix, m = count.shape[0], flat.shape[0]
    if packed.shape[0] != npix or packed_update.shape[0] != m:
        raise ValueError(f"shape mismatch: count {npix}, packed {packed.shape[0]}, "
                         f"flat {m}, packed_update {packed_update.shape[0]}")
    if m == 0:
        return count, packed
    lib = cuda_lib.library()
    with torch.cuda.device(count.device):
        stream = torch.cuda.current_stream(count.device).cuda_stream
        err = lib.sat_bin_packed(
            ctypes.c_void_p(count.data_ptr()), ctypes.c_void_p(packed.data_ptr()),
            ctypes.c_void_p(flat.data_ptr()), ctypes.c_void_p(packed_update.data_ptr()),
            m, npix, ctypes.c_void_p(stream))
    cuda_lib.check_launch(err, "bin_packed")
    bin_chunk_kernel.launches += 1
    return count, packed


bin_chunk_kernel.launches = 0
