"""PyTorch port, a sequence's host array in page-locked memory, on the CPU.

From a card ``deliver.host_frames`` takes the sequence's array from torch's
caching host allocator (``deliver._page_locked``) and ``deliver_batch``
copies each batch into it by DMA; the ``deliver.copy`` span says
``pinned`` 1. The CPU has no page-locked memory, so here a pool of CPU
blocks stands in for the allocator (a block freed when its array dies goes
to the next request of its size, at the same address) and ``deliver._card``
says the CPU is a card, as the delivered-copy tests let a CPU tensor stand
in for the card's. Held: a CPU sequence stays a plain, writable, unrecorded
array; a card's asks for page-locked memory once and keeps the contract
(read-only, one record a frame against its batch row, the CPU's values);
a reused block never mixes two sequences' records; a failed page-lock
falls back to pageable memory with ``pinned`` 0; every ``deliver.copy``
span carries ``pinned``; the array ``_page_locked`` makes owns its block.
Last, the benchmark's reader of the attribute on canned spans.
"""

import gc
import math
import threading
import weakref

import numpy as np
import pytest
import torch

import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import deliver
from strange_attractor_tpu_torch.utils import profiling

ENGINES = ("render_sequence_shared", "render_sequence_batched")
ANGLES = [0.0, 10.0, 20.0]


def _cfg(seed=3, **kw):
    return sat.presets.poisson_saturne(width=32, height=18, iterations=4000, lanes=32,
                                       chunk_steps=16, warmup=16, seed=seed, silent=True, **kw)


class _Pool:
    """Page-locked memory as torch's caching host allocator hands it out,
    on the CPU: a block goes back to the pool when the array made on it
    dies, and the next request of its size gets it; with ``live`` every
    request gets the first block, alive or not (what the allocator never
    does: it shows the records' tokens alone keep two sequences apart);
    with ``refuse`` every request fails, as one out of page-locked memory."""

    def __init__(self, live: bool = False, refuse: bool = False):
        self.live, self.refuse = live, refuse
        self.requests, self.blocks, self.free = [], [], {}

    def __call__(self, shape, dtype):
        self.requests.append((tuple(shape), dtype))
        if self.refuse:
            raise RuntimeError("CUDA error: out of memory")
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        free = self.free.setdefault(nbytes, [])
        if self.live and self.blocks:
            block = self.blocks[0]
        elif free:
            block = free.pop()
        else:
            block = torch.empty(nbytes, dtype=torch.uint8)
            self.blocks.append(block)
        arr = block.view(dtype).reshape(shape).numpy()
        weakref.finalize(arr, free.append, block)
        return arr

    def locked(self, arr: np.ndarray) -> bool:
        ptr = arr.__array_interface__["data"][0]
        return any(b.data_ptr() <= ptr < b.data_ptr() + b.numel() for b in self.blocks)


def _as_card(monkeypatch, **kw) -> _Pool:
    """The CPU as a card whose page-locked memory is a :class:`_Pool`."""
    pool = _Pool(**kw)
    monkeypatch.setattr(deliver, "_card", lambda device: True)
    monkeypatch.setattr(deliver, "_page_locked", pool)
    monkeypatch.setattr(deliver, "_is_page_locked", pool.locked)
    return pool


def _sequence(name="render_sequence_shared", seed=3, eight_bit=True, transparent=False):
    """(frames, the ``deliver.copy`` spans' attributes) of three frames, two
    a batch, on the CPU."""
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        frames = getattr(sat, name)(_cfg(seed), ANGLES, frames_per_batch=2,
                                    transparent=transparent, eight_bit=eight_bit, device="cpu")
    copies = [dict(r.attrs) for r in profiling.spans() if r.name == "deliver.copy"]
    profiling.clear_spans()
    return frames, copies


def _records(frames: np.ndarray) -> list:
    """Whether each frame of ``frames`` has a record."""
    return [deliver._layout(frames[f]) in deliver._DEVICE_COPIES for f in range(len(frames))]


@pytest.mark.parametrize("name", ENGINES)
def test_a_cpu_sequence_is_plain_writable_and_unrecorded(monkeypatch, name):
    pool = _Pool()
    monkeypatch.setattr(deliver, "_page_locked", pool)
    frames, copies = _sequence(name)
    assert pool.requests == []
    assert type(frames) is np.ndarray and frames.base is None and frames.flags.writeable
    assert _records(frames) == [False] * len(ANGLES)
    assert [c["pinned"] for c in copies] == [0, 0]


@pytest.mark.parametrize("eight_bit,transparent", [(True, False), (False, True)])
@pytest.mark.parametrize("name", ENGINES)
def test_a_card_sequence_lands_in_page_locked_memory_and_keeps_its_contract(
        monkeypatch, name, eight_bit, transparent):
    want, _ = _sequence(name, eight_bit=eight_bit, transparent=transparent)
    pool = _as_card(monkeypatch)
    frames, copies = _sequence(name, eight_bit=eight_bit, transparent=transparent)
    assert pool.requests == [((3, 18, 32, 3 if not transparent else 4),
                              torch.uint8 if eight_bit else torch.uint16)]
    assert pool.locked(frames) and isinstance(frames.base, torch.Tensor)
    np.testing.assert_array_equal(frames, want)
    assert not frames.flags.writeable
    assert _records(frames) == [True] * len(ANGLES)
    assert all(deliver._owner(frames[f]) is frames for f in range(len(frames)))
    for f in range(len(frames)):
        copy = deliver.take_device_copy(frames[f])
        np.testing.assert_array_equal(copy.numpy(), frames[f])
    assert [c["pinned"] for c in copies] == [1, 1]
    assert [c["bytes"] for c in copies] == [2 * frames[0].nbytes, frames[0].nbytes]


def test_a_reused_block_takes_the_new_sequences_records(monkeypatch):
    """The old sequence dies, the next lands on its block: the old records
    went with the old array, and each new frame's record is its own."""
    pool = _as_card(monkeypatch)
    old, _ = _sequence(seed=3)
    old_values, old_ptr = old.copy(), old.__array_interface__["data"][0]
    old_keys = [deliver._layout(old[f]) for f in range(len(old))]
    del old
    gc.collect()
    assert not any(k in deliver._DEVICE_COPIES for k in old_keys)
    new, _ = _sequence(seed=4)
    assert new.__array_interface__["data"][0] == old_ptr and len(pool.blocks) == 1
    assert [deliver._layout(new[f]) for f in range(len(new))] == old_keys
    assert not np.array_equal(new, old_values)
    for f in range(len(new)):
        np.testing.assert_array_equal(deliver.take_device_copy(new[f]).numpy(), new[f])


def test_the_old_finalizer_drops_none_of_the_new_records(monkeypatch):
    """Two sequences on one block at once: the newer records replace the
    older, and the older array's death leaves them be."""
    _as_card(monkeypatch, live=True)
    old, _ = _sequence(seed=3)
    new, _ = _sequence(seed=4)
    assert new.__array_interface__["data"][0] == old.__array_interface__["data"][0]
    new_values = new.copy()
    del old
    gc.collect()
    assert _records(new) == [True] * len(ANGLES)
    for f in range(len(new)):
        np.testing.assert_array_equal(deliver.take_device_copy(new[f]).numpy(), new_values[f])


@pytest.mark.parametrize("name", ENGINES)
def test_a_failed_page_lock_falls_back_to_pageable_memory(monkeypatch, name):
    want, _ = _sequence(name)
    pool = _as_card(monkeypatch, refuse=True)
    frames, copies = _sequence(name)
    assert pool.requests == [((3, 18, 32, 3), torch.uint8)] and not pool.blocks
    assert frames.base is None
    np.testing.assert_array_equal(frames, want)
    assert not frames.flags.writeable and _records(frames) == [True] * len(ANGLES)
    assert [c["pinned"] for c in copies] == [0, 0]


@pytest.mark.parametrize("where", ["cpu", "card", "card-fallback"])
def test_every_copy_span_says_pinned(monkeypatch, where):
    if where != "cpu":
        _as_card(monkeypatch, refuse=where == "card-fallback")
    for name in ENGINES:
        _, copies = _sequence(name)
        assert len(copies) == 2
        assert all(set(c) == {"bytes", "pinned"} for c in copies)
        assert {c["pinned"] for c in copies} == {int(where == "card")}


def test_the_page_locked_array_owns_its_block(monkeypatch):
    """The array ``_page_locked`` makes is the root of its frames' views,
    and its death lets go of the tensor that holds the block."""
    asked, empty = [], torch.empty

    def unpinned(*args, pin_memory=False, **kw):
        asked.append(pin_memory)
        return empty(*args, **kw)

    monkeypatch.setattr(deliver.torch, "empty", unpinned)
    arr = deliver._page_locked((2, 3, 4, 3), torch.uint8)
    monkeypatch.undo()
    assert asked == [True] and arr.shape == (2, 3, 4, 3) and arr.dtype == np.uint8
    assert isinstance(arr.base, torch.Tensor)
    assert deliver._owner(arr[1]) is arr and deliver._owner(arr[:1][0]) is arr
    held = weakref.ref(arr.base)
    del arr
    gc.collect()
    assert held() is None


# ---------------------------------------------------------------- reader ----


def _pinned_share(pinned: list, *, missing: bool = False):
    """host_copy_pinned_share.rotation on a canned window of one sequence
    an entry of ``pinned``, each with its ``deliver.copy`` span."""
    from bench_torch import harness

    rec = harness.Recorder(False)
    buf = profiling.SpanBuffer()
    me = threading.get_native_id()
    for i, value in enumerate(pinned):
        rec.items.append(harness.Span("item", i, 10.0 * i, 10.0 * i + 4.0))
        attrs = {"bytes": 373_248_000}
        if not missing:
            attrs["pinned"] = value
        buf.add(profiling.SpanRecord("deliver.copy", round((10.0 * i + 1) * 1e9),
                                     round((10.0 * i + 2) * 1e9), me, i + 1, None, attrs))
    run = harness.Run(harness.find_cell(harness.load_bench(), "poisson-saturne.rotation-pam"),
                      1.0, rec, {"frames_per_item": 120, "width": 4, "height": 2}, {}, None, {})
    metric = "host_copy_pinned_share.rotation"
    module = harness.load_module(harness.HERE / "metrics" / f"{metric}.py", "m_pinned_share")
    old, profiling.BUFFER = profiling.BUFFER, buf
    try:
        return module.read(run)
    finally:
        profiling.BUFFER = old


def test_the_pinned_share_reader():
    assert _pinned_share([1, 1, 1, 1]) == pytest.approx(100.0)
    assert _pinned_share([1, 0, 1, 0]) == pytest.approx(50.0)
    assert _pinned_share([0, 0]) == 0.0
    # a program before the attribute, no span at all
    assert _pinned_share([1, 1], missing=True) is None
    assert _pinned_share([]) is None
