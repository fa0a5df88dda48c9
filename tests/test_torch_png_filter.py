"""PyTorch port, the PNG scanline filter on the image's device.

Kernel F's plain twin (``ops.png_filter.png_filter_plain``, what
``png_filter`` runs for an image on the CPU) is held byte for byte to
``utils.export._filter_scanlines_numpy`` in the four layouts a PNG is
written in (8- and 16-bit, RGB and RGBA), at shapes from one pixel to a
270 x 480 render-like image, and on a constant image, where filters tie,
and to the JAX package's ``_filter_scanlines_numpy`` on the scanlines the
JAX package's own ``_png_geometry`` makes. (The kernel's own source runs on
the CPU in ``test_torch_png_filter_emulation.py``, and on the card in
chip_smoke.py.)

Then the record of a delivered image's device copy (``utils.export``), with
a CPU tensor standing in for the card's, registered through
``_record_device_copy``: a record is used by one PNG and then gone, and a
PAM or BMP write drops it; it dies with the array that owns the memory, not
with a view that was handed over; past the budget of device bytes the
oldest records go first, a batch's storage counted once; an array made
writable again, a slice, a ``convert_format`` result and a copy take the
host filter; the ``png.filter`` span says ``card`` 1 or 0 to match, and the
PNG's bytes are the host filter's either way. Last, the two benchmark
readers of that attribute on canned spans.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from strange_attractor_tpu.utils import export as jexport
from strange_attractor_tpu_torch.ops import png_filter as pf
from strange_attractor_tpu_torch.render import _fetch
from strange_attractor_tpu_torch.utils import export, profiling
from test_torch_encoder import _image, _rows

LAYOUTS = ((np.uint8, 3), (np.uint8, 4), (np.uint16, 3), (np.uint16, 4))
SHAPES = ((1, 1), (2, 3), (37, 53), (270, 480), "constant")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,ch", LAYOUTS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_the_twin_is_byte_identical_to_the_numpy_filter(dtype, ch, shape):
    if shape == "constant":
        img = np.full((31, 45, ch), np.iinfo(dtype).max // 5, dtype)
    else:
        h, w = shape
        img = _image(np.random.default_rng(h * 7 + w), h, w, dtype, ch)
    want = export._filter_scanlines_numpy(*_rows(img))
    launches = pf.png_filter.launches
    got = pf.png_filter(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.shape == (img.shape[0], len(want) // img.shape[0])
    assert got.numpy().tobytes() == want
    assert pf.png_filter.launches == launches  # the twin counts no launch
    if shape == "constant":
        # Up and Paeth both cost 0 below row 0: the tie goes to Up
        assert got[0, 0] == 1 and (got[1:, 0] == 2).all()
    if shape == (270, 480) and dtype == np.uint8:
        assert set(got[:, 0].tolist()) == {0, 1, 2, 3, 4}


def _jax_filter(img: np.ndarray) -> bytes:
    """The JAX package's numpy filter of ``img``'s PNG scanlines, the
    scanlines as the JAX package's writer makes them."""
    h, _, _, _, raw = jexport._png_geometry(img)
    raw = np.ascontiguousarray(raw)
    return jexport._filter_scanlines_numpy(raw.reshape(h, -1).view(np.uint8).reshape(h, -1),
                                           jexport._bytes_per_pixel(raw))


@pytest.mark.parametrize("shape", ((1, 1), (37, 53), (270, 480), "constant"), ids=str)
@pytest.mark.parametrize("dtype,ch", LAYOUTS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_the_twin_is_byte_identical_to_the_jax_filter(dtype, ch, shape):
    if shape == "constant":
        img = np.full((31, 45, ch), np.iinfo(dtype).max // 7, dtype)
    else:
        h, w = shape
        img = _image(np.random.default_rng(h * 11 + w), h, w, dtype, ch)
    assert pf.png_filter_plain(torch.from_numpy(img)).numpy().tobytes() == _jax_filter(img)


@pytest.mark.parametrize("bad,error", [
    (torch.zeros(4, 4, dtype=torch.uint8), ValueError),
    (torch.zeros(4, 4, 2, dtype=torch.uint8), ValueError),
    (torch.zeros(4, 4, 3, dtype=torch.int32), TypeError),
    (torch.zeros(4, 4, 3, dtype=torch.float32), TypeError),
])
def test_the_filter_refuses_what_a_png_cannot_hold(bad, error):
    with pytest.raises(error):
        pf.png_filter(bad)


# ------------------------------------------------------ delivered copies ----


@pytest.fixture
def spans_cleared():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _delivered(h=9, w=11, ch=3, dtype=np.uint8, seed=0):
    """A host array and its stand-in device copy, recorded as
    ``render._fetch`` records a card's image."""
    img = _image(np.random.default_rng(seed), h, w, dtype, ch)
    device = torch.from_numpy(img.copy())
    host = device.numpy().copy()
    host.flags.writeable = False
    export._record_device_copy(host, device)
    return host, device


def _png(arr, **kw):
    """The PNG of ``arr`` through ``write_image``'s conversion and the
    ``card`` attribute of its one ``png.filter`` span."""
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        data = export.png_bytes(export.convert_format(arr, kw.get("transparent", True),
                                                      kw.get("eight_bit", False)))
    (span,) = [r for r in profiling.spans() if r.name == "png.filter"]
    return data, span.attrs["card"]


def _host_png(arr) -> bytes:
    return export.png_bytes(np.array(arr))  # a fresh, writable array: never recorded


@pytest.mark.parametrize("dtype,ch", LAYOUTS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_record_is_used_by_one_png(spans_cleared, dtype, ch):
    host, _ = _delivered(ch=ch, dtype=dtype)
    first, card = _png(host)
    assert card == 1
    again, card = _png(host)
    assert card == 0
    assert first == again == _host_png(host)
    assert export._take_device_copy(host) is None


def test_a_record_dies_with_the_array_that_owns_the_memory():
    """A sequence's frames are recorded through the batch's slice, which
    dies at once; the records live on until the sequence's array dies."""
    owner = np.zeros((4, 5, 6, 3), np.uint8)
    batch = torch.arange(owner.size, dtype=torch.int64).to(torch.uint8).reshape(owner.shape)
    part = owner[1:3]
    part[:] = batch[1:3].numpy()
    keys = [export._layout(part[f]) for f in range(2)]
    for f in range(2):
        export._record_device_copy(part[f], batch[1 + f])
    del part
    gc.collect()
    assert all(k in export._DEVICE_COPIES for k in keys)
    owner.flags.writeable = False
    frame = owner[2]
    assert export._layout(frame) == keys[1]
    del owner, frame
    gc.collect()
    assert not any(k in export._DEVICE_COPIES for k in keys)


def test_a_frame_of_a_read_only_sequence_is_filtered_from_its_copy(spans_cleared):
    owner = _image(np.random.default_rng(3), 12, 10, np.uint8, 4)[None].repeat(3, axis=0)
    batch = torch.from_numpy(owner.copy())
    for f in range(3):
        export._record_device_copy(owner[f], batch[f])
    owner.flags.writeable = False
    got = [_png(owner[f]) for f in range(3)]
    assert [card for _, card in got] == [1, 1, 1]
    assert all(data == _host_png(owner[f]) for f, (data, _) in enumerate(got))


@pytest.mark.parametrize("how", ["writable-again", "slice", "head", "converted", "copy"])
def test_what_is_not_the_delivered_array_takes_the_host_filter(spans_cleared, how):
    host, _ = _delivered(ch=4, dtype=np.uint16)
    kw = {}
    if how == "writable-again":
        host.flags.writeable = True
        arr = host
    elif how == "slice":
        arr = host[1:]
    elif how == "head":  # the same first byte, fewer rows
        arr = host[:-1]
    elif how == "converted":
        arr, kw = host, {"transparent": False, "eight_bit": True}
    else:
        arr = host.copy()
        arr.flags.writeable = False
    data, card = _png(arr, **kw)
    assert card == 0
    assert data == _host_png(export.convert_format(arr, kw.get("transparent", True),
                                                   kw.get("eight_bit", False)))
    if how == "writable-again":
        host.flags.writeable = False
        assert export._take_device_copy(host) is None  # dropped at its first look


def test_each_record_is_taken_once_under_many_threads():
    """Encoder threads take records while the engine records the next
    batch: every frame's record goes to exactly one taker, none is lost."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    frames, takers = 150, 16
    owners = [np.zeros((frames, 2, 3, 3), np.uint8) for _ in range(2)]
    batch = torch.zeros(owners[0].shape, dtype=torch.uint8)
    for f in range(frames):
        export._record_device_copy(owners[0][f], batch[f])
    for owner in owners:
        owner.flags.writeable = False

    def record_next():
        for f in range(frames):
            export._record_device_copy(owners[1][f], batch[f])

    def take(t):
        got = 0
        for _ in range(3):
            for owner in owners:
                for f in range(t % 2, frames, 1 + t % 2):
                    got += export._take_device_copy(owner[f]) is not None
        return got

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=takers + 1) as pool:
            recorder = pool.submit(record_next)
            taken = [pool.submit(take, t) for t in range(takers)]
            counts = [f.result(timeout=60) for f in taken]
            recorder.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    left = sum(export._take_device_copy(owner[f]) is not None
               for owner in owners for f in range(frames))
    assert sum(counts) + left == 2 * frames


def test_a_cpu_delivery_is_neither_recorded_nor_read_only():
    image = torch.from_numpy(_image(np.random.default_rng(5), 6, 7, np.uint8, 3))
    before = len(export._DEVICE_COPIES)
    out = _fetch(image)
    assert out.flags.writeable and len(export._DEVICE_COPIES) == before
    assert export._take_device_copy(out) is None


def test_a_copy_of_another_shape_cannot_be_recorded():
    host = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError):
        export._record_device_copy(host, torch.zeros(4, 5, 4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        export._record_device_copy(host, torch.zeros(4, 5, 3, dtype=torch.uint16))


@pytest.mark.parametrize("fmt", ["pam", "bmp"])
def test_a_pam_or_bmp_write_drops_the_record(tmp_path, fmt):
    host, _ = _delivered(ch=3, dtype=np.uint8)
    before = pf.png_filter.launches
    path = export.write_image(tmp_path / "frame", host, fmt=fmt, transparent=False,
                              eight_bit=True, announce=False)
    assert path.exists() and pf.png_filter.launches == before
    assert export._take_device_copy(host) is None


def test_past_the_budget_the_oldest_records_go_first(spans_cleared, monkeypatch):
    """Three batches of four frames, each batch one storage of 4 * 60 bytes,
    against a budget of two batches: the first batch's records go when the
    third's first frame comes, all of them, since a row keeps its whole
    batch; a frame that lost its record takes the host filter."""
    monkeypatch.setattr(export, "_DEVICE_COPY_BUDGET", 2 * 4 * 60)
    owner = np.stack([_image(np.random.default_rng(f), 4, 5, np.uint8, 3) for f in range(12)])
    batches = [torch.from_numpy(owner[4 * b:4 * b + 4].copy()) for b in range(3)]
    held = lambda: sum(b for (_, b) in export._HELD.values())  # noqa: E731
    for f in range(8):
        export._record_device_copy(owner[f], batches[f // 4][f % 4])
    assert held() == 2 * 4 * 60
    export._record_device_copy(owner[8], batches[2][0])
    assert held() == 2 * 4 * 60
    keys = [export._layout(owner[f]) for f in range(12)]
    assert [k in export._DEVICE_COPIES for k in keys[:9]] == [False] * 4 + [True] * 5
    for f in range(9, 12):
        export._record_device_copy(owner[f], batches[2][f - 8])
    owner.flags.writeable = False
    assert _png(owner[0])[1] == 0 and _png(owner[4])[1] == 1
    assert _png(owner[0])[0] == _host_png(owner[0])
    assert _png(owner[11])[0] == _host_png(owner[11])
    for f in range(12):
        export._take_device_copy(owner[f])
    assert held() == 0 and not export._HELD


def test_one_frame_larger_than_the_budget_is_not_kept(monkeypatch):
    monkeypatch.setattr(export, "_DEVICE_COPY_BUDGET", 100)
    host, _ = _delivered(h=9, w=11, ch=3)  # 297 bytes
    assert export._take_device_copy(host) is None and not export._HELD


# --------------------------------------------------------------- readers ----


def _share(metric: str, cards: list, *, off_thread: bool, missing: bool = False):
    """The reader ``metric`` on a canned still window of one frame a
    ``cards`` entry, each with its ``png.filter`` span."""
    from bench_torch import harness

    cell = "poisson-saturne.rotation-png" if off_thread else "poisson-saturne.still"
    rec = harness.Recorder(False)
    buf = profiling.SpanBuffer()
    me = threading.get_native_id()
    for i, card in enumerate(cards):
        rec.items.append(harness.Span("item", i, 10.0 * i, 10.0 * i + 4.0))
        attrs = {"bytes_in": 24, "native": 1 - card}
        if not missing:
            attrs["card"] = card
        buf.add(profiling.SpanRecord("png.filter", round((10.0 * i + 1) * 1e9),
                                     round((10.0 * i + 2) * 1e9), me + off_thread, i + 1, None,
                                     attrs))
    run = harness.Run(harness.find_cell(harness.load_bench(), cell), 1.0, rec,
                      {"frames_per_item": 1, "width": 4, "height": 2}, {}, None, {})
    module = harness.load_module(harness.HERE / "metrics" / f"{metric}.py", f"m_{metric}")
    old, profiling.BUFFER = profiling.BUFFER, buf
    try:
        return module.read(run)
    finally:
        profiling.BUFFER = old


@pytest.mark.parametrize("metric,off_thread", [("png_filter_card_share.still", False),
                                               ("png_filter_card_share.rotation", True)])
def test_the_card_share_readers(metric, off_thread):
    assert _share(metric, [1, 1, 1, 1], off_thread=off_thread) == pytest.approx(100.0)
    assert _share(metric, [1, 0, 1, 0], off_thread=off_thread) == pytest.approx(50.0)
    assert _share(metric, [0, 0], off_thread=off_thread) == 0.0
    # a program before the attribute, no span at all, spans on the other thread
    assert _share(metric, [1, 1], off_thread=off_thread, missing=True) is None
    assert _share(metric, [], off_thread=off_thread) is None
    if off_thread:
        assert _share(metric, [1, 1], off_thread=False) is None
