"""A whole run on the CPU with the timed path broken underneath must come out
not correct, once for each fault a cell can have: a step that returns its
state unchanged, half of the batch left out, and an answer altered where it
is produced. (No cell exchanges anything between chips: each runs on one.)
A sound run of the same cell comes out correct."""

from __future__ import annotations

import pytest

from bench_torch import harness

from .conftest import measure

CELLS = ("poisson-saturne.still", "solar-sail.still", "poisson-saturne.rotation-png")


def _patch_bin(monkeypatch, fn):
    """Put ``fn(bin, *planes_and_stream)`` in place of the KERNEL bin the
    program's render engines look up."""
    render, config = harness.program("render"), harness.program("config")
    kernel, twin = render._BINS[config.BinStrategy.KERNEL]
    monkeypatch.setitem(render._BINS, config.BinStrategy.KERNEL,
                        (lambda *a, **k: fn(kernel, *a, **k), twin))


def _unchanged(bin_, count, packed, flat, key, **kw):
    return count, packed


def _half_left_out(bin_, count, packed, flat, key, **kw):
    half = flat.shape[0] // 2
    return bin_(count, packed, flat[:half], key[:half], **kw)


def _alter_answer(monkeypatch):
    """Flip one pixel of every image where the program produces it."""
    render = harness.program("render")

    def altered(fn):
        def inner(*a, **k):
            img = fn(*a, **k)
            img[..., 0, 0, 0] ^= 0x80
            return img
        return inner

    for name in ("colorize_convert_fetch", "render_sequence_shared"):
        monkeypatch.setattr(render, name, altered(getattr(render, name)))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    bench, root = tiny
    assert measure(bench, root, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_broken_path_is_not_correct(tiny, monkeypatch, cell, fault):
    bench, root = tiny
    if fault == "state_unchanged":
        _patch_bin(monkeypatch, _unchanged)
    elif fault == "half_left_out":
        _patch_bin(monkeypatch, _half_left_out)
    else:
        _alter_answer(monkeypatch)
    res = measure(bench, root, cell)
    assert res["correct"] is False
    assert res["failed"] >= 1
    off = {k: c["value"] for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert off, res["checks"]
