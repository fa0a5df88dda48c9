"""PyTorch port, the sequence deliverables: the frame-naming helpers, the
animated PNG writer and the ``sequence`` subcommand, against the JAX
package on the CPU.

The APNG's chunk layout, header fields, frame delays, sequence numbers and
inflated frame data must equal the JAX package's; only the deflate streams
may differ (the port deflates with the stdlib, JAX with its native
parallel compressor).
"""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from strange_attractor_tpu.cli import main as jmain
from strange_attractor_tpu.utils import export as jexport, sequencing as jseq
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.utils import export, sequencing

FAST = ["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32", "--chunk-steps", "16",
        "--seed", "1", "-q", "-8"]

# (start, end, step) in degrees: whole turns, fractional steps, a step past
# the range, a degenerate range, and needed_digits' undercount (0, 5, 3)
GRID = [(0.0, 360.0, 0.5), (0.0, 360.0, 4.0), (0.0, 360.0, 3.0), (10.0, 12.5, 0.25),
        (0.0, 10.0, 30.0), (45.0, 45.0, 1.0), (0.0, 5.0, 3.0), (-90.0, 90.0, 7.5),
        (0.0, 2.0, 1.0), (0.0, 1000.0, 1.0)]


@pytest.mark.parametrize("start,end,step", GRID)
def test_sequencing_helpers_match_jax(start, end, step):
    assert list(sequencing.angle_iter(start, end, step)) == list(jseq.angle_iter(start, end,
                                                                                 step))
    assert sequencing.needed_digits(start, end, step) == jseq.needed_digits(start, end, step)
    for base in (Path("out/att.png"), Path("att"), Path("o/f.v.pam")):
        assert (list(sequencing.frame_sequence(start, end, step, base))
                == list(jseq.frame_sequence(start, end, step, base)))
    assert sequencing.frame_path(Path("a.png"), 7, 3) == jseq.frame_path(Path("a.png"), 7, 3)


def test_needed_digits_keeps_the_reference_undercount():
    """The reference's estimate gives 0 digits for two frames at (0, 5, 3);
    frame_sequence pads by the real count, so the names stay distinct."""
    assert sequencing.needed_digits(0.0, 5.0, 3.0) == 0
    names = [p.name for _, p in sequencing.frame_sequence(0.0, 5.0, 3.0, Path("f.png"))]
    assert names == ["f0.png", "f1.png"]


def _chunks(data: bytes) -> list:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, out = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        assert crc == zlib.crc32(tag + payload) & 0xFFFFFFFF
        out.append((tag, payload))
        pos += 12 + length
    return out


def _layout(data: bytes) -> list:
    """Every chunk with its deflate stream replaced by the inflated bytes
    (an fdAT keeps its sequence number)."""
    out = []
    for tag, payload in _chunks(data):
        if tag == b"IDAT":
            payload = zlib.decompress(payload)
        elif tag == b"fdAT":
            payload = payload[:4] + zlib.decompress(payload[4:])
        out.append((tag, payload))
    return out


@pytest.mark.parametrize("fps", [0.4, 12.5])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_apng_matches_jax(dtype, channels, fps):
    rng = np.random.default_rng(channels)
    hi = np.iinfo(dtype).max
    frames = rng.integers(0, hi + 1, (3, 9, 13, channels)).astype(dtype)
    frames[1, :4] = frames[0, :4]  # rows the Up filter predicts exactly
    got, want = export.apng_bytes(frames, fps), jexport.apng_bytes(frames, fps)
    assert _layout(got) == _layout(want)
    tags = [t for t, _ in _chunks(got)]
    assert tags == [b"IHDR", b"acTL", b"fcTL", b"IDAT", b"fcTL", b"fdAT", b"fcTL", b"fdAT",
                    b"IEND"]
    seqs = [struct.unpack(">I", p[:4])[0] for t, p in _chunks(got) if t in (b"fcTL", b"fdAT")]
    assert seqs == list(range(5))
    num, den = struct.unpack(">HH", next(p for t, p in _chunks(got) if t == b"fcTL")[20:24])
    assert num / den == pytest.approx(1.0 / fps)


def test_apng_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError, match="fps"):
        export.apng_bytes(np.zeros((1, 2, 2, 3), np.uint8), fps=0.0)
    with pytest.raises(ValueError, match="frames"):
        export.apng_bytes(np.zeros((2, 2, 3), np.uint8))
    path = export.write_apng(tmp_path / "a.apng", np.zeros((2, 2, 2, 4), np.uint16), fps=5)
    assert path.read_bytes() == export.apng_bytes(np.zeros((2, 2, 2, 4), np.uint16), 5)


def _names(d: Path) -> list:
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("extra", [[], ["--frames-per-batch", "2", "--orbit", "shared"],
                                   ["--frames-per-batch", "2"], ["--apng", "--fps", "10"]])
def test_cli_sequence_writes_the_jax_cli_files(tmp_path, extra):
    argv = ["sequence", "-s", "0", "-e", "3", "-d", "1", *extra]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    assert jmain(FAST + ["-o", str(tmp_path / "jax" / "f.png")] + argv) == 0
    assert cli.main(FAST + ["--device", "cpu", "-o", str(tmp_path / "torch" / "f.png")]
                    + argv) == 0
    names = _names(tmp_path / "torch")
    assert names == _names(tmp_path / "jax")
    assert names == (["f.apng"] if "--apng" in extra else ["f0.png", "f1.png", "f2.png"])
    if "--apng" in extra:
        got = _chunks((tmp_path / "torch" / "f.apng").read_bytes())
        want = _chunks((tmp_path / "jax" / "f.apng").read_bytes())
        assert [t for t, _ in got] == [t for t, _ in want]
        assert [p for t, p in got if t != b"IDAT" and t != b"fdAT"] == \
            [p for t, p in want if t != b"IDAT" and t != b"fdAT"]


@pytest.mark.parametrize("argv,message", [
    (["sequence", "-s", "10", "-e", "5"], "end must be after start"),
    (["sequence", "-d", "-1"], "step must be a positive"),
    (["sequence", "--orbit", "shared"], "--frames-per-batch > 0"),
])
def test_cli_sequence_parse_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(FAST + argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_failed_frame_write_raises_after_the_others(tmp_path):
    written = []

    def write(path, image):
        if path.name == "bad":
            raise OSError("disk full")
        written.append(path.name)

    frames = [(np.zeros(1), tmp_path / n) for n in ("a", "bad", "c", "d", "e", "f")]
    with pytest.raises(OSError, match="disk full"):
        cli._write_frames(frames, write)
    assert sorted(written) == ["a", "c", "d", "e", "f"]
