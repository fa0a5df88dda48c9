"""The CLI's ``doctor`` on the CPU: with ``--device cpu`` it runs its oracle
checks on the plain twins and says the kernels were not checked; with the
default CUDA device on a machine without CUDA it reports the problem and
renders nothing."""

import importlib

import pytest
import torch

from strange_attractor_tpu_torch import cli

# the module: the package's ``render`` is the function
port_render = importlib.import_module("strange_attractor_tpu_torch.render")


def test_cpu_doctor_passes_on_the_twins(capsys):
    assert cli.main(["--device", "cpu", "doctor"]) == 0
    out = capsys.readouterr().out
    assert "oracle agreement (exact-kernel, short-horizon exact): 100.0000%" in out
    assert "oracle agreement (kernel, short-horizon exact): 100.0000%" in out
    assert "CUDA kernels are not checked" in out
    assert "PNG encoder: " in out and "throughput: render=" in out and "iters/s" in out
    assert out.rstrip().endswith("doctor: OK")


def test_cuda_doctor_without_cuda_fails_and_renders_nothing(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; doctor would check it for real")

    def refuse(*args, **kwargs):
        raise AssertionError("doctor rendered without its device")

    for name in ("render", "render_seeds"):
        monkeypatch.setattr(port_render, name, refuse)
    assert cli.main(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "PROBLEM: --device cuda needs a CUDA card" in out
    assert "oracle agreement" not in out
    assert out.rstrip().endswith("doctor: PROBLEMS FOUND")


def test_a_kernel_build_failure_is_a_problem(capsys, monkeypatch):
    """A card without nvcc (or a source nvcc refuses) fails doctor before
    any render; it is never skipped quietly."""
    from strange_attractor_tpu_torch.ops import cuda_lib

    def no_nvcc():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")

    def refuse(*args, **kwargs):
        raise AssertionError("doctor rendered after a failed build")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "a test card")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    monkeypatch.setattr(cuda_lib, "nvcc", no_nvcc)
    for name in ("render", "render_seeds"):
        monkeypatch.setattr(port_render, name, refuse)
    assert cli.main(["--device", "cuda:0", "doctor"]) == 1
    out = capsys.readouterr().out
    assert "card: a test card, compute capability 9.0" in out
    assert "PROBLEM: the CUDA kernels did not build or load: nvcc not found" in out
    assert out.rstrip().endswith("doctor: PROBLEMS FOUND")
