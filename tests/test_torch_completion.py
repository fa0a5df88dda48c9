"""The port's shell completion (``utils/completion.py``, a copy of the JAX
package's) and the CLI's ``completion`` subcommand, against the JAX
package's generator on the CPU: the same script, string for string, for the
same parser."""

import shutil
import subprocess
import tomllib
from pathlib import Path

import pytest

from strange_attractor_tpu.cli import build_parser as jax_parser
from strange_attractor_tpu.utils import completion as jcompletion
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.config import BinStrategy
from strange_attractor_tpu_torch.models import presets
from strange_attractor_tpu_torch.utils import completion

REPO = Path(__file__).resolve().parents[1]
SHELLS = ("bash", "zsh", "fish")


@pytest.mark.parametrize("parser", ["port", "jax"])
@pytest.mark.parametrize("shell", SHELLS)
def test_script_equals_the_jax_generator(shell, parser):
    p = cli.build_parser() if parser == "port" else jax_parser()
    assert completion.completion_script(shell, p) == jcompletion.completion_script(shell, p)


def test_prog_is_the_console_script():
    """Completion scripts are keyed on ``parser.prog``: it is the console
    script pyproject.toml installs, one word, so ``complete -F`` and the
    install file name work."""
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts[cli.PROG] == "strange_attractor_tpu_torch.cli:main"
    assert cli.build_parser().prog == cli.PROG == "strange-attractor-renderer-torch"
    bash = completion.completion_script("bash", cli.build_parser())
    assert bash.rstrip().endswith(
        "complete -F _strange_attractor_renderer_torch strange-attractor-renderer-torch")


@pytest.mark.parametrize("shell", SHELLS)
def test_install_writes_under_the_script_name(shell, tmp_path):
    parser = cli.build_parser()
    path = completion.install_completion(shell, parser, home=tmp_path)
    assert path == jcompletion.install_path(shell, cli.PROG, tmp_path)
    assert tmp_path in path.parents and cli.PROG in path.name
    assert path.read_text() == completion.completion_script(shell, parser)


def test_cli_prints_presets_and_strategies(capsys):
    assert cli.main(["completion", "--shell", "bash"]) == 0
    out = capsys.readouterr().out
    assert " ".join(presets.PRESET_NAMES) in out
    assert " ".join(s.value for s in BinStrategy) in out
    assert "--frames-per-batch" in out and "--profile" in out and "compgen -f" in out
    assert out == completion.completion_script("bash", cli.build_parser())
    if shutil.which("bash"):
        subprocess.run(["bash", "-n"], input=out, text=True, check=True, timeout=30)


@pytest.mark.parametrize("shell", SHELLS)
def test_cli_install_into_home(shell, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert cli.main(["completion", "--shell", shell, "--install"]) == 0
    path = completion.install_path(shell, cli.PROG, tmp_path)
    assert f"Installed {shell} completion to '{path}'." in capsys.readouterr().out
    assert path.read_text() == completion.completion_script(shell, cli.build_parser())
