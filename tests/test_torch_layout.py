"""PyTorch port, the import boundaries between its modules, read from the
sources with ``ast``.

No module of the package imports another module's ``_``-prefixed name,
whether by ``from ... import`` (over one line or several, relative or
absolute) or as an attribute of an imported package module; names of
other packages (``torch``'s own private ones) are out of scope. The file
writer ``utils/export.py`` is host file formats only: it imports neither
``torch`` nor anything under ``ops``, and no module under ``ops`` imports
it (it still reaches ``torch`` through ``deliver``, which it imports for
the card's side of a PNG). The sequence engines' batch rule reads the
delivery's device budget, and a still reaches the host in one copy. The
checker itself is held to a few sources it must and must not flag.
"""

import ast
from pathlib import Path

import pytest
import torch

from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
PKG = "strange_attractor_tpu_torch"
FILES = sorted((REPO / PKG).rglob("*.py"))


def _name(path: Path) -> tuple:
    """(dotted module name, whether it is a package's ``__init__``)."""
    parts = path.relative_to(REPO).with_suffix("").parts
    if parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


MODULES = {_name(f)[0] for f in FILES}
TINY = ["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32", "--chunk-steps", "16",
        "--seed", "1", "-q", "--device", "cpu"]


def _tiny_config():
    parser = cli.build_parser()
    args = parser.parse_args(TINY)
    cli._validate(args, parser)
    return cli.config_from_args(args).replace(warmup=16)


@pytest.fixture
def spans_cleared():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _private(name: str) -> bool:
    return name.startswith("_") and not (name.startswith("__") and name.endswith("__"))


def _in_package(name) -> bool:
    return bool(name) and (name == PKG or name.startswith(PKG + "."))


def _absolute(module: str, is_pkg: bool, level: int, target) -> str:
    """The absolute name a ``from`` import of ``module`` reads."""
    if level == 0:
        return target
    base = module.split(".")
    if not is_pkg:
        base = base[:-1]
    base = base[:len(base) - (level - 1)]
    return ".".join(base + ([target] if target else []))


def _dotted(node):
    """``a.b.c`` of a chain of attributes on a name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id, *reversed(parts)])


def _imports(tree, module: str, is_pkg: bool):
    """(absolute source, imported name, line) of every import, and the local
    names bound to package modules."""
    found, bound = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                found.append((a.name, None, node.lineno))
                if _in_package(a.name):
                    if a.asname:
                        bound[a.asname] = a.name
                    else:
                        bound[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            src = _absolute(module, is_pkg, node.level, node.module)
            for a in node.names:
                found.append((src, a.name, node.lineno))
                if _in_package(src) and f"{src}.{a.name}" in MODULES:
                    bound[a.asname or a.name] = f"{src}.{a.name}"
    return found, bound


def private_uses(source: str, module: str, is_pkg: bool = False) -> list:
    """Where ``module``'s source reads a ``_``-prefixed name of another
    module of the package: ``line: name`` strings."""
    tree = ast.parse(source)
    found, bound = _imports(tree, module, is_pkg)
    bad = [f"{line}: from {src} import {name}" for src, name, line in found
           if name is not None and _in_package(src) and src != module and _private(name)]
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Attribute) and _private(node.attr)):
            continue
        base = _dotted(node.value)
        if base is None or base.split(".")[0] not in bound:
            continue
        head, *rest = base.split(".")
        owner = ".".join([bound[head], *rest])
        if owner in MODULES and owner != module:
            bad.append(f"{node.lineno}: {owner}.{node.attr}")
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO / PKG)))
def test_no_module_reads_another_modules_private_names(path):
    module, is_pkg = _name(path)
    assert private_uses(path.read_text(), module, is_pkg) == []


def _import_sources(path: Path) -> set:
    module, is_pkg = _name(path)
    found, _ = _imports(ast.parse(path.read_text()), module, is_pkg)
    return {src if name is None or f"{src}.{name}" not in MODULES else f"{src}.{name}"
            for src, name, _ in found}


def test_the_file_writer_imports_neither_torch_nor_ops():
    sources = _import_sources(REPO / PKG / "utils" / "export.py")
    assert not {s for s in sources if s == "torch" or s.startswith("torch.")}
    assert not {s for s in sources if s.startswith(f"{PKG}.ops")}
    assert f"{PKG}.deliver" in sources


@pytest.mark.parametrize("path", sorted((REPO / PKG / "ops").glob("*.py")), ids=lambda p: p.name)
def test_no_kernel_module_imports_the_file_writer(path):
    assert f"{PKG}.utils.export" not in _import_sources(path)


def test_one_device_budget_and_one_host_copy(monkeypatch, spans_cleared):
    """The sequence engines' batch rule reads the delivery's budget, so
    patching :data:`deliver.DEVICE_BUDGET` resizes their batches; and a
    still reaches the host in one copy, :func:`deliver.fetch`'s
    ``deliver.copy``."""
    import importlib

    from strange_attractor_tpu_torch import deliver
    from strange_attractor_tpu_torch.config import BinStrategy

    render = importlib.import_module(f"{PKG}.render")  # the package re-binds the name

    config = _tiny_config()
    # KERNEL's packed planes (8 B a pixel) and the u16 RGBA frame (8 B)
    per_frame = config.width * config.height * (8 + 8)
    for frames in (1, 3, 7):
        monkeypatch.setattr(deliver, "DEVICE_BUDGET", frames * per_frame)
        assert render.auto_frames_per_batch(config, BinStrategy.KERNEL) == frames
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        image = render.render_frame(config, torch.Generator().manual_seed(1), device="cpu")
    copies = [r.attrs for r in profiling.spans() if r.name == "deliver.copy"]
    assert copies == [{"bytes": image.nbytes}]


CASES = {
    "a private name in an import over several lines": (
        "from .render import (\n    colorize,\n    _draw_base,\n)\n", f"{PKG}.cli", 1),
    "a private function called through a module": (
        "from ..ops import cuda_lib\n\ncuda_lib._nvcc()\n", f"{PKG}.tools.probe", 1),
    "a private name through an aliased absolute import": (
        f"import {PKG}.render as r\n\nr._fetch(None)\n", f"{PKG}.cli", 1),
    "a private name through the package's dotted path": (
        f"import {PKG}.deliver\n\n{PKG}.deliver._HELD.clear()\n", f"{PKG}.cli", 1),
    "a private name from a sibling package's module": (
        "from .. import deliver\n\nx = deliver._DEVICE_COPIES\n", f"{PKG}.utils.export", 1),
    "torch's own private names": (
        "from torch._C._autograd import _profiler_enabled\nimport torch\ntorch._C\n",
        f"{PKG}.utils.profiling", 0),
    "a module's own private names and an object's": (
        "def _own():\n    return self._x\n\n_own()\nstate._asdict()\n", f"{PKG}.runtime", 0),
    "a private name imported from the module itself": (
        "from .render import _KERNEL_OF\n", f"{PKG}.render", 0),
}


@pytest.mark.parametrize("case", CASES)
def test_the_checker_flags_what_it_should(case):
    source, module, want = CASES[case]
    assert len(private_uses(source, module)) == want
