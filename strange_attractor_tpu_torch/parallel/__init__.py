"""Several devices: lane-sharded renders with a collective canvas merge
(:mod:`.mesh`) and multi-process renders over ``torch.distributed``
(:mod:`.distributed`).

``distributed`` is imported lazily, as in the JAX package
(strange_attractor_tpu/parallel/__init__.py): a program that renders on
one process never loads it.
"""

from . import mesh

__all__ = ["distributed", "mesh"]


def __getattr__(name):
    if name == "distributed":
        import importlib

        return importlib.import_module(".distributed", __name__)
    raise AttributeError(name)
