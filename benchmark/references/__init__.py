"""Plain PyTorch references, one a model family, named by a
configuration's ``reference`` key.  They import nothing of the measured
program."""

import importlib


def load(name: str):
    """The reference module ``benchmark/references/<name>.py``."""
    return importlib.import_module(f"benchmark.references.{name}")
