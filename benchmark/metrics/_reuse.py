"""A reader of another driver's cells, loaded by its file name (the names
hold dots, so not by import), for a reader that reads the same quantity
in the cells of a driver of its own."""

import importlib.util
from pathlib import Path


def reader(name: str):
    """``metrics/<name>.py`` as a module of its own."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_reuse_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
