"""How the benchmark's data files name code and values: a dotted path names
a module's attribute (``benchmark.yardstick.pools.masked_tiles``, or an
attribute of a class, ``pkg.module.Class.field``), a dotted key names a
value of a configuration (``variogram.range``)."""

from __future__ import annotations

import importlib


def resolve(dotted: str):
    """The object at ``dotted``: the longest prefix that imports as a module,
    then attributes down from it."""
    parts = dotted.split(".")
    for i in range(len(parts) - 1, 0, -1):
        name = ".".join(parts[:i])
        try:
            obj = importlib.import_module(name)
        except ModuleNotFoundError as err:
            if err.name is not None and not name.startswith(err.name):
                raise
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"no module in {dotted!r}")


def value(cfg: dict, key: str):
    """The configuration's value at the dotted ``key``."""
    for part in key.split("."):
        cfg = cfg[part]
    return cfg
