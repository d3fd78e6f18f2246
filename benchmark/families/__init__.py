"""Model families: what the harness knows of a configuration's network.

A configuration file names its family under ``family``; a file without
that key is of the family ``unet``.  The family is
``benchmark/families/<family>.py``, found by name; a new family is a new
file.  A family module has:

- ``KEYS``: the network's keys, which every configuration of the family
  states;
- ``PUBLISHED``: key -> the value a configuration states at full size; a
  configuration that cuts one lists it in ``reduced`` and gives its
  published value under ``published``;
- ``WIDTHS``: the keys that are widths, which no configuration cuts;
- ``model_config(config)``: the network's settings from the file, as the
  family's entries and reference take them;
- ``forward_flops(model_cfg, h, w)``: the FLOPs of one forward on one
  h x w input, two per multiply-add;
- ``state_shapes(model_cfg)``: every entry of the weights, name ->
  (kind, shape), in order (the kinds ``harness/weights.py`` makes);
- ``tiny(config)``: the configuration narrowed so that the CPU runs it in
  seconds (the benchmark's tests);
- optionally ``averaging_scale(name, shape)``: a factor on one kernel of
  the ``averaging`` weights.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType

DEFAULT = "unet"


def load(name: str) -> ModuleType:
    """``benchmark/families/<name>.py``."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"bad family name {name!r}")
    return importlib.import_module(f"benchmark.families.{name}")


def name_of(config: dict) -> str:
    """The family a configuration file names."""
    return config.get("family", DEFAULT)


def of(config: dict) -> ModuleType:
    """The family of a configuration file."""
    return load(name_of(config))


def forward_flops_of(config: dict, h: int, w: int) -> int:
    """One forward's FLOPs on one h x w input of a configuration file's
    network."""
    family = of(config)
    return family.forward_flops(family.model_config(config), h, w)
