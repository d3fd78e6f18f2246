"""What the drivers of the port's entry points share, and how a traffic
mix's ``entry`` finds its driver: ``benchmark/entries/<entry>.py`` and the
``Driver`` class there.  A new entry is a new file.

A driver makes its inputs and weights from the seed in ``setup`` and warms
up every shape the cell uses; ``window(seconds)`` runs the measured loop;
``traced_window()`` a short one under the profiler; ``free()`` drops the
port's state; ``check()`` runs the reference and returns the numbers that
decide ``correct``, each with its limit.

A driver names every key of the configuration and of the traffic mix that
it reads (``CONFIG_KEYS``, ``TRAFFIC_KEYS``; the network's keys are the
configuration's family's, ``benchmark/families``) and the values it can
run (``RUNS``, ``"family"`` among them): a file of another family, with a
key it does not read, or with a value it cannot run, is refused before
set-up rather than run as something else.
"""

from __future__ import annotations

import importlib
import random
import re
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import families
from benchmark.harness.common import NOTE_KEYS, OPTIONAL_KEYS


def load(entry: str) -> type:
    """The ``Driver`` of ``benchmark/entries/<entry>.py``."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", entry):
        raise ValueError(f"bad entry name {entry!r}")
    return importlib.import_module(f"benchmark.entries.{entry}").Driver


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def inputs_made(dev) -> None:
    """The inputs are made: the card's peak memory counts from here."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = item


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit)}


def _refuse_keys(what: str, given, required, optional=()) -> None:
    extra = sorted(set(given) - set(required) - set(optional))
    missing = sorted(set(required) - set(given))
    if extra or missing:
        raise ValueError(f"{what}: keys not read {extra}, keys missing "
                         f"{missing}")


class Driver:
    CONFIG_KEYS: tuple = ()
    TRAFFIC_KEYS: tuple = ()
    # config key -> the values this entry and the reference can run
    RUNS: Dict[str, tuple] = {}

    def __init__(self, cell, seed: int, device, control: bool = False,
                 log=print):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.mix, self.control, self.log = cell.traffic, control, log
        self.accept(cell.config, cell.traffic)
        self.family = families.of(cell.config)
        self.mcfg = self.family.model_config(cell.config)
        self.phases: List[tuple] = []

    @classmethod
    def accept(cls, config: dict, traffic: dict) -> None:
        """Refuse a configuration or mix this entry would not run as it
        says."""
        given = dict(config, family=families.name_of(config))

        def refuse_values(keys):
            for key in keys:
                if given[key] not in cls.RUNS[key]:
                    raise ValueError(f"{key} {given[key]!r}: this entry and "
                                     f"the reference run only "
                                     f"{cls.RUNS[key]}")

        # the family first: its keys are asked of a family this entry runs
        refuse_values([k for k in cls.RUNS if k == "family"])
        _refuse_keys(f"configuration {config.get('name')!r}", config,
                     families.of(config).KEYS + NOTE_KEYS + cls.CONFIG_KEYS,
                     OPTIONAL_KEYS)
        _refuse_keys(f"traffic mix of entry {traffic.get('entry')!r}",
                     traffic, cls.TRAFFIC_KEYS)
        refuse_values([k for k in cls.RUNS if k != "family"])

    @classmethod
    def tiny(cls, mix: dict, limits: dict):
        """The mix and limits at a size the CPU runs in seconds (the
        benchmark's tests)."""
        raise NotImplementedError(f"{cls.__module__} gives no CPU preset")

    def mark(self, phase: str) -> None:
        """The end of a set-up phase (logged by ``core.run``)."""
        sync(self.dev)
        self.phases.append((phase, time.perf_counter()))

    def loop(self, seconds: float, call) -> dict:
        """Closed loop: ``call(i)`` until ``seconds`` have passed; the rate
        is over every call and all the time up to the last one's end."""
        sync(self.dev)
        t0 = time.perf_counter()
        end = t0 + seconds
        i, ends = 0, []
        while True:
            call(i)
            i += 1
            ends.append(time.perf_counter())
            if ends[-1] >= end:
                break
        sync(self.dev)
        took = np.diff([t0] + ends) * 1e3
        q = np.percentile(took, [25, 50, 75])
        half = max(1, i // 2)
        self.log(f"window: {i} calls, ms a call: quartiles {q[0]:.3f} "
                 f"{q[1]:.3f} {q[2]:.3f}; mean of the first and the second "
                 f"half {took[:half].mean():.3f} {took[half:].mean():.3f}"
                 if i > 1 else f"window: 1 call, {took[0]:.3f} ms")
        return {"calls": i, "seconds": time.perf_counter() - t0}
