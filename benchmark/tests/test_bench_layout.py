"""Every cell, configuration, traffic mix, limit and metric is found by
name, and a new cell, or a configuration of a new model family, is taken
as files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import families
from benchmark.harness.common import BENCH, ROOT, Cell, benchmark_json
from benchmark.harness.core import reader

BENCHMARK = benchmark_json()
NAMES = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", NAMES)
def test_every_cell_is_found_by_name(name):
    c = Cell(name)
    assert (BENCH / "entries" / f"{c.traffic['entry']}.py").is_file()
    assert c.config["name"] == c.workload["config"]
    assert c.chips == 1
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_every_metric_has_a_reader():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert callable(reader(m["name"])), m["name"]


def test_every_configuration_lists_what_it_changed():
    """A configuration states its family's published values; where it cuts
    one, ``reduced`` (in the file and in BENCHMARK.json) names it and
    ``published`` gives the value cut from.  No width is cut: a ``unet``
    configuration, whose published value is its widths, cuts nothing."""
    for c in BENCHMARK["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        fam = families.of(conf)
        reduced = conf["reduced"]
        assert reduced == c["reduced"], c["name"]
        published = conf.get("published", {})
        assert sorted(published) == sorted(reduced), c["name"]
        for key in reduced:
            assert key not in fam.WIDTHS, (c["name"], key)
            assert key in fam.PUBLISHED, (c["name"], key)
            assert published[key] == fam.PUBLISHED[key] != conf[key], (
                c["name"], key)
        for key, value in fam.PUBLISHED.items():
            if key not in reduced:
                assert conf[key] == value, (c["name"], key)


def test_a_new_cell_needs_files_alone(tmp_path):
    """A copy of the benchmark with one more traffic mix, limits file and
    workload entry: the harness finds the new cell and runs it."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((BENCH / "traffic" / "crops256.json").read_text())
    mix.update(frame=64, stack=2, pool=2, sample=1, objects=[2, 4],
               must_launch=[])
    (tmp_path / "benchmark" / "traffic" / "crops64.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark" / "limits" / "new-cell.json").write_text(
        json.dumps({"field_err": 0.05, "post_mismatch": 0.0,
                    "frames_compared": 1}))
    conf = json.loads((BENCH / "configs" / "dunet_relu_bn.json").read_text())
    conf.update(name="narrow", filters=[8, 16])
    (tmp_path / "benchmark" / "configs" / "narrow.json").write_text(
        json.dumps(conf))
    bench["configs"].append(dict(bench["configs"][0], name="narrow",
                                 file="benchmark/configs/narrow.json"))
    bench["workloads"].append({"name": "new-cell", "config": "narrow",
                               "traffic": "crops64", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dunet-crops256" in m.get("workloads", ()):
            m["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.harness.common import Cell\n"
        "from benchmark.harness.core import run\n"
        "out = run(Cell('new-cell'), 7, 0.2, False, 'cpu', "
        "time.perf_counter(), log=lambda *a: None)\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert set(out["metrics"]) == {"segment_mpx_per_s", "setup_s"}


TOY_FAMILY = '''"""A stack of ``depth`` 3x3 convolutions of ``width``
channels on one input channel, relu between."""

KEYS = ("width", "depth")
PUBLISHED = {"depth": 24}
WIDTHS = ("width",)


def model_config(config):
    return {k: config[k] for k in KEYS}


def channels(cfg):
    return [1] + [cfg["width"]] * (cfg["depth"] - 1) + [1]


def forward_flops(cfg, h, w):
    c = channels(cfg)
    return sum(2 * h * w * 9 * a * b for a, b in zip(c, c[1:]))


def state_shapes(cfg):
    c, out = channels(cfg), {}
    for i, (a, b) in enumerate(zip(c, c[1:])):
        out[f"{i}.weight"] = ("conv", (b, a, 3, 3))
        out[f"{i}.bias"] = ("bias", (b,))
    return out


def tiny(config):
    return dict(config, width=4)
'''

TOY_ENTRY = '''"""Frames through the toy family's network, closed loop;
the reference is the same network in float64."""

import torch
import torch.nn.functional as F

from benchmark.harness import drivers, gen, weights


def net(state, depth, x):
    for i in range(depth):
        x = F.conv2d(x, state[f"{i}.weight"], state[f"{i}.bias"], padding=1)
        x = torch.relu(x) if i < depth - 1 else x
    return x


class Driver(drivers.Driver):
    RUNS = {"family": ("toy",)}
    TRAFFIC_KEYS = ("entry", "frame", "stack", "infer")

    @classmethod
    def tiny(cls, mix, limits):
        return dict(mix, frame=16), limits

    def setup(self):
        self.mark("imports")
        self.state = weights.make(self.mcfg, self.seed, self.dev, "lecun",
                                  self.family)
        side = self.mix["frame"]
        self.frames = torch.rand(self.mix["stack"], 1, side, side,
                                 generator=gen.generator(self.seed, 1,
                                                         self.dev),
                                 device=self.dev)
        self.mark("inputs")

    def window(self, seconds):
        def call(i):
            self.out = net(self.state, self.mcfg["depth"], self.frames)
        out = self.loop(seconds, call)
        frames = out["calls"] * self.mix["stack"]
        out.update(frames=frames, pixels=frames * self.mix["frame"] ** 2,
                   attempted=out["calls"], failed=0)
        return out

    def free(self):
        pass

    def check(self):
        ref = net({k: v.double() for k, v in self.state.items()},
                  self.mcfg["depth"], self.frames.double())
        err = float((self.out.double() - ref).abs().max() / ref.abs().max())
        return [drivers.check("out_err", err, self.cell.limits["out_err"])]
'''


def _files(root):
    return {p.relative_to(root) for p in root.rglob("*")
            if "__pycache__" not in p.parts}


def test_a_new_family_needs_files_alone(tmp_path):
    """A copy of the benchmark with a family ``toy`` (keys of its own, a
    FLOP count of its own, a cut in depth), an entry, a configuration, a
    mix, a limits file and entries in BENCHMARK.json, and no other file
    edited: the cell runs on the CPU and comes out correct, its metrics
    read (the share of the peak from the toy family's count), and the
    layout checks and the CPU run of every cell take it."""
    before = _files(BENCH)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    copy = tmp_path / "benchmark"
    (copy / "families" / "toy.py").write_text(TOY_FAMILY)
    (copy / "entries" / "toy.py").write_text(TOY_ENTRY)
    (copy / "configs" / "toy_net.json").write_text(json.dumps(
        {"family": "toy", "name": "toy_net", "source": "a test",
         "width": 8, "depth": 3, "reduced": ["depth"],
         "published": {"depth": 24}}))
    (copy / "traffic" / "toy64.json").write_text(json.dumps(
        {"entry": "toy", "frame": 64, "stack": 2,
         "infer": {"use_tiling": False}}))
    (copy / "limits" / "toy-cell.json").write_text(json.dumps(
        {"out_err": 1e-5}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_net", "source": "a test",
                             "file": "benchmark/configs/toy_net.json",
                             "reduced": ["depth"], "why": "a test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy_net",
                               "traffic": "toy64", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("segment_mpx_per_s", "segment_mfu_pct"):
            m["workloads"].append("toy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": ""}
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.harness.common import Cell\n"
        "from benchmark.harness.core import reader, run\n"
        "cell = Cell('toy-cell')\n"
        "out = run(cell, 2147483701, 0.2, False, 'cpu', time.perf_counter(),"
        " log=lambda *a: None)\n"
        "ctx = {'cell': cell, 'window': {'frames': 10, 'seconds': 2.0}}\n"
        "out['mfu'] = reader('segment_mfu_pct')(ctx)\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"segment_mpx_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    # 64^2 pixels, 1 -> 8 -> 8 -> 1 channels, 3x3 taps, 5 frames a second
    flops = 2 * 64 * 64 * 9 * (8 + 64 + 8)
    assert out["mfu"] == pytest.approx(100 * flops * 5 / 989e12, rel=1e-12)
    tests = "benchmark/tests/"
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-W", "ignore::pytest.PytestUnknownMarkWarning",
         tests + "test_bench_layout.py::test_every_cell_is_found_by_name"
         "[toy-cell]",
         tests + "test_bench_layout.py::test_every_metric_has_a_reader",
         tests + "test_bench_layout.py::"
         "test_every_configuration_lists_what_it_changed",
         tests + "test_bench_runs_cpu.py::test_each_mix_runs_and_is_correct"
         "[toy-cell]"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env)
    assert res.returncode == 0, res.stdout[-3000:]
    assert "4 passed" in res.stdout
    assert _files(BENCH) == before
