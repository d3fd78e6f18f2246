"""Every cell, configuration, traffic mix, limit and metric is found by
name, and a new cell is taken as files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

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
    for c in BENCHMARK["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []
        assert list(conf["filters"]) == [64, 1024]


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
