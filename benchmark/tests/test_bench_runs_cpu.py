"""Each traffic mix's driver runs on the CPU at a tiny size and comes out
correct; the faults planted under the timed path come out not correct;
the last line has exactly the contract's keys."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.harness.common import ROOT, benchmark_json
from conftest import run_tiny, tiny

CELLS = [w["name"] for w in benchmark_json()["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("name", CELLS)
def test_each_mix_runs_and_is_correct(name):
    out = run_tiny(name)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    assert set(out) - {"readings"} == KEYS
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    ("dunet-crops256", "altered_answer"),
    ("dunet-tiled2048", "altered_answer"),
    ("dunet-mish-gn-train-b4", "unchanged_state"),
    ("dunet-mish-gn-train-b4", "half_batch"),
])
def test_a_planted_fault_is_not_correct(name, fault):
    undo = faults.plant(fault)
    try:
        out = run_tiny(name)
    finally:
        undo()
    assert out["correct"] is False, out["checks"]


def test_the_fault_leaves_nothing_behind():
    from microbeseg_torch.training.trainer import Trainer
    before = Trainer.train_step
    faults.plant("half_batch")()
    assert Trainer.train_step is before


def test_without_a_card_no_result():
    """run.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dunet-crops256",
         "--seed", "2147483648", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "BENCH_RUN": "x"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run exits non-zero and prints no result."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dunet-crops256",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_the_result_line_is_json_with_checks_last(capsys):
    from benchmark.harness.core import finish
    out = run_tiny("dunet-crops256")
    assert finish(out) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(line)
    assert set(d) == KEYS and list(d)[-1] == "checks"
