"""What of the harness a CPU can check: the result line's keys, the
refusal without a card, the import guard, and a cell added from new files
alone."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from radiobench import run
from radiobench.tests.conftest import ROOT, TINY, run_tiny


def test_last_line_keys_and_checks_last(bench_root):
    res = run_tiny(bench_root, "wbfm_rcv256.file")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.report(res)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"input_rate", "req_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert line["correct"] is True and line["failed"] == 0
    tail = err.getvalue().strip().splitlines()
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_refuses_without_a_card(tmp_path):
    if subprocess.run([sys.executable, "-c", "import torch, sys; "
                       "sys.exit(torch.cuda.is_available())"]).returncode:
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "radiobench.run", "--workload",
                        "wbfm_rcv256.file", "--seed", str(2 ** 33), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "radiobench", tmp_path / "radiobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    p = subprocess.run([sys.executable, "-m", "radiobench.run", "--workload",
                        "dmr_4fsk48k.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("grtpu_torch_extra", "grtpux", "jaxlibrary", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "grtpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.banned_modules() == ["grtpu", "jax"]


def test_a_cell_loads_neither_jax_nor_the_jax_package(bench_root):
    code = ("import sys; from pathlib import Path; from radiobench import bench, run;"
            "from radiobench.tests.conftest import TINY;"
            f"[bench.run_cell(Path({str(bench_root)!r}), w, 3, 0.5, False, "
            "device='cpu', overrides=TINY[w]) for w in TINY];"
            "print(run.banned_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_from_new_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "radiobench", tmp_path / "radiobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "radiobench")
    # a new traffic mix, its cell's limits, and the cell's entry
    file = json.loads((tmp_path / "radiobench/traffic/file.json").read_text())
    (tmp_path / "radiobench/traffic/file2m.json").write_text(
        json.dumps({**file, "source_samples": 1 << 21, "request_samples": 1 << 21}))
    shutil.copy(tmp_path / "radiobench/limits/wbfm_rcv256.file.json",
                tmp_path / "radiobench/limits/wbfm_rcv256.file2m.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "wbfm_rcv256.file2m", "config": "wbfm_rcv256",
                               "traffic": "file2m", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny = {**TINY["wbfm_rcv256.file"]["traffic"], "request_samples": 32768,
            "chunk": 8192}
    code = ("import json; from pathlib import Path; from radiobench import bench;"
            f"r = bench.run_cell(Path('.'), 'wbfm_rcv256.file2m', 11, 1.0, False,"
            f" device='cpu', overrides={{'traffic': {tiny!r}}});"
            "print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] > 0
    after = _digests(tmp_path / "radiobench")
    assert {k: after[k] for k in before} == before
