"""What of the harness a CPU can check: the result line's keys, the
refusal without a card, the import guard, a cell added from new files
alone, and the record of where the process ran."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from radiobench import hostrecord, run
from radiobench.tests.conftest import ROOT, TINY, run_tiny

HOST_KEYS = {"cpus_allowed", "cpu_nodes", "card", "card_node", "us_chunk"}


def test_last_line_keys_and_checks_last(bench_root):
    res = run_tiny(bench_root, "wbfm_rcv256.file")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.report(res)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"input_rate.file", "req_p95_ms.file", "setup_s"}
    assert line["metrics"]["input_rate.file"]["unit"] == "Msamples/s"
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["host"]) == HOST_KEYS and line["host"]["us_chunk"] > 0
    lines = err.getvalue().strip().splitlines()
    tail = lines[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert float(lines[-len(tail) - 1].split(" check_s ", 1)[1]) == line["check_s"] > 0
    assert json.loads(lines[-len(tail) - 2].split(" host ", 1)[1]) == line["host"]


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
        json.dumps({**file, "source_samples": 1 << 21, "request_samples": 1 << 21,
                    "chunk": 1 << 19}))
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
    assert set(res["host"]) == HOST_KEYS and list(res)[-3:] == ["host", "check_s", "checks"]
    assert res["host"]["us_chunk"] > 0
    assert set(res["host"]["cpus_allowed"]) == os.sched_getaffinity(0)
    after = _digests(tmp_path / "radiobench")
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("text, cpus", [
    ("0-3,8,10-11", {0, 1, 2, 3, 8, 10, 11}), ("5", {5}), ("0-7\n", set(range(8))),
    ("", set()), ("2,0-1", {0, 1, 2})])
def test_cpulist_parses(text, cpus):
    assert hostrecord.parse_cpulist(text) == cpus


def _sysfs(root, cards=(), nodes=None):
    """A /sys with PCI devices ``(address, numa_node or None)`` and
    ``nodes`` ({node: cpulist})."""
    for addr, node in cards:
        (root / "bus" / "pci" / "devices" / addr).mkdir(parents=True)
        if node is not None:
            (root / "bus" / "pci" / "devices" / addr / "numa_node").write_text(f"{node}\n")
    for n, cpus in (nodes or {}).items():
        (root / "devices" / "system" / "node" / f"node{n}").mkdir(parents=True)
        (root / "devices" / "system" / "node" / f"node{n}" / "cpulist").write_text(cpus)
    return root


class _Props:
    """CUDA's device properties as far as the record reads them."""
    def __init__(self, bus):
        self.pci_domain_id, self.pci_bus_id, self.pci_device_id = 0, bus, 0


@pytest.mark.parametrize("cards, nodes, props, card, card_node, cpu_nodes", [
    ([("0000:5d:00.0", 1)], {0: "0-3", 1: "4-7"}, _Props(0x5D), "0000:5d:00.0", 1, [0, 1]),
    ([("0000:5d:00.0", -1)], {0: "0-7"}, _Props(0x5D), "0000:5d:00.0", None, [0]),
    ([("0000:18:00.0", 0)], {0: "8-15"}, _Props(0x5D), "0000:5d:00.0", None, None),
    ([("0000:5d:00.0", None)], {}, _Props(0x5D), "0000:5d:00.0", None, None),
    ([], {}, None, None, None, None),                      # no card: the CPU run
    ([], {}, object(), None, None, None)])                 # a CUDA with no PCI ids
def test_host_record_reads_the_cpus_their_nodes_and_the_cards_node(
        tmp_path, monkeypatch, cards, nodes, props, card, card_node, cpu_nodes):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    rec = hostrecord.describe(props, _sysfs(tmp_path, cards, nodes))
    assert rec == {"cpus_allowed": list(range(8)), "cpu_nodes": cpu_nodes,
                   "card": card, "card_node": card_node}


def test_host_record_changes_no_affinity(monkeypatch):
    monkeypatch.setattr(os, "sched_setaffinity", lambda *a: pytest.fail("affinity set"))
    before = os.sched_getaffinity(0)
    assert hostrecord.describe()["cpus_allowed"] == sorted(before)
    assert os.sched_getaffinity(0) == before


def test_metrics_of_a_cell_come_from_benchmark_json(bench_root):
    """Each cell reports the end-to-end metrics whose ``workloads`` name it,
    or that name none; a per-layer metric ``<base>.<cells>`` is read by
    ``metrics/<base>.py``."""
    from radiobench import bench

    res = run_tiny(bench_root, "dmr_4fsk48k.stream")
    assert set(res["metrics"]) == {"input_rate", "req_p95_ms", "setup_s"}
    assert res["correct"] is True
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = ROOT / "radiobench" / "metrics"
    for m in spec["per_layer"]:
        own = metrics / f"{m['name']}.py"
        reader = own if own.exists() else metrics / f"{m['name'].split('.')[0]}.py"
        assert reader.exists()
        assert bench.module("metrics", m["name"]).__file__ == str(reader)
    for m in spec["end_to_end"]:
        assert m["name"].split(".")[0] in {"input_rate", "req_p95_ms", "setup_s"}
