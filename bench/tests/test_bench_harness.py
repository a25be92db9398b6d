"""The harness on the CPU: the benchmark's files hold together, every name
is of the allowed characters, a run's last line has the contract's
schema, and nothing a run loads is JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest
import torch

from bench.harness import cell as cell_mod
from bench.harness.cell import BENCH, ROOT, benchmark, load, metric_reader
from bench.tests.tiny import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_JSON = benchmark()
#: The largest numbers sound tiny runs read (the CPU, the plain kernels).
TINY_LIMITS = {"train": {"loss_gap": 1e-4, "grad_norm_gap": 5e-3,
                         "update_norm_gap": 5e-3},
               "prefill": {"logit_gap": 0.02, "logits_rel": 0.02,
                           "state_rel": 0.02}}
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]
#: The cells a CPU run drives: the benchmark's, and a prefill one per
#: configuration (``tiny.py``).
RUN_CELLS = CELLS + [f"{c['name']}.prefill" for c in BENCH_JSON["configs"]]


def test_benchmark_json_keys_and_names():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"]
    assert b["command"][:2] == ["python3", "bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    c = load(name)
    spec = c.spec
    entry = {w["name"]: w for w in BENCH_JSON["workloads"]}[name]
    assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == \
        (entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert c.config["name"] == entry["config"]
    assert (BENCH / "traffic" / f"{c.kind}.py").exists()
    assert hasattr(c.runner(), "Run") and c.reference()
    for m in c.per_layer:
        assert hasattr(metric_reader(m["name"]), "read")
    moved = {m["moves"] for m in c.per_layer}
    assert moved <= {m["name"] for m in c.end_to_end}
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert set(spec["limits"]) <= set(TINY_LIMITS[c.kind])
    assert all(v > 0 for v in spec["limits"].values())


def test_every_workload_file_is_a_cell():
    files = {p.name[:-len(".json")] for p in (BENCH / "workloads").glob(
        "*.json")}
    assert files == set(CELLS)


def test_per_layer_metrics_each_report_their_moved_metric():
    for name in CELLS:
        c = load(name)
        e2e = {m["name"] for m in c.end_to_end}
        for m in c.per_layer:
            assert m["moves"] in e2e, (name, m["name"])


def test_config_files_hold_the_program_configs():
    from bench.harness.program import Program

    for c in BENCH_JSON["configs"]:
        cfg = cell_mod.load_json(ROOT / c["file"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        prog = Program(cfg, torch.device("cpu"))
        from repro_torch import configs

        assert prog.cfg == configs.get(cfg["program"]).make_config()


def _schema(result: dict, traced: bool):
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if traced:
        keys.append("breakdown")
    assert list(result)[:len(keys)] == keys
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"}
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][part]) <= 10
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name", RUN_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu_has_the_result_schema(name, traced):
    from bench.run import finite, run_cell

    # the tiny widths read other numbers than the cell's: limits of their
    # own, ten times what sound tiny runs read
    loose = {k: 10 * v for k, v in TINY_LIMITS[tiny(name).kind].items()}
    cell = tiny(name, loose)
    result = run_cell(cell, 2 ** 33 + 1, 0.5, traced,
                      torch.device("cpu"), log=lambda s: None)
    result.pop("numbers")
    result.pop("reference_s")
    result = finite(result)
    _schema(result, traced)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    if not traced:
        assert set(result["metrics"]) == {m["name"] for m in
                                          cell.end_to_end}


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 2 and out.stdout == ""


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, torch\n"
        "sys.path[:0] = ['.', 'src']\n"
        "from bench.run import forbidden_modules, run_cell\n"
        "from bench.tests.tiny import tiny\n"
        "import bench.readings\n"
        f"run_cell(tiny({CELLS[0]!r}), 3, 0.2, True, torch.device('cpu'),"
        " log=lambda s: None)\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from bench import run

    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert run.forbidden_modules() == ["repro"]


def test_traffic_is_a_function_of_the_seed():
    c = tiny("hymba-1.5b.prefill")
    t = c.traffic()
    a, b = t.cycle(c.mix, c.config, 2 ** 40 + 9), \
        t.cycle(c.mix, c.config, 2 ** 40 + 9)
    assert [r.length for r in a] == [r.length for r in b]
    assert all((x.rows == y.rows).all() for x, y in zip(a, b))
    other = t.cycle(c.mix, c.config, 5)
    assert sorted(r.length for r in other) == sorted(r.length for r in a)
    counts = {n: k for n, k in c.mix["lengths"]}
    assert {n: sum(r.length == n for r in a) for n in counts} == counts
    picked = t.sample(c.mix, a, 2 ** 40 + 9)
    assert len(picked) == c.mix["sample"]
    assert max(a[i].length for i in picked) == max(counts)
    train = load("hymba-1.5b.train")
    feed = train.traffic().Feed(train.mix, train.config, 2 ** 40 + 9)
    rows = [feed.rows(k) for k in range(2)]
    flat = [tuple(r) for step in rows for r in step[:, :64]]
    assert len(set(flat)) == len(flat)
