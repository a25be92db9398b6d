"""Tiny cells for the CPU tests: the benchmark's cells with every width
cut so that a run takes seconds on the CPU, dtype and structure kept.

``<config>.prefill`` is no cell of ``BENCHMARK.json`` (no prompt-length
mix of a cited serving trace is in the repository yet); it is built here
from the configuration and a tiny mix of kind ``prefill``, so that the
prefill runner a later cell will use stays tested."""
from __future__ import annotations

import copy

from bench.harness import cell as cell_mod

SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "d_head": 16, "d_ff": 96, "vocab_size": 256}
SMALL_MOE = {"n_experts": 8, "top_k": 2, "d_ff": 32}
SMALL_HYBRID = {"window": 32, "global_layers": [0], "ssm_state": 8,
                "ssm_head_dim": 16}
SMALL_MIX = {"train": {"seq_len": 64, "global_batch": 4, "checked_steps": 3,
                       "trace_steps": 1},
             "prefill": {"lengths": [[32, 2], [64, 2], [160, 1]],
                         "sample": 3}}
PREFILL_MIX = {"kind": "prefill", "batch": 4, "cap_extra": 8,
               "corpus": {"zipf_exponent": 1.1, "copy_share": 0.5,
                          "period_base": 64, "period_span": 64}}
PREFILL_END_TO_END = [{"name": "prefill_tokens_per_s", "unit": "tokens/s"},
                      {"name": "prefill_p95_ms", "unit": "ms"},
                      {"name": "setup_s", "unit": "s"}]
PREFILL_PER_LAYER = [
    {"name": f"{m}.prefill", "unit": unit, "moves": "prefill_tokens_per_s"}
    for m, unit in [("device_idle", "%"), ("mfu", "%"),
                    ("moe_dispatch_ms", "ms/request"), ("k3_roofline", "%"),
                    ("k4_roofline", "%"), ("gemm_roofline", "%")]]


def _prefill_cell(name: str) -> cell_mod.Cell:
    bench = cell_mod.benchmark()
    config = name[:-len(".prefill")]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    return cell_mod.Cell(
        name, cell_mod.load_json(cell_mod.ROOT / files[config]),
        dict(PREFILL_MIX), {"config": config, "traffic": "prefill",
                            "chips": 1, "limits": {}},
        copy.deepcopy(PREFILL_END_TO_END), copy.deepcopy(PREFILL_PER_LAYER))


def tiny(name: str, limits: dict | None = None) -> cell_mod.Cell:
    cells = {w["name"] for w in cell_mod.benchmark()["workloads"]}
    if name not in cells and name.endswith(".prefill"):
        c = _prefill_cell(name)
    else:
        c = copy.deepcopy(cell_mod.load(name))
    c.config.update(SMALL)
    if c.config["family"] == "moe":
        c.config.update(SMALL_MOE)
    if c.config["family"] == "hybrid":
        c.config.update(SMALL_HYBRID)
    c.mix.update(SMALL_MIX[c.kind])
    if limits is not None:
        c.spec["limits"] = limits
    return c
