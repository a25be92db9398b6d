"""The port's cell builder (``launch/steps.py``) and dry run
(``launch/dryrun.py``) against the reference's, on the CPU.

* ``apply_variant`` gives the reference's config, rules, optimizer config,
  int8-weight flag and extras for every key, and refuses an unknown one;
* ``build_cell``'s ``in_specs`` (and the shapes of ``args_sds``) equal the
  reference's for one cell per (family, kind) at the single-pod mesh and
  two at the multi-pod one: the reference's from ``jax.eval_shape``, the
  port's from its model on ``meta``;
* the dry run traces reduced configs on ``meta`` and writes records with
  the reference's keys (``arch``, ``shape``, ``mesh``, ``variant``,
  ``kind``, ``chips``, ``params``, ``active_params``,
  ``flops_per_device``, ``memory.argument_bytes``) beside ``trace_s`` and
  ``analysis: "meta"`` (``temp_bytes`` and ``collectives`` null).  Its
  argument bytes equal XLA's on the reduced (2, 4) train cell in
  tests/test_torch_distributed.py.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.launch import steps as r_steps
from repro.models.common import ShardRules as RRules
from repro.training import optimizer as r_opt
from repro_torch import configs
from repro_torch.distributed import partition
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import P, make_production_mesh, dp_axes
from repro_torch.models.common import ShardRules
from repro_torch.training import optimizer as opt_mod

VARIANTS = ["", "remat=dots", "fsdp=none", "fsdp=model", "sp=data",
            "opt8=on", "attn_block=512", "cap=2.0", "wq=int8",
            "dtype=float32", "castbf16=on", "kvtp=on", "moegroups=4",
            "moe2d=on", "kv=int8", "unroll=on", "scan_attn=off",
            "remat=none,opt8=on,wq=int8,kvtp=on"]

#: One cell per (family, kind) at the single-pod mesh, two at multi-pod.
CELLS = [(a, s, False) for a in ("starcoder2-7b", "granite-moe-1b-a400m",
                                 "mamba2-2.7b", "hymba-1.5b",
                                 "phi-3-vision-4.2b", "whisper-medium")
         for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("kimi-k2-1t-a32b", "train_4k", True), ("mamba2-2.7b", "long_500k", True)]


def _norm(spec) -> tuple:
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_variant_equals_the_reference(variant):
    arch = "granite-moe-1b-a400m"
    r_cfg = r_steps.configs.get(arch).make_config()
    cfg = configs.get(arch).make_config()
    r_out = r_steps.apply_variant(r_cfg, RRules(), r_opt.AdamWConfig(),
                                  variant)
    out = steps.apply_variant(cfg, ShardRules(), opt_mod.AdamWConfig(),
                              variant)
    for a, b in zip(out[:3], r_out[:3]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert out[3:] == r_out[3:]


def test_apply_variant_refuses_an_unknown_key():
    with pytest.raises(ValueError, match="unknown variant key 'bogus'"):
        steps.apply_variant(configs.get("granite-20b").make_config(),
                            ShardRules(), opt_mod.AdamWConfig(), "bogus=1")


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_build_cell_specs_equal_the_reference(arch, shape, multi_pod):
    r_cell = r_steps.build_cell(arch, shape, multi_pod)
    cell = steps.build_cell(arch, shape, multi_pod)
    assert cell["kind"] == r_cell["kind"]
    assert dataclasses.asdict(cell["rules"]) == dataclasses.asdict(
        r_cell["rules"])
    is_rp = lambda x: isinstance(x, RP)
    is_p = lambda x: isinstance(x, P)
    r_args, r_specs = r_cell["args_sds"], r_cell["in_specs"]
    args, specs = cell["args_sds"], cell["in_specs"]
    if cell["kind"] == "decode":
        # the port's serve state adds whisper's host int enc_len
        keys = list(r_args[1])
        args = (args[0], {k: args[1][k] for k in keys}, args[2])
        specs = (specs[0], {k: specs[1][k] for k in keys}, specs[2])
    r_leaves = jax.tree.leaves(r_args)
    leaves = partition.tree_leaves(args)
    assert [(tuple(x.shape), _dtype_name(x.dtype)) for x in r_leaves] == \
        [(x.shape, _dtype_name(x.dtype)) for x in leaves]
    assert [_norm(s) for s in partition.tree_leaves(specs, is_leaf=is_p)] \
        == [_norm(s) for s in jax.tree.leaves(r_specs, is_leaf=is_rp)]


def test_production_mesh_and_dp_axes():
    single = make_production_mesh(devices=["meta"] * 256)
    assert single.shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert dp_axes(True) == ("pod", "data") and dp_axes(False) == ("data",)
    with pytest.raises(ValueError, match="n_devices=256 but 8"):
        make_production_mesh(devices=["meta"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_production_mesh()


#: Reduced configs traced on meta: one per family, the kinds rotating.
DRY_CELLS = [("starcoder2-7b", "train_4k"), ("granite-moe-1b-a400m",
                                             "decode_32k"),
             ("mamba2-2.7b", "prefill_32k"), ("hymba-1.5b", "long_500k"),
             ("phi-3-vision-4.2b", "train_4k"), ("whisper-medium",
                                                 "prefill_32k")]
KEYS = {"arch", "shape", "mesh", "variant", "kind", "chips", "params",
        "active_params", "flops_per_device", "memory", "trace_s",
        "analysis", "collectives"}


def test_dry_run_traces_reduced_cells_on_meta(tmp_path):
    records, failures = dryrun.run_grid(DRY_CELLS, [False, True],
                                        reduced=True, out=str(tmp_path),
                                        log=lambda *a: None)
    assert not failures, failures
    assert len(records) == 2 * len(DRY_CELLS)
    for rec in records:
        assert KEYS <= set(rec), rec
        assert rec["analysis"] == "meta" and rec["collectives"] is None
        assert rec["memory"]["temp_bytes"] is None
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["flops_per_device"] > 0
        assert rec["chips"] == (512 if rec["mesh"] == "pod2x16x16" else 256)
        assert rec["flops_per_device"] * rec["chips"] == rec["flops_global"]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2 * len(DRY_CELLS)
    with open(tmp_path / "hymba-1.5b_long_500k_multi.json") as f:
        rec = json.load(f)
    assert rec["kind"] == "decode" and rec["reduced"]
    cfg = configs.get("hymba-1.5b").reduced()
    assert rec["params"] == cfg.param_count()


def test_dry_run_cli_and_a_shape_error(tmp_path):
    recs = dryrun.main(["--arch", "granite-20b", "--shape", "decode_32k",
                        "--mesh", "single", "--reduced", "--variant",
                        "wq=int8", "--out", str(tmp_path)])
    assert [r["variant"] for r in recs] == ["wq=int8"]
    assert (tmp_path / "granite-20b_decode_32k_single_wq-int8.json").exists()
    cell = steps.build_cell("granite-20b", "train_4k", False, reduced=True)
    state, batch = cell["trace_args"]()
    batch["tokens"] = torch.empty((256, 4097), dtype=torch.int32,
                                  device="meta")
    with pytest.raises(RuntimeError):
        cell["fn"](state, batch)
