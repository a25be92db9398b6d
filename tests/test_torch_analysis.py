"""The port's static analyzer (``repro_torch.analysis``) rule by rule.

Each rule gets a seeded fault proving it fires there and a clean twin
proving it stays quiet on the port's sanctioned idioms (as
tests/test_analysis.py does for the reference's rules); the waiver and
baseline machinery is held to the reference's semantics; the whole port
must come back clean modulo ``analysis_baseline_torch.json`` — the same
invocation the gate runs.  The dispatch pass runs at the registry's tiny
shapes on the CPU; the card's own checks (sync-debug window, HtoD bytes,
the libraries' plans and attributes) are in tests/test_torch_cuda.py.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import (CARD_RULES, RULES, ast_lint,
                                  dispatch_checks, kernel_budget)
from repro_torch.analysis.report import (
    Finding,
    Report,
    Waiver,
    dump_baseline,
    load_baseline,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINE = REPO / "analysis_baseline_torch.json"


def lint_snippet(tmp_path, source: str, hot=()):
    p = tmp_path / "snippet.py"
    p.write_text(source)
    findings, _ = ast_lint.lint_files([str(p)], str(tmp_path), hot=hot)
    return findings


def rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# GEN-REUSE
# ---------------------------------------------------------------------------


def test_gen_reuse_fires_on_one_seed_for_two_streams(tmp_path):
    findings = lint_snippet(tmp_path, """
import torch

def draw_core(seed):
    gauss = torch.randn(4, generator=torch.Generator().manual_seed(seed))
    alpha = torch.randn(2, generator=torch.Generator().manual_seed(seed))
    return gauss, alpha
""")
    assert [f.rule for f in findings] == ["GEN-REUSE"]
    assert findings[0].symbol == "draw_core"


def test_gen_reuse_fires_on_one_counter_triple_drawn_twice(tmp_path):
    findings = lint_snippet(tmp_path, """
from repro_torch.core.analog import counter_normals

def two_sweeps(k, v_idx, dim):
    gauss = counter_normals(k, v_idx, dim)
    alpha = counter_normals(k, v_idx, dim)
    return gauss, alpha
""")
    assert [f.rule for f in findings] == ["GEN-REUSE"]


def test_gen_reuse_fires_in_a_loop_that_does_not_change_the_seed(tmp_path):
    findings = lint_snippet(tmp_path, """
import torch

def per_pair(seed, n):
    out = []
    for i in range(n):
        g = torch.Generator().manual_seed(seed)
        out.append(torch.randn(4, generator=g))
    return out
""")
    assert rules_of(findings) == {"GEN-REUSE"}


def test_gen_reuse_quiet_on_distinct_streams(tmp_path):
    findings = lint_snippet(tmp_path, """
import torch
from repro_torch.core import analog

def ok_seeds(seed):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator().manual_seed(seed + 1)
    return a, b

def ok_one_generator(seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(4, generator=gen), torch.randn(2, generator=gen)

def ok_counter(k, dim):
    full = analog.counter_normals(k, torch.arange(40), dim)
    part = analog.counter_normals(k, torch.arange(17, 29), dim)
    return full, part

def ok_loop(seed, n):
    return [torch.Generator().manual_seed(seed + i) for i in range(n)]

def ok_loop_rotating(seed, n):
    out = []
    for i in range(n):
        g = torch.Generator().manual_seed(seed * 7 + i)
        out.append(g)
    return out

def ok_branches(seed, flag):
    if flag:
        return torch.Generator().manual_seed(seed)
    else:
        return torch.Generator().manual_seed(seed)
""")
    assert findings == []


# ---------------------------------------------------------------------------
# DEVICE-THREAD
# ---------------------------------------------------------------------------


def test_device_thread_fires_on_a_dropped_device(tmp_path):
    findings = lint_snippet(tmp_path, """
def compile_bank(specs, device=None):
    return specs

def deploy(specs, device=None):
    return compile_bank(specs)
""")
    assert [f.rule for f in findings] == ["DEVICE-THREAD"]
    assert findings[0].symbol == "deploy"


def test_device_thread_fires_on_an_availability_switch(tmp_path):
    findings = lint_snippet(tmp_path, """
import torch
from repro_torch.kernels import rbf

def scores(x, sv, gamma):
    if torch.cuda.is_available():
        return rbf.kernel_matrix_cuda(x, sv, gamma)
    return rbf.kernel_matrix_plain(x, sv, gamma)
""")
    assert [f.rule for f in findings] == ["DEVICE-THREAD"]


def test_device_thread_fires_on_a_silent_fallback(tmp_path):
    findings = lint_snippet(tmp_path, """
from repro_torch.kernels import ops, ref

def solve(x, y, c, g):
    try:
        return ops.solve_lanes(x, y, c, g)
    except RuntimeError:
        return ref.solve_lanes(x, y, c, g)
""")
    assert [f.rule for f in findings] == ["DEVICE-THREAD"]


def test_device_thread_quiet_on_threaded_calls(tmp_path):
    findings = lint_snippet(tmp_path, """
import torch
from repro_torch.kernels import ops

def compile_bank(specs, n, device=None):
    return specs

def deploy(specs, device=None):
    return compile_bank(specs, 3, device=device)

def deploy_positional(specs, device=None):
    return compile_bank(specs, 3, device)

def _private(specs, device=None):
    return compile_bank(specs, 3)

def need_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no card")

def solve(x, y, c, g):
    try:
        return ops.solve_lanes(x, y, c, g)
    except RuntimeError as e:
        raise ValueError("bad lanes") from e
""")
    assert findings == []


# ---------------------------------------------------------------------------
# DEVICE-MOVE
# ---------------------------------------------------------------------------


def test_device_move_fires_on_a_field_left_behind(tmp_path):
    findings = lint_snippet(tmp_path, """
import dataclasses
import torch

@dataclasses.dataclass
class Bank:
    w: torch.Tensor
    b: torch.Tensor
    bits: int = 0

    def to(self, device):
        return dataclasses.replace(self, w=self.w.to(device))

def move(bank, dev):
    return Bank(w=bank.w.to(dev), b=bank.b, bits=bank.bits)
""")
    assert [f.rule for f in findings] == ["DEVICE-MOVE"] * 2
    assert {f.symbol for f in findings} == {"Bank.to", "move"}


def test_device_move_quiet_on_whole_moves_and_casts(tmp_path):
    findings = lint_snippet(tmp_path, """
import dataclasses
import torch

@dataclasses.dataclass
class Bank:
    w: torch.Tensor
    b: torch.Tensor

def move(bank, dev):
    return Bank(w=bank.w.to(dev), b=bank.b.to(device=dev))

def cast(bank):
    return Bank(w=bank.w.to(torch.float32), b=bank.b)

def generic(bank, dev):
    return dataclasses.replace(bank, **{
        f.name: getattr(bank, f.name).to(dev)
        for f in dataclasses.fields(bank)})
""")
    assert findings == []


# ---------------------------------------------------------------------------
# BANNED-IN-HOT
# ---------------------------------------------------------------------------

HOT_SNIPPET = """
import time
import numpy as np
import torch

def helper(x: torch.Tensor):
    return float(x.sum())

def hot(x: torch.Tensor):
    noise = np.random.normal(size=4)
    t0 = time.perf_counter()
    s = x.sum().item()
    rows = x.cpu().numpy()
    lst = x.tolist()
    return helper(x) + s + t0 + noise.sum() + rows.sum() + len(lst)

def cold(x: torch.Tensor):
    t0 = time.perf_counter()
    return x.sum().item(), float(x.shape[0]), np.random.normal(), t0

def hot_ok(x: torch.Tensor):
    n = int(x.shape[0])
    return x * float(np.float32(0.5)) + n
"""


def test_banned_in_hot_fires_on_every_class_and_follows_calls(tmp_path):
    findings = lint_snippet(tmp_path, HOT_SNIPPET,
                            hot=[("snippet.py", "hot")])
    assert rules_of(findings) == {"BANNED-IN-HOT"}
    msgs = " ".join(f.message for f in findings)
    for what in ("np.random", "time.perf_counter", ".item()", ".cpu()",
                 ".numpy()", ".tolist()", "float() of a tensor"):
        assert what in msgs, what
    assert {f.symbol for f in findings} == {"hot", "helper"}


def test_banned_in_hot_quiet_outside_hot_and_on_host_scalars(tmp_path):
    assert lint_snippet(tmp_path, HOT_SNIPPET) == []
    assert lint_snippet(tmp_path, HOT_SNIPPET,
                        hot=[("snippet.py", "hot_ok")]) == []


# ---------------------------------------------------------------------------
# Pass 1: F64-IN-HOT / HOST-SYNC / UPLOAD-PER-CALL / SLOT-REUSE
# ---------------------------------------------------------------------------


def _recorded(fn):
    rec = dispatch_checks.OpRecorder()
    with rec:
        fn()
    return dispatch_checks.check_ops(rec.ops, path="fixture",
                                     symbol="fixture")[0]


def test_f64_in_hot_fires_on_a_float64_tensor():
    x = torch.zeros(3, dtype=torch.float32)
    findings = _recorded(lambda: x.to(torch.float64) * 2.0)
    assert rules_of(findings) == {"F64-IN-HOT"}


def test_f64_in_hot_quiet_on_f32_and_host_numpy():
    import numpy as np

    x = torch.zeros(3, dtype=torch.float32)
    findings = _recorded(
        lambda: x * float(np.float64(2.0)) + torch.as_tensor(
            np.arange(3, dtype=np.float64).astype(np.float32)))
    assert findings == []


@pytest.mark.parametrize("op", ["item", "nonzero", "mask", "unique",
                                "repeat_interleave"])
def test_host_sync_fires_on_data_dependent_ops(op):
    x = torch.arange(6, dtype=torch.float32)
    fns = {
        "item": lambda: x.sum().item(),
        "nonzero": lambda: torch.nonzero(x > 2),
        "mask": lambda: x[x > 2],
        "unique": lambda: torch.unique(x),
        "repeat_interleave": lambda: torch.repeat_interleave(
            torch.tensor([1, 2])),
    }
    findings = _recorded(fns[op])
    assert rules_of(findings) == {"HOST-SYNC"}


def test_host_sync_quiet_on_static_shapes():
    x = torch.arange(6, dtype=torch.float32)
    findings = _recorded(lambda: (
        torch.where(x > 2, x, 0.0),
        x[torch.tensor([0, 2])],
        torch.repeat_interleave(torch.tensor([1, 2]), output_size=3),
        torch.argmax(x)))
    assert findings == []


def _upload_entry(nbytes: int):
    """An entry point that uploads ``nbytes`` per call: a host f32 tensor
    moved to the ``meta`` device (a device that is not the host, which
    the CPU has) by ``.to()`` and by ``copy_``."""
    from repro_torch.analysis.entrypoints import EntryPoint

    half = torch.zeros(nbytes // 8, dtype=torch.float32)
    dst = torch.empty(nbytes // 8, dtype=torch.float32, device="meta")
    return EntryPoint("upload", "fixture",
                      lambda: (half.to("meta"), dst.copy_(half)))


def test_upload_per_call_fires_above_the_limit():
    findings, info = dispatch_checks.run_entrypoint(_upload_entry(3 << 20))
    assert info["htod_bytes_per_call"] == 3 << 20
    assert [f.rule for f in findings] == ["UPLOAD-PER-CALL"]


def test_upload_per_call_quiet_below_the_limit():
    findings, info = dispatch_checks.run_entrypoint(_upload_entry(1 << 19))
    assert info["htod_bytes_per_call"] == 1 << 19 and findings == []
    big = _upload_entry(3 << 20)
    big.max_upload_bytes = 4 << 20
    assert dispatch_checks.run_entrypoint(big)[0] == []


def test_upload_bytes_counts_host_to_device_copies_only():
    """Device -> host, host -> host and casts on one device copy nothing
    up; each host -> device copy counts its source's bytes once."""
    rec = dispatch_checks.OpRecorder()
    host = torch.zeros(100, dtype=torch.float32)
    dev = torch.empty(100, dtype=torch.float32, device="meta")
    with rec:
        host.to(torch.float64)
        host.clone().copy_(host)
        dev.to(torch.float16)
        dev.copy_(dev)
        host.to("meta", dtype=torch.float16)
    assert rec.htod_bytes == 400


@pytest.fixture(scope="module")
def registry():
    from repro_torch.analysis.entrypoints import build_registry

    return build_registry("cpu")


def _engine_entry(registry):
    return next(e for e in registry if e.engine is not None)


def test_slot_reuse_quiet_on_the_engine(registry):
    entry = _engine_entry(registry)
    findings, info = dispatch_checks.check_slot_reuse(
        entry.engine, path=entry.path, symbol=entry.symbol, dispatches=3)
    assert findings == []
    assert info["slots_per_bucket"] == entry.engine.pipeline_depth + 1


def test_slot_reuse_fires_on_a_lost_slot_and_a_foreign_output(registry,
                                                               monkeypatch):
    eng = _engine_entry(registry).engine
    monkeypatch.setitem(eng._staging, 8, eng._staging[8][:1])
    monkeypatch.setattr(eng._sharded, "enqueue",
                        lambda x, idx, out, bufs=None: [])
    findings, _ = dispatch_checks.check_slot_reuse(
        eng, path="fixture", symbol="engine", dispatches=2)
    msgs = " ".join(f.message for f in findings)
    assert rules_of(findings) == {"SLOT-REUSE"}
    assert "staging slots" in msgs and "did not write" in msgs


def test_registry_covers_every_hot_symbol(registry):
    """Every hot symbol the AST pass starts from has a registered entry
    point (the gate below runs them all)."""
    from repro_torch.analysis.entrypoints import HOT_SYMBOLS

    symbols = {e.symbol for e in registry}
    for needed in ("FleetMachine._labels[dag]", "SVMEngine._forward"):
        assert needed in symbols
    for path, qual in HOT_SYMBOLS:
        assert (REPO / path).is_file()
        leaf = qual.rsplit(".", 1)[-1]
        assert any(e.path == path and e.symbol.split("[")[0].endswith(leaf)
                   for e in registry), qual


# ---------------------------------------------------------------------------
# Pass 3: SMEM-BUDGET / GRID-COVERS / FUSED-VS-ORACLE / REG-*
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,dh,want", [
    (1, 64, 50_240), (1, 96, 74_816), (1, 112, 87_104), (1, 128, 99_392),
    (0, 64, 66_304), (0, 128, 115_456)])
def test_mirror_k3_dynamic_shared_memory(dtype, dh, want):
    launch, = kernel_budget.k3_plan(dtype, 4, 32, 8, 2048, 2048, dh)
    assert launch.smem == want


@pytest.mark.parametrize("dtype,dh,dkv,dq", [
    (0, 32, 67_584, 50_944), (0, 64, 100_352, 83_712),
    (0, 128, 165_888, 149_248),
    (1, 32, 34_880, 33_856), (1, 64, 67_648, 66_624),
    (1, 96, 100_416, 99_392), (1, 112, 116_800, 115_776),
    (1, 128, 133_184, 132_160)])
def test_mirror_k3b_dynamic_shared_memory_at_every_head_dim(dtype, dh, dkv,
                                                            dq):
    """K3-bwd's dK / dV and dQ shared memory: f32 four padded f32 tiles
    and the P / dS tiles; bf16 four 64-row bf16 tiles of k, v (q, dO) and
    two ring stages, 1,024 B of alignment slack and the barriers."""
    pre, dkv_l, dq_l = kernel_budget.k3b_plan(dtype, 2, 16, 8, 4096, 4096,
                                              dh)
    assert (dkv_l.smem, dq_l.smem) == (dkv, dq)
    assert pre.smem == 0 and max(dkv, dq) <= kernel_budget.H100_SMEM_OPTIN
    if dtype == 1:
        assert pre.kernel == "bwd_prep_kernel"
        assert dkv_l.kernel == f"bwd_dkv_wgmma_kernel<{dh}>"
        assert (dkv_l.block, dq_l.block) == ((384, 1, 1), (288, 1, 1))
        assert (dkv_l.grid, dq_l.grid) == ((16, 32, 1), (32, 32, 1))
    else:
        assert dkv_l.kernel == f"bwd_dkv_kernel<{dh}>"


@pytest.mark.parametrize("args,splits", [
    ((1, 2, 16, 8, 4096, 4096, 64), 1),       # granite-moe: 512 CTAs
    ((1, 2, 36, 4, 4096, 4096, 128), 2),      # starcoder2: 256 -> 512
    ((1, 2, 48, 1, 4096, 4096, 128), 5),      # granite-20b MQA: 64 -> 320
    ((1, 1, 5, 1, 400, 400, 64), 5),          # a small MQA case: 1 head each
    ((0, 2, 48, 1, 4096, 4096, 128), 1)])     # f32 is never split
def test_mirror_k3b_splits_a_group_that_would_not_fill_the_card(args,
                                                                splits):
    """bf16 dK / dV CTAs below two waves of the card split the group's q
    heads over grid.z, and a fourth launch sums the splits."""
    launches = kernel_budget.k3b_plan(*args)
    assert launches[1].grid[2] == splits
    assert len(launches) == (4 if splits > 1 else 3)
    if splits > 1:
        assert launches[3].kernel == "bwd_dkv_sum_kernel"
    assert kernel_budget.grid_covers("flash_attention_bwd", args,
                                     launches) == []
    assert kernel_budget.grid_covers("flash_attention_bwd", args,
                                     launches[:3]) != [] or splits == 1


@pytest.mark.parametrize("nh,ds,state,scan", [
    (50, 16, 41_504, 89_088),      # hymba (dh 64, ds 16, chunk 128)
    (80, 128, 98_848, 199_680)])   # mamba2 (ds 128)
def test_mirror_k4_dynamic_shared_memory(nh, ds, state, scan):
    launches = kernel_budget.k4_plan(4, 2048, nh, 1, 64, ds, 128)
    assert [ln.smem for ln in launches] == [state, 0, scan]
    assert launches[0].kernel == f"ssd_chunk_state_kernel<64, {ds}>"


@pytest.mark.parametrize("nh,ds,state,chunk,terms,slices", [
    (50, 16, 93_184, 212_480, 94_272, 7),       # hymba training (dh 64,
                                                # ds 16, chunk 128)
    (80, 128, 207_872, 212_480, 208_960, 10)])  # mamba2 training (ds 128)
def test_mirror_k4b_dynamic_shared_memory_and_grids(nh, ds, state, chunk,
                                                    terms, slices):
    """K4-bwd's five launches at the training microbatch (2, 4096): a CTA
    per (batch, chunk, slice of at most 8 heads) in passes 1, 3 and 4, a
    thread per state value in the state pass and per (step, group, k) in
    the slice sum; the slices as the plain twins cut them."""
    from repro_torch.kernels import ref

    launches = kernel_budget.k4b_plan(2, 4096, nh, 1, 64, ds, 128)
    assert [ln.smem for ln in launches] == [state, 0, chunk, terms, 0]
    assert [ln.grid[0] for ln in launches] == [
        2 * 32 * slices, 2 * nh * 64 * ds // 256, 2 * 32 * slices,
        2 * 32 * slices, 2 * 4096 * ds // 256]
    assert launches[2].kernel == f"ssd_bwd_chunk_kernel<64, {ds}>"
    assert kernel_budget.k4b_plan(2, 4096, nh, 1, 64, ds, 128, 1) == \
        launches[:1]
    assert kernel_budget.grid_covers(
        "ssd_bwd", (2, 4096, nh, 1, 64, ds, 128, 0), launches) == []
    short = dataclasses.replace(launches[4], grid=(launches[4].grid[0] - 1,
                                                   1, 1))
    assert kernel_budget.grid_covers(
        "ssd_bwd", (2, 4096, nh, 1, 64, ds, 128, 0), launches[:4] + [short])
    for rep in (1, 2, 7, 8, 9, 25, 50, 80):
        assert kernel_budget.k4b_slices(rep) == ref.ssd_bwd_slices(rep)


@pytest.mark.parametrize("lanes,want", [
    ((3, 7, 35, 399, 4), dict(n_pad=400, chunk=400, fixed_floats=15_328,
                              lanes_fit=32, per_cta=6, groups=6,
                              grid=(6, 7, 3), smem=70_912)),
    ((66, 7, 35, 1582, 5), dict(n_pad=1584, chunk=512, fixed_floats=27_600,
                                lanes_fit=19, per_cta=18, groups=2,
                                grid=(2, 7, 66), smem=224_448))])
def test_mirror_k2_plan_at_balance_and_har12(lanes, want):
    lay = kernel_budget.k2_layout(*lanes, kind=1)
    launch = lay.pop("launch")
    assert lay == {k: v for k, v in want.items() if k in lay}
    assert (launch.grid, launch.smem, launch.block) == \
        (want["grid"], want["smem"], (1024, 1, 1))


def test_mirror_k1_plan_fills_the_card():
    small, = kernel_budget.k1_plan(3, 188, 71, 4, 1)
    wide, = kernel_budget.k1_plan(4, 1875, 1582, 5, 2)
    assert small.kernel == "kernel_matrix_kernel<kRbf, 4>"
    assert small.block == (32, 8, 1) and small.smem == 0
    assert wide.kernel == "kernel_matrix_kernel<kSech2, 5>"
    assert wide.grid == (13, 30, 4)     # 8 rows per thread: 8 x 8 x 30 >= n
    assert kernel_budget.k1_plan(2, 10, 10, 7, 1)[0].kernel.endswith(", 0>")


def test_repo_kernels_within_budget_and_fused_below_oracle():
    findings, info = kernel_budget.check_kernels()
    assert findings == []
    assert {r["library"] for r in info["launches"]} == \
        set(kernel_budget.LIBRARIES)
    for contract in info["fused_vs_oracle"]:
        assert contract["holds"] is True
        assert contract["fused_bytes"] < contract["oracle_gram_bytes"] / 50


def test_smem_budget_fires_over_the_budget():
    findings, _ = kernel_budget.check_kernels(smem_budget=150_000)
    fired = [f for f in findings if f.rule == "SMEM-BUDGET"]
    assert fired and rules_of(findings) == {"SMEM-BUDGET"}
    # K2 at har12 (224,448 B), K4 pass 3 at mamba2 (199,680 B) and K4-bwd
    # pass 3 at mamba2 (201,152 B)
    assert {f.path for f in fired} == {
        kernel_budget.SOURCE["solver"], kernel_budget.SOURCE["ssd"],
        kernel_budget.SOURCE["ssd_bwd"]}


def test_grid_covers_fires_on_short_grids_and_unpadded_shapes():
    short = kernel_budget.Launch("flash_wgmma_kernel<64>", (100, 15, 1),
                                 (288, 1, 1), 50_240)
    assert kernel_budget.grid_covers(
        "flash_attention", (1, 4, 25, 5, 2048, 2048, 64), [short])
    state, sp, scan = kernel_budget.k4_plan(4, 2048, 50, 1, 64, 16, 128)
    unpadded = dataclasses.replace(scan, kernel="ssd_chunk_scan_kernel<64, "
                                                "12>")
    assert kernel_budget.grid_covers(
        "ssd", (4, 2048, 50, 1, 64, 16, 128, 0), [state, sp, unpadded])
    ragged = kernel_budget.grid_covers(
        "ssd", (4, 2000, 50, 1, 64, 16, 128, 0), [state, sp, scan])
    assert any("multiple of chunk" in why for why in ragged)
    k2, = kernel_budget.k2_plan(3, 7, 35, 399, 4, 1)
    too_few = dataclasses.replace(k2, grid=(5, 7, 3))
    assert kernel_budget.grid_covers("solver", (3, 7, 35, 399, 4, 1),
                                     [too_few])
    f, _ = kernel_budget.check_call("solver", "fixture",
                                    (3, 7, 35, 399, 4, 1))
    assert f == []


def test_grid_covers_quiet_on_every_mirror_plan():
    for library, _, args in kernel_budget.MAIN_PATH_CALLS:
        plan = kernel_budget.mirror_plan(library, args)
        assert kernel_budget.grid_covers(library, args, plan) == []


def test_fused_vs_oracle_gate_fails_on_seeded_regression():
    findings, info = kernel_budget.check_kernels(oracle_bytes=1)
    assert rules_of(findings) == {"FUSED-VS-ORACLE"}
    assert all(c["holds"] is False for c in info["fused_vs_oracle"])


def _attrs(regs, local_bytes=0):
    return kernel_budget.Attributes(
        regs=regs, static_smem=0, local_bytes=local_bytes,
        max_threads=1024, ctas_per_sm=1, regs_per_sm=65_536,
        smem_optin=232_448, sm_count=132, smem_per_sm=233_472,
        const_bytes=0)


def test_reg_budget_and_spill_fire_on_the_card_attributes():
    k2, = kernel_budget.k2_plan(3, 7, 35, 399, 4, 1)
    findings = kernel_budget.check_launch("solver", "k2", k2,
                                          attrs=_attrs(65, local_bytes=8))
    assert sorted(f.rule for f in findings) == ["REG-BUDGET", "REG-SPILL"]


def test_reg_budget_quiet_at_64_registers_for_1024_threads():
    k2, = kernel_budget.k2_plan(3, 7, 35, 399, 4, 1)
    assert kernel_budget.check_launch("solver", "k2", k2,
                                      attrs=_attrs(64)) == []
    static = dataclasses.replace(_attrs(64), static_smem=10_000)
    assert [f.rule for f in kernel_budget.check_launch(
        "solver", "k2", dataclasses.replace(k2, smem=230_000),
        attrs=static)] == ["SMEM-BUDGET"]


def test_reg_spill_waiver_holds_the_measured_frame_only():
    """The baseline waives each K2 mode's measured stack frame; the same
    instance with a larger frame is a new finding."""
    waivers = load_baseline(str(BASELINE))
    k2, = kernel_budget.k2_plan(3, 7, 35, 399, 4, 1)
    for local, waived in ((136, True), (144, False), (512, False)):
        f, = kernel_budget.check_launch("solver", "k2", k2,
                                        attrs=_attrs(64, local_bytes=local))
        assert f.rule == "REG-SPILL" and str(local) in f.symbol
        assert any(w.covers(f) for w in waivers) is waived, local


def test_record_launches_collects_the_wrappers_shapes():
    """The launch counters collect each launch's plan arguments only
    inside ``record_launches``, and count every launch either way."""
    from repro_torch.kernels import flash_attention_bwd, rbf, ssd

    before = rbf.LAUNCHES.count
    rbf.LAUNCHES.launched((1, 2, 3, 4, 1))
    with kernel_budget.record_launches() as seen:
        rbf.LAUNCHES.launched((3, 188, 71, 4, 1))
        rbf.LAUNCHES.launched((3, 188, 71, 4, 1))
        ssd.LAUNCHES.launched((4, 2048, 50, 1, 64, 16, 128, 0))
        flash_attention_bwd.LAUNCHES.launched((1, 2, 16, 8, 4096, 4096, 64))
    rbf.LAUNCHES.launched((5, 6, 7, 4, 1))
    assert seen == {"kernel_matrix": {(3, 188, 71, 4, 1)}, "solver": set(),
                    "flash_attention": set(),
                    "ssd": {(4, 2048, 50, 1, 64, 16, 128, 0)},
                    "flash_attention_bwd": {(1, 2, 16, 8, 4096, 4096, 64)},
                    "ssd_bwd": set()}
    assert rbf.LAUNCHES.count == before + 4
    assert rbf.LAUNCHES.shapes is None and ssd.LAUNCHES.shapes is None
    assert flash_attention_bwd.LAUNCHES.shapes is None
    rbf.LAUNCHES.count = before
    ssd.LAUNCHES.count -= 1
    flash_attention_bwd.LAUNCHES.count -= 1


def _cu_constants(library: str) -> dict:
    """The ``constexpr int`` constants of a kernel source, evaluated."""
    import re

    text = (REPO / kernel_budget.SOURCE[library]).read_text()
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    out: dict = {}
    for decl in re.findall(r"^constexpr int (k\w+ *=[^;]+);", text, flags=re.M):
        for name, expr in re.findall(r"(\w+)\s*=\s*([^,]+)", decl):
            expr = re.sub(r"\b(k\w+)\b", lambda m: str(out[m.group(1)]),
                          expr)
            assert re.fullmatch(r"[\d\s+*/()-]+", expr), (name, expr)
            out[name] = eval(expr)   # noqa: S307 — digits and + - * / only
    return out


#: The mirror's constants and the names the kernel sources give them.
MIRROR_CONSTANTS = {
    "kernel_matrix": {"K1_TX": "kTx", "K1_TY": "kTy", "K1_COLS": "kCols",
                      "K1_MAX_ROWS": "kMaxRows", "K1_FILL_CTAS": "kFillCtas",
                      "K1_UNROLLED_D": "kUnrolledD"},
    "solver": {"K2_BLOCK": "kBlock", "K2_MAX_CHUNK": "kMaxChunk",
               "K2_MAX_LANES": "kMaxLanesPerCta", "K2_THREADS": "kCtaThreads"},
    "flash_attention": {"K3_BLOCK_Q": "kBlockQ", "K3_BLOCK_K": "kBlockK",
                        "K3_THREADS": "kThreads", "K3_TC_BLOCK_Q": "kTcBlockQ",
                        "K3_TC_THREADS": "kTcThreads", "K3_STAGES": "kStages"},
    "ssd": {"K4_THREADS": "kThreads", "K4_MAX_CHUNK": "kMaxChunk",
            "K4_STRIP_LD": "kStripLd"},
    "ssd_bwd": {"K4B_THREADS": "kThreads", "K4B_MAX_CHUNK": "kMaxChunk",
                "K4B_TILE": "kTile", "K4B_PAD": "kPad",
                "K4B_MAX_SLICE": "kMaxSlice"},
    "flash_attention_bwd": {"K3B_BLOCK_Q": "kBlockQ",
                            "K3B_BLOCK_K": "kBlockK",
                            "K3B_THREADS": "kThreads",
                            "K3B_TC_CONSUMERS": "kTcConsumers",
                            "K3B_DKV_THREADS": "kDkvThreads",
                            "K3B_DQ_THREADS": "kDqThreads",
                            "K3B_TC_STAGES": "kTcStages",
                            "K3B_LD_FLOATS": "kLdFloats",
                            "K3B_FILL_CTAS": "kFillCtas"},
}


@pytest.mark.parametrize("library", kernel_budget.LIBRARIES)
def test_mirror_constants_match_the_kernel_sources(library):
    """A tile or block constant edited in a ``.cu`` file shows on the CPU:
    the mirror's copy must equal the source's ``constexpr``.  (An edit to
    a plan's formula shows only on the card, where the mirror is held to
    the library's own plan.)"""
    consts = _cu_constants(library)
    for mirror, c_name in MIRROR_CONSTANTS[library].items():
        assert getattr(kernel_budget, mirror) == consts[c_name], mirror


#: Each rule's seeded-fault test and clean-twin test in this file.
RULE_TESTS = {
    "F64-IN-HOT": ("test_f64_in_hot_fires_on_a_float64_tensor",
                   "test_f64_in_hot_quiet_on_f32_and_host_numpy"),
    "HOST-SYNC": ("test_host_sync_fires_on_data_dependent_ops",
                  "test_host_sync_quiet_on_static_shapes"),
    "UPLOAD-PER-CALL": ("test_upload_per_call_fires_above_the_limit",
                        "test_upload_per_call_quiet_below_the_limit"),
    "SLOT-REUSE": ("test_slot_reuse_fires_on_a_lost_slot_and_a_foreign_output",
                   "test_slot_reuse_quiet_on_the_engine"),
    "GEN-REUSE": ("test_gen_reuse_fires_on_one_seed_for_two_streams",
                  "test_gen_reuse_quiet_on_distinct_streams"),
    "DEVICE-THREAD": ("test_device_thread_fires_on_a_dropped_device",
                      "test_device_thread_quiet_on_threaded_calls"),
    "DEVICE-MOVE": ("test_device_move_fires_on_a_field_left_behind",
                    "test_device_move_quiet_on_whole_moves_and_casts"),
    "BANNED-IN-HOT": (
        "test_banned_in_hot_fires_on_every_class_and_follows_calls",
        "test_banned_in_hot_quiet_outside_hot_and_on_host_scalars"),
    "SMEM-BUDGET": ("test_smem_budget_fires_over_the_budget",
                    "test_repo_kernels_within_budget_and_fused_below_oracle"),
    "GRID-COVERS": ("test_grid_covers_fires_on_short_grids_and_unpadded_shapes",
                    "test_grid_covers_quiet_on_every_mirror_plan"),
    "FUSED-VS-ORACLE": (
        "test_fused_vs_oracle_gate_fails_on_seeded_regression",
        "test_repo_kernels_within_budget_and_fused_below_oracle"),
    "REG-BUDGET": ("test_reg_budget_and_spill_fire_on_the_card_attributes",
                   "test_reg_budget_quiet_at_64_registers_for_1024_threads"),
    "REG-SPILL": ("test_reg_budget_and_spill_fire_on_the_card_attributes",
                  "test_reg_budget_quiet_at_64_registers_for_1024_threads"),
}


def test_every_rule_has_its_fixtures():
    assert set(RULE_TESTS) == set(RULES)
    for rule, names in RULE_TESTS.items():
        for name in names:
            assert callable(globals().get(name)), (rule, name)


# ---------------------------------------------------------------------------
# Baseline / report machinery
# ---------------------------------------------------------------------------


def test_waiver_requires_reason(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({
        "format": "repro_torch.analysis.baseline", "version": 1,
        "waivers": [{"rule": "GEN-REUSE", "match": "x.py::f",
                     "reason": "  "}]}))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(p))


def test_waiver_rejects_todo_placeholder(tmp_path):
    p = tmp_path / "baseline.json"
    for reason in ("TODO: justify this waiver", "todo later"):
        p.write_text(json.dumps({
            "format": "repro_torch.analysis.baseline", "version": 1,
            "waivers": [{"rule": "GEN-REUSE", "match": "x.py::f",
                         "reason": reason}]}))
        with pytest.raises(ValueError, match="placeholder"):
            load_baseline(str(p))
    # the reference's baseline format is not the port's
    p.write_text(json.dumps({"format": "repro.analysis.baseline",
                             "version": 1, "waivers": []}))
    with pytest.raises(ValueError, match="repro_torch.analysis.baseline"):
        load_baseline(str(p))


def test_update_baseline_requires_real_reason(tmp_path):
    from repro_torch.analysis.__main__ import main

    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "bad.py").write_text(
        "import torch\n\n"
        "def f(seed):\n"
        "    a = torch.Generator().manual_seed(seed)\n"
        "    b = torch.Generator().manual_seed(seed)\n"
        "    return a, b\n")
    baseline = tmp_path / "baseline.json"
    args = ["--root", str(tmp_path), "--no-dispatch", "--no-budget",
            "--baseline", str(baseline), "--update-baseline"]
    with pytest.raises(SystemExit):
        main(args)                                   # no --reason
    with pytest.raises(SystemExit):
        main(args + ["--reason", "TODO: fill in"])   # placeholder reason
    assert not baseline.exists()
    assert main(args + ["--reason", "intentional shared stream"]) == 0
    waivers = load_baseline(str(baseline))
    assert waivers and all(
        w.reason == "intentional shared stream" for w in waivers)
    assert main(args + ["--reason", "a different reason"]) == 0
    assert [w.reason for w in load_baseline(str(baseline))] == \
        [w.reason for w in waivers]


def test_waiver_glob_and_unused_tracking(tmp_path):
    f = Finding(rule="GEN-REUSE", path="tests/test_torch_cuda.py",
                symbol="test_x", message="m")
    report = Report(findings=[f], waivers=[
        Waiver(rule="GEN-REUSE", match="tests/test_torch_*", reason="r"),
        Waiver(rule="SMEM-BUDGET", match="never/*", reason="r"),
    ])
    assert report.new_findings == []
    assert len(report.waived_findings) == 1
    assert [w.rule for w in report.unused_waivers()] == ["SMEM-BUDGET"]
    p = tmp_path / "b.json"
    dump_baseline(str(p), report.waivers)
    assert [dataclasses.asdict(w) for w in load_baseline(str(p))] == \
        [dataclasses.asdict(w) for w in report.waivers]
    assert report.to_dict()["format"] == "repro_torch.analysis.report"


def test_finding_key_is_line_stable():
    a = Finding(rule="R", path="p.py", symbol="f", message="m", line=10)
    b = Finding(rule="R", path="p.py", symbol="f", message="m", line=99)
    assert a.key == b.key


# ---------------------------------------------------------------------------
# The gate: the port is clean modulo its baseline
# ---------------------------------------------------------------------------


def test_repo_clean_modulo_baseline(tmp_path):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "report.json"
    rc = main(["--root", str(REPO), "--device", "cpu", "--baseline",
               str(BASELINE), "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["summary"]["new"] == 0
    # only the waivers of rules a card decides stay unused on the CPU
    assert {w["rule"] for w in report["summary"]["unused_waivers"]} <= \
        set(CARD_RULES)
    assert all(c["holds"] for c in
               report["info"]["kernel_budget"]["fused_vs_oracle"])
    entries = report["info"]["dispatch_checks"]["entrypoints"]
    assert len(entries) == 15 and not any("error" in e for e in entries)
    slot = [e["slot_reuse"] for e in entries if "slot_reuse" in e]
    assert slot and slot[0]["slots_per_bucket"] == 2


def test_gate_fails_without_baseline_and_on_a_seeded_finding(tmp_path):
    from repro_torch.analysis.__main__ import build_report, main

    report = build_report(str(REPO), run_dispatch=False, run_budget=False)
    # the deliberate exceptions exist, so an empty baseline must gate
    assert len(report.new_findings) > 0
    bad = tmp_path / "src" / "repro_torch" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def deploy(specs, device=None):\n"
                   "    return compile_bank(specs)\n\n"
                   "def compile_bank(specs, device=None):\n"
                   "    return specs\n")
    args = ["--root", str(tmp_path), "--no-dispatch", "--no-budget",
            "--baseline", str(BASELINE)]
    assert main(args) == 1


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the analyzer runs on the card, as every entry
    point of the port does, and raises where there is none; the AST pass
    alone needs no device."""
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.entrypoints import build_registry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--root", str(REPO), "--no-ast", "--no-dispatch"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_registry()
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    assert main(["--root", str(tmp_path), "--no-dispatch",
                 "--no-budget"]) == 0


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis."
            "__main__, repro_torch.analysis.entrypoints, repro_torch."
            "analysis.kernel_budget, repro_torch.analysis.dispatch_checks; "
            "assert 'jax' not in sys.modules; "
            "assert not [m for m in sys.modules if m == 'repro' or "
            "m.startswith('repro.')]")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={**os.environ, "PYTHONPATH": str(REPO / "src")})
