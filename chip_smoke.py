#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:

1. Environment and build: the card's name and power limit, f32 matmuls
   without TF32, and the hand kernels built from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel), with ptxas's registers,
   shared memory and spills of every kernel instance.
2. Each hand kernel against its plain PyTorch version on the card: max abs
   error, kernel and plain times (CUDA events after warm-up) and the least
   time the card could take.  K2 runs in all four modes (linear, rbf,
   sech2, Gram input) on balance's Table II CV lanes and on har12-width
   lanes (n = 1582, d = 5) before the main path, and after phase 10 on
   the full har12 fit's own launches (the linear and rbf CV grids at 66
   pairs x 1 or 7 gammas x 35 lanes, one gamma of the gated hw grid, the
   rbf refit at the fit's picks): at 3 epochs to the plain tolerances, at
   the fit's epochs to the solver's invariants with the f32 drift against
   an f64 plain run printed, and one pair's lanes alone equal to the same
   lanes in the full grid bit for bit; K1 runs after phase 10, on the kernel
   banks the main path deployed (har12's ``rbf`` and ``rbf_float``
   included), and at har12's width (1875 queries x 1582 rows of a padded
   training set, d = 5), with its device time per launch
   (``torch.profiler``) and host time per call beside the time per call
   back to back.
3. The main path, paper Algorithm 1, for balance, seeds and vertebral at
   the estimator's defaults: ``datasets.load`` -> ``fit`` -> ``deploy`` for
   all six targets -> ``predict`` -> ``score`` -> ``hwcost.system_cost``,
   printing each Table II row with the fit wall time and each target's
   predict wall times (first call, then median / min / max).  The launch
   counters are zeroed just before and read just after; both kernels must
   have run.  Balance must meet the properties of tests/test_system.py.
8. The kernel-assignment design space (run right after phase 3, on its
   three fitted estimators): ``est.pareto`` sweeps all 2^3 assignments of
   each dataset; the Algorithm-1 vertex's accuracy is the circuit
   machine's; a deploy under an area budget strictly between the
   all-linear and the Algorithm-1 areas returns a machine whose
   ``hwcost.system_cost`` area is within it; ``save`` / ``load`` keep
   ``assignment_``; the candidate bits equal a CPU machine's off ties and
   the sweep's accuracies equal the CPU's recombination of the same bits,
   bit for bit.  Then the two synthetic spaces of the reference (K = 5:
   1024 assignments, n_val 400, d 4, M 6; K = 12: P = 66, n_val 400, d 3,
   M 6, the portfolio search), card against CPU the same way.
9. Monte-Carlo on balance: the robust sweep at 64 variants (variant 0 the
   nominal candidate bits and scores, bit for bit), ``deploy("circuit",
   yield_floor=0.9)`` (or the reference's error when no design meets it),
   the dense engine at V = 64, the streamed engine (Sobol, chunk 2048, the
   first 64 test rows) at V = 64 and V = 10^6 with its peak card memory
   flat between them, streamed against its dense oracle and against the
   dense engine within the Wilson bounds, and a ``torch.profiler`` split
   of one streamed chunk.  The launch counters are zeroed before phase 8
   and read after phase 9: this path reaches no hand kernel (its RBF
   candidates are analog measured-curve banks), and the counts are
   printed.
10. The K >= 10 scale-out on har12 (K = 12, P = 66; run after phase 9):
   ``MixedKernelSVM().fit`` on the full training split (4375 rows, subset
   sizes 198..1582) at the estimator's defaults, with its wall time, K2's
   launches (as the trainer's rule gives them: where the Gram-memory gate
   trips, the hw family's CV grid is one launch per gamma, 2 + 2 + (7 +
   1) = 12), peak card memory and the kernel map's RBF count; the same fit
   with the gate off (one stacked hw launch), its wall and peak, and every
   pick and coefficient equal to the gated fit's; the Table-II-style row (linear, rbf, circuit in
   the default cost-model units); ``circuit`` and ``rbf`` deployed with
   ``decider="votes"`` and ``decider="dag"`` on the 1875 test rows: DAG =
   votes on every Condorcet sample off ties, the agreement, each predict's
   median of 9 and queries/s, the card's DAG labels = a CPU machine's
   loaded from the same save off ties, the save round trip with its
   ``"decider": "dag"``, K1's launches in the ``rbf`` votes predict (>= 1)
   and in the DAG predicts (0); the K = 12 closure on the fitted banks
   (``pareto`` on 400 test rows, ``monte_carlo`` at 16 variants, the iid
   stream at 64 variants in chunks of 16); and the size-sharded CV grid
   (rbf, gammas (0.5, 2), Cs (1, 10), 30 epochs) with ``devices=[card] *
   D`` for D in 1, 2, 4, 8, each equal to D = 1's within 1e-6, with its
   wall (best of 3), padded and true work units and lane units/s.
11. Fleet serving (run after K1's checks, on the fits of phases 3 and 10,
   nothing refitted): balance, seeds, vertebral and har12 co-batched into
   one ``FleetMachine`` (P_total = 3 + 3 + 3 + 66 = 75), deployed as
   ``rbf`` (K1) and as ``circuit`` (the measured curve), each with
   ``decider="votes"`` and ``"dag"``. For each of the four fleets: its
   scores and labels equal each member's bit for bit on the member's test
   rows; its save is served by ``launch.serve_svm.main`` for each of
   SERVE_SVM_RUNS (the reference's defaults: 4000 queries at 5000 q/s,
   max_batch 256, max_wait_ms 2; 20,000 q/s; a closed loop of 1024
   outstanding requests; the d = 1 serving mesh; the overload settings of
   the launcher's docstring), every answered request equal to its member's
   label off ties, K1 launched once per rbf bank per dispatch (votes
   ``rbf`` fleet; 0 otherwise), with the ``ServingStats``, wall time, host
   and device ms per dispatch per bucket and the device's idle share of a
   traced window of TRACE_QUERIES queries. Then: K1 at a full dispatch of
   the ``rbf`` fleet against its plain version; the engine's d = 1
   serving mesh against the fleet's own labels program on the same rows
   at every bucket height, bit for bit; the reference's overload test at
   those overload settings (a burst of 8192 priority-0 and 1024
   priority-1 requests against a dispatch slowed by 20 ms sheds only
   priority 0); balance's streamed Monte-Carlo (4096 variants) through a
   1-device variants mesh equal to the run without one bit for bit; its
   rbf CV grid through a 1-device trainer mesh equal to the local grid bit
   for bit in one K2 launch; the two grid layouts timed on balance and
   har12.  The launch counters are zeroed just before each served window
   (inside ``serve_svm.main``) and the trainer mesh's grid, and read just
   after: K1 (serving) and K2 (the trainer's mesh leg) must both have
   run, and the ``kernels`` line carries those counts alone.
4. A small input (the 150-row balance subsample) fit on the card and with
   the plain versions on the CPU: the same kernel picks, (gamma, C),
   support sets and scores.
5. The LM kernels against their plain versions on the card at the shapes
   of hymba-1.5b's prefill of 4 x 2048 tokens: K3 (flash attention) on a
   global layer (causal) and an SWA layer (window 1024), in bf16 (the
   tensor-core kernel) and f32 (the CUDA-core kernel), with
   ``scaled_dot_product_attention`` timed on the same tensors; the
   tensor-core kernel with its window narrowed by one kv block must fail
   the bf16 check (a planted fault); K3 at the other families' shapes
   (``K3_FAMILY_CASES``: phi-3-vision's prefill, dh 96; kimi-k2's
   attention, dh 112; and every shape phase 12's served prefills give it:
   starcoder2-7b's, granite-moe's, whisper's encoder (1500 x 1500,
   non-causal), decoder self-attention (64 x 64) and cross-attention (64
   queries against 1500 keys, non-causal)), bf16 and f32, each beside
   SDPA, bf16 also within ``K3_BF16_REL_L2`` in relative L2, and K3
   letting in the zero-padded keys of a ragged last kv block (a planted
   fault) must fail that check at 1500 keys; K4
   (SSD scan) at (b, s, nh, dh, ds) = (4, 2048, 50, 64, 16) (hymba) and
   (4, 2048, 80, 64, 128) (mamba2), chunk 128, with random, strong and
   the model's own decays, each of its three passes also held to its
   plain twin (at ds 128 y also within ``K4_WIDE_RTOL``, both versions'
   distance to an f64 sequential scan printed).
6. The LM serving path, hymba-1.5b at full width (32 layers, d_model 1600,
   random init from a seed): ``repro_torch.launch.serve.main`` answers 4
   prompts of 2048 tokens and samples 32 tokens each.  The launch counters
   are zeroed just before and read just after: exactly 32 K3 and 32 K4
   launches (one per layer in the one prefill; decode launches neither),
   all 32 K3 launches on the tensor-core kernel.
   Then one more prefill at the same shape, timed warm, and one traced
   prefill and decode step (``torch.profiler``): device time by kernel
   group and the device's idle share.
7. A small prefill (full width, 4 layers, 1 prompt of 1100 tokens) on the
   card through the kernels and through their plain versions: in bf16 the
   last-token logits within 4 bf16 ulps at the largest logit's scale and
   the same argmax wherever the top-2 margin exceeds 0.05; in f32 the
   logits and SSM states within 1e-4.  A negative control, K3 with one kv
   block dropped from every layer's last query, must fail the f32 check.

12. Every other family served at full width, bf16, from seeded random
   weights (``FAMILY_SERVES``): starcoder2-7b (dense), granite-moe-1b-a400m
   (moe) and mamba2-2.7b (ssm) through ``serve.main`` (4 prompts of 2048
   tokens, 32 sampled tokens); phi-3-vision-4.2b (576 patch embeddings +
   2048 tokens) through ``engine.prefill`` and 32 ``decode_step``s;
   whisper-medium (1500 frames + a 64-token prompt, cap 3000) through
   ``engine.prefill_audio`` and 32 ``decode_step``s.  The launch counters
   are zeroed just before each served run and read just after (and after
   the prefill alone where the engine is driven): exactly 32 / 24 / 0 /
   32 / 72 K3 launches, all on the tensor-core kernel, and 0 / 0 / 64 / 0
   / 0 K4, none in decode; cold and warm prefill wall, decode ms per step,
   tokens/s and peak memory; one traced prefill and decode step per model
   (device time by kernel group, the device's idle share, as in phase 6).
   Then a small full-width prefill of eight
   configs (``SMALL_PREFILLS``: 4 layers; kimi-k2 at 2 layers with its
   experts cut to 8), kernels against plain versions by phase 7's rule
   (bf16 logits within ``BF16_LOGIT_ULPS``, the argmax off ties; f32
   logits and every state tensor within 1e-4).
13. Static analysis (``repro_torch.analysis``), after phase 14, on what
   the earlier phases built (nothing refitted).  Budget pass: every launch
   of the six kernel libraries in phases 2-12 and 14 was recorded by its
   shapes, which
   each wrapper hands its launch counter (``kernel_budget.record_launches``
   turns the collecting on); for each recorded shape the Python
   mirror's launches (grid, block, dynamic shared memory) must equal the
   library's own plan, and each kernel instance's registers, static and
   dynamic shared memory, spills and CTAs per SM are printed, one line per
   instance; SMEM-BUDGET, REG-BUDGET and REG-SPILL must be waived or
   absent.  Dispatch pass at the paths' full widths, each entry point once
   under a dispatch recorder (which also counts the bytes each op copies
   from the host to the card) and ``set_sync_debug_mode("warn")``: har12's ``circuit`` and ``rbf`` machines on the 1875 test
   rows with both deciders, the four-member ``rbf`` fleet at a 256-row
   bucket through ``SVMEngine`` (with the allocator's live allocation
   count over 100 dispatches of one slot), one streamed Monte-Carlo chunk
   of balance (phase 9's machine, Sobol, chunk 2048) and balance's rbf CV
   grid at the fit's settings; per entry point the syncs and HtoD bytes
   per call are printed, and every finding must be waived.  Last,
   ``python -m repro_torch.analysis --device cuda --baseline
   analysis_baseline_torch.json`` must exit 0.

14. LM training (run after phase 12, inside phase 13's launch recording):
   (a) K3-bwd against its plain twin (f32, on the same inputs) at
   granite-moe's training shape, hymba's SWA layer, whisper's encoder, a
   dh-32 ``q_offset`` case and the training microbatches of phi-3-vision
   (dh 96), kimi-k2 (dh 112), starcoder2, command-r, qwen2.5-32b and
   granite-20b (dh 128, MQA), each in bf16 (the tensor-core kernels) and
   f32 (the CUDA-core kernels) (f32 max |err| <= 1e-4 max(1, max
   |plain|), bf16 relative L2 <= 2^-7, lse within 1e-5 of
   ``torch.logsumexp``), two launches bit for bit, a planted fault (every
   q block dropping its last visible kv block) caught; ms per call beside
   the bound (10 dh operations per live pair and q head), the plain
   twin's and SDPA's backward, and K3's forward with and without the lse
   store.  K4-bwd against its plain twin ``ref.ssd_scan_bwd`` at hymba's
   and mamba2's training microbatch (2, 4096, 50 / 80 heads of 64, ds 16 /
   128, chunk 128), mild and strong decay, with K4's own cum and states:
   every leaf and each of its five passes within relative L2 1e-4 and
   max |err| <= 1e-4 max(1, max |plain|), two launches bit for bit, its
   planted fault (each 16-row j tile skipping its last t tile) caught, the
   scratch bytes of a call; ms per call beside the bounds (``ssd_bwd_ops``:
   split-TF32 products on the tensor cores, and PR 22's f32 count) and the
   twin's.  (b) Full-width 2-layer f32 steps (granite-moe at B = 2, S =
   1100; phi-3-vision, kimi-k2 with 8 experts and starcoder2 at B = 2, S
   = 600; hymba and mamba2 at B = 2, S = 1100, padded to 1152 for the
   scan): loss and every gradient leaf through the kernels (K3 / K3-bwd,
   K4 / K4-bwd) against the plain versions on the card, every leaf finite
   and nonzero, K3-bwd with dq zeroed and K4-bwd with its planted fault
   caught; the same in the trainer's bf16 (phi-3-vision, starcoder2 and
   hymba at B = 2, S = 4096: leaves within relative L2 2^-4, the loss
   within 2^-8, each K3-bwd call of the step within 2^-7 of its twin on
   its own inputs).  (c)
   ``launch.train.main`` on granite-moe at full width, 6 steps of 4 x 4096
   tokens, grad_accum 2: exactly 96 K3 forward (tensor-core), 48 K3-bwd
   and 0 K4 launches in step 2, finite losses and grad norms, s/step,
   tokens/s, peak memory and one traced step; then the 2-layer resume
   check (4 steps against 2 + checkpoint + restore + 2, the last two
   losses within 1e-3 relative) with the save's and restore's seconds and
   bytes; then the six large-head-dim configs (``TRAIN_RUNS``: phi-3-vision
   at full width with ``--opt8``, the others at full width and 2 layers),
   3 steps each, with their launch counts, s/step, tokens/s and peak
   memory; then hymba-1.5b (32 layers, 6 steps) and mamba2-2.7b (64
   layers, 3 steps, 8-bit moments) whole at 4 x 4096 tokens, grad_accum 2
   (``SSM_TRAIN_RUNS``): exactly 128 / 64 / 128 / 64 and 0 / 0 / 256 / 128
   K3 / K3-bwd / K4 / K4-bwd launches in step 2, finite losses and grad
   norms, s/step, tokens/s, peak memory and a traced last step (K4-bwd's
   device ms); then starcoder2's three steps again with the plain attention
   and with f32 moments, beside the kernels' losses (``RISE_ARCH``).

15. The distributed substrate on the card (after phase 13), its parts on
   ``[card] * n`` meshes of the one card: (a) hymba-1.5b whole in bf16,
   its 32 blocks as 4 stages of 8 (``distributed.pipeline``) over 4
   microbatches of 1 x 2048 tokens, against the same blocks run in order
   on each microbatch (phase 7's bf16 bound), exactly 128 K3 and 128 K4
   launches, both wall times, and K3 / K4 against their plain versions at
   the pipeline's shapes (batch 1; phase 5's tolerances); (b)
   granite-moe-1b-a400m at full width, the mesh train step on a (2, 2)
   ("data", "model") mesh, 4 x 4096 tokens, 2 steps, against the unsharded
   ``grad_accum=2`` step from the same state, both under deterministic
   algorithms (loss within 1e-5 relative, every leaf of the state within
   1e-4 relative L2; bit for bit on an H100), 96 K3 / 48 K3-bwd launches in
   step 2, then one more step of each with the default algorithms, timed
   (s/step of both modes), and peak memory; (d) that state resharded (2, 2) -> (4, 1) -> (2, 2) bit for
   bit, and one step on each mesh over the same four microbatches within
   (b)'s bounds; (c) (b)'s gradient tree as 8 shares (share i = g (1 +
   u_i / 2)) through the compressed all-reduce on ``[card] * 8``, leaf by
   leaf: the error within half a block's step, 20 repeats with error
   feedback halving it, all the codes and block scales of the timed call
   equal to the CPU's, ms per all-reduce; (f) ``QuantTensor`` of every expert bank, codes equal
   to the CPU's; (e) the dry run (``launch.dryrun``) of every (arch x
   shape) cell at both production meshes on ``meta``, in processes beside
   (a)-(f), with trace seconds and argument bytes per device per cell; one
   cell per (family, kind) if the grid would outrun ``DRYRUN_BUDGET_S``
   (the rest are named).

Each phase prints its wall time.  Then it prints the ``kernels`` JSON
line, the ``nvidia-smi`` line and, last, ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32
#: operations/s outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_TC_OPS_PER_S = 989e12

#: The LM serving path: hymba-1.5b at full width, 4 prompts of 2048 tokens,
#: 32 sampled tokens each (cap = 2048 + 32 + 8).
SERVE_ARGV = ["--arch", "hymba-1.5b", "--no-reduced", "--batch", "4",
              "--prompt-len", "2048", "--gen", "32", "--seed", "0"]

TABLE2_DATASETS = ("balance", "seeds", "vertebral")

#: Phase 10's size-sharded grid: the lane ladder of benchmarks/scale.py.
LADDER_GAMMAS = (0.5, 2.0)
LADDER_CS = (1.0, 10.0)
LADDER_EPOCHS = 30
LADDER_SHARDS = (1, 2, 4, 8)
#: Epochs of the short run of K2 on the full har12 launches, held to the
#: plain version at its tolerances alone: over the fit's 100 CV epochs the
#: f32 drift between two summation orders exceeds them on some of the rbf
#: grid's lanes (``check_k2_har12`` prints how far).
HAR12_K2_SHORT_EPOCHS = 3
#: har12 as phase 10 fits it: (train rows, features), test rows, classes.
HAR12_SHAPE = ((4375, 5), 1875, 12)
#: Phase 11's serving runs, each ``serve_svm.main`` on the saved fleet at
#: the reference's defaults (4000 queries, 5000 q/s Poisson, max_batch 256,
#: max_wait_ms 2) but for what a run changes: benchmarks/serving.py's rate,
#: a closed loop, the d = 1 serving mesh and the overload settings of the
#: launcher's docstring.
SERVE_SVM_RUNS = {
    "defaults": [],
    "rate_20000": ["--rate", "20000"],
    "closed_loop": ["--concurrency", "1024", "--n-queries", "16384",
                    "--pipeline-depth", "2"],
    "mesh_d1": ["--mesh-devices", "1"],
    "overload": ["--deadline-ms", "25", "--priority-classes", "2",
                 "--queue-bound", "2048", "--shed-expired",
                 "--pipeline-depth", "2"],
}
#: Queries of each run's traced window (the device's idle share).
TRACE_QUERIES = 1000


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(timer, fn, reps: int, batches: int = 5) -> float:
    """Median over ``batches`` of ``timer(fn, reps)``: for calls of a few
    microseconds of host time, where one host hiccup moves a single mean."""
    times = sorted(timer(fn, reps) for _ in range(batches))
    return times[batches // 2]


def host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn``: the enqueue alone, no synchronize
    between calls (what a caller waits for when the card keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def device_ms(fn, match: str, reps: int = 10) -> tuple:
    """Device time per call of ``fn`` of the CUDA kernels whose name holds
    ``match``, and their launches per call, from one ``torch.profiler``
    trace of ``reps`` calls after a warm-up; ``("not measured", 0)`` if the
    trace holds no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and match in evt.name:
            us += evt.time_range.end - evt.time_range.start
            count += 1
    if count == 0:
        return "not measured", 0
    return us / 1e3 / reps, count / reps


def ptxas_report(text: str) -> list[tuple[str, str]]:
    """(kernel<instance>, "registers, shared memory, spills") per entry
    function of one library's ``nvcc -Xptxas -v`` log."""
    import re

    out, kernel, parts = [], None, []
    for line in text.splitlines() + ["Compiling entry function 'end'"]:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            if kernel:
                out.append((kernel, "; ".join(parts)))
            k = re.search(r"\d+([A-Za-z_]+_kernel)((?:I(?:Li\d+E)+E)?)",
                          m.group(1))
            args = ", ".join(re.findall(r"Li(\d+)E", k.group(2))) if k else ""
            kernel = (k.group(1) + (f"<{args}>" if args else "")) if k \
                else m.group(1)[:60]
            parts = []
        elif "spill" in line or "registers" in line:
            parts.append(line.split(":", 1)[-1].strip())
    return out


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(got, want, atol, rtol) -> tuple[bool, float]:
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


#: f32 operations per kernel value of K2's tile bodies (``tiles.cuh``),
#: transcendentals counted as one each: linear d FMAs; rbf d FMAs + norm
#: combine, scale and exp; sech2 per dimension a difference, a scale and
#: two stable softplus, then one exp.
def tile_ops(kind: str, d: int) -> int:
    return {"linear": 2 * d, "rbf": 2 * d + 5, "sech2": 17 * d + 1,
            "gram": 0}[kind]


#: f32 operations per value of K1's own bodies: rbf is K2's rbf tile;
#: sech2 in product form per dimension a difference, a scale, |.|, a
#: negation, one exp, 1 + t, 4t, the square and the two products, then one
#: division (for d <= 5; past that, one division per dimension instead).
def k1_ops(kind: str, d: int) -> int:
    if kind == "rbf":
        return tile_ops(kind, d)
    return 10 * d + 1 if d <= 5 else 11 * d


def k2_ops(c_box, n_true, g: int, epochs: int, kind: str, d: int) -> float:
    """Operations the solver lanes need: per epoch only the rows with a
    nonzero box can move, and only they can give a nonzero column (padding
    and held-out rows keep alpha = 0), so each epoch needs m^2 kernel
    values for a lane with m such rows; the final margins need n_true x m.
    Each value costs its tile body plus the margin FMA."""
    import torch

    m = (c_box > 0).sum(-1).double()                       # (P, L)
    nt = torch.as_tensor(n_true, dtype=torch.float64,
                         device=m.device)[:, None]
    per_lane = epochs * m * m + nt * m
    return g * float(per_lane.sum()) * (tile_ops(kind, d) + 2)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def lanes_inputs(name: str, dev):
    """The rbf family's CV lanes of ``name`` as the main path builds them."""
    import numpy as np
    import torch

    from repro_torch.core import trainer
    from repro_torch.data import datasets

    ds = datasets.load(name)
    padded = trainer.pad_pairs(ds.x_train, ds.y_train, ds.n_classes)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.as_tensor(padded.x, **f32)
    y = torch.as_tensor(padded.y, **f32)
    fm = torch.as_tensor(padded.fold_masks, **f32)
    valid = torch.as_tensor(padded.valid, **f32)
    cs = torch.as_tensor(trainer.DEFAULT_CS, **f32)
    n_f = fm.shape[1]
    c_box = (torch.repeat_interleave(cs, n_f)[None, :, None]
             * fm.repeat(1, cs.shape[0], 1) * valid[:, None, :]).contiguous()
    gam = torch.as_tensor(np.broadcast_to(trainer.DEFAULT_RBF_GAMMAS,
                                          (x.shape[0], 7)).copy(), **f32)
    return ds, padded, x, y, c_box, gam


def check_k1(dev, fitted: dict) -> tuple[dict, list]:
    """K1 on the kernel banks the main path deployed (each Table II
    dataset's ``rbf`` and ``rbf_float`` machines: their support vectors,
    gammas and ADC-quantized queries), then at har12's width on a padded
    training set standing in for a bank."""
    from repro_torch.core import quant
    from repro_torch.data import datasets

    cases = []
    for name, est in fitted.items():
        ds = datasets.load(name)
        for target in ("rbf", "rbf_float"):
            machine = est.deploy(target)
            x = machine._as_input(ds.x_test)
            for bank in machine._kernel_banks:
                xv = x if bank.input_bits == 0 else quant.quantize_unit(
                    x, bank.input_bits)
                cases.append((f"{name}/{target}", bank.kind, xv, bank.sv,
                              bank.gamma))
    cases += k1_har12_cases(dev)
    rows = [k1_row(*case) for case in cases]
    return rows[0], rows


def k1_har12_cases(dev) -> list:
    """K1 at har12's width: its 1875 test queries against the 4 largest
    pairs of its padded training set (4 x 1582 rows, d = 5), rbf and
    sech2."""
    import numpy as np
    import torch

    from repro_torch.core import trainer
    from repro_torch.data import datasets

    ds = datasets.load("har12")
    padded = trainer.pad_pairs(ds.x_train, ds.y_train, ds.n_classes)
    sv = padded.x[np.argsort(padded.n_true)[::-1][:4]]
    x = torch.as_tensor(np.ascontiguousarray(ds.x_test),
                        dtype=torch.float32, device=dev)
    sv = torch.as_tensor(np.ascontiguousarray(sv), dtype=torch.float32,
                         device=dev)
    gamma = torch.as_tensor(trainer.DEFAULT_RBF_GAMMAS[:4],
                            dtype=torch.float32, device=dev)
    return [("har12/padded-training-set", kind, x, sv, gamma)
            for kind in ("rbf", "sech2")]


def k1_row(name: str, kind: str, x, sv, gamma) -> dict:
    """K1 against its plain version on one bank, and its times: ``ms`` per
    call back to back (CUDA events: the larger of host and device time),
    ``device_ms`` per launch (``torch.profiler``) and ``host_ms`` per call
    (the enqueue); ``ms`` and ``host_ms`` are medians of 5 batches."""
    import torch

    from repro_torch.kernels import rbf

    args = (x, sv, gamma, kind)
    run = lambda: rbf.kernel_matrix_cuda(*args, v_scale=1.0)
    got = run()
    want = rbf.kernel_matrix_plain(*args, v_scale=1.0)
    torch.cuda.synchronize()
    atol = max(5e-6, 2e-6 * float(gamma.max()))
    ok, err = within(got, want, atol, 1e-5)
    if not ok:
        raise AssertionError(f"K1 {kind} {name}: max err {err}")
    dev_ms, per_call = device_ms(run, "kernel_matrix", reps=20)
    p, m, d = sv.shape
    n_out = p * x.shape[0] * m
    b, by = bound_ms(4 * (x.numel() + sv.numel() + p + n_out),
                     n_out * k1_ops(kind, d))
    row = dict(name=name, kind=kind, shape=[p, x.shape[0], m, d],
               max_abs_err=err, ms=median_ms(cuda_ms, run, reps=40),
               device_ms=dev_ms, device_launches_per_call=per_call,
               host_ms=median_ms(host_ms, run, reps=100),
               plain_ms=cuda_ms(
                   lambda: rbf.kernel_matrix_plain(*args, v_scale=1.0),
                   reps=3),
               bound_ms=b, bound_by=by)
    log("K1", json.dumps(row))
    return row


def check_k2(dev) -> tuple[dict, list]:
    """K2 in all four modes on balance's Table II CV lanes at the
    estimator's CV epochs, and on a cut of har12's lanes (its 2 largest
    pairs, 2 lanes, 3 epochs); the full har12 fit's launches are held
    after phase 10 (``check_k2_har12``)."""
    import torch

    from repro_torch.core import svm, trainer

    rows, entry = [], None
    cv_epochs = max(60, 200 // 2)      # the estimator's default CV epochs
    ds, padded, x, y, c_box, gam = lanes_inputs("balance", dev)
    hw = trainer.default_hw(0)
    hw_kernel = trainer._training_kernel(hw.kernel_response, dev)
    kp_gammas = torch.as_tensor(trainer.hw_gamma_grid(hw),
                                dtype=torch.float32, device=dev)[None]
    kp_hw = svm.callable_grams(hw_kernel, x, kp_gammas.expand(
        x.shape[0], -1)).contiguous()
    cases = [(name, kind, cv_epochs if name == "balance" else 3)
             for name in ("balance", "har12")
             for kind in ("linear", "rbf", "sech2", "gram")]
    _, padded_h, xh, yh, ch, gh = lanes_inputs("har12", dev)
    top = torch.argsort(torch.tensor(padded_h.n_true),
                        descending=True)[:2].to(dev)
    for name, kind, epochs in cases:
        if name == "har12":
            xs, ys = xh[top].contiguous(), yh[top].contiguous()
            cb, gs = ch[top][:, :2].contiguous(), gh[top][:, :1].contiguous()
            n_true = torch.as_tensor(padded_h.n_true)[top.cpu()]
        else:
            xs, ys, cb = x, y, c_box
            gs = gam[:, :1].contiguous() if kind == "linear" else gam
            n_true = padded.n_true
        kp = None
        if kind == "gram":
            kp = kp_hw if name == "balance" else svm.callable_grams(
                hw_kernel, xs, kp_gammas[:, :1].expand(xs.shape[0], -1)
            ).contiguous()
        row = k2_row(name, kind, xs, ys, cb, gs, kp, epochs, n_true)
        rows.append(row)
        if name == "balance" and kind == "rbf":
            entry = row
    return entry, rows


def k2_row(name: str, kind: str, xs, ys, cb, gs, kp, epochs: int, n_true,
           reps: int = 3, long_run: bool = False) -> dict:
    """K2 against its plain version on one set of lanes (alpha and the
    margins f, each scaled by its lane's C, within 5e-4 and 5e-3 absolute
    and 1e-3 relative; masked rows exactly 0), and its times: ``ms`` by
    CUDA events after a warm-up (none when ``reps`` is 1), ``plain_ms``
    the compared call of the plain version, by CUDA events.

    A ``long_run`` (a full har12 launch at the fit's epochs) is held to
    the solver's invariants instead: every alpha in its box [0, C], 0 on
    masked rows, every margin finite.  Over that many epochs the f32
    rounding of ill-conditioned lanes (large gamma and C) drifts in any
    implementation, the kernel's and the plain version's each their own
    way; the row counts the values that part beyond the tolerances and,
    where some do, gives each f32 solution's distance from the plain
    version run in f64 (``f64_drift``)."""
    import torch

    from repro_torch.kernels import ref, solver

    if kind == "gram":
        run = lambda: solver.solve_lanes_gram_cuda(kp, ys, cb, epochs)
        plain = lambda dt=torch.float32: ref.solve_lanes_gram(
            kp.to(dt), ys.to(dt), cb.to(dt), epochs)
    else:
        run = lambda: solver.solve_lanes_cuda(xs, ys, cb, gs, kind, epochs)
        plain = lambda dt=torch.float32: ref.solve_lanes(
            xs.to(dt), ys.to(dt), cb.to(dt), gs.to(dt), kind, epochs)
    a, f = run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    a_p, f_p = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    scale = cb.amax(-1).clamp(min=1.0)[:, None, :, None]   # per lane C
    ok_a, err_a = within(a / scale, a_p / scale, 5e-4, 1e-3)
    ok_f, err_f = within(f / scale, f_p / scale, 5e-3, 1e-3)
    beyond = int(((a - a_p).abs() / scale > 5e-4 + 1e-3 * a_p.abs() / scale
                  ).sum() + ((f - f_p).abs() / scale
                             > 5e-3 + 1e-3 * f_p.abs() / scale).sum())
    pad_ok = bool((a[cb[:, None].expand_as(a) == 0] == 0).all())
    invariants = bool(((a >= 0) & (a <= cb[:, None])).all()
                      and torch.isfinite(f).all())
    drift = None
    if long_run and beyond:
        a64, _ = plain(torch.float64)
        drift = f64_drift(a, a_p, a64, scale)
        del a64
    max_abs_err = max(float((a - a_p).abs().max()),
                      float((f - f_p).abs().max()))
    del a_p, f_p
    ok = invariants if long_run else ok_a and ok_f
    if not (ok and pad_ok):
        raise AssertionError(
            f"K2 {kind} {name}: alpha err {err_a} f err {err_f} "
            f"masked rows exact {pad_ok} in the box {invariants}")
    ms = cuda_ms(run, reps=reps, warmup=1 if reps > 1 else 0)
    p, n = ys.shape
    g = kp.shape[1] if kind == "gram" else gs.shape[1]
    lanes = p * g * cb.shape[1]
    d = 0 if kind == "gram" else xs.shape[2]
    n_bytes = 4 * (p * n * (d + 1) + cb.numel() + 2 * lanes * n
                   + (kp.numel() if kind == "gram" else gs.numel()))
    b, by = bound_ms(n_bytes, k2_ops(cb, n_true, g, epochs, kind, d))
    steps = (epochs + 1) * -(-n // 16)   # coordinate blocks + final pass
    row = dict(name=name, kind=kind, shape=[p, g, cb.shape[1], n, d],
               epochs=epochs, serial_chain=epochs * n,
               us_per_block_step=ms * 1e3 / steps,
               max_abs_err=max_abs_err,
               max_rel_lane_err=max(err_a, err_f),
               beyond_tolerance=beyond, f64_drift=drift, ms=ms,
               plain_ms=plain_ms, bound_ms=b, bound_by=by)
    log("K2", json.dumps(row))
    return row


def f64_drift(a, a_p, a64, scale) -> dict:
    """Each f32 solution's alpha against the f64 one, per lane the largest
    distance scaled by the lane's C: the largest and the mean over lanes,
    and the share of lanes where the kernel's is the larger."""
    lane = lambda t: ((t.double() - a64).abs() / scale).amax(-1).flatten()
    k, p = lane(a), lane(a_p)
    return dict(kernel_max=float(k.max()), plain_max=float(p.max()),
                kernel_mean=float(k.mean()), plain_mean=float(p.mean()),
                kernel_farther_share=float((k > p).double().mean()))


def check_k2_har12(dev, est, padded) -> list:
    """K2 on the full har12 fit's own launches, each against its plain
    version: the linear and rbf CV grids (66 pairs x 1 or 7 gammas x 35
    lanes, n = 1582: with 462 (pair, gamma) cells on 132 SMs each CTA
    carries 18 lanes in shared memory near the opt-in limit), the first
    gamma of the gated hw family's Gram-input grid, and the rbf refit at
    the fit's own (gamma, C) picks.  Each runs at
    ``HAR12_K2_SHORT_EPOCHS``, where the f32 drift has not set in, at the
    plain tolerances, and at the fit's epochs as a long run.  Then the
    largest pair's rbf lanes alone against the same lanes in the full
    grid."""
    import numpy as np
    import torch

    from repro_torch.core import svm, trainer
    from repro_torch.kernels import solver

    cv_epochs = est.cv_epochs if est.cv_epochs is not None else max(
        60, est.n_epochs // 2)
    f32 = dict(dtype=torch.float32, device=dev)
    x, y, fm, valid = trainer._pair_tensors(padded, dev)
    cs = torch.as_tensor(trainer.DEFAULT_CS, **f32)
    n_f = fm.shape[1]
    c_box = (torch.repeat_interleave(cs, n_f)[None, :, None]
             * fm.repeat(1, cs.shape[0], 1) * valid[:, None, :]).contiguous()
    p = x.shape[0]
    rbf_g = torch.as_tensor(np.broadcast_to(
        trainer.DEFAULT_RBF_GAMMAS, (p, len(trainer.DEFAULT_RBF_GAMMAS))
    ).copy(), **f32)
    hw_kernel = trainer._training_kernel(est.hw_.kernel_response, dev)
    hw_g = torch.as_tensor(trainer.hw_gamma_grid(est.hw_)[:1], **f32)
    kp = svm.callable_grams(hw_kernel, x, hw_g[None].expand(p, -1)
                            ).contiguous()
    picks = [pr.model_rbf for pr in est.pairs_]
    g_sel = torch.as_tensor([[m.gamma] for m in picks], **f32)
    c_sel = torch.as_tensor([m.c for m in picks], **f32)
    refit_box = (c_sel[:, None] * valid)[:, None, :].contiguous()
    rows = []
    for name, kind, cb, gs, kpc, epochs in (
            ("har12/cv", "linear", c_box, torch.ones((p, 1), **f32), None,
             cv_epochs),
            ("har12/cv", "rbf", c_box, rbf_g, None, cv_epochs),
            ("har12/cv-gated-gamma0", "gram", c_box, None, kp, cv_epochs),
            ("har12/refit", "rbf", refit_box, g_sel, None, est.n_epochs)):
        for run_epochs in (HAR12_K2_SHORT_EPOCHS, epochs):
            rows.append(k2_row(name, kind, x, y, cb, gs, kpc, run_epochs,
                               padded.n_true, reps=1,
                               long_run=run_epochs == epochs))
            torch.cuda.empty_cache()
    # The regime itself: the largest pair's lanes launched alone (2 per
    # CTA) equal, bit for bit, the same lanes inside the full grid (18 per
    # CTA).
    big = int(np.argmax(padded.n_true))
    one = lambda t: t[big:big + 1].contiguous()
    full, _ = solver.solve_lanes_cuda(x, y, c_box, rbf_g, "rbf", cv_epochs)
    alone, _ = solver.solve_lanes_cuda(one(x), one(y), one(c_box),
                                       one(rbf_g), "rbf", cv_epochs)
    if not torch.equal(full[big], alone[0]):
        raise AssertionError(f"K2: har12 pair {big}'s lanes alone differ "
                             "from the same lanes in the full grid")
    log("K2 har12 lanes alone = in the full grid, bit for bit: pair", big)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def predict_times(machine, x, reps: int = 9) -> dict:
    """Host wall time of ``machine.predict(x)`` in ms: the first call at
    this shape, then the median, min and max of ``reps`` calls after one
    more warm-up (``predict`` returns host labels, so each call ends
    synchronized)."""
    import torch

    def once() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        machine.predict(x)
        return (time.perf_counter() - t0) * 1e3

    first = once()
    once()
    times = sorted(once() for _ in range(reps))
    return {"first": first, "median": times[reps // 2], "min": times[0],
            "max": times[-1]}


def table2_row(name: str, dev):
    import numpy as np
    import torch

    from repro_torch.api import MixedKernelSVM
    from repro_torch.core import hwcost
    from repro_torch.data import datasets

    ds = datasets.load(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = MixedKernelSVM(device=dev).fit(ds.x_train, ds.y_train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    acc, predict_ms = {}, {}
    for target in est.targets:
        machine = est.deploy(target)
        predict_ms[target] = predict_times(machine, ds.x_test)
        labels = machine.predict(ds.x_test)
        scores = machine.decision_scores(ds.x_test)
        if labels.shape != ds.y_test.shape or not np.isfinite(scores).all():
            raise AssertionError(f"{name}/{target}: bad output")
        acc[target] = est.score(ds.x_test, ds.y_test, target)
    cm = hwcost.CostModel()
    cost = {t: hwcost.system_cost(est.bank(t), cm)
            for t in ("linear", "rbf", "circuit")}
    row = {
        "dataset": name, "kernel_map": est.kernel_map_,
        "n_rbf": est.n_rbf_, "fit_s": fit_s, "predict_ms": predict_ms,
        "accuracy": acc,
        "linear": [acc["linear"], cost["linear"].area_mm2,
                   cost["linear"].power_mw],
        "rbf": [acc["rbf"], cost["rbf"].area_mm2, cost["rbf"].power_mw],
        "mixed": [acc["circuit"], cost["circuit"].area_mm2,
                  cost["circuit"].power_mw],
        "mixed_analog_power_frac": cost["circuit"].analog_power_frac,
    }
    log("TABLE2", json.dumps(row))
    return row, est


def check_balance(row: dict) -> None:
    """The properties of tests/test_system.py on balance."""
    acc = row["accuracy"]
    lin, rbf, mix = row["linear"], row["rbf"], row["mixed"]
    checks = {
        "1 <= n_rbf <= 2": 1 <= row["n_rbf"] <= 2,
        "mixed >= linear - 0.01": acc["circuit"] >= acc["linear"] - 0.01,
        "|float - circuit| <= 0.015":
            abs(acc["float"] - acc["circuit"]) <= 0.015,
        "area linear < mixed < rbf": lin[1] < mix[1] < rbf[1],
        "power linear < mixed < rbf": lin[2] < mix[2] < rbf[2],
        "rbf/mixed area > 20": rbf[1] / mix[1] > 20,
        "rbf/mixed power > 5": rbf[2] / mix[2] > 5,
        "analog power dominates mixed": row["mixed_analog_power_frac"] > 0.5,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"balance properties failed: {failed}")


# ---------------------------------------------------------------------------
# Phases 8 and 9: the design space and Monte-Carlo
# ---------------------------------------------------------------------------


class FixedBits:
    """A bit machine holding given candidate bits (so a CPU design space
    recombines exactly the bits the card produced)."""

    def __init__(self, bits):
        self.bits = bits

    def pair_bits(self, x):
        return self.bits


def same_bits_off_ties(card_machine, cpu_machine, x) -> int:
    """Candidate bits of the card and of the CPU equal wherever the card's
    score is off a tie (|score| > 1e-5); returns how many bits differ."""
    import numpy as np

    scores, bits = card_machine.pair_scores(x), card_machine.pair_bits(x)
    cpu_bits = cpu_machine.pair_bits(x)
    clear = np.abs(scores) > 1e-5
    if not np.array_equal(bits[clear], cpu_bits[clear]):
        raise AssertionError("candidate bits: card != CPU off ties")
    return int((bits != cpu_bits).sum())


def cpu_sweep_of(bits, space, x, y, **kw):
    """The CPU's sweep of the card's bits through the same cost table."""
    from repro_torch.core import dse

    return dse.DesignSpace(FixedBits(bits), space.cost_table,
                           space.n_classes, device="cpu").sweep(x, y, **kw)


def assert_same_sweep(name: str, sw, cpu_sw) -> None:
    import numpy as np

    if not (np.array_equal(sw.assignments, cpu_sw.assignments)
            and np.array_equal(sw.accuracy, cpu_sw.accuracy)
            and np.array_equal(sw.front, cpu_sw.front)):
        raise AssertionError(f"{name}: card sweep != CPU sweep")


def dse_dataset(name: str, est, dev) -> dict:
    """Phase 8 on one fitted estimator."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import MixedKernelSVM, compile_candidates
    from repro_torch.core import dse, hwcost
    from repro_torch.data import datasets

    ds = datasets.load(name)
    x, y = ds.x_test, ds.y_test
    times = []
    for _ in range(2):                     # first call (lowering), warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw = est.pareto(x, y)
        times.append(time.perf_counter() - t0)
    if not sw.exhaustive or sw.assignments.shape != (8, 3):
        raise AssertionError(f"{name}: not the exhaustive 2^3 sweep")
    alg1 = dse.assignment_from_kernel_map(est.kernel_map_)
    i = sw.find(alg1)
    circuit_acc = est.deploy("circuit").accuracy(x, y)
    if abs(sw.accuracy[i] - circuit_acc) > 1e-6:
        raise AssertionError(f"{name}: Algorithm-1 vertex {sw.accuracy[i]} "
                             f"!= circuit machine {circuit_acc}")
    lin = sw.find(np.zeros(3, bool))
    budget = None
    if sw.area[i] > sw.area[lin]:
        budget = float(sw.area[lin] + sw.area[i]) / 2
        machine = est.deploy("circuit", area_budget=budget)
        chosen = est._assignment_bank(est.assignment_)
        area = hwcost.system_cost(chosen, hwcost.CostModel()).area_mm2
        j = sw.find(dse.assignment_from_kernel_map(est.assignment_))
        if area > budget or abs(machine.accuracy(x, y) - sw.accuracy[j])                 > 1e-6:
            raise AssertionError(f"{name}: budgeted deploy area {area} > "
                                 f"{budget} or accuracy off the sweep")
        with tempfile.TemporaryDirectory() as tmp:
            est.save(f"{tmp}/est")
            again = MixedKernelSVM.load(f"{tmp}/est", device=dev)
        if again.assignment_ != est.assignment_:
            raise AssertionError(f"{name}: save/load lost assignment_")
        budgeted = dict(budget_mm2=budget, kernel_map=est.assignment_,
                        area_mm2=area, accuracy=float(sw.accuracy[j]))
        est.assignment_ = None
    else:
        budgeted = "Algorithm 1 is the all-linear corner: no budget between"
    space = est.design_space()
    cpu_machine = compile_candidates(est._candidates(), est.n_classes_,
                                     device="cpu")
    flips = same_bits_off_ties(space.machine, cpu_machine, x)
    assert_same_sweep(name, sw, cpu_sweep_of(space.machine.pair_bits(x),
                                             space, x, y))
    row = dict(dataset=name, sweep_s_first=times[0], sweep_s_warm=times[1],
               sweep_elapsed_s=sw.elapsed_s,
               assignments_per_s=sw.assignments_per_s,
               front_size=int(len(sw.front)),
               front=[sw.kernel_map(k) for k in sw.front],
               alg1=dict(kernel_map=est.kernel_map_,
                         accuracy=float(sw.accuracy[i]),
                         area_mm2=float(sw.area[i]),
                         power_mw=float(sw.power[i]),
                         on_front=bool(i in set(sw.front.tolist())),
                         domination_margin=sw.domination_margin(alg1)),
               budgeted_deploy=budgeted, card_cpu_bits_differing=flips,
               card_equals_cpu_sweep=True)
    log("DSE", json.dumps(row))
    return row


def synthetic_space(k: int, n_val: int, d: int, m: int, dev, x_seed=None):
    """The reference's synthetic candidates (tests/test_dse.py:241 for K =
    5 with its own x / y draw; benchmarks/scale.py:325 for K = 12, x / y
    from the candidates' generator), built in the port from the numpy
    seed 0 around the port's default core."""
    import numpy as np

    from repro_torch.core import dse, hwcost, ovo, trainer
    from repro_torch.core.analog import AnalogBinaryClassifier
    from repro_torch.core.svm import SVMModel

    rng = np.random.RandomState(0)
    hw = trainer.default_hw(0)
    gamma = float(trainer.hw_gamma_grid(hw)[3])
    cands = []
    for _ in ovo.class_pairs(k):
        w = rng.randn(d)
        lin = SVMModel(kind="linear", support_x=np.zeros((1, d)),
                       support_y=np.ones(1), alpha=np.zeros(1),
                       bias=float(-w.sum() / 2), gamma=1.0, c=1.0, w=w)
        sv = rng.rand(m, d)
        yv = np.where(rng.rand(m) > 0.5, 1.0, -1.0)
        rbf = SVMModel(kind="hw", support_x=sv, support_y=yv,
                       alpha=rng.rand(m) + 0.1, bias=float(rng.randn() * 0.1),
                       gamma=gamma, c=1.0, kernel_fn=hw.kernel_response)
        cands.append((ovo.DigitalLinearClassifier.deploy(lin),
                      AnalogBinaryClassifier.deploy(rbf, hw)))
    xr = rng if x_seed is None else np.random.RandomState(x_seed)
    x = xr.rand(n_val, d).astype(np.float32)
    y = xr.randint(0, k, n_val)
    space = dse.DesignSpace.from_candidates(cands, k, hwcost.CostModel(),
                                            device=dev)
    return cands, space, x, y


def dse_synthetic(dev) -> list:
    import torch

    from repro_torch.api import compile_candidates

    rows = []
    for k, d, x_seed in ((5, 4, 1), (12, 3, None)):
        cands, space, x, y = synthetic_space(k, 400, d, 6, dev, x_seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw = space.sweep(x, y)
        wall = time.perf_counter() - t0
        if sw.exhaustive != (k == 5):
            raise AssertionError(f"K={k}: wrong sweep mode")
        flips = same_bits_off_ties(space.machine, compile_candidates(
            cands, k, device="cpu"), x)
        t0 = time.perf_counter()
        cpu_sw = cpu_sweep_of(space.machine.pair_bits(x), space, x, y)
        cpu_s = time.perf_counter() - t0
        assert_same_sweep(f"K={k}", sw, cpu_sw)
        row = dict(k=k, p=space.n_pairs, n_val=400, d=d, m=6,
                   exhaustive=sw.exhaustive,
                   evaluated_assignments=int(sw.assignments.shape[0]),
                   front_size=int(len(sw.front)), sweep_s=wall,
                   assignments_per_s=sw.assignments_per_s,
                   cpu_recombination_s=cpu_s,
                   card_cpu_bits_differing=flips,
                   card_equals_cpu_sweep=True)
        log("DSE synthetic", json.dumps(row))
        rows.append(row)
    return rows


def profile_split(stages: dict) -> dict:
    """Device time of each stage (one traced call each, ``torch.profiler``
    CUDA events), in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        out[name] = sum(us) / 1e3 if us else "not measured"
    return out


def stream_chunk_trace(sm, x, y, a, floor: float) -> dict:
    """One streamed chunk in the steady state (the second chunk of a
    stream, so the Sobol engine continues rather than being built): its
    device time by stage and, from one trace of the whole chunk as
    ``stream`` runs it (host Sobol draws included), the device's idle
    share."""
    import torch

    from repro_torch.api import compiled
    from repro_torch.core import mcstream

    dev = sm.device
    b = sm.mc_chunk
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y.astype("int64"), device=dev)
    a = torch.as_tensor(a.astype("int32"), device=dev)
    v_idx = torch.arange(b, 2 * b, device=dev)
    valid = torch.ones(b, device=dev)
    sm._uniforms(0, b)
    t0 = time.perf_counter()
    u = sm._uniforms(b, b)
    torch.cuda.synchronize()
    host_draws_ms = (time.perf_counter() - t0) * 1e3
    st = {}

    def lower():
        st["bv"], st["w"], st["lr"] = sm._chunk_banks(v_idx, u)

    def score():
        flat = compiled._all_scores_mc(
            x, sm._linear_banks, sm._kernel_banks, st["bv"], sm._inv_perm,
            b, False)
        st["bits"] = compiled._split_candidates(flat, sm.n_pairs)[1]

    def recombine():
        st["acc"] = compiled._recombine_acc(st["bits"], a, y, sm._table,
                                            sm._weights)

    state = mcstream.init_stream(1, mcstream.hist_bins(x.shape[0]), dev)

    def fold():
        mcstream.update_stream(state, st["acc"], st["w"], valid, floor,
                               log_ref=st["lr"])

    lower(), score(), recombine(), fold()        # warm
    split = profile_split({
        "draws_and_variant_lowering": lower,
        "hw_interpolation_and_rails": score,
        "recombination": recombine, "accumulator_fold": fold})

    def whole():
        uu = sm._uniforms(2 * b, b)
        acc, w, lr = sm._chunk_acc(x, v_idx, a, y, uu)
        mcstream.update_stream(state, acc, w, valid, floor, log_ref=lr)

    trace = device_breakdown(whole)
    return dict(chunk=b, host_sobol_draws_ms=host_draws_ms,
                device_ms_by_stage=split,
                chunk_wall_ms=trace["wall_ms"],
                chunk_device_busy_ms=trace.get("device_busy_ms"),
                chunk_device_idle_share=trace.get("device_idle_share"))


def monte_carlo_phase(est, dev) -> dict:
    """Phase 9 on balance's fitted estimator."""
    import numpy as np
    import torch

    from repro_torch.core import dse, mcstream
    from repro_torch.data import datasets

    ds = datasets.load("balance")
    x, y = ds.x_test, ds.y_test
    floor = round(est.score(x, y, target="circuit") - 0.02, 6)
    sweep_s = []
    for _ in range(2):        # first call (lowering, first kernels), warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw = est.pareto(x, y, n_variants=64, key=0, accuracy_floor=floor)
        sweep_s.append(time.perf_counter() - t0)
    machine = est.monte_carlo_machine(64, 0)
    nominal = est.design_space().machine
    if not (np.array_equal(machine.pair_bits(x)[0], nominal.pair_bits(x))
            and np.array_equal(machine.pair_scores(x)[0],
                               nominal.pair_scores(x))):
        raise AssertionError("variant 0 != the nominal candidate machine")
    per_call = cuda_ms(lambda: machine.pair_bits(x), reps=10) / 1e3
    lcb, _ = mcstream.wilson_bounds(sw.yield_, 64, 0.95)
    try:
        est.deploy("circuit", yield_floor=0.9)
        j = sw.find(dse.assignment_from_kernel_map(est.assignment_))
        if lcb[j] < 0.9:
            raise AssertionError("yield deploy below its floor")
        yield_deploy = dict(kernel_map=est.assignment_,
                            yield_lcb=float(lcb[j]),
                            area_mm2=float(sw.area[j]))
    except ValueError as e:
        if (lcb[sw.robust_front] >= 0.9).any() or \
                "no robust-front point meets yield 95%-LCB >= 0.9" \
                not in str(e):
            raise
        yield_deploy = f"raised as the reference does: {e}"
    est.assignment_ = None
    i = sw.find(dse.assignment_from_kernel_map(est.kernel_map_))
    dense = est.monte_carlo(x, y, n_variants=64, key=0)

    # The streamed engine on the first 64 test rows.
    x64, y64 = x[:64], y[:64]
    floor64 = round(est.score(x64, y64, target="circuit") - 0.02, 6)
    a = dse.assignment_from_kernel_map(est.kernel_map_)[None, :]
    sm = est.stream_machine(0, method="sobol", mc_chunk=2048)
    bits64 = sm.pair_bits_dense(x64, np.arange(64))
    acc64 = dse.assignment_accuracies_mc(bits64, a, y64, est.n_classes_,
                                         device=dev)[:, 0]
    runs = {}
    for v in (64, 64, 1_000_000):      # the first V = 64 run warms up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = sm.stream(x64, y64, a, n_variants=v, accuracy_floor=floor64)
        torch.cuda.synchronize()
        runs[v] = dict(out=out, s=time.perf_counter() - t0,
                       peak=torch.cuda.max_memory_allocated())
    o64, o1m = runs[64]["out"], runs[1_000_000]["out"]
    if not (abs(o64["mean"][0] - acc64.mean()) < 1e-4
            and o64["worst"][0] == acc64.min()
            and o64["yield"][0] == (acc64 >= floor64).mean()):
        raise AssertionError("streamed V = 64 != its dense oracle")
    dense64 = est.monte_carlo(x64, y64, n_variants=64, key=0)
    d_lo, d_hi = mcstream.wilson_bounds(dense64.yield_at(floor64), 64)
    for o in (o64, o1m):
        if o["yield_lo"][0] > d_hi or o["yield_hi"][0] < d_lo:
            raise AssertionError("streamed and dense yields disagree beyond "
                                 "their Wilson bounds")
    m_max = max(int(b.sv.shape[1]) for b in sm._kernel_banks)
    n_pb = max(len(b.pair_idx) for b in sm._kernel_banks)
    chunk_bytes = 4 * sm.mc_chunk * (sm.mismatch_dim + n_pb * 64 * m_max)
    peak_gap = runs[1_000_000]["peak"] - runs[64]["peak"]
    if abs(peak_gap) > chunk_bytes:
        raise AssertionError(f"streamed peak memory not flat: "
                             f"{runs[64]['peak']} -> "
                             f"{runs[1_000_000]['peak']} bytes")
    row = dict(
        dataset="balance", n_variants=64, accuracy_floor=floor,
        mc_sweep_s_first=sweep_s[0], mc_sweep_s_warm=sweep_s[1],
        dense_forward_ms=per_call * 1e3,
        dense_variants_per_s=64 / per_call,
        variant0_bit_identical=True,
        robust_front=[sw.kernel_map(k) for k in sw.robust_front],
        alg1=dict(acc_mean=float(sw.acc_mean[i]),
                  acc_std=float(sw.acc_std[i]),
                  acc_worst=float(sw.acc_worst[i]),
                  yield_frac=float(sw.yield_[i]), yield_lcb=float(lcb[i])),
        yield_floor_0_9=yield_deploy,
        dense_engine=dict(nominal=dense.nominal, mean=dense.mean,
                          worst=dense.worst, yield_at_floor=dense.yield_at(
                              floor)),
        stream=dict(method="sobol", mc_chunk=2048, n_rows=64,
                    accuracy_floor=floor64,
                    mismatch_dim=sm.mismatch_dim,
                    **{f"v{v}": dict(
                        seconds=r["s"], variants_per_s=v / r["s"],
                        peak_bytes=r["peak"], mean=float(r["out"]["mean"][0]),
                        std=float(r["out"]["std"][0]),
                        worst=float(r["out"]["worst"][0]),
                        yield_frac=float(r["out"]["yield"][0]),
                        yield_lo=float(r["out"]["yield_lo"][0]),
                        yield_hi=float(r["out"]["yield_hi"][0]))
                       for v, r in runs.items()},
                    peak_gap_bytes=peak_gap, one_chunk_bytes=chunk_bytes,
                    dense64_yield_wilson=[float(d_lo), float(d_hi)]),
        chunk_trace=stream_chunk_trace(sm, x64, y64, a, floor64))
    log("MC", json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Phase 10: the K >= 10 scale-out on har12
# ---------------------------------------------------------------------------


def deciders_on(est, target: str, xq, dev, tmp: str) -> dict:
    """Votes and DAG fronts of one deployed target on the test rows."""
    import numpy as np

    from repro_torch.api import CompiledMachine
    from repro_torch.core import ovo
    from repro_torch.kernels import ops

    k = est.n_classes_
    m_votes = est.deploy(target)
    m_dag = est.deploy(target, decider="dag")
    ops.reset_launches()
    labels_v = m_votes.predict(xq)
    k1_votes = ops.launch_counts()["kernel_matrix"]
    ops.reset_launches()
    labels_d = m_dag.predict(xq)
    k1_dag = ops.launch_counts()["kernel_matrix"]
    if k1_dag != 0:
        raise AssertionError(f"{target}: the DAG gather launched K1")
    scores = m_votes.decision_scores(xq)
    bits = m_votes.predict_bits(xq)
    if not np.isfinite(scores).all() or labels_d.shape != labels_v.shape:
        raise AssertionError(f"{target}: bad output")
    clear = (np.abs(scores) > 1e-5).all(axis=1)
    cond = ovo.condorcet_mask(bits, k) & clear
    off = int((labels_d[cond] != labels_v[cond]).sum())
    if off:
        raise AssertionError(f"{target}: DAG != votes on {off} of "
                             f"{int(cond.sum())} Condorcet samples off ties")
    if not np.array_equal(labels_d[clear],
                          ovo.decide_dag(bits, k)[clear]):
        raise AssertionError(f"{target}: DAG != decide_dag of the bits")
    path = f"{tmp}/{target}_dag"
    m_dag.save(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    if (meta["format"], meta["decider"]) != ("repro.api.CompiledMachine",
                                             "dag"):
        raise AssertionError(f"{target}: the save is not a DAG machine")
    again = CompiledMachine.load(path, device=dev)
    if again.decider != "dag" or not np.array_equal(again.predict(xq),
                                                    labels_d):
        raise AssertionError(f"{target}: the DAG save does not round-trip")
    host = CompiledMachine.load(path, device="cpu")
    clear_both = clear & (np.abs(host.decision_scores(xq)) > 1e-5).all(axis=1)
    cpu_off = int((host.predict(xq)[clear_both]
                   != labels_d[clear_both]).sum())
    if cpu_off:
        raise AssertionError(f"{target}: card DAG != CPU DAG on {cpu_off} "
                             "samples off ties")
    t_votes = predict_times(m_votes, xq)
    t_dag = predict_times(m_dag, xq)
    n = len(xq)
    return dict(
        target=target, n_linear_pairs=m_dag.n_linear_pairs,
        n_kernel_pairs=m_dag.n_kernel_pairs,
        condorcet_off_ties=int(cond.sum()), off_ties=int(clear.sum()),
        agreement=float(np.mean(labels_d == labels_v)),
        k1_launches_votes_predict=k1_votes, k1_launches_dag_predict=k1_dag,
        votes_ms=t_votes, dag_ms=t_dag,
        votes_qps=n / (t_votes["median"] / 1e3),
        dag_qps=n / (t_dag["median"] / 1e3),
        card_vs_cpu_compared=int(clear_both.sum()),
        save_roundtrip=True)


def best_wall_s(fn, reps: int = 3):
    """(best wall time in s of ``reps`` synchronized calls after one
    warm-up, the last call's result)."""
    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls), walls, out


def ladder_grid(padded, dev) -> list:
    """The size-sharded rbf CV grid at D in LADDER_SHARDS shards on one
    card: every D equal to D = 1's within 1e-6.  Each rung also times each
    of its shards alone (its own trimmed launch, synchronized), so the
    wall can be read against the largest shard's time (full overlap) and
    the shards' sum (none)."""
    import numpy as np

    from repro_torch.core import trainer

    g, c = np.asarray(LADDER_GAMMAS), np.asarray(LADDER_CS)
    n_true = np.asarray(padded.n_true)
    true_units = int(sum(int(n) ** 2 for n in n_true)) * len(g) * len(c)
    rungs, base = [], None
    for d in LADDER_SHARDS:
        shards = trainer.shard_lane_layout(padded.n_true, d)
        _, walls, acc = best_wall_s(
            lambda: trainer.family_cv_grid_size_sharded(
                padded, "rbf", g, c, LADDER_EPOCHS, devices=[dev] * d))
        alone = [best_wall_s(lambda s=s: trainer.family_cv_grid(
            padded.take([int(i) for i in s]).trim(), "rbf", g, c,
            LADDER_EPOCHS, device=dev))[0] for s in shards]
        if base is None:
            base = acc
        err = float(np.abs(acc - base).max())
        if err > 1e-6:
            raise AssertionError(f"size-sharded grid at D = {d} != D = 1 "
                                 f"(max |diff| {err})")
        padded_units = sum(len(s) * int(n_true[s].max()) ** 2
                           for s in shards) * len(g) * len(c)
        rungs.append(dict(
            d=d, n_shards=len(shards), wall_s=min(walls), walls_s=walls,
            shard_maxes=[int(n_true[s].max()) for s in shards],
            padded_work_units=int(padded_units),
            true_work_units=true_units,
            padded_over_true=padded_units / true_units,
            lane_units_per_s=true_units / min(walls), max_abs_diff=err,
            shard_alone_s=alone, shard_alone_sum_s=sum(alone)))
        log("LADDER", json.dumps(rungs[-1]))
    return rungs


def timed_fit(ds, dev):
    """``MixedKernelSVM(device=dev).fit`` on the full training split at
    the estimator's defaults: (estimator, wall s, launches, peak bytes)."""
    import torch

    from repro_torch.api import MixedKernelSVM
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    est = MixedKernelSVM(device=dev).fit(ds.x_train, ds.y_train)
    torch.cuda.synchronize()
    return (est, time.perf_counter() - t0, ops.launch_counts(),
            torch.cuda.max_memory_allocated())


def fit_solver_launches(padded, hw) -> int:
    """K2 launches of one fit by the trainer's rule: a CV grid and a refit
    for each of the three families, the hw family's CV grid one launch per
    gamma when its stacked Grams pass ``CV_GRID_VMAP_BYTES``."""
    from repro_torch.core import trainer

    hw_gammas = trainer.hw_gamma_grid(hw)
    hw_cv = len(hw_gammas) if trainer._seq_gamma(padded.x, hw_gammas) else 1
    return 2 + 2 + hw_cv + 1


def same_fit(est, other) -> None:
    """Two fits of one split: the same kernel map, and for every pair and
    family the same (gamma, C), support set and coefficients, bit for
    bit."""
    import numpy as np

    if other.kernel_map_ != est.kernel_map_:
        raise AssertionError("the two har12 fits differ in kernel map")
    for pa, pb in zip(est.pairs_, other.pairs_):
        for slot in ("model_linear", "model_rbf", "model_hw"):
            ma, mb = getattr(pa, slot), getattr(pb, slot)
            if (ma is None) != (mb is None):
                raise AssertionError(f"{pa.pair} {slot}: one fit lacks it")
            if ma is None:
                continue
            if ((ma.gamma, ma.c, ma.bias) != (mb.gamma, mb.c, mb.bias)
                    or not np.array_equal(ma.alpha, mb.alpha)
                    or not np.array_equal(ma.support_x, mb.support_x)):
                raise AssertionError(f"{pa.pair} {slot}: the two har12 fits "
                                     "differ")


def scaleout_phase(dev):
    """Phase 10: Algorithm 1 on the full har12 training split (with the
    Gram-memory gate as the trainer sets it, then off), both decision
    fronts, the K = 12 closure and the size-sharded grid.  Returns (the
    phase's row, the gated fit's estimator, the padded pairs it trained
    on)."""
    import tempfile

    import torch

    from repro_torch.core import hwcost, trainer
    from repro_torch.data import datasets

    ds = datasets.load("har12")
    if (ds.x_train.shape, ds.x_test.shape[0], ds.n_classes) != HAR12_SHAPE:
        raise AssertionError(f"har12 is not the {HAR12_SHAPE} set")
    xq, yq = ds.x_test, ds.y_test
    padded = trainer.pad_pairs(ds.x_train, ds.y_train, ds.n_classes,
                               n_folds=5, seed=0)
    est, fit_s, fit_counts, fit_peak = timed_fit(ds, dev)
    gated = trainer._seq_gamma(padded.x, trainer.hw_gamma_grid(est.hw_))
    log("har12 fit:", json.dumps(dict(
        fit_s=fit_s, launches=fit_counts, peak_bytes=fit_peak,
        hw_cv_gated=gated, n_rbf=est.n_rbf_, kernel_map=est.kernel_map_)))
    want = fit_solver_launches(padded, est.hw_)
    if fit_counts["solver"] != want:
        raise AssertionError(f"har12 fit: {fit_counts['solver']} K2 "
                             f"launches, the trainer's rule gives {want}")
    # The same fit with the Gram-memory gate off: the hw family's 7 Grams
    # stacked into one launch.  The lanes are independent, so every pick
    # and coefficient must be the gated fit's, bit for bit.
    gate = trainer.CV_GRID_VMAP_BYTES
    trainer.CV_GRID_VMAP_BYTES = 1 << 62
    try:
        want_off = fit_solver_launches(padded, est.hw_)
        stacked, stacked_s, stacked_counts, stacked_peak = timed_fit(ds, dev)
    finally:
        trainer.CV_GRID_VMAP_BYTES = gate
    log("har12 fit, gate off:", json.dumps(dict(
        fit_s=stacked_s, launches=stacked_counts, peak_bytes=stacked_peak)))
    if stacked_counts["solver"] != want_off:
        raise AssertionError(f"har12 fit, gate off: {stacked_counts['solver']}"
                             f" K2 launches, the trainer's rule gives "
                             f"{want_off}")
    same_fit(est, stacked)
    del stacked

    cm = hwcost.CostModel()
    table = []
    for design, target in (("linear", "linear"), ("rbf", "rbf"),
                           ("mixed", "circuit")):
        cost = hwcost.system_cost(est.bank(target), cm)
        table.append(dict(design=design,
                          accuracy=est.score(xq, yq, target=target),
                          area_mm2=float(cost.area_mm2),
                          power_mw=float(cost.power_mw)))
    log("TABLE2", json.dumps(dict(dataset="har12", designs=table,
                                  cost_model="default units")))

    with tempfile.TemporaryDirectory() as tmp:
        fronts = [deciders_on(est, t, xq, dev, tmp)
                  for t in ("circuit", "rbf")]
    for f in fronts:
        log("DECIDERS", json.dumps(f))
    k1_votes = fronts[1]["k1_launches_votes_predict"]
    if k1_votes < 1:
        raise AssertionError("the rbf votes predict launched no K1")

    xv, yv = xq[:400], yq[:400]
    closure = {}
    for name, fn in (
            ("pareto", lambda: est.pareto(xv, yv)),
            ("monte_carlo_dense_v16", lambda: est.monte_carlo(
                xv, yv, n_variants=16)),
            ("monte_carlo_iid_v64_chunk16", lambda: est.monte_carlo(
                xv, yv, n_variants=64, method="iid", mc_chunk=16))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        closure[name] = dict(s=time.perf_counter() - t0)
        if name == "pareto":
            closure[name].update(exhaustive=bool(out.exhaustive),
                                 evaluated=int(out.assignments.shape[0]),
                                 front=int(len(out.front)))
        else:
            closure[name].update(mean=float(out.mean))
    if closure["pareto"]["exhaustive"]:
        raise AssertionError("K = 12 must take the portfolio search")
    log("CLOSURE", json.dumps(closure))

    ladder = ladder_grid(padded, dev)
    row = dict(dataset="har12", n_train=len(ds.y_train), n_test=len(yq),
               k=ds.n_classes, p=len(est.pairs_), n_max=padded.n_max,
               n_min=int(min(padded.n_true)), fit_s=fit_s,
               fit_launches=fit_counts, fit_peak_bytes=fit_peak,
               hw_cv_gated=gated,
               gate_off=dict(fit_s=stacked_s, launches=stacked_counts,
                             peak_bytes=stacked_peak),
               n_rbf=est.n_rbf_, table2=table, deciders=fronts,
               closure=closure, ladder=ladder)
    log("SCALEOUT", json.dumps(row))
    return row, est, padded


# ---------------------------------------------------------------------------
# Phase 11: fleet serving
# ---------------------------------------------------------------------------


def fleet_tests(names) -> dict:
    """Each fleet member's test rows (its query pool)."""
    import numpy as np

    from repro_torch.data import datasets

    return {n: np.asarray(datasets.load(n).x_test, np.float32) for n in names}


def fleet_bits_equal_members(fleet, machines: dict, tests: dict) -> None:
    """Fleet against member, bit for bit: every member's scores (raw f32
    bit patterns) and labels on its own test rows."""
    import numpy as np

    for name, m in machines.items():
        x = tests[name]
        if not np.array_equal(fleet.decision_scores(x, name).view(np.int32),
                              m.decision_scores(x).view(np.int32)):
            raise AssertionError(f"fleet scores of {name} != the member's")
        if not np.array_equal(fleet.predict(x, name), m.predict(x)):
            raise AssertionError(f"fleet labels of {name} != the member's")


def serve_runs(path: str, dev, n_rbf_banks: int) -> dict:
    """``serve_svm.main`` on the saved fleet for each of SERVE_SVM_RUNS,
    its stdout kept out of the log; every answered request is checked
    against its member off ties inside ``main``, and K1's launches in the
    served traffic (``main`` zeroes the counters just before its served
    window and reads them just after) must be one per rbf bank per
    dispatch."""
    import contextlib
    import io

    from repro_torch.launch import serve_svm

    runs = {}
    for run, argv in SERVE_SVM_RUNS.items():
        with contextlib.redirect_stdout(io.StringIO()):
            s = serve_svm.main(
                ["--fleet", path, "--device", str(dev),
                 "--trace-queries", str(TRACE_QUERIES)] + argv)
        k1 = s["launches"]["kernel_matrix"]
        if k1 != n_rbf_banks * s["n_batches"]:
            raise AssertionError(
                f"{path} {run}: {k1} K1 launches for {s['n_batches']} "
                f"dispatches of {n_rbf_banks} rbf banks")
        s["k1_launches_per_dispatch"] = k1 / s["n_batches"]
        runs[run] = s
    return runs


def dispatch_alone(fleet, tests: dict) -> dict:
    """The fleet's labels program alone, outside the engine (main thread,
    no other thread running): host ms per synchronized call at 32 and 256
    mixed rows already on the card, and the device events (kernels and
    copies) per call and their device ms at 256 rows (``torch.profiler``)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(3)
    names = list(tests)
    out = {}
    for n in (32, 256):
        ids = rng.randint(len(names), size=n)
        x = np.zeros((n, fleet.n_features), np.float32)
        for r, i in enumerate(ids):
            pool = tests[names[i]]
            x[r, :pool.shape[1]] = pool[rng.randint(len(pool))]
        xd = torch.as_tensor(x, device=fleet.device)
        idd = torch.as_tensor(ids.astype(np.int32), device=fleet.device)
        call = lambda: fleet._labels(xd, idd)

        def synced() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        synced()
        out[f"host_ms_{n}"] = float(np.median([synced() for _ in range(20)]))
        if n == 256:
            out["device_ms_256"], out["device_events_256"] = device_ms(
                call, "", reps=5)
    return out


def mesh_d1_equals_unsharded(fleet, tests: dict) -> dict:
    """The engine's d = 1 serving mesh (pinned slots, its stream, events)
    against the fleet's own labels program called on the same rows on the
    card, one staged batch per bucket height (mixed members, zero-padded
    features): labels bit for bit."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import SVMEngine

    eng = SVMEngine(fleet, max_batch=256, mesh=make_serving_mesh(1))
    eng._order_after_banks()
    rng = np.random.RandomState(11)
    names = list(tests)
    for b in eng.policy.buckets:
        ids = rng.randint(len(names), size=b).astype(np.int32)
        x = np.zeros((b, fleet.n_features), np.float32)
        for r, i in enumerate(ids):
            pool = tests[names[i]]
            x[r, :pool.shape[1]] = pool[rng.randint(len(pool))]
        slot = eng._make_slot(b)
        slot.xv[:] = x
        slot.iv[:] = ids
        for launch in eng._forward(slot):
            launch.wait()
        want = fleet._labels(torch.as_tensor(x, device=fleet.device),
                             torch.as_tensor(ids, device=fleet.device))
        if not np.array_equal(slot.ov, want.cpu().numpy()):
            raise AssertionError(f"d = 1 mesh != the fleet's labels at "
                                 f"bucket {b}")
    return {"buckets": list(eng.policy.buckets), "bit_equal": True}


def overload_burst(fleet, tests: dict) -> dict:
    """tests/test_serving_svm.py::test_overload_burst_sheds_only_lowest_
    priority at the launcher's overload settings (max_batch 256,
    queue_bound 2048, shed_expired, pipeline_depth 2) against a device
    slowed by 20 ms per dispatch: a burst of 8192 priority-0 requests then
    1024 priority-1 (below the bound) sheds some priority-0 work and none
    of priority 1, and every answered request gets its member's label."""
    import numpy as np

    from repro_torch.serving import ShedError, SVMEngine

    name = next(iter(tests))
    m = fleet.member(name)
    xs = tests[name]
    x = xs[int(np.argmax(np.abs(m.decision_scores(xs)).min(axis=1)))]
    want = int(m.predict(x[None])[0]) if fleet.decider == m.decider else \
        int(fleet.predict(x[None], name)[0])
    eng = SVMEngine(fleet, max_batch=256, queue_bound=2048,
                    shed_expired=True, pipeline_depth=2)
    orig = eng._forward

    def slowed(slot):
        time.sleep(0.02)
        return orig(slot)

    eng._forward = slowed
    with eng:
        eng.warmup()
        lo = [eng.submit(x, name, priority=0) for _ in range(8192)]
        hi = [eng.submit(x, name, priority=1) for _ in range(1024)]
        shed = {0: 0, 1: 0}
        for prio, futs in ((0, lo), (1, hi)):
            for f in futs:
                try:
                    if f.result(timeout=120.0) != want:
                        raise AssertionError("overload: wrong label")
                except ShedError:
                    shed[prio] += 1
    if shed[0] == 0 or shed[1] != 0:
        raise AssertionError(f"overload burst shed {shed} (want some of "
                             "priority 0 and none of priority 1)")
    return {"shed_by_priority": shed, "stats": eng.stats.summary()}


def k1_fleet_dispatch(fleet, tests: dict) -> dict:
    """K1 at a full dispatch of the rbf fleet: each member's rbf banks on
    256 rows of its test set (ADC-quantized as the bank reads them)."""
    import numpy as np
    import torch

    from repro_torch.core import quant

    rows = []
    for name, m in zip(fleet.model_ids, fleet._members):
        xs = tests[name]
        x = torch.as_tensor(np.resize(xs, (256, xs.shape[1])),
                            device=fleet.device)
        for bank in m._kernel_banks:
            if bank.kind != "rbf":
                continue
            xv = x if bank.input_bits == 0 else quant.quantize_unit(
                x, bank.input_bits)
            rows.append(k1_row(f"fleet/{name}", bank.kind, xv, bank.sv,
                               bank.gamma))
    return dict(shape=[r["shape"] for r in rows],
                launches_per_dispatch=len(rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows))


def mc_and_trainer_mesh_d1(est, dev, har12_padded) -> dict:
    """Balance's streamed Monte-Carlo (iid, 4096 variants in chunks of
    1024 on 64 test rows) through ``make_variant_mesh(1)`` and without (the
    machine's own device alone): bit for bit (the reference test's
    tolerance, atol 1e-5, is the weaker claim).  Balance's rbf CV grid at
    the fit's settings through ``make_trainer_mesh(1)``: bit for bit
    against the local grid, and one K2 launch, counted with the counters
    zeroed just before that call and read just after.  Then the two grid
    layouts timed (best of 3) on balance and on har12's rbf grid, the
    fit's own widths: the local grid keeps one copy of each pair's rows
    for all its gammas, the mesh leg one per (pair, gamma) cell."""
    import numpy as np

    from repro_torch.core import dse, trainer
    from repro_torch.data import datasets
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_trainer_mesh, make_variant_mesh

    ds = datasets.load("balance")
    a = dse.assignment_from_kernel_map(est.kernel_map_)[None, :]
    sm = est.stream_machine(0, method="iid", mc_chunk=1024)
    xq, yq = ds.x_test[:64], ds.y_test[:64]
    out = {key: sm.stream(xq, yq, a, n_variants=4096, accuracy_floor=0.8,
                          mesh=mesh)
           for key, mesh in (("local", None), ("mesh1", make_variant_mesh(1)))}
    for k in ("mean", "std", "worst", "best", "yield", "hist"):
        if not np.array_equal(out["mesh1"][k], out["local"][k]):
            raise AssertionError(f"stream(mesh=1) {k} != stream()")
    padded = trainer.pad_pairs(ds.x_train, ds.y_train, ds.n_classes,
                               n_folds=5, seed=0)
    grids = {"balance": padded, "har12": har12_padded}
    rbf = ("rbf", trainer.DEFAULT_RBF_GAMMAS, trainer.DEFAULT_CS, 100)
    local = trainer.family_cv_grid(padded, *rbf, device=dev)
    mesh1 = make_trainer_mesh(1)
    ops.reset_launches()
    sharded = trainer.family_cv_grid(padded, *rbf, mesh=mesh1)
    k2 = ops.launch_counts()["solver"]
    if k2 != 1 or not np.array_equal(sharded, local):
        raise AssertionError(f"family_cv_grid(mesh=1): {k2} K2 launches, "
                             f"max |diff| {np.abs(sharded - local).max()}")
    layouts = {}
    for name, pp in grids.items():
        lo_s, lo_walls, lo = best_wall_s(
            lambda pp=pp: trainer.family_cv_grid(pp, *rbf, device=dev))
        sh_s, sh_walls, sh = best_wall_s(
            lambda pp=pp: trainer.family_cv_grid(pp, *rbf, mesh=mesh1))
        layouts[name] = dict(
            shape=[pp.n_pairs, len(rbf[1]), len(rbf[2]), pp.n_max],
            local_s=lo_s, mesh1_s=sh_s, local_walls=lo_walls,
            mesh1_walls=sh_walls, max_abs_diff=float(np.abs(sh - lo).max()))
    return dict(stream_mean=float(out["local"]["mean"][0]),
                stream_yield=float(out["local"]["yield"][0]),
                cv_grid_mesh1_k2_launches=k2, bit_equal=True,
                cv_grid_layouts=layouts)


def fleet_phase(dev, fits: dict, har12_padded) -> dict:
    """Phase 11: the four fitted machines (balance, seeds, vertebral at the
    estimator's defaults, har12 on its full split) co-batched into one
    fleet, deployed as ``rbf`` (K1) and ``circuit`` (the measured curve),
    each with ``decider="votes"`` and ``"dag"``."""
    import tempfile

    from repro_torch.api import compile_fleet

    tests = fleet_tests(fits)
    configs, k1_dispatch, burst, mesh_check = [], None, None, None
    rbf_fleet = None
    with tempfile.TemporaryDirectory() as tmp:
        for target in ("rbf", "circuit"):
            for decider in ("votes", "dag"):
                machines = {n: est.deploy(target, decider=decider)
                            for n, est in fits.items()}
                fleet = compile_fleet(machines, decider=decider)
                fleet_bits_equal_members(fleet, machines, tests)
                n_rbf = sum(b.kind == "rbf" for m in machines.values()
                            for b in m._kernel_banks) \
                    if decider == "votes" else 0
                path = f"{tmp}/{target}_{decider}"
                fleet.save(path)
                runs = serve_runs(path, dev, n_rbf)
                row = dict(target=target, decider=decider,
                           p_total=fleet.n_pairs_total,
                           d_max=fleet.n_features, rbf_banks=n_rbf,
                           alone=dispatch_alone(fleet, tests), runs=runs)
                log("FLEET", json.dumps(row))
                configs.append(row)
                if (target, decider) == ("rbf", "votes"):
                    k1_dispatch = k1_fleet_dispatch(fleet, tests)
                    rbf_fleet = fleet
                if (target, decider) == ("circuit", "votes"):
                    mesh_check = mesh_d1_equals_unsharded(fleet, tests)
                    burst = overload_burst(fleet, tests)
                    log("OVERLOAD", json.dumps(burst))
    if configs[0]["p_total"] != 75:
        raise AssertionError(f"fleet P_total {configs[0]['p_total']} != 75")
    legs = mc_and_trainer_mesh_d1(fits["balance"], dev, har12_padded)
    log("MESH_D1", json.dumps(dict(serving=mesh_check, **legs)))
    return dict(configs=configs, k1_fleet_dispatch=k1_dispatch,
                overload=burst, mesh_d1=dict(serving=mesh_check, **legs),
                fleet=rbf_fleet)


# ---------------------------------------------------------------------------
# Phase 4: the card against the plain versions on a small input
# ---------------------------------------------------------------------------


def check_small_input(dev) -> None:
    import numpy as np

    from repro_torch.api import MixedKernelSVM, compile_machine
    from repro_torch.data import datasets

    ds = datasets.load("balance")
    idx = np.random.RandomState(0).permutation(len(ds.y_train))[:150]
    x, y = ds.x_train[idx], ds.y_train[idx]
    kw = dict(n_epochs=40, cv_epochs=20, seed=0)
    card = MixedKernelSVM(device=dev, **kw).fit(x, y)
    host = MixedKernelSVM(device="cpu", **kw).fit(x, y)
    if card.kernel_map_ != host.kernel_map_:
        raise AssertionError("small input: kernel maps differ")
    for pc, ph in zip(card.pairs_, host.pairs_):
        for slot in ("model_linear", "model_rbf", "model_hw"):
            mc, mh = getattr(pc, slot), getattr(ph, slot)
            if (mc.gamma, mc.c) != (mh.gamma, mh.c) or not np.array_equal(
                    mc.support_x, mh.support_x) or not np.allclose(
                    mc.alpha, mh.alpha, atol=5e-4, rtol=1e-3):
                raise AssertionError(f"small input: {pc.pair} {slot} differs")
    # The host-trained machines evaluated on the card and on the CPU: scores
    # to f32 (the measured-curve columns sum ~1e-6 interpolation noise
    # against their coefficients, hence the looser atol), labels off ties.
    for target in host.targets:
        on_card = compile_machine(host.bank(target), device=dev)
        sc = on_card.decision_scores(ds.x_test)
        sh = host.deploy(target).decision_scores(ds.x_test)
        if not np.allclose(sc, sh, atol=1e-4, rtol=1e-5):
            raise AssertionError(f"small input: {target} scores differ by "
                                 f"{np.abs(sc - sh).max()}")
        clear = np.abs(sh) > 1e-5
        if not np.array_equal(sc[clear] >= 0, sh[clear] >= 0):
            raise AssertionError(f"small input: {target} labels differ")
    log("small input: card == plain versions on the CPU (kernel picks, "
        "(gamma, C), support sets, alphas; scores and labels of the same "
        "machines)")


# ---------------------------------------------------------------------------
# Phase 5: the LM kernels against their plain versions
# ---------------------------------------------------------------------------


def attn_live_pairs(sq: int, skv: int, causal: bool, window,
                    q_offset: int = 0) -> int:
    """(query, key) pairs a causal / windowed mask leaves visible, query
    rows at kv positions ``q_offset``.."""
    total = 0
    for qpos in range(q_offset, q_offset + sq):
        hi = min(qpos, skv - 1) if causal else skv - 1
        lo = max(0, qpos - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def check_k3(dev) -> list:
    """K3 at the prefill shapes: q (4, 25, 2048, 64), k and v (4, 5, 2048,
    64), on a global layer (causal) and an SWA layer (window 1024), bf16 as
    the model runs it and f32.  ``library_ms`` is one call of
    ``scaled_dot_product_attention(..., enable_gqa=True)`` on the same
    tensors: ``is_causal=True`` for the global layer, an explicit boolean
    mask for the SWA layer."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ref

    cfg = configs.get("hymba-1.5b").make_config()
    b, hq, hkv, s, dh = 4, cfg.n_heads, cfg.n_kv_heads, 2048, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(12)
    pos = torch.arange(s, device=dev)
    rows = []
    for dtype, tol, peak in ((torch.bfloat16, 2e-2, BF16_TC_OPS_PER_S),
                             (torch.float32, 2e-5, F32_OPS_PER_S)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                                 (b, hkv, s, dh)))
        for layer, window in (("global", None), ("swa", cfg.window)):
            run = lambda: flash_attention.flash_attention_cuda(q, k, v, True,
                                                               window)
            plain = lambda: ref.flash_attention(q, k, v, True, window)
            got, want = run(), plain()
            torch.cuda.synchronize()
            ok, err = within(got.float(), want.float(), tol, tol)
            if not ok:
                raise AssertionError(f"K3 {layer} {dtype}: max err {err}")
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            else:
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[None, :] > pos[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            lib_err = float((lib().float() - want.float()).abs().max())
            fault = {}
            if window is not None and dtype == torch.bfloat16:
                # The planted fault on the tensor-core kernel: its window
                # narrowed by one kv block must fail the same check.
                bad = _k3_dropping_a_kv_block(q, k, v, True, window)
                caught, bad_err = within(bad.float(), want.float(), tol, tol)
                fault = dict(dropped_kv_block_err=bad_err,
                             dropped_kv_block_caught=not caught)
                if caught:
                    raise AssertionError(
                        f"K3 {layer} {dtype}: the {tol} check passed the "
                        f"kernel dropping a kv block (err {bad_err})")
            pairs = attn_live_pairs(s, s, True, window)
            n_ops = 4 * dh * pairs * b * hq
            n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            bnd, by = bound_ms(n_bytes, n_ops, peak)
            row = dict(layer=layer, dtype=str(dtype).split(".")[-1],
                       shape=[b, hq, hkv, s, dh], window=window,
                       live_pairs_per_head=pairs, max_abs_err=err,
                       tolerance=tol, ms=cuda_ms(run, reps=10),
                       plain_ms=cuda_ms(plain, reps=3),
                       library_ms=cuda_ms(lib, reps=10),
                       library_max_abs_err=lib_err, bound_ms=bnd,
                       bound_by=by, **fault)
            rows.append(row)
            log("K3", json.dumps(row))
        del q, k, v
    return rows


def ssd_ops(b: int, s: int, nh: int, dh: int, ds: int, chunk: int) -> float:
    """f32 operations of the chunked scan, counting only the causal half of
    the two (L, L) products (the upper triangle is zero): per chunk and
    head, C B^T and (G * decay) x over L(L+1)/2 pairs, one exp per pair,
    the inter-chunk output and the state update (2 L dh ds each)."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * pairs * ds + 2 * pairs * dh + pairs + 4 * chunk * dh * ds
    return float(b * nh * (s // chunk) * per_chunk)


#: K4's inputs at the prefill shape: the decay a per step.  "random": a =
#: -|N(0, 1)| * 0.3 (the timed case); "strong decay": a = -|N(0, 1)| * 3,
#: so exp(cum) underflows to 0 within a chunk; "model a": a = -exp(a_log) *
#: dt with dt = softplus(N(0, 1)) and a_log = log(linspace(1, 16, nh)), as
#: models/ssm.py initializes and computes them (x scaled by dt, as there).
K4_CASES = ("random", "strong decay", "model a")

#: rtol of K4's y and final state against the plain version at a state
#: wider than 64 (mamba2's 128).  The decay exp(cum_t - cum_j) turns the
#: rounding of cum (which reaches -1.9e3 with model a) into a relative error
#: of y, and y grows with ds: at mamba2's shape the plain f32 version lies
#: 1.0e-4 from an f64 sequential scan itself (model a, |y| up to 11; the
#: kernel as far), so two right f32 scans differ by ~2e-4 there.  Narrower
#: states keep rtol 0.  ``check_k4`` prints both versions' distance to the
#: f64 scan at these widths.
K4_WIDE_RTOL = 1e-4


def k4_inputs(dev, case: str, b: int = 4, s: int = 2048,
              arch: str = "hymba-1.5b") -> tuple:
    """x, a, B and C of ``arch``'s prefill, drawn from a seed: hymba-1.5b's
    x (4, 2048, 50, 64), a (4, 2048, 50), B and C (4, 2048, 1, 16);
    mamba2-2.7b's x (4, 2048, 80, 64), B and C (4, 2048, 1, 128)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs

    cfg = configs.get(arch).make_config()
    nh, dh = cfg.n_ssm_heads, cfg.ssm_head_dim
    g, ds = cfg.ssm_groups, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(13)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, a = draw(b, s, nh, dh) * 0.3, -draw(b, s, nh).abs() * 0.3
    bm, cm = draw(b, s, g, ds) * 0.3, draw(b, s, g, ds) * 0.3
    if case == "strong decay":
        a = a * 10.0
    elif case == "model a":
        dt = F.softplus(draw(b, s, nh))
        a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
        a = (-torch.exp(a_log) * dt).contiguous()
        x = (x * dt[..., None]).contiguous()
    return x, a, bm, cm


def check_k4(dev, arch: str = "hymba-1.5b") -> dict:
    """K4 at ``arch``'s prefill shape, chunk 128, in each of ``K4_CASES``:
    y and the final state within atol 1e-4 of ``ref.ssd_scan`` (and rtol
    ``K4_WIDE_RTOL`` at a state wider than 64), and each of
    the three passes against its plain twin on the kernel's own inputs to
    it (so a fault shows in the pass that makes it): pass 1's cumsum (atol
    1e-4, rtol 1e-5: it reaches -10^3 with model a) and chunk states, pass
    2's entering and final states, pass 3's y, each within atol 1e-4.
    Timed on the "random" case.  No single PyTorch call computes the
    chunked scan, so ``library_ms`` is null."""
    import torch

    from repro_torch.kernels import ref, ssd

    chunk, cases, row = 128, {}, None
    for case in K4_CASES:
        x, a, bm, cm = k4_inputs(dev, case, arch=arch)
        y, sf, cum, s_prev = ssd.ssd_passes_cuda(x, a, bm, cm, chunk)
        _, _, cum1, ds1 = ssd.ssd_passes_cuda(
            x, a, bm, cm, chunk, chunk_states_only=True)
        y_p, sf_p = ref.ssd_scan(x, a, bm, cm, chunk)
        cum_p, ds_p = ref.ssd_chunk_states(x, a, bm, chunk)
        s_prev_p, sf_p2 = ref.ssd_state_pass(cum1, ds1, chunk)
        y_p3 = ref.ssd_chunk_scan(x, bm, cm, cum, s_prev, chunk)
        torch.cuda.synchronize()
        rtol = K4_WIDE_RTOL if bm.shape[3] > 64 else 0.0
        checks = {"y": within(y, y_p, 1e-4, rtol),
                  "final_state": within(sf, sf_p, 1e-4, rtol),
                  "pass1_cum": within(cum1, cum_p, 1e-4, 1e-5),
                  "pass1_chunk_states": within(ds1, ds_p, 1e-4, 0.0),
                  "pass2_entering_states":
                      within(s_prev, s_prev_p, 1e-4, 0.0),
                  "pass2_final_state": within(sf, sf_p2, 1e-4, 0.0),
                  "pass3_y": within(y, y_p3, 1e-4, 0.0)}
        cases[case] = {k: err for k, (_, err) in checks.items()}
        if rtol:
            y64, _ = ref.ssd(x.double(), a.double(), bm.double(),
                             cm.double())
            cases[case]["y_kernel_vs_f64"] = float(
                (y.double() - y64).abs().max())
            cases[case]["y_plain_vs_f64"] = float(
                (y_p.double() - y64).abs().max())
            del y64
        failed = [k for k, (ok, _) in checks.items() if not ok]
        if failed:
            raise AssertionError(f"K4 {arch} {case}: {failed} "
                                 f"{cases[case]}")
        if case == "random":
            row = k4_times(x, a, bm, cm, chunk)
        del x, a, bm, cm, y, sf, cum, s_prev, y_p, y_p3
        torch.cuda.empty_cache()
    row["max_abs_err"] = max(max(c["y"], c["final_state"])
                             for c in cases.values())
    row["cases"] = cases
    row["arch"] = arch
    log("K4", json.dumps(row))
    return row


def k4_times(x, a, bm, cm, chunk: int) -> dict:
    """K4's times on these inputs: ``ms`` per call and ``pass1_ms``, pass 1
    alone (``chunk_states_only``), by CUDA events; ``device_ms`` per call
    and by pass (``torch.profiler``), "not measured" unless the trace holds
    all ``ssd.DEVICE_LAUNCHES`` launches of every call; the plain version's
    ms, and the bound."""
    from repro_torch.kernels import ref, ssd

    b, s, nh, dh = x.shape
    g, ds = bm.shape[2], bm.shape[3]
    run = lambda: ssd.ssd_scan_cuda(x, a, bm, cm, chunk)
    plain = lambda: ref.ssd_scan(x, a, bm, cm, chunk)
    n_bytes = 4 * (2 * x.numel() + a.numel() + bm.numel() + cm.numel()
                   + b * nh * dh * ds)
    bnd, by = bound_ms(n_bytes, ssd_ops(b, s, nh, dh, ds, chunk))
    dev_ms, per_call = device_ms(run, "ssd_", reps=10)
    by_pass = {name: device_ms(run, name, reps=10) for name in
               ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")}
    if per_call != ssd.DEVICE_LAUNCHES or any(
            n != 1 for _, n in by_pass.values()):
        # The trace dropped events (it does after the earlier phases).
        dev_ms = f"not measured (trace held {per_call} launches per call)"
        by_pass = {name: "not measured" for name in by_pass}
    else:
        by_pass = {name: t for name, (t, _) in by_pass.items()}
    return dict(shape=[b, s, nh, dh, g, ds], chunk=chunk, tolerance=1e-4,
                ms=cuda_ms(run, reps=10),
                pass1_ms=cuda_ms(lambda: ssd.ssd_passes_cuda(
                    x, a, bm, cm, chunk, chunk_states_only=True), reps=10),
                device_ms=dev_ms, device_launches_per_call=per_call,
                device_ms_by_pass=by_pass,
                plain_ms=cuda_ms(plain, reps=3), library_ms=None,
                bound_ms=bnd, bound_by=by)


# ---------------------------------------------------------------------------
# Phases 6 and 7: LM serving
# ---------------------------------------------------------------------------


def device_breakdown(fn) -> dict:
    """One traced call of ``fn``: host wall time, device kernel time by
    group (K3, K4, cuBLAS GEMMs by their kernel names, the rest) and the
    device's idle share of the wall time.  Kernel times come from
    ``torch.profiler``'s CUDA events; with none recorded the breakdown
    says "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"K3 flash_attention": 0.0, "K4 ssd": 0.0, "cuBLAS GEMM": 0.0,
              "other": 0.0}
    by_name: dict[str, float] = {}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.end - evt.time_range.start
        n_kernels += 1
        name = evt.name
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
        if "flash_kernel" in name or "flash_wgmma_kernel" in name:
            groups["K3 flash_attention"] += us / 1e3
        elif "ssd_" in name:
            groups["K4 ssd"] += us / 1e3
        elif any(t in name.lower() for t in ("gemm", "nvjet", "xmma",
                                                "cutlass")):
            groups["cuBLAS GEMM"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    if n_kernels == 0:
        return {"wall_ms": wall_ms, "device": "not measured"}
    busy = sum(groups.values())
    if busy > wall_ms:
        # One stream runs one kernel at a time: a larger sum is a wrong one.
        raise AssertionError(f"device busy {busy} ms > wall {wall_ms} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": groups, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_kernels": n_kernels,
            "top_kernels_ms": [[n[:60], t] for n, t in top]}


def serve_path() -> tuple[dict, dict]:
    """hymba-1.5b served at full width through the port's entry point."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    ops.reset_launches()
    out = serve.main(SERVE_ARGV)
    counts = ops.launch_counts()
    log("launches on the serve path:", json.dumps(counts))
    cfg, toks = out["cfg"], out["tokens"]
    if (cfg.n_layers, cfg.d_model) != (32, 1600):
        raise AssertionError(f"not the full config: {cfg}")
    for name in ("flash_attention", "flash_attention_bf16_wgmma", "ssd"):
        if counts[name] != cfg.n_layers:
            raise AssertionError(
                f"{name}: {counts[name]} launches, expected {cfg.n_layers} "
                "(one per layer in one prefill)")
    if counts["flash_attention_f32_cuda_cores"] != 0:
        raise AssertionError("the bf16 prefill ran the f32 CUDA-core K3")
    if toks.shape != (4, 32) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape}")
    b, s, n_dec = 4, 2048, out["decode_steps"]
    row = dict(config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               batch=b, prompt_len=s, gen=toks.shape[1],
               prefill_s=out["prefill_s"],
               prefill_tokens_per_s=b * s / out["prefill_s"],
               decode_s=out["decode_s"], decode_steps=n_dec,
               decode_ms_per_step=out["decode_s"] / n_dec * 1e3,
               decode_tokens_per_s=b * n_dec / out["decode_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    # One more prefill at the same shape, warm, outside the counted run.
    from repro_torch.models import transformer as tfm

    dev = toks.device
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev)
    engine.prefill(cfg, params, {"tokens": prompts}, s + 40)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, logits = engine.prefill(cfg, params, {"tokens": prompts}, s + 40)
    torch.cuda.synchronize()
    row["prefill_warm_s"] = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("warm prefill: non-finite logits")
    log("SERVE", json.dumps(row))

    # Where the time goes: one traced prefill and one traced decode step.
    state = {}

    def prefill():
        state["s"], state["logits"] = engine.prefill(
            cfg, params, {"tokens": prompts}, s + 40)

    log("TRACE prefill", json.dumps(device_breakdown(prefill)))
    tok = torch.argmax(state["logits"], dim=-1)[:, None]
    engine.decode_step(cfg, params, state["s"], tok)
    log("TRACE decode step", json.dumps(device_breakdown(
        lambda: engine.decode_step(cfg, params, state["s"], tok))))
    return row, counts


def _prefill_last(cfg, params, batch, attention=None, scan=None):
    """One prefill on the card through K3 and K4 or through the functions
    given in their place -> (last-token logits in f32, the state).  The
    audio family prefills ``engine.prefill_audio`` with a cross cache as
    long as its frames."""
    from repro_torch.kernels import ops
    from repro_torch.serving import engine

    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention = attention or saved[0]
    ops.ssd_scan = scan or saved[1]
    try:
        if cfg.family == "audio":
            st, lg = engine.prefill_audio(
                cfg, params, batch,
                batch["frames"].shape[1] * cfg.enc_seq_divisor)
        else:
            n = sum(batch[k].shape[1] for k in ("tokens", "patch_embeds")
                    if k in batch)
            st, lg = engine.prefill(cfg, params, batch, n + 40)
    finally:
        ops.flash_attention, ops.ssd_scan = saved
    return lg.float(), st


def _k3_dropping_a_kv_block(q, k, v, causal=True, window=None, q_offset=0):
    """K3 with a planted fault, phase 7's negative control: the window is
    narrowed by one kv block (64 keys), so the last query of every layer
    loses its oldest visible block."""
    from repro_torch.kernels import flash_attention

    return flash_attention.flash_attention_cuda(
        q, k, v, causal, (window or k.shape[2]) - 64, q_offset)


#: Phase 7's bf16 bound on the kernels' last-token logits against the plain
#: versions': this many bf16 ulps at the scale of the largest logit.  A
#: sound run reads 2.5 ulps at 4 layers (PERF.md, section 6).
BF16_LOGIT_ULPS = 4


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    import math

    return 2.0 ** (math.floor(math.log2(x)) - 7)


def check_small_prefill(dev) -> dict:
    """Full width, 4 layers (global 0 and 3, SWA 1 and 2), 1 prompt of 1100
    tokens (past the 1024 window; ragged for both kernels): the prefill on
    the card through K3 / K4 and through their plain versions, with the
    same weights in bf16 and in f32.

    bf16 (as the model serves): the kernels' last-token logits within
    ``BF16_LOGIT_ULPS`` bf16 ulps (at the largest logit's scale) of the
    plain versions', and the same argmax wherever the top-2 margin exceeds
    0.05.  f32: logits and SSM states within atol 1e-4 / rtol 1e-4.  The
    negative control, K3 dropping a kv block, must fail the f32 check; what
    it reads on the bf16 one is logged."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(configs.get("hymba-1.5b").make_config(),
                              n_layers=4, global_layers=(0, 3))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.as_tensor(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 1100)), device=dev)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    plain = dict(attention=ref.flash_attention, scan=ref.ssd_scan)
    batch = {"tokens": toks}
    k16, _ = _prefill_last(cfg, params, batch)
    p16, _ = _prefill_last(cfg, params, batch, **plain)
    m16, _ = _prefill_last(cfg, params, batch, _k3_dropping_a_kv_block)
    params = params.float()
    k32, st = _prefill_last(cfg32, params, batch)
    sk32 = st["ssm"]
    p32, st = _prefill_last(cfg32, params, batch, **plain)
    sp32 = st["ssm"]
    m32, _ = _prefill_last(cfg32, params, batch, _k3_dropping_a_kv_block)
    del params, st

    scale = float(p16.abs().max())
    bound16 = BF16_LOGIT_ULPS * bf16_ulp(scale)
    err16 = float((k16 - p16).abs().max())
    mut16 = float((m16 - p16).abs().max())
    ok32, err32 = within(k32, p32, 1e-4, 1e-4)
    ok_st, err_st = within(sk32, sp32, 1e-4, 1e-4)
    mut_ok32, mut32 = within(m32, p32, 1e-4, 1e-4)
    top2 = torch.topk(p16, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.05
    same = bool((k16.argmax(-1) == p16.argmax(-1))[clear].all())
    row = dict(shape=[1, 1100], n_layers=4, bf16_logit_absmax=scale,
               bf16_bound=bound16, bf16_logits_max_abs_err=err16,
               bf16_err_ulps=err16 / bf16_ulp(scale),
               argmax_equal_off_ties=same, clear_rows=int(clear.sum()),
               f32_logits_max_abs_err=err32,
               f32_ssm_state_max_abs_err=err_st,
               dropped_kv_block_bf16_err=mut16,
               dropped_kv_block_bf16_caught=mut16 > bound16,
               dropped_kv_block_f32_err=mut32,
               dropped_kv_block_f32_caught=not mut_ok32)
    log("small prefill:", json.dumps(row))
    if not (err16 <= bound16 and same and ok32 and ok_st):
        raise AssertionError(f"small prefill: kernels vs plain {row}")
    if mut_ok32:
        raise AssertionError(
            f"small prefill: the f32 check passed K3 dropping a kv block {row}")
    return row



# ---------------------------------------------------------------------------
# Phase 5, the other families' shapes; phase 12: every family served
# ---------------------------------------------------------------------------

#: K3 at the other families' prefill shapes: (case, arch, b, hq, hkv, sq,
#: skv, dh, causal, dtypes).  phi-3-vision's prefill of 576 patches + 2048
#: tokens (MHA, dh 96), kimi-k2's attention (GQA 64 / 8, dh 112), and the
#: launches of phase 12's served prefills: starcoder2-7b's (GQA 36 / 4, a
#: group of 9, dh 128), granite-moe's (GQA 16 / 8), and whisper-medium's
#: encoder (1500 frames against themselves, non-causal), decoder
#: self-attention (64 tokens, causal) and cross-attention (64 decoder
#: tokens against the 1500 encoder frames, non-causal).
K3_FAMILY_CASES = (
    ("phi-3-vision prefill", "phi-3-vision-4.2b", 4, 32, 32, 2624, 2624, 96,
     True, ("bfloat16", "float32")),
    ("kimi-k2 attention", "kimi-k2-1t-a32b", 4, 64, 8, 2048, 2048, 112, True,
     ("bfloat16", "float32")),
    ("starcoder2 prefill", "starcoder2-7b", 4, 36, 4, 2048, 2048, 128, True,
     ("bfloat16", "float32")),
    ("granite-moe prefill", "granite-moe-1b-a400m", 4, 16, 8, 2048, 2048, 64,
     True, ("bfloat16", "float32")),
    ("whisper encoder", "whisper-medium", 4, 16, 16, 1500, 1500, 64, False,
     ("bfloat16", "float32")),
    ("whisper decoder self-attention", "whisper-medium", 4, 16, 16, 64, 64,
     64, True, ("bfloat16", "float32")),
    ("whisper cross-attention", "whisper-medium", 4, 16, 16, 64, 1500, 64,
     False, ("bfloat16", "float32")),
)

#: bf16 K3 against its plain version in the L2 sense as well: the relative
#: L2 distance of the outputs within one bf16 ulp of a value's size, 2^-8.
#: Each output is rounded to bf16 (half an ulp, at most 2^-8 of its size)
#: and the kernel rounds p to bf16 before p v; a sound kernel reads 1.8e-3
#: to 2.4e-3 at every shape of ``K3_FAMILY_CASES`` (PERF.md).  The
#: element-wise 2e-2 does not see a bias of ~1 % on outputs of ~0.04
#: (softmax over 1500 keys); this does: a kernel letting whisper's 36
#: zero-padded keys of the ragged last kv block into the softmax shrinks
#: every output by ~36 / 2500 and reads 1.4e-2
#: (``_k3_letting_in_padded_keys``, which the check must refuse).
K3_BF16_REL_L2 = 2.0 ** -8


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _k3_letting_in_padded_keys(q, k, v, causal=False):
    """K3 with a planted fault for a ragged key count: k and v zero-padded
    to whole 64-key blocks and the padding left visible, as a kernel that
    did not mask its ragged last kv block would compute."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention

    pad = (0, 0, 0, -k.shape[2] % 64)
    return flash_attention.flash_attention_cuda(q, F.pad(k, pad),
                                                F.pad(v, pad), causal)


def check_k3_families(dev) -> list:
    """K3 at ``K3_FAMILY_CASES`` against its plain version (2e-2 in bf16,
    2e-5 in f32, and in bf16 ``K3_BF16_REL_L2`` as well), timed beside one
    ``scaled_dot_product_attention(..., enable_gqa=True)`` call on the same
    tensors (``is_causal`` for the causal cases).  Where skv is ragged and
    the attention non-causal, the planted fault ``_k3_letting_in_padded_keys``
    must fail the bf16 check."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for case, arch, b, hq, hkv, sq, skv, dh, causal, dtypes in \
            K3_FAMILY_CASES:
        for name in dtypes:
            dtype = getattr(torch, name)
            bf16 = name == "bfloat16"
            tol, peak = ((2e-2, BF16_TC_OPS_PER_S) if bf16
                         else (2e-5, F32_OPS_PER_S))
            q = torch.randn((b, hq, sq, dh), generator=gen, device=dev).to(
                dtype)
            k, v = (torch.randn((b, hkv, skv, dh), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            run = lambda: flash_attention.flash_attention_cuda(q, k, v,
                                                               causal)
            plain = lambda: ref.flash_attention(q, k, v, causal)
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
            got, want = run(), plain()
            torch.cuda.synchronize()
            ok, err = within(got.float(), want.float(), tol, tol)
            l2 = rel_l2(got, want)
            if not ok or (bf16 and l2 > K3_BF16_REL_L2):
                raise AssertionError(f"K3 {case} {name}: max err {err}, "
                                     f"relative L2 {l2}")
            fault = {}
            if bf16 and not causal and skv % 64:
                bad = _k3_letting_in_padded_keys(q, k, v)
                bad_l2 = rel_l2(bad, want)
                fault = dict(
                    padded_keys_max_abs_err=float(
                        (bad.float() - want.float()).abs().max()),
                    padded_keys_rel_l2=bad_l2,
                    padded_keys_caught=bad_l2 > K3_BF16_REL_L2)
                if not fault["padded_keys_caught"]:
                    raise AssertionError(
                        f"K3 {case}: the bf16 check passed the kernel "
                        f"letting in the padded keys {fault}")
                del bad
            pairs = attn_live_pairs(sq, skv, causal, None)
            bnd, by = bound_ms(q.element_size() * (2 * q.numel()
                                                   + 2 * k.numel()),
                               4 * dh * pairs * b * hq, peak)
            row = dict(case=case, arch=arch, dtype=name,
                       shape=[b, hq, hkv, sq, skv, dh], causal=causal,
                       max_abs_err=err, rel_l2=l2, tolerance=tol,
                       rel_l2_bound=K3_BF16_REL_L2 if bf16 else None,
                       ms=cuda_ms(run, reps=10),
                       plain_ms=cuda_ms(plain, reps=2, warmup=1),
                       library_ms=cuda_ms(lib, reps=10),
                       library_max_abs_err=float(
                           (lib().float() - want.float()).abs().max()),
                       bound_ms=bnd, bound_by=by, **fault)
            rows.append(row)
            log("K3", json.dumps(row))
            del q, k, v, got, want
        torch.cuda.empty_cache()
    return rows


def _greedy_decode(cfg, params, state, logits, steps: int):
    """``steps`` decode steps from the prefill's logits, greedy; returns the
    tokens (B, steps + 1) and the wall seconds of the steps."""
    import torch

    from repro_torch.serving import engine

    tok = torch.argmax(logits, dim=-1)[:, None]
    outs = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, logits = engine.decode_step(cfg, params, state, tok)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs.append(tok)
    torch.cuda.synchronize()
    return torch.cat(outs, dim=1), time.perf_counter() - t0


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


#: Phase 12: one model per family at full width, bf16, 4 prompts of 2048
#: tokens (phi-3-vision: after 576 patch embeddings; whisper-medium: a
#: 64-token prompt after 1500 frames, cap 3000) and 32 generated tokens:
#: family -> (arch, driven through serve.main, K3 / K4 launches of one
#: prefill).
FAMILY_SERVES = {
    "dense": ("starcoder2-7b", True, 32, 0),
    "moe": ("granite-moe-1b-a400m", True, 24, 0),
    "ssm": ("mamba2-2.7b", True, 0, 64),
    "vlm": ("phi-3-vision-4.2b", False, 32, 0),
    "audio": ("whisper-medium", False, 72, 0),
}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 4, 2048, 32
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_CAP = 1500, 64, 3000


def serve_family(dev, family: str) -> dict:
    """Serve ``FAMILY_SERVES[family]`` at full width from seeded random
    weights.  The launch counters are zeroed just before the served run
    and read just after (``serve.main``), or after the prefill and after
    the decode steps (``engine.prefill`` / ``prefill_audio`` +
    ``decode_step``): one prefill's K3 / K4 launches exactly, every K3 on
    the tensor-core kernel, none in decode.  Then a warm prefill."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import engine

    arch, via_main, want_k3, want_k4 = FAMILY_SERVES[family]
    b, s, gen = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(arch).make_config()
    row = dict(family=family, arch=arch, n_layers=cfg.n_layers,
               d_model=cfg.d_model, params=cfg.param_count(), batch=b,
               gen=gen)
    if via_main:
        ops.reset_launches()
        out = serve.main(["--arch", arch, "--no-reduced", "--batch", str(b),
                          "--prompt-len", str(s), "--gen", str(gen),
                          "--seed", "0"])
        counts = ops.launch_counts()
        decode_counts = None
        toks, cold, dec_s = out["tokens"], out["prefill_s"], out["decode_s"]
        steps = out["decode_steps"]
        del out
        params = tfm.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         device=dev)}
        prefill = lambda: engine.prefill(cfg, params, batch, s + gen + 8)
        n_in = s
    else:
        params = tfm.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
        gen_in = torch.Generator(device=dev).manual_seed(15)
        if family == "vlm":
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                             device=dev, generator=gen_in),
                     "patch_embeds": torch.randn(
                         (b, cfg.n_patches, cfg.d_model), device=dev,
                         generator=gen_in).to(cfg.compute_dtype)}
            n_in, cap = cfg.n_patches + s, cfg.n_patches + s + gen + 8
            prefill = lambda: engine.prefill(cfg, params, batch, cap)
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                             (b, WHISPER_PROMPT), device=dev,
                                             generator=gen_in),
                     "frames": torch.randn(
                         (b, WHISPER_FRAMES, cfg.d_model), device=dev,
                         generator=gen_in).to(cfg.compute_dtype)}
            n_in, cap = WHISPER_PROMPT, WHISPER_CAP
            prefill = lambda: engine.prefill_audio(cfg, params, batch, cap)
            row["frames"] = WHISPER_FRAMES
        ops.reset_launches()
        (state, logits), cold = _timed(prefill)
        counts = ops.launch_counts()
        if family == "audio" and state["enc_len"] != WHISPER_FRAMES:
            raise AssertionError(f"whisper: enc_len {state['enc_len']}")
        ops.reset_launches()
        steps = gen - 1
        toks, dec_s = _greedy_decode(cfg, params, state, logits, steps)
        decode_counts = ops.launch_counts()
        del state, logits
    if counts["flash_attention"] != want_k3 or \
            counts["flash_attention_bf16_wgmma"] != want_k3 or \
            counts["flash_attention_f32_cuda_cores"] != 0 or \
            counts["ssd"] != want_k4:
        raise AssertionError(f"{arch}: launches {counts}, expected K3 "
                             f"{want_k3} (all tensor-core), K4 {want_k4}")
    if decode_counts is not None and (decode_counts["flash_attention"] or
                                      decode_counts["ssd"]):
        raise AssertionError(f"{arch}: decode launched {decode_counts}")
    if toks.shape != (b, gen) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: bad tokens {tuple(toks.shape)}")
    (state, logits), warm = _timed(prefill)
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{arch}: non-finite warm prefill logits")
    row.update(prompt_len=n_in, via="serve.main" if via_main else
               ("engine.prefill" if family == "vlm" else
                "engine.prefill_audio"),
               k3_launches=counts["flash_attention"],
               k3_tensor_core=counts["flash_attention_bf16_wgmma"],
               k4_launches=counts["ssd"],
               decode_launches=(0 if decode_counts is None else
                                decode_counts["flash_attention"]
                                + decode_counts["ssd"]),
               prefill_cold_s=cold, prefill_warm_s=warm,
               prefill_tokens_per_s=b * n_in / warm,
               decode_steps=steps, decode_ms_per_step=dec_s / steps * 1e3,
               decode_tokens_per_s=b * steps / dec_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("SERVE", json.dumps(row))

    # Where the time goes: one traced prefill and one traced decode step
    # (after an untraced one), as phase 6 traces hymba.
    row["trace_prefill"] = device_breakdown(prefill)
    log(f"TRACE {arch} prefill", json.dumps(row["trace_prefill"]))
    tok = torch.argmax(logits, dim=-1)[:, None]
    state, _ = engine.decode_step(cfg, params, state, tok)
    row["trace_decode_step"] = device_breakdown(
        lambda: engine.decode_step(cfg, params, state, tok))
    log(f"TRACE {arch} decode step", json.dumps(row["trace_decode_step"]))
    del params, batch, logits, state
    torch.cuda.empty_cache()
    return row


#: The small full-width prefills of the other families (phase 7's rule):
#: name -> (arch, config overrides).  Full published widths at 4 layers;
#: kimi-k2 at 2 layers with its 384 experts cut to 8 (one layer's experts
#: alone are ~34 GB in bf16): its check is the dh 112 attention.
SMALL_PREFILLS = {
    "starcoder2-7b": ("starcoder2-7b", dict(n_layers=4)),
    "command-r-35b": ("command-r-35b", dict(n_layers=4)),
    "granite-20b": ("granite-20b", dict(n_layers=4)),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", dict(n_layers=4)),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", dict(n_layers=2, n_experts=8)),
    "mamba2-2.7b": ("mamba2-2.7b", dict(n_layers=4)),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", dict(n_layers=4)),
    "whisper-medium": ("whisper-medium", dict(n_layers=4, n_enc_layers=4)),
}
#: One prompt of this many tokens (ragged for K3's 64-key blocks and K4's
#: 128-step chunks); phi-3-vision's follows its 576 patches, whisper's 40
#: tokens follow this many frames.
SMALL_PROMPT = 600


def check_small_family_prefill(dev, name: str) -> dict:
    """``SMALL_PREFILLS[name]``: the prefill on the card through K3 / K4 and
    through their plain versions, the same weights in bf16 and in f32.
    bf16: the last-token logits within ``BF16_LOGIT_ULPS`` bf16 ulps at the
    largest logit's scale, the same argmax where the top-2 margin exceeds
    0.05.  f32: the logits and every state tensor within atol / rtol
    1e-4."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tfm

    arch, over = SMALL_PREFILLS[name]
    full = configs.get(arch).make_config()
    cfg = dataclasses.replace(full, **over)
    cut = {k: f"{getattr(full, k)} -> {v}" for k, v in over.items()}
    gen_in = torch.Generator(device=dev).manual_seed(16)
    if cfg.family == "audio":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 40),
                                         device=dev, generator=gen_in),
                 "frames": torch.randn((1, SMALL_PROMPT, cfg.d_model),
                                       device=dev, generator=gen_in)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (1, SMALL_PROMPT), device=dev,
                                         generator=gen_in)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.randn(
                (1, cfg.n_patches, cfg.d_model), device=dev,
                generator=gen_in)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(2))
    plain = dict(attention=ref.flash_attention, scan=ref.ssd_scan)
    b16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
           for k, v in batch.items()}
    k16, _ = _prefill_last(cfg, params, b16)
    p16, _ = _prefill_last(cfg, params, b16, **plain)
    params = params.float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    k32, sk = _prefill_last(cfg32, params, batch)
    p32, sp = _prefill_last(cfg32, params, batch, **plain)
    del params
    scale = float(p16.abs().max())
    bound16 = BF16_LOGIT_ULPS * bf16_ulp(scale)
    err16 = float((k16 - p16).abs().max())
    ok32, err32 = within(k32, p32, 1e-4, 1e-4)
    st_err, st_ok = 0.0, True
    for key, t in sk.items():
        if isinstance(t, torch.Tensor):
            ok, err = within(t.float(), sp[key].float(), 1e-4, 1e-4)
            st_ok, st_err = st_ok and ok, max(st_err, err)
    top2 = torch.topk(p16, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.05
    same = bool((k16.argmax(-1) == p16.argmax(-1))[clear].all())
    row = dict(name=name, cut=cut, n_layers=cfg.n_layers,
               d_model=cfg.d_model, head_dim=cfg.head_dim,
               prompt={k: list(v.shape) for k, v in batch.items()},
               bf16_logit_absmax=scale, bf16_bound=bound16,
               bf16_logits_max_abs_err=err16,
               bf16_err_ulps=err16 / bf16_ulp(scale),
               argmax_equal_off_ties=same, clear_rows=int(clear.sum()),
               f32_logits_max_abs_err=err32, f32_state_max_abs_err=st_err)
    log("small prefill:", json.dumps(row))
    if not (err16 <= bound16 and same and ok32 and st_ok):
        raise AssertionError(f"small prefill {name}: kernels vs plain {row}")
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 14: LM training on the card (granite-moe-1b-a400m)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-moe-1b-a400m"
#: K3-bwd's shapes: (b, hq, hkv, sq, skv, dh, causal, window, q_offset).
K3B_SHAPES = {
    "granite-moe training": (2, 16, 8, 4096, 4096, 64, True, None, 0),
    "hymba swa": (4, 25, 5, 2048, 2048, 64, True, 1024, 0),
    "whisper encoder": (4, 16, 16, 1500, 1500, 64, False, None, 0),
    "dh 32, q_offset": (2, 8, 2, 1000, 1100, 32, True, None, 100),
    "phi-3-vision training": (2, 32, 32, 4096, 4096, 96, True, None, 0),
    "kimi-k2 training": (1, 64, 8, 4096, 4096, 112, True, None, 0),
    "starcoder2 training": (2, 36, 4, 4096, 4096, 128, True, None, 0),
    "command-r training": (1, 64, 8, 4096, 4096, 128, True, None, 0),
    "qwen2.5-32b training": (2, 40, 8, 4096, 4096, 128, True, None, 0),
    "granite-20b training": (2, 48, 1, 4096, 4096, 128, True, None, 0),
}
#: Phase 14 (b): each gradient leaf's relative L2 against the plain
#: versions' (beside max |err| <= 1e-4 max(1, max |g|)): loose enough for a
#: token routed to another expert by a last-bit difference, far below the
#: 1.0 of a leaf whose gradient was dropped.
GRAD_REL_L2 = 1e-2
#: Phase 14 (c): the full-width run, and the 2-layer resume check.
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "6", "--global-batch", "4",
              "--seq-len", "4096", "--grad-accum", "2", "--seed", "0",
              "--log-every", "1"]
RESUME_ARGV = ["--arch", TRAIN_ARCH, "--global-batch", "4", "--seq-len",
               "4096", "--grad-accum", "2", "--seed", "0", "--log-every", "1",
               "--d-model", "1024", "--d-ff", "512", "--n-layers", "2"]


def plain_lse(q, k, causal, window, q_offset):
    """torch.logsumexp of the masked f32 logits, one batch row at a time."""
    import torch

    from repro_torch.kernels import ref

    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    mask = ref._attn_mask(sq, 0, skv, causal, window, q_offset, q.device)
    out = []
    for i in range(b):
        qg = q[i].float().reshape(hkv, hq // hkv, sq, dh) / float(dh) ** 0.5
        logits = torch.einsum("hgqd,hkd->hgqk", qg, k[i].float())
        logits = logits.masked_fill(~mask, float("-inf"))
        out.append(torch.logsumexp(logits, dim=-1).reshape(hq, sq))
        del logits
    return torch.stack(out)


def sdpa_backward_ms(q, k, v, do, causal, window, q_offset) -> float:
    """``scaled_dot_product_attention(enable_gqa=True)`` forward plus
    backward, minus its forward, ms per call: ``is_causal`` where the
    queries start at key 0, a boolean mask otherwise."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    sq, skv = q.shape[2], k.shape[2]
    kw = {}
    if causal and window is None and q_offset == 0 and sq == skv:
        kw["is_causal"] = True
    elif causal or window is not None:
        kw["attn_mask"] = ref._attn_mask(sq, 0, skv, causal, window,
                                         q_offset, q.device)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True,
                                              **kw)

    def fwd_bwd():
        fwd().backward(do)

    return cuda_ms(fwd_bwd, reps=5) - cuda_ms(fwd, reps=5)


def check_k3_bwd(dev) -> list:
    """Phase 14 (a): K3-bwd against its plain twin at ``K3B_SHAPES`` in
    bf16 (the tensor-core kernels) and f32 (the CUDA-core kernels); two
    launches bit for bit; the planted fault (every q block dropping its
    last visible kv block) caught; lse against ``torch.logsumexp``; times
    beside the bound, the plain twin's and SDPA's backward; K3's forward
    with and without the lse store."""
    import torch

    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for name, (b, hq, hkv, sq, skv, dh, causal, window, q_offset) in \
            K3B_SHAPES.items():
        for dtype, peak in ((torch.bfloat16, BF16_TC_OPS_PER_S),
                            (torch.float32, F32_OPS_PER_S)):
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                           .to(dtype) for shape in (
                               (b, hq, sq, dh), (b, hkv, skv, dh),
                               (b, hkv, skv, dh), (b, hq, sq, dh)))
            mask = (causal, window, q_offset)
            o, lse = flash_attention.flash_attention_cuda(
                q, k, v, *mask, return_lse=True)
            lse_err = float((lse - plain_lse(q, k, *mask)).abs().max())
            if not lse_err <= 1e-5:
                raise AssertionError(f"K3 lse {name} {dtype}: err {lse_err}")

            def run(fault=0):
                return flash_attention_bwd.flash_attention_bwd_cuda(
                    q, k, v, o, lse, do, *mask, fault=fault)

            def plain():
                return ref.flash_attention_bwd(
                    q.float(), k.float(), v.float(), o.float(), lse,
                    do.float(), *mask)

            variant = (flash_attention_bwd.LAUNCHES_TC
                       if dtype == torch.bfloat16
                       else flash_attention_bwd.LAUNCHES_F32)
            before = variant.count
            got, again, want = run(), run(), plain()
            if variant.count != before + 2:
                raise AssertionError(f"K3-bwd {name} {dtype}: not the "
                                     f"{variant.name} kernels")
            bad = run(flash_attention_bwd.FAULT_DROP_LAST_KV_BLOCK)
            torch.cuda.synchronize()
            errs, fault_caught = {}, True
            for g_name, g, g2, w, gb in zip("qkv", got, again, want, bad):
                if not torch.equal(g, g2):
                    raise AssertionError(f"K3-bwd {name} {dtype}: d{g_name} "
                                         "differs between two launches")
                scale = max(1.0, float(w.abs().max()))
                err = float((g.float() - w).abs().max())
                rel = rel_l2(g, w)
                ok = (err <= 1e-4 * scale if dtype == torch.float32
                      else rel <= 2 ** -7)
                bad_ok = (float((gb.float() - w).abs().max()) <= 1e-4 * scale
                          if dtype == torch.float32
                          else rel_l2(gb, w) <= 2 ** -7)
                fault_caught &= not bad_ok
                if not ok:
                    raise AssertionError(f"K3-bwd {name} {dtype}: d{g_name} "
                                         f"max err {err}, rel L2 {rel}")
                errs[f"d{g_name}"] = dict(max_abs_err=err, rel_l2=rel)
            if not fault_caught:
                raise AssertionError(f"K3-bwd {name} {dtype}: the check "
                                     "passed the planted fault")
            pairs = attn_live_pairs(sq, skv, causal, window, q_offset)
            n_ops = 10 * dh * pairs * b * hq
            n_bytes = q.element_size() * 2 * (3 * q.numel() + 2 * k.numel()) \
                + 4 * lse.numel()
            bnd, by = bound_ms(n_bytes, n_ops, peak)
            row = dict(shape=name, dtype=str(dtype).split(".")[-1],
                       dims=[b, hq, hkv, sq, skv, dh], causal=causal,
                       window=window, q_offset=q_offset,
                       live_pairs_per_head=pairs, errors=errs,
                       max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                       lse_max_abs_err=lse_err, planted_fault_caught=True,
                       deterministic=True, ms=cuda_ms(run, reps=5),
                       plain_ms=cuda_ms(plain, reps=1, warmup=1),
                       library_ms=sdpa_backward_ms(q, k, v, do, *mask),
                       bound_ms=bnd, bound_by=by)
            if name == "granite-moe training":
                # K3's forward at the training shape: the serving instance,
                # the lse-storing one, its plain version and SDPA.
                import torch.nn.functional as F

                row["k3_forward_ms"] = cuda_ms(
                    lambda: flash_attention.flash_attention_cuda(q, k, v,
                                                                 *mask),
                    reps=10)
                row["k3_forward_with_lse_ms"] = cuda_ms(
                    lambda: flash_attention.flash_attention_cuda(
                        q, k, v, *mask, return_lse=True), reps=10)
                row["k3_forward_plain_ms"] = cuda_ms(
                    lambda: ref.flash_attention(q, k, v, *mask, True),
                    reps=1, warmup=1)
                row["k3_forward_library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), reps=10)
                row["k3_forward_bound_ms"] = bound_ms(
                    q.element_size() * (2 * q.numel() + 2 * k.numel()),
                    4 * dh * pairs * b * hq, peak)[0]
            rows.append(row)
            log("K3-BWD", json.dumps(row))
            del q, k, v, do, o, lse, got, again, want, bad
        torch.cuda.empty_cache()
    return rows


#: Phase 14 (a): K4-bwd's shapes, each config's training microbatch (b, s)
#: = (2, 4096) at chunk 128: config -> decay cases (the scale of a =
#: -|N(0, 1)| * scale: mild, and strong, where exp(cum) underflows within a
#: chunk).
K4B_SHAPES = {"hymba-1.5b": (0.3, 3.0), "mamba2-2.7b": (0.3, 3.0)}
#: Each leaf's relative L2 and max |err| / max(1, max |plain|) against the
#: plain twin: the reference sweep's SSD atol (tests/test_torch_lm_kernels.py).
K4B_TOL = 1e-4


def ssd_bwd_ops(b: int, s: int, nh: int, dh: int, ds: int, chunk: int,
                g: int | None = None) -> tuple[float, float]:
    """Operations of the scan's gradient, counting only the causal (t, j)
    pairs -> ``(products, all)``: per chunk and head, 2 dh multiply-adds
    per pair (P = dy x^T and dx) and one exp, 3 ds per pair (G = C B^T and
    the dB, dC products) and 4 L dh ds multiply-adds for the state terms
    (U = sum e^{cum} dy C^T, the entering state's part of dC, the leaving
    state's of dx and dB).  G, dB and dC depend on a head only through
    the sum over its group of P D: with ``g`` they are counted once per
    group (the least work), without it once per head (PR 22's count)."""
    pairs = chunk * (chunk + 1) // 2
    per_head = 2 * pairs * 2 * dh + 8 * chunk * dh * ds
    per_ds = 2 * pairs * 3 * ds
    n_ds = nh if g is None else g
    prods = float(b * (s // chunk) * (nh * per_head + n_ds * per_ds))
    return prods, prods + b * (s // chunk) * nh * pairs


def k4b_inputs(dev, arch: str, a_scale: float, b: int = 2, s: int = 4096):
    """K4-bwd's inputs at ``arch``'s training microbatch from a seed: x,
    a = -|N(0, 1)| * a_scale, B, C (as ``k4_inputs``), dy and dfinal, and
    the forward's cum, entering states and final state (K4's own)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ssd

    cfg = configs.get(arch).make_config()
    nh, dh = cfg.n_ssm_heads, cfg.ssm_head_dim
    g, ds = cfg.ssm_groups, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(22)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, a = draw(b, s, nh, dh) * 0.3, -draw(b, s, nh).abs() * a_scale
    bm, cm = draw(b, s, g, ds) * 0.3, draw(b, s, g, ds) * 0.3
    dy, dfin = draw(b, s, nh, dh), draw(b, nh, dh, ds)
    _, s_fin, cum, s_prev = ssd.ssd_passes_cuda(x, a, bm, cm, 128)
    return x, a, bm, cm, cum, s_prev, s_fin, dy, dfin


def k4b_pass_pairs(inp, chunk: int = 128) -> list:
    """Each of K4-bwd's five passes against its plain twin on the kernel's
    own inputs to it (a call stopped after that pass): (name, kernel,
    twin) triples."""
    from repro_torch.kernels import ref, ssd_bwd

    x, a, bm, cm, cum, s_prev, s_fin, dy, dfin = inp
    one, two, three, four, five = (
        ssd_bwd.ssd_bwd_passes_cuda(*inp, chunk, passes=n)
        for n in range(1, ssd_bwd.DEVICE_LAUNCHES + 1))
    u, dcp, dcum = ref.ssd_bwd_chunk_states(dy, cm, cum, s_prev, chunk)
    dsn = ref.ssd_bwd_state_pass(cum, one[4], dfin, chunk)
    dx3, dcum3, dbp3, dcp3 = ref.ssd_bwd_chunk(x, bm, cm, dy, cum, one[5],
                                               one[7], chunk)
    dx4, da4, dbp4 = ref.ssd_bwd_state_terms(x, bm, cum, s_prev, s_fin,
                                             two[4], three[0], three[5],
                                             three[6], chunk)
    db5, dc5 = ref.ssd_bwd_slice_sum(four[6], four[7])
    return [("pass1_u", one[4], u), ("pass1_dcp", one[7], dcp),
            ("pass1_dcum", one[5], dcum), ("pass2_dstate", two[4], dsn),
            ("pass3_dx", three[0], dx3), ("pass3_dcum", three[5], dcum3),
            ("pass3_dbp", three[6], dbp3), ("pass3_dcp", three[7], dcp3),
            ("pass4_dx", four[0], dx4), ("pass4_da", four[1], da4),
            ("pass4_dbp", four[6], dbp4), ("pass5_db", five[2], db5),
            ("pass5_dc", five[3], dc5)]


def check_k4_bwd(dev) -> list:
    """Phase 14 (a): K4-bwd against its plain twin ``ref.ssd_scan_bwd`` at
    hymba's and mamba2's training microbatch, chunk 128, mild and strong
    decay, on the same inputs (K4's own cum and states): every leaf within
    relative L2 ``K4B_TOL`` and max |err| <= ``K4B_TOL`` max(1, max
    |plain|); each of the five passes against its plain twin on the
    kernel's own inputs to it; two launches bit for bit; the planted fault
    (each j tile skipping its last t tile) caught; the scratch bytes of a
    call; ms per call beside the bounds and the plain twin's ms (mild
    decay).  No single PyTorch call computes the scan's gradient, so
    ``library_ms`` is null."""
    import torch

    from repro_torch.kernels import ref, ssd_bwd

    rows = []
    for arch, scales in K4B_SHAPES.items():
        for a_scale in scales:
            inp = k4b_inputs(dev, arch, a_scale)
            x, a, bm, cm, cum, s_prev, s_fin, dy, dfin = inp

            def run(fault=0):
                return ssd_bwd.ssd_scan_bwd_cuda(*inp, 128, fault=fault)

            def plain():
                return ref.ssd_scan_bwd(*inp, 128)

            got, again, want = run(), run(), plain()
            bad = run(ssd_bwd.FAULT_DROP_LAST_T_BLOCK)
            passes = {name: (g, w) for name, g, w in k4b_pass_pairs(inp)}
            torch.cuda.synchronize()
            errs, fault_caught = {}, False
            for name, (g, w) in [(f"d{n}", (g, w)) for n, g, w in zip(
                    ("x", "a", "bmat", "cmat"), got, want)] + list(
                    passes.items()):
                scale = max(1.0, float(w.abs().max()))
                errs[name] = dict(max_abs_err=float((g - w).abs().max()),
                                  rel_l2=rel_l2(g, w))
                if not (errs[name]["max_abs_err"] <= K4B_TOL * scale
                        and errs[name]["rel_l2"] <= K4B_TOL):
                    raise AssertionError(f"K4-bwd {arch} a x {a_scale}: "
                                         f"{name} {errs[name]}")
            for g, g2, w, gb in zip(got, again, want, bad):
                if not torch.equal(g, g2):
                    raise AssertionError(f"K4-bwd {arch} a x {a_scale}: two "
                                         "launches differ")
                fault_caught |= rel_l2(gb, w) > K4B_TOL
            if not fault_caught:
                raise AssertionError(f"K4-bwd {arch} a x {a_scale}: the "
                                     "check passed the planted fault")
            b, s, nh, dh = x.shape
            g, ds = bm.shape[2], bm.shape[3]
            row = dict(arch=arch, a_scale=a_scale, shape=[b, s, nh, dh, g,
                                                          ds],
                       chunk=128, dfinal=True, errors=errs,
                       max_abs_err=max(errs[f"d{n}"]["max_abs_err"]
                                       for n in ("x", "a", "bmat", "cmat")),
                       rel_l2=max(errs[f"d{n}"]["rel_l2"]
                                  for n in ("x", "a", "bmat", "cmat")),
                       tolerance=K4B_TOL, deterministic=True,
                       planted_fault_caught=True,
                       scratch_bytes=ssd_bwd.scratch_bytes(b, s, nh, g, dh,
                                                         ds))
            if a_scale == scales[0]:
                n_bytes = 4 * (3 * x.numel() + 2 * cum.numel()
                               + 4 * bm.numel() + s_prev.numel()
                               + 2 * s_fin.numel())
                _, ops_head = ssd_bwd_ops(b, s, nh, dh, ds, 128)
                prods, ops_group = ssd_bwd_ops(b, s, nh, dh, ds, 128, g)
                bnd, by = bound_ms(n_bytes, 3 * prods, TF32_OPS_PER_S)
                row.update(ms=cuda_ms(run, reps=10),
                           plain_ms=cuda_ms(plain, reps=2, warmup=1),
                           library_ms=None, bound_ms=bnd, bound_by=by,
                           bound_f32_ms=bound_ms(n_bytes, ops_head)[0],
                           bound_f32_group_ms=bound_ms(n_bytes,
                                                       ops_group)[0],
                           bound_note="bound_ms: 3 TF32 products each at "
                                      "495 TFLOP/s, G / dB / dC once per "
                                      "group, or the bytes; bound_f32_ms: "
                                      "PR 22's f32 count at 67 TFLOP/s; "
                                      "bound_f32_group_ms: that count with "
                                      "G / dB / dC once per group")
            rows.append(row)
            log("K4-BWD", json.dumps(row))
            del inp, x, a, bm, cm, cum, s_prev, s_fin, dy, dfin, got, again
            del want, bad, passes
            torch.cuda.empty_cache()
    return rows


def _grads(cfg, model, batch) -> float:
    """The loss; the gradient is left in each parameter's ``.grad``."""
    from repro_torch.models import transformer as tfm

    for t in model.parameters():
        t.grad = None
    loss, _ = tfm.forward_train(cfg, model, batch)
    loss.backward()
    return float(loss.detach())


def _worst(model, want) -> tuple:
    """The worst leaf of ``model``'s ``.grad`` against ``want`` by the
    stated tolerance (max |err| over max(1, max |g|)), and by relative L2:
    most leaves' gradients are far below 1, where the first alone would
    pass a dropped gradient."""
    err = rel = 0.0
    for t, w in zip(model.parameters(), want):
        err = max(err, float((t.grad - w).abs().max())
                  / max(1.0, float(w.abs().max())))
        rel = max(rel, rel_l2(t.grad, w))
    return err, rel


#: Phase 14 (b): (config overrides, batch, sequence) of the full-width
#: 2-layer f32 steps; kimi-k2's 384 experts cut to 8 as phase 12 serves it.
#: hymba's and mamba2's 1100 steps are padded to 1152 for the scan.
SMALL_STEPS = {
    TRAIN_ARCH: (dict(n_layers=2), 2, 1100),
    "phi-3-vision-4.2b": (dict(n_layers=2), 2, 600),
    "kimi-k2-1t-a32b": (dict(n_layers=2, n_experts=8), 2, 600),
    "starcoder2-7b": (dict(n_layers=2), 2, 600),
    "hymba-1.5b": (dict(n_layers=2), 2, 1100),
    "mamba2-2.7b": (dict(n_layers=2), 2, 1100),
}


@contextlib.contextmanager
def lm_kernels(plain: bool = False, k3_bwd=None, k4_bwd=None):
    """The four LM kernel entry points a train step reaches on the card (K3,
    K3-bwd, K4's passes, K4-bwd): their plain versions where ``plain``,
    else the kernels, with ``k3_bwd`` / ``k4_bwd`` in place of the backward
    kernels where given; restored on exit."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     ref, ssd, ssd_bwd)

    slots = [(flash_attention, "flash_attention_cuda", ref.flash_attention),
             (flash_attention_bwd, "flash_attention_bwd_cuda",
              ref.flash_attention_bwd),
             (ssd, "ssd_passes_cuda", ref.ssd_passes),
             (ssd_bwd, "ssd_scan_bwd_cuda", ref.ssd_scan_bwd)]
    real = [getattr(m, name) for m, name, _ in slots]
    try:
        for (m, name, twin), fn in zip(slots, real):
            setattr(m, name, twin if plain else fn)
        if k3_bwd is not None:
            flash_attention_bwd.flash_attention_bwd_cuda = k3_bwd
        if k4_bwd is not None:
            ssd_bwd.ssd_scan_bwd_cuda = k4_bwd
        yield
    finally:
        for (m, name, _), fn in zip(slots, real):
            setattr(m, name, fn)


def step_launches(cfg, per: int, dtype: str) -> dict:
    """The launch counts of a train step of ``cfg`` under remat "full" with
    ``per`` layer passes (layers x microbatches): K3 twice (the forward and
    the recompute) and K3-bwd once per attention layer, all on ``dtype``'s
    kernels; K4 twice and K4-bwd once per ssm layer."""
    attn = per if cfg.n_heads > 0 else 0
    scan = per if cfg.family in ("ssm", "hybrid") else 0
    other = "f32_cuda_cores" if dtype == "bf16_wgmma" else "bf16_wgmma"
    return {"flash_attention": 2 * attn, f"flash_attention_{dtype}": 2 * attn,
            f"flash_attention_{other}": 0, "flash_attention_bwd": attn,
            f"flash_attention_bwd_{dtype}": attn,
            f"flash_attention_bwd_{other}": 0, "ssd": 2 * scan,
            "ssd_bwd": scan, "ssd_scan_backward": scan}


def small_train_step(dev, arch: str) -> dict:
    """Phase 14 (b), one config of ``SMALL_STEPS`` in f32 with remat
    "full": loss and every gradient leaf through K3 / K3-bwd and K4 /
    K4-bwd against the same model with the plain versions on the card;
    every leaf's gradient finite and nonzero; K3-bwd with dq zeroed (models
    with attention) and K4-bwd with its planted fault (ssm / hybrid) fail
    the check; the launches of ``step_launches``.  Only the plain versions'
    gradients are kept beside the model's own."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention_bwd, ops, ssd_bwd
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import step as step_mod

    over, b, seq = SMALL_STEPS[arch]
    cfg = dataclasses.replace(configs.get(arch).make_config(), **over,
                              dtype="float32", remat="full")
    model = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 0,
                                      dev)["params"]
    rng = np.random.RandomState(14)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, seq + 1)),
                           device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    real_k3b = flash_attention_bwd.flash_attention_bwd_cuda
    with lm_kernels(plain=True):
        loss_p = _grads(cfg, model, batch)
    grads_p = [t.grad.clone() for t in model.parameters()]

    ops.reset_launches()
    loss = _grads(cfg, model, batch)
    counts = ops.launch_counts()
    names = [n for n, _ in model.named_parameters()]
    dead = [n for n, t in model.named_parameters()
            if not (torch.isfinite(t.grad).all() and t.grad.abs().max() > 0)]
    if dead:
        raise AssertionError(f"{arch}: no finite nonzero gradient on the "
                             f"card: {dead}")
    grad_err, grad_rel = _worst(model, grads_p)

    def dq_zeroed(*args, **kw):
        dq, dk, dv = real_k3b(*args, **kw)
        return torch.zeros_like(dq), dk, dv

    controls = {}
    if cfg.n_heads > 0:
        with lm_kernels(k3_bwd=dq_zeroed):
            _grads(cfg, model, batch)
        controls["k3_bwd_dq_zeroed"] = _worst(model, grads_p)
    if cfg.family in ("ssm", "hybrid"):
        with lm_kernels(k4_bwd=functools.partial(
                ssd_bwd.ssd_scan_bwd_cuda,
                fault=ssd_bwd.FAULT_DROP_LAST_T_BLOCK)):
            _grads(cfg, model, batch)
        controls["k4_bwd_fault"] = _worst(model, grads_p)

    loss_rel = abs(loss - loss_p) / abs(loss_p)
    if loss_rel > 1e-5 or grad_err > 1e-4 or grad_rel > GRAD_REL_L2:
        raise AssertionError(f"{arch} train step kernels vs plain: loss rel "
                             f"{loss_rel}, worst gradient {grad_err}, worst "
                             f"relative L2 {grad_rel}")
    for name, (bad_err, bad_rel) in controls.items():
        if bad_err <= 1e-4 and bad_rel <= GRAD_REL_L2:
            raise AssertionError(f"{arch}: the gradient check passed "
                                 f"{name}")
    want = step_launches(cfg, cfg.n_layers, "f32_cuda_cores")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{arch} small step launches {counts}")
    del model, grads_p
    torch.cuda.empty_cache()
    row = dict(config=f"{arch} full width, {cfg.n_layers} layers, f32, "
                      f"B {b}, S {seq}", cut=over, head_dim=cfg.head_dim,
               loss=loss, loss_rel_err=loss_rel,
               worst_grad_err_over_max=grad_err,
               worst_grad_rel_l2=grad_rel, leaves=len(names),
               controls_err_over_max_rel_l2=controls, launches=counts)
    log("TRAIN-SMALL", json.dumps(row))
    return row


def small_train_steps(dev) -> dict:
    """Phase 14 (b): every ``SMALL_STEPS`` config, then every
    ``BF16_STEPS`` config."""
    rows = {arch: small_train_step(dev, arch) for arch in SMALL_STEPS}
    bf16 = {arch: bf16_train_step(dev, arch) for arch in BF16_STEPS}
    return dict(steps=rows, bf16_steps=bf16)


#: Phase 14 (b), bf16: (config overrides, batch, sequence) of the
#: full-width 2-layer steps in the trainer's bf16 over f32 masters, at
#: ``TRAIN_RUNS``' microbatch shapes: dh 96, and dh 128 (K3-bwd's split
#: plan); and hymba's (SWA; K4 / K4-bwd in f32 inside the bf16 model).
BF16_STEPS = {
    "phi-3-vision-4.2b": (dict(n_layers=2), 2, 4096),
    "starcoder2-7b": (dict(n_layers=2), 2, 4096),
    "hymba-1.5b": (dict(n_layers=2), 2, 4096),
}
#: Each bf16 gradient leaf's relative L2 against the plain versions' (f32
#: attention rounded to bf16 once): 8x K3-bwd's own 2^-7 per call, for the
#: bf16 roundings both paths carry on through two layers and the loss; a
#: dropped dq puts a leaf at 1.  The loss within half a bf16 ulp, 2^-8.
BF16_GRAD_REL_L2 = 2 ** -4
BF16_LOSS_REL = 2 ** -8


def bf16_train_step(dev, arch: str) -> dict:
    """Phase 14 (b), one config of ``BF16_STEPS``: the loss and every
    gradient leaf through K3 / K3-bwd (and K4 / K4-bwd for hymba) against
    the same model with the plain versions on the card (``BF16_LOSS_REL``,
    ``BF16_GRAD_REL_L2``); each K3-bwd call of the step against the plain
    twin on its own inputs (dq, dk, dv within relative L2 2^-7, as phase 14
    (a)); K3-bwd with dq zeroed caught; the launches of
    ``step_launches``, K3's all tensor-core."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention_bwd, ops, ref
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import step as step_mod

    over, b, seq = BF16_STEPS[arch]
    cfg = dataclasses.replace(configs.get(arch).make_config(), **over)
    model = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 0,
                                      dev)["params"]
    rng = np.random.RandomState(14)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, seq + 1)),
                           device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    real_bwd = flash_attention_bwd.flash_attention_bwd_cuda
    calls = []

    def checked(q, k, v, o, lse, do, *mask):
        got = real_bwd(q, k, v, o, lse, do, *mask)
        want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), *mask)
        calls.append({f"d{n}": rel_l2(g, w)
                      for n, g, w in zip("qkv", got, want)})
        return got

    def dq_zeroed(*args):
        dq, dk, dv = real_bwd(*args)
        return torch.zeros_like(dq), dk, dv

    with lm_kernels(plain=True):
        loss_p = _grads(cfg, model, batch)
    grads_p = [t.grad.clone() for t in model.parameters()]
    with lm_kernels(k3_bwd=checked):
        ops.reset_launches()
        loss = _grads(cfg, model, batch)
        counts = ops.launch_counts()
    grad_err, grad_rel = _worst(model, grads_p)
    with lm_kernels(k3_bwd=dq_zeroed):
        _grads(cfg, model, batch)
    bad_err, bad_rel = _worst(model, grads_p)

    loss_rel = abs(loss - loss_p) / abs(loss_p)
    call_rel = max(max(c.values()) for c in calls)
    if loss_rel > BF16_LOSS_REL or grad_rel > BF16_GRAD_REL_L2 or \
            call_rel > 2 ** -7 or len(calls) != cfg.n_layers:
        raise AssertionError(f"{arch} bf16 step kernels vs plain: loss rel "
                             f"{loss_rel}, worst relative L2 {grad_rel}, "
                             f"K3-bwd calls against the twin {calls}")
    if bad_rel <= BF16_GRAD_REL_L2:
        raise AssertionError(f"{arch}: the bf16 gradient check passed K3-bwd "
                             "with dq zeroed")
    want = step_launches(cfg, cfg.n_layers, "bf16_wgmma")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{arch} bf16 step launches {counts}")
    del model, grads_p
    torch.cuda.empty_cache()
    row = dict(config=f"{arch} full width, {cfg.n_layers} layers, "
                      f"{cfg.dtype} over f32 masters, B {b}, S {seq}",
               cut=over, head_dim=cfg.head_dim, loss=loss, loss_plain=loss_p,
               loss_rel_err=loss_rel, worst_grad_err_over_max=grad_err,
               worst_grad_rel_l2=grad_rel, k3_bwd_calls_rel_l2=calls,
               dq_zeroed_err_over_max=bad_err, dq_zeroed_rel_l2=bad_rel,
               launches=counts)
    log("TRAIN-BF16", json.dumps(row))
    return row


def _step_groups(prof) -> tuple[dict, list]:
    """Device ms by kernel group of one traced training step, and the ten
    kernels that took the most."""
    from torch.autograd import DeviceType

    groups = {"K3 forward": 0.0, "K3-bwd": 0.0, "K4 forward": 0.0,
              "K4-bwd": 0.0, "cuBLAS GEMM": 0.0, "other": 0.0}
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (evt.time_range.end - evt.time_range.start) / 1e3
        name = evt.name
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += ms
        tot[1] += 1
        if "flash_kernel" in name or "flash_wgmma_kernel" in name:
            groups["K3 forward"] += ms
        elif "ssd_bwd_" in name:
            groups["K4-bwd"] += ms
        elif "ssd_" in name:
            groups["K4 forward"] += ms
        elif any(k in name for k in ("bwd_dot_kernel", "bwd_prep_kernel",
                                     "bwd_dkv_", "bwd_dq_")):
            groups["K3-bwd"] += ms
        elif any(t in name.lower() for t in ("gemm", "nvjet", "xmma",
                                                "cutlass")):
            groups["cuBLAS GEMM"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return groups, [[n[:90], t, c] for n, (t, c) in top]


def full_width_training(dev) -> dict:
    """Phase 14 (c): ``launch.train.main`` on granite-moe-1b-a400m at full
    width (6 steps of 4 x 4096 tokens, grad_accum 2, bf16 compute over f32
    masters, remat "full"): the launches of step 2 (counters zeroed after
    step 1), s/step (median of steps 2-6), tokens/s, peak memory, one
    traced step (step 6); then the resume check at 2 layers."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train

    losses, seen = _train_run(TRAIN_ARGV, {}, trace=True)
    peak_gb, traced = seen["peak_gb"], seen["traced"]
    want = step_launches(seen["cfg"], 2 * seen["cfg"].n_layers, "bf16_wgmma")
    got = {k: seen["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"full-width step launches {got}, want {want}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(seen["gnorm"])):
        raise AssertionError(f"non-finite loss / grad norm: {losses} "
                             f"{seen['gnorm']}")
    s_step = statistics.median(seen["s"][1:])
    tokens = 4 * 4096

    # The resume check at 2 layers: 4 steps, against 2 + save + restore +
    # 2, in one process (the restore builds a fresh train state).
    io = {"save_s": [], "save_bytes": [], "restore_s": [],
          "restore_bytes": []}
    real_save, real_restore = ckpt.save, ckpt.restore

    def timed_save(d, step, tree):
        t0 = time.perf_counter()
        path = real_save(d, step, tree)
        io["save_s"].append(time.perf_counter() - t0)
        io["save_bytes"].append(sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)))
        return path

    def timed_restore(d, tree_like):
        t0 = time.perf_counter()
        out = real_restore(d, tree_like)
        io["restore_s"].append(time.perf_counter() - t0)
        path = os.path.join(d, f"step_{out[0]:08d}")
        io["restore_bytes"].append(sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
            if f.endswith(".npy")))
        return out

    (ROOT / "build").mkdir(exist_ok=True)
    cont = train.main(RESUME_ARGV + ["--steps", "4"])
    try:
        ckpt.save, ckpt.restore = timed_save, timed_restore
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            first = train.main(RESUME_ARGV + ["--steps", "2", "--ckpt-dir", d])
            rest = train.main(RESUME_ARGV + ["--steps", "4", "--ckpt-dir", d])
    finally:
        ckpt.save, ckpt.restore = real_save, real_restore
    resumed = first + rest
    diff = max(abs(a - b) / abs(b) for a, b in zip(resumed[2:], cont[2:]))
    if len(resumed) != 4 or diff > 1e-3:
        raise AssertionError(f"resume: {resumed} vs continuous {cont}")
    torch.cuda.empty_cache()
    row = dict(argv=" ".join(TRAIN_ARGV), losses=losses,
               grad_norms=seen["gnorm"], step_s=seen["s"],
               s_per_step_median_2_6=s_step, tokens_per_s=tokens / s_step,
               peak_memory_gb=peak_gb, launches_step_2=got,
               traced_step_6=traced,
               resume=dict(argv=" ".join(RESUME_ARGV), continuous=cont,
                           resumed=resumed, last_two_max_rel_diff=diff,
                           bit_for_bit=resumed == cont,
                           deterministic_algorithms=False, **io))
    log("TRAIN", json.dumps(row))
    return row


#: Phase 14 (c), the six configs whose head dims the previous K3-bwd did
#: not take, through ``launch.train.main`` with 8-bit moments: name -> (batch
#: flags, config overrides).  phi-3-vision runs whole; the others at full
#: width and 2 layers (kimi-k2's experts cut to 8, as phase 12 serves it).
#: Microbatches of 2 x 4096 tokens, 1 x 4096 where the logits of a
#: 163,840 / 256,000-row vocabulary would not fit beside the state.
TRAIN_RUN_ARGV = ["--steps", "3", "--seq-len", "4096", "--seed", "0",
                  "--log-every", "1", "--opt8"]
TRAIN_RUNS = {
    "phi-3-vision-4.2b": (["--global-batch", "4", "--grad-accum", "2"], {}),
    "kimi-k2-1t-a32b": (["--global-batch", "2", "--grad-accum", "2"],
                        dict(n_layers=2, n_experts=8)),
    "starcoder2-7b": (["--global-batch", "4", "--grad-accum", "2"],
                      dict(n_layers=2)),
    "command-r-35b": (["--global-batch", "2", "--grad-accum", "2"],
                      dict(n_layers=2)),
    "qwen2.5-32b": (["--global-batch", "4", "--grad-accum", "2"],
                    dict(n_layers=2)),
    "granite-20b": (["--global-batch", "4", "--grad-accum", "2"],
                    dict(n_layers=2)),
}


def _train_run(argv: list, over: dict, trace: bool = False
               ) -> tuple[list, dict]:
    """``launch.train.main(argv)`` with its config builder wrapped to apply
    ``over`` -> the losses, and per step the seconds and grad norms, the
    parameter count, the launches of step 2 (counters zeroed after step 1)
    and the peak memory; with ``trace``, the last step traced
    (``torch.profiler``): its wall ms and device ms by kernel group."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    seen: dict = {"s": [], "gnorm": []}
    steps = int(argv[argv.index("--steps") + 1])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    real_build = train.build

    def build(args):
        cfg, oc = real_build(args)
        seen["cfg"] = dataclasses.replace(cfg, **over)
        return seen["cfg"], oc

    def on_step(step, state, m, seconds):
        seen["s"].append(seconds)
        seen["gnorm"].append(float(m["grad_norm"]))
        if step == 0:
            seen["params"] = sum(t.numel()
                                 for t in state["params"].parameters())
            ops.reset_launches()
        elif step == 1:
            seen["launches"] = ops.launch_counts()
        if trace and step == steps - 2:
            torch.cuda.synchronize()
            prof.start()
            seen["t_traced"] = time.perf_counter()
        elif trace and step == steps - 1:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - seen["t_traced"]) * 1e3
            prof.stop()
            groups, top = _step_groups(prof)
            busy = sum(groups.values())
            seen["traced"] = dict(
                step=steps, wall_ms=wall, device_ms=groups,
                device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
                top_kernels_ms_launches=top) if busy > 0 else dict(
                step=steps, wall_ms=wall, device="not measured")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        train.build = build
        losses = train.main(argv, on_step=on_step)
    finally:
        train.build = real_build
    seen["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return losses, seen


def large_head_dim_training(dev) -> dict:
    """Phase 14 (c), the configs of ``TRAIN_RUNS``: 3 steps each through
    ``launch.train.main`` (its config builder wrapped to apply the
    overrides): finite losses and grad norms; in step 2 exactly 2 K3
    forward launches (the forward and remat's recompute, all tensor-core)
    and 1 K3-bwd (tensor-core) per layer and microbatch, 0 K4; s/step
    (step 2 and 3), tokens/s and peak memory."""
    import numpy as np

    rows = {}
    for arch, (flags, over) in TRAIN_RUNS.items():
        argv = ["--arch", arch] + flags + TRAIN_RUN_ARGV
        losses, seen = _train_run(argv, over)
        cfg = seen["cfg"]
        accum = int(flags[flags.index("--grad-accum") + 1])
        gb = int(flags[flags.index("--global-batch") + 1])
        per = cfg.n_layers * accum
        want = {"flash_attention": 2 * per, "flash_attention_bf16_wgmma":
                2 * per, "flash_attention_f32_cuda_cores": 0,
                "flash_attention_bwd": per,
                "flash_attention_bwd_bf16_wgmma": per,
                "flash_attention_bwd_f32_cuda_cores": 0, "ssd": 0}
        got = {k: seen["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"{arch}: step 2 launches {got}, want {want}")
        if not (all(np.isfinite(losses)) and all(np.isfinite(seen["gnorm"]))):
            raise AssertionError(f"{arch}: non-finite loss / grad norm: "
                                 f"{losses} {seen['gnorm']}")
        s_step = float(np.median(seen["s"][1:]))
        rows[arch] = dict(
            argv=" ".join(argv), overrides=over, n_layers=cfg.n_layers,
            d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
            head_dim=cfg.head_dim, parallel_block=cfg.parallel_block,
            params=seen["params"], losses=losses,
            grad_norms=seen["gnorm"], step_s=seen["s"],
            s_per_step_median_2_3=s_step, tokens_per_s=gb * 4096 / s_step,
            peak_memory_gb=seen["peak_gb"], launches_step_2=got)
        log("TRAIN-CONFIG", json.dumps(rows[arch]))
    return rows


#: Phase 14 (c), the ssm and hybrid configs through ``launch.train.main``,
#: whole (hymba-1.5b: 32 layers, mamba2-2.7b: 64), 4 x 4096 tokens per step,
#: grad_accum 2: name -> (steps, flags).  mamba2's f32 AdamW moments do not
#: fit beside its 2.83 B f32 masters and gradients on 80 GB (the update of
#: a stacked in_proj leaf asked for 6.46 GiB more at 69.09 GiB allocated),
#: so it runs with 8-bit moments.
SSM_TRAIN_RUNS = {"hymba-1.5b": (6, []), "mamba2-2.7b": (3, ["--opt8"])}
SSM_TRAIN_ARGV = ["--global-batch", "4", "--seq-len", "4096", "--grad-accum",
                  "2", "--seed", "0", "--log-every", "1"]


def ssm_training(dev) -> dict:
    """Phase 14 (c), the configs of ``SSM_TRAIN_RUNS``: finite losses and
    grad norms; in step 2 exactly the launches of ``step_launches`` over 2
    microbatches (remat "full": K3 twice and K3-bwd once per attention
    layer, all tensor-core; K4 twice and K4-bwd once per layer); s/step
    (median of steps 2 on), tokens/s, peak memory and the last step traced,
    with K4-bwd's device ms."""
    import numpy as np

    rows = {}
    for arch, (steps, flags) in SSM_TRAIN_RUNS.items():
        argv = ["--arch", arch, "--steps", str(steps), *SSM_TRAIN_ARGV,
                *flags]
        losses, seen = _train_run(argv, {}, trace=True)
        cfg = seen["cfg"]
        want = step_launches(cfg, 2 * cfg.n_layers, "bf16_wgmma")
        got = {k: seen["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"{arch}: step 2 launches {got}, want {want}")
        if not (all(np.isfinite(losses)) and all(np.isfinite(seen["gnorm"]))):
            raise AssertionError(f"{arch}: non-finite loss / grad norm: "
                                 f"{losses} {seen['gnorm']}")
        s_step = float(np.median(seen["s"][1:]))
        rows[arch] = dict(
            argv=" ".join(argv), n_layers=cfg.n_layers, d_model=cfg.d_model,
            ssm=[cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                 cfg.ssm_state], params=seen["params"], losses=losses,
            grad_norms=seen["gnorm"], step_s=seen["s"],
            s_per_step_median_from_2=s_step, tokens_per_s=4 * 4096 / s_step,
            peak_memory_gb=seen["peak_gb"], launches_step_2=got,
            traced_last_step=seen["traced"])
        log("TRAIN-SSM", json.dumps(rows[arch]))
    return rows


#: Phase 14 (c): the config whose three steps are run again with the plain
#: attention swapped in, and with f32 moments in place of 8-bit ones, to
#: tell whose the loss's rise at step 2 is: K3 / K3-bwd's, the 8-bit
#: moments' or AdamW's first steps'.
RISE_ARCH = "starcoder2-7b"


def loss_rise_runs(kernels_row: dict) -> dict:
    """Phase 14 (c): ``RISE_ARCH``'s ``TRAIN_RUNS`` argv with the plain
    versions of K3 / K3-bwd on the card, and with the kernels and f32
    moments; step 1's loss through the plain versions within
    ``BF16_LOSS_REL`` of the kernels' (``kernels_row``); the three runs'
    losses and grad norms side by side."""
    flags, over = TRAIN_RUNS[RISE_ARCH]
    argv = ["--arch", RISE_ARCH] + flags + TRAIN_RUN_ARGV
    with lm_kernels(plain=True):
        plain, plain_seen = _train_run(argv, over)
    f32_moments, f32_seen = _train_run([a for a in argv if a != "--opt8"],
                                       over)
    rel = abs(plain[0] - kernels_row["losses"][0]) / abs(plain[0])
    if rel > BF16_LOSS_REL:
        raise AssertionError(f"{RISE_ARCH}: step 1 loss through the plain "
                             f"versions {plain[0]} vs the kernels' "
                             f"{kernels_row['losses'][0]}")
    row = dict(argv=" ".join(argv),
               losses={"kernels, 8-bit moments": kernels_row["losses"],
                       "plain attention, 8-bit moments": plain,
                       "kernels, f32 moments": f32_moments},
               grad_norms={"kernels, 8-bit moments": kernels_row[
                               "grad_norms"],
                           "plain attention, 8-bit moments":
                               plain_seen["gnorm"],
                           "kernels, f32 moments": f32_seen["gnorm"]},
               step_1_loss_rel_err=rel)
    log("TRAIN-RISE", json.dumps(row))
    return row


def training_phase(dev) -> dict:
    """Phase 14: (a) K3-bwd and K4-bwd, (b) small steps kernels vs plain
    (f32 and bf16), (c) the full-width run, the resume check, the six
    large-head-dim configs, the ssm / hybrid configs and the loss-rise
    runs."""
    rows = dict(k3_bwd=check_k3_bwd(dev), k4_bwd=check_k4_bwd(dev),
                small=small_train_steps(dev), full=full_width_training(dev),
                configs=large_head_dim_training(dev),
                ssm=ssm_training(dev))
    rows["rise"] = loss_rise_runs(rows["configs"][RISE_ARCH])
    return rows


# ---------------------------------------------------------------------------
# Phase 13: static analysis on the card
# ---------------------------------------------------------------------------

BASELINE_TORCH = ROOT / "analysis_baseline_torch.json"


def unwaived(findings, waivers) -> list:
    """The findings no waiver of the port's baseline covers."""
    return [f for f in findings if not any(w.covers(f) for w in waivers)]


def budget_pass(recorded: dict) -> tuple[dict, list]:
    """Every recorded kernel call: the mirror = the library's plan (else
    ``check_calls`` raises), and each instance's attributes, one line per
    instance.  Returns ``{library: {instance: budget fields}}`` and the
    findings."""
    from repro_torch.analysis import kernel_budget

    calls = [(lib, "phases 2-12, 14", args)
             for lib, seen in recorded.items() for args in sorted(seen)]
    if {lib for lib, _, _ in calls} != set(kernel_budget.LIBRARIES):
        raise AssertionError(f"a kernel was not recorded: "
                             f"{ {k: len(v) for k, v in recorded.items()} }")
    findings, info = kernel_budget.check_calls(calls, on_card=True)
    budgets: dict = {lib: {} for lib in kernel_budget.LIBRARIES}
    for r in info["launches"]:
        b = budgets[r["library"]].setdefault(r["kernel"], dict(
            registers=r["registers"], static_smem=r["static_smem"],
            local_bytes=r["local_bytes"], threads=math.prod(r["block"]),
            dynamic_smem=set(), ctas_per_sm=set(), shapes=0))
        b["dynamic_smem"].add(r["dynamic_smem"])
        b["ctas_per_sm"].add((r["dynamic_smem"], r["ctas_per_sm"]))
        b["shapes"] += 1
    for lib, insts in budgets.items():
        for name, b in sorted(insts.items()):
            b["dynamic_smem"] = sorted(b["dynamic_smem"])
            b["ctas_per_sm"] = [c for _, c in sorted(b["ctas_per_sm"])]
            log(f"BUDGET[{lib}] {name}: {b['registers']} registers x "
                f"{b['threads']} threads, static {b['static_smem']} B, "
                f"dynamic {b['dynamic_smem']} B, spills (local) "
                f"{b['local_bytes']} B, CTAs per SM {b['ctas_per_sm']}, "
                f"{b['shapes']} launch shapes")
    log(f"budget pass: {len(calls)} recorded calls, "
        f"{sum(len(v) for v in budgets.values())} instances, card "
        f"{info['sm_count']} SMs, {info['smem_optin']} B opt-in")
    for c in info["fused_vs_oracle"]:
        log("FUSED-VS-ORACLE", json.dumps(c))
    return budgets, findings


def full_width_entries(dev, fits: dict, har12, fleet) -> list:
    """Phase 13's dispatch-pass entry points at the paths' full widths."""
    import numpy as np
    import torch

    from repro_torch.analysis.entrypoints import EntryPoint
    from repro_torch.core import dse, mcstream, trainer
    from repro_torch.data import datasets
    from repro_torch.serving import SVMEngine

    api = "src/repro_torch/api/compiled.py"
    entries = []
    xq = torch.as_tensor(np.ascontiguousarray(
        datasets.load("har12").x_test, np.float32), device=dev)
    for target in ("circuit", "rbf"):
        votes = har12.deploy(target)
        dag = har12.deploy(target, decider="dag")
        entries.append(EntryPoint(f"CompiledMachine.forward[har12 {target}]",
                                  api, lambda m=votes: m.forward(xq)))
        entries.append(EntryPoint(
            f"CompiledMachine._labels_dag[har12 {target}]", api,
            lambda m=dag: m._labels_dag(xq)))

    tests = fleet_tests(fleet.model_ids)
    engine = SVMEngine(fleet, max_batch=256, min_bucket=256)
    engine._order_after_banks()
    slot = engine._staging[256][0]
    rng = np.random.RandomState(5)
    ids = rng.randint(fleet.n_models, size=256)
    slot.xv[:] = 0.0
    for r, i in enumerate(ids):
        pool = tests[fleet.model_ids[i]]
        slot.xv[r, :pool.shape[1]] = pool[rng.randint(len(pool))]
    slot.iv[:] = ids
    entries.append(EntryPoint(
        "SVMEngine._forward[rbf fleet, bucket 256]",
        "src/repro_torch/serving/svm_engine.py",
        lambda: engine._forward(slot), engine=engine))

    est = fits["balance"]
    ds = datasets.load("balance")
    sm = est.stream_machine(0, method="sobol", mc_chunk=2048)
    x64 = torch.as_tensor(ds.x_test[:64], dtype=torch.float32, device=dev)
    y64 = torch.as_tensor(ds.y_test[:64].astype("int64"), device=dev)
    a = torch.as_tensor(dse.assignment_from_kernel_map(
        est.kernel_map_)[None, :].astype("int32"), device=dev)
    b = sm.mc_chunk
    v_idx = torch.arange(b, 2 * b, device=dev)
    u = sm._uniforms(b, b)
    valid = torch.ones(b, device=dev)
    state = mcstream.init_stream(1, mcstream.hist_bins(64), dev)

    def chunk():
        acc, w, lr = sm._chunk_acc(x64, v_idx, a, y64, u)
        return mcstream.update_stream(state, acc, w, valid, 0.8, log_ref=lr)

    entries.append(EntryPoint("StreamingMCMachine._chunk_bits[balance "
                              "sobol chunk 2048] + update_stream", api,
                              chunk))

    padded = trainer.pad_pairs(ds.x_train, ds.y_train, ds.n_classes,
                               n_folds=5, seed=0)
    x, y, folds, valid_p = trainer._pair_tensors(padded, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    gammas = torch.as_tensor(trainer.DEFAULT_RBF_GAMMAS, **f32)
    cs = torch.as_tensor(trainer.DEFAULT_CS, **f32)
    entries.append(EntryPoint(
        "trainer._cv_grid_all_pairs[balance rbf, 100 epochs]",
        "src/repro_torch/core/trainer.py",
        lambda: trainer._cv_grid_all_pairs(x, y, folds, valid_p, gammas, cs,
                                           "rbf", 100)))
    return entries


def k4b_tensor_cores() -> dict:
    """Tensor-core instructions (``HMMA`` / ``HGMMA``) of each K4-bwd
    kernel instance in the built library's SASS (``cuobjdump -sass``):
    every instance of the three passes that compute products must have
    some, the state pass and the slice sum none."""
    import re
    import shutil

    from repro_torch.kernels import build

    lib = build.build_all()["ssd_bwd"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(
                r"(ssd_bwd_[a-z_]+?_kernel)(?:ILi(\d+)ELi(\d+)E)?", line)
            name = None if m is None else (
                f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m.group(2)
                else m.group(1))
            if name is not None:
                counts.setdefault(name, 0)
        elif name is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    products = {k: v for k, v in counts.items()
                if not k.startswith(("ssd_bwd_state_pass",
                                     "ssd_bwd_slice_sum"))}
    if len(products) != 30 or min(products.values()) <= 0:
        raise AssertionError(f"K4-bwd instances without tensor-core "
                             f"instructions: {counts}")
    log("K4-BWD-SASS", json.dumps(counts))
    return counts


def static_analysis_phase(dev, recorded: dict, fits: dict, har12,
                          fleet) -> dict:
    """Phase 13: the budget pass on every recorded launch, the dispatch
    pass at full width, then the analyzer's own CLI on the card."""
    from repro_torch.analysis import dispatch_checks
    from repro_torch.analysis.report import load_baseline

    waivers = load_baseline(str(BASELINE_TORCH))
    budgets, findings = budget_pass(recorded)
    rows = []
    for entry in full_width_entries(dev, fits, har12, fleet):
        t0 = time.perf_counter()
        fnds, info = dispatch_checks.run_entrypoint(entry, on_card=True)
        findings += fnds
        row = dict(symbol=entry.symbol, syncs=info.get("card_syncs"),
                   sync_ops=info.get("sync_ops"), f64_ops=info.get("f64_ops"),
                   aten_ops=info.get("ops"),
                   htod_bytes_per_call=info.get("htod_bytes_per_call"),
                   live_allocations_100=(info.get("slot_reuse") or {}).get(
                       "live_allocations"),
                   findings=[f"{f.rule}: {f.message}" for f in fnds],
                   seconds=time.perf_counter() - t0)
        log("DISPATCH", json.dumps(row))
        rows.append(row)
    new = unwaived(findings, waivers)
    for line in sorted({f"[{'NEW' if f in new else 'waived'}] {f.rule} "
                        f"{f.path} ({f.symbol}): {f.message}"
                        for f in findings}):
        log(line)
    if new:
        raise AssertionError(f"{len(new)} unwaived finding(s) in phase 13")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cuda",
         "--baseline", str(BASELINE_TORCH)], cwd=ROOT, capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    summary = (cli.stdout.strip().splitlines() or [""])[-1]
    log(f"python -m repro_torch.analysis --device cuda: rc {cli.returncode}, "
        f"{summary} ({time.perf_counter() - t0:.1f} s)")
    if cli.returncode != 0:
        log(cli.stdout[-4000:], cli.stderr[-4000:])
        raise AssertionError("the analyzer's gate failed on the card")
    return dict(budgets=budgets, dispatch=rows, cli_summary=summary,
                k4b_tensor_cores=k4b_tensor_cores())


# ---------------------------------------------------------------------------
# Phase 15: the distributed substrate on the card
# ---------------------------------------------------------------------------

#: (a) hymba-1.5b whole in bf16: its blocks as PIPE_STAGES stages on a
#: ``[card] * PIPE_STAGES`` "stage" mesh, PIPE_MICRO microbatches of 1 x
#: PIPE_SEQ tokens.
PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = "hymba-1.5b", 4, 4, 2048
#: (b)-(d), (f): granite-moe-1b-a400m at full width, f32 masters and
#: moments, on a (2, 2) ("data", "model") mesh of ``[card] * 4``; a global
#: batch of 4 x 4096 tokens, MESH_STEPS steps.
MESH_ARCH, MESH_SHAPE, MESH_BATCH, MESH_STEPS = TRAIN_ARCH, (2, 2), (4, 4096), 2
#: (b), (d): the mesh step against the unsharded one, loss and every leaf,
#: both under deterministic algorithms (``_deterministic``); (b) then
#: times one more step of each with the default ones.
MESH_LOSS_RTOL, MESH_LEAF_REL_L2 = 1e-5, 1e-4
#: (c) the compressed all-reduce: shares, block, feedback repeats, and the
#: blocks per piece in which the CPU re-encodes a leaf to hold every code
#: of the timed call to its own (a block's code reads that block alone).
AR_SHARES, AR_BLOCK, AR_REPEATS, AR_CPU_BLOCKS = 8, 256, 20, 1 << 14
#: (c)'s int8 bound in block steps: half a step (each share's rounding),
#: plus the f32 rounding of a mean of up to 127 steps, twice.
AR_STEP_BOUND = 0.5 + 2 * 127 * 2.0 ** -24
#: (e) the dry run: processes tracing (arch, shape) cells on meta beside
#: the card's work; the full grid if it ends within DRYRUN_BUDGET_S of
#: the phase's start, else one cell per (family, kind).
DRYRUN_WORKERS, DRYRUN_BUDGET_S = 6, 120.0


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms`` (warn only) for the phase's
    step comparisons: the MoE's ``index_add_`` adds with atomics by
    default, and a last-bit difference in one layer's output can route a
    token to another expert in the next, which moves that expert's
    gradient by percents (on an H100, 4.8e-2 relative L2 on the second
    moment of granite-moe's expert banks after two steps)."""
    import torch

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _pipeline_kernel_checks(dev, cfg) -> dict:
    """(a)'s kernels against their plain versions at the shapes the
    pipeline gives them (one microbatch of 1 x PIPE_SEQ tokens; phase 5
    holds them at batch 4), with phase 5's tolerances: K3 in bf16 on a
    global and an SWA layer (``check_k3``'s 2e-2), K4 in each of
    ``K4_CASES`` (``check_k4``'s atol 1e-4 on y and the final state)."""
    import torch

    from repro_torch.kernels import flash_attention, ref, ssd

    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in (
        (1, cfg.n_heads, PIPE_SEQ, cfg.head_dim),
        (1, cfg.n_kv_heads, PIPE_SEQ, cfg.head_dim),
        (1, cfg.n_kv_heads, PIPE_SEQ, cfg.head_dim)))
    checks = {}
    for layer, window in (("global", None), ("swa", cfg.window)):
        got = flash_attention.flash_attention_cuda(q, k, v, True, window)
        want = ref.flash_attention(q, k, v, True, window)
        checks[f"k3_{layer}"] = within(got.float(), want.float(), 2e-2,
                                       2e-2)
    for case in K4_CASES:
        x, a, bm, cm = k4_inputs(dev, case, b=1, s=PIPE_SEQ, arch=PIPE_ARCH)
        y, sf = ssd.ssd_scan_cuda(x, a, bm, cm, 128)
        y_p, sf_p = ref.ssd_scan(x, a, bm, cm, 128)
        (ok_y, e_y), (ok_s, e_s) = within(y, y_p, 1e-4, 0.0), \
            within(sf, sf_p, 1e-4, 0.0)
        checks[f"k4_{case}"] = (ok_y and ok_s, max(e_y, e_s))
    torch.cuda.synchronize()
    errs = {name: err for name, (_, err) in checks.items()}
    failed = [name for name, (ok, _) in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pipeline shapes: {failed} {errs}")
    return dict(shapes={"k3": [1, cfg.n_heads, cfg.n_kv_heads, PIPE_SEQ,
                               cfg.head_dim],
                        "k4": list(x.shape) + list(bm.shape[2:])},
                max_abs_err=errs)


def _pipeline_run(dev) -> dict:
    """(a): hymba-1.5b's blocks through ``distributed.pipeline`` against
    the same blocks run in order on each microbatch, within phase 7's bf16
    bound (the same kernels on the same inputs: a sound run reads bit for
    bit), and the kernels against their plain versions at the pipeline's
    shapes (``_pipeline_kernel_checks``)."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tfm

    cfg = configs.get(PIPE_ARCH).make_config()
    shape_checks = _pipeline_kernel_checks(dev, cfg)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(5))
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, 1, PIPE_SEQ),
                         generator=torch.Generator(device=dev).manual_seed(6),
                         device=dev)
    with torch.no_grad():
        mbs = torch.stack([tfm.embed_tokens(cfg, params, t) for t in toks])
        mesh = mesh_mod.make_mesh((PIPE_STAGES,), ("stage",),
                                  [dev] * PIPE_STAGES)
        stages = pipeline.stage_layers(list(params.layers), PIPE_STAGES)
        f = pipeline.pipeline_forward(mesh, pipeline.blocks_stage_fn(cfg))
        pos = torch.arange(PIPE_SEQ, device=dev)

        def plain():
            return torch.stack([tfm.run_stack(cfg, params.layers, x, pos)[0]
                                for x in mbs])

        f(stages, mbs)                                  # warm
        plain()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        got = f(stages, mbs).full()
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    scale = float(want.float().abs().max())
    bound = BF16_LOGIT_ULPS * bf16_ulp(scale)
    err = float((got.float() - want.float()).abs().max())
    n = PIPE_MICRO * cfg.n_layers
    row = dict(arch=PIPE_ARCH, stages=PIPE_STAGES, micro=PIPE_MICRO,
               microbatch=[1, PIPE_SEQ], layers=cfg.n_layers,
               pipeline_s=pipe_s, plain_stack_s=plain_s,
               k3_launches=counts["flash_attention"],
               k4_launches=counts["ssd"], max_abs_err=err, bound=bound,
               bit_for_bit=bool(torch.equal(got, want)),
               hidden_absmax=scale, kernels_vs_plain=shape_checks)
    log("PIPELINE", json.dumps(row))
    if counts["flash_attention"] != n or counts["ssd"] != n:
        raise AssertionError(f"pipeline launches {counts}, want {n} K3 and "
                             f"{n} K4")
    if err > bound:
        raise AssertionError(f"pipeline vs plain stack: {row}")
    del params, stages, got, want
    torch.cuda.empty_cache()
    return row


def _mesh_batch(cfg, dev):
    import torch

    b, s = MESH_BATCH
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def _leaf_errors(tree, want: dict, dev) -> dict:
    """Relative L2 of each leaf of a state on a mesh (or a port state's
    reference tree) against a reference-layout numpy state ``want``."""
    import torch

    from repro_torch.distributed import partition
    from repro_torch.launch.mesh import Sharded

    errs = {}
    got = partition.tree_leaves_with_path(
        {"params": tree["params"], "m": tree["opt"]["m"],
         "v": tree["opt"]["v"]}, is_leaf=lambda x: isinstance(x, Sharded))
    ref = dict(partition.tree_leaves_with_path(
        {"params": want["params"], "m": want["opt"]["m"],
         "v": want["opt"]["v"]}))
    for path, x in got:
        w = torch.from_numpy(ref[path]).to(dev)
        errs["/".join(map(str, path))] = rel_l2(x.full(), w) if \
            float(w.norm()) > 0 else float((x.full() - w).abs().max())
    return errs


def _mesh_steps(dev) -> tuple[dict, dict]:
    """(b): the mesh step on (2, 2) against the unsharded ``grad_accum=2``
    step from the same state; returns the row and what (c)-(f) read."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.distributed import partition
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import convert
    from repro_torch.models.common import ShardRules
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import step as step_mod

    cfg = configs.get(MESH_ARCH).make_config()
    oc = opt_mod.AdamWConfig(warmup_steps=1, total_steps=10)
    rules = ShardRules()
    batch = _mesh_batch(cfg, dev)
    state = step_mod.init_train_state(
        cfg, oc, torch.Generator(device=dev).manual_seed(0))
    # a copy: on the CPU (a rehearsal) the tree's unstacked leaves would be
    # views of the parameters the unsharded steps update in place
    tree0 = partition.tree_map(np.copy,
                               convert.train_state_to_numpy(cfg, state))

    def run(ts, st, name, steps):
        out = {"s": [], "loss": [], "gnorm": []}
        for i in range(steps):
            if i == steps - 1:
                ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = ts(st, batch)
            out["loss"].append(float(m["loss"]))
            torch.cuda.synchronize()
            out["s"].append(time.perf_counter() - t0)
            out["gnorm"].append(float(m["grad_norm"]))
            if i == steps - 1:
                out["launches"] = ops.launch_counts()
        log(f"MESH {name}", json.dumps({k: v for k, v in out.items()}))
        return st, out

    def compared_then_timed(ts, st, name, snapshot):
        """MESH_STEPS steps under deterministic algorithms, ``snapshot``
        of the state they leave, then one step with the default
        algorithms, as a trainer runs: its time is the path's s/step."""
        with _deterministic():
            st, det = run(ts, st, name + ", deterministic", MESH_STEPS)
        taken = snapshot(st)
        st, fast = run(ts, st, name, 1)
        det["s_default"] = fast["s"][0]
        return st, det, taken

    torch.cuda.reset_peak_memory_stats()
    state, flat, want = compared_then_timed(
        step_mod.make_train_step(cfg, rules, oc, grad_accum=2), state,
        "unsharded", lambda st: partition.tree_map(
            np.copy, convert.train_state_to_numpy(cfg, st)))
    flat["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()

    mesh = mesh_mod.make_mesh(MESH_SHAPE, ("data", "model"), [dev] * 4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    on_mesh = step_mod.shard_train_state(cfg, rules, oc, tree0, mesh)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    on_mesh, sharded, errs = compared_then_timed(
        step_mod.make_train_step(cfg, rules, oc, mesh=mesh), on_mesh,
        "sharded", lambda st: _leaf_errors(st, want, dev))
    sharded["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sharded["loss"],
                                                       flat["loss"]))
    want_k = step_launches(cfg, 2 * cfg.n_layers, "bf16_wgmma")
    got_k = {k: sharded["launches"][k] for k in want_k}
    worst = max(errs, key=errs.get)
    row = dict(arch=MESH_ARCH, mesh=list(MESH_SHAPE), devices="[card] * 4",
               batch=list(MESH_BATCH), steps=MESH_STEPS,
               unsharded_grad_accum=2, shard_s=shard_s,
               s_per_step_sharded=sharded["s_default"],
               s_per_step_unsharded=flat["s_default"],
               s_per_step_sharded_deterministic=sharded["s"],
               s_per_step_unsharded_deterministic=flat["s"],
               peak_gb_sharded=sharded["peak_gb"],
               peak_gb_unsharded=flat["peak_gb"],
               losses_sharded=sharded["loss"], losses_unsharded=flat["loss"],
               grad_norms_sharded=sharded["gnorm"],
               loss_max_rel_diff=loss_rel, leaf_max_rel_l2=errs[worst],
               worst_leaf=worst, launches_last_step=got_k,
               bit_for_bit_leaves=sum(e == 0.0 for e in errs.values()),
               leaves=len(errs))
    log("MESH STEP", json.dumps(row))
    if got_k != want_k:
        raise AssertionError(f"mesh step launches {got_k}, want {want_k}")
    if loss_rel > MESH_LOSS_RTOL or errs[worst] > MESH_LEAF_REL_L2 or \
            not all(np.isfinite(sharded["loss"])):
        raise AssertionError(f"mesh step vs unsharded: {row}")
    return row, dict(cfg=cfg, oc=oc, rules=rules, batch=batch, mesh=mesh,
                     state=on_mesh, tree0=tree0)


def _elastic_run(dev, ctx: dict) -> dict:
    """(d): (b)'s state (2, 2) -> (4, 1) -> (2, 2) bit for bit, then one
    step on each mesh from it over the same microbatches (a dp share is a
    microbatch: the MoE routes and caps per share)."""
    import torch

    from repro_torch.distributed import elastic, partition
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import Sharded, device_put
    from repro_torch.training import step as step_mod

    cfg, oc, rules, mesh = ctx["cfg"], ctx["oc"], ctx["rules"], ctx["mesh"]
    state = ctx.pop("state")
    m41 = mesh_mod.make_mesh((4, 1), ("data", "model"), [dev] * 4)
    is_sh = lambda x: isinstance(x, Sharded)
    t0 = time.perf_counter()
    s41 = elastic.reshard(state, step_mod.train_state_specs(
        cfg, rules, oc, m41.shape), m41)
    torch.cuda.synchronize()
    to41_s = time.perf_counter() - t0
    specs22 = step_mod.train_state_specs(cfg, rules, oc, mesh.shape)
    same, n, t_back = True, 0, 0.0
    for x22, x41, spec in zip(partition.tree_leaves(state, is_sh),
                              partition.tree_leaves(s41, is_sh),
                              partition.tree_leaves(
                                  specs22, lambda x: isinstance(
                                      x, partition.P))):
        if not is_sh(x22):
            continue
        t0 = time.perf_counter()
        back = device_put(x41, mesh, spec)
        torch.cuda.synchronize()
        t_back += time.perf_counter() - t0
        same &= back.spec == x22.spec and all(
            torch.equal(a, b) for a, b in zip(back.shards, x22.shards))
        n += 1
    # the same four 1-row microbatches in the same order: a dp share of
    # (4, 1), two accumulated in each share of (2, 2)
    losses = {}
    for name, m, st, ga in (("(4, 1)", m41, s41, 1),
                            ("(2, 2)", mesh, state, 2)):
        ts = step_mod.make_train_step(cfg, rules, oc, ga, mesh=m)
        with _deterministic():
            st, metrics = ts(st, ctx["batch"])
        losses[name] = float(metrics["loss"])
        del ts
        torch.cuda.empty_cache()
    worst = 0.0
    for a, b in zip(partition.tree_leaves(state, is_sh),
                    partition.tree_leaves(s41, is_sh)):
        if is_sh(a) and a.dtype.is_floating_point:
            fa = a.full()
            e = rel_l2(b.full(), fa) if float(fa.norm()) > 0 else \
                float((b.full() - fa).abs().max())
            worst = max(worst, e)
    rel = abs(losses["(4, 1)"] - losses["(2, 2)"]) / abs(losses["(2, 2)"])
    row = dict(roundtrip_bit_for_bit=bool(same), leaves=n,
               reshard_to_41_s=to41_s, reshard_back_s=t_back,
               losses_after_rescale=losses, loss_rel_diff=rel,
               leaf_max_rel_l2=worst,
               local_shape_embed={"(2, 2)": list(
                   state["params"]["embed"].local_shape), "(4, 1)": list(
                   s41["params"]["embed"].local_shape)})
    log("ELASTIC", json.dumps(row))
    del state, s41
    torch.cuda.empty_cache()
    if not same or rel > MESH_LOSS_RTOL or worst > MESH_LEAF_REL_L2:
        raise AssertionError(f"elastic: {row}")
    return row


def _codes_equal_cpu(shares, codes: list, scale) -> bool:
    """All of a leaf's codes and block scales, as the card's all-reduce
    made them, against the CPU's on the same shares (with zero error
    buffers): ``compression.common_scale`` and the encoding
    ``encode_shares`` applies, AR_CPU_BLOCKS blocks at a time (a block's
    code reads that block of every share alone)."""
    import torch

    from repro_torch.distributed import compression

    flat = shares.reshape(AR_SHARES, -1)
    n, n_blocks = flat.shape[1], scale.shape[0]
    zero = torch.zeros(AR_CPU_BLOCKS * AR_BLOCK)
    for b0 in range(0, n_blocks, AR_CPU_BLOCKS):
        b1 = min(n_blocks, b0 + AR_CPU_BLOCKS)
        e0, e1 = b0 * AR_BLOCK, min(n, b1 * AR_BLOCK)
        host = [x[e0:e1].cpu() for x in flat]
        h_scale = compression.common_scale(
            host, [zero[:e1 - e0]] * AR_SHARES, AR_BLOCK)
        if not torch.equal(scale[b0:b1].cpu(), h_scale) or not all(
                torch.equal(q[b0:b1].cpu(), compression._encode(
                    compression._blocks(x, AR_BLOCK), h_scale))
                for q, x in zip(codes, host)):
            return False
    return True


def _allreduce_run(dev, ctx: dict) -> dict:
    """(c): (b)'s gradient tree (its first microbatch's, from its initial
    state) in AR_SHARES shares, share i = g (1 + u_i / 2) with u_i drawn
    per entry, through the compressed all-reduce on ``[card] *
    AR_SHARES``, leaf by leaf; the error against the exact mean within
    the int8 bound (half a block's step), AR_REPEATS repeats with error
    feedback halving it, and every code and block scale of the timed call
    (kept by wrapping ``compression.encode_shares`` for that call) equal
    to the CPU's (``_codes_equal_cpu``, in a thread beside the card's
    repeats; the previous leaf's check ends before a timed call, so no copy
    of it lands between the timed call's events)."""
    import concurrent.futures

    import torch

    from repro_torch.distributed import compression
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import convert
    from repro_torch.models import transformer as tfm

    cfg, tree0 = ctx["cfg"], ctx["tree0"]
    model = convert.params_from_numpy(cfg, tree0["params"], dev,
                                      torch.float32)
    for t in model.parameters():
        t.requires_grad_(True)
    micro = {k: v[:MESH_BATCH[0] // 2] for k, v in ctx["batch"].items()}
    loss, _ = tfm.forward_train(cfg, model, micro)
    loss.backward()
    grads = [(leaf.path, leaf.gather(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad))
        for leaf in convert.reference_leaves(cfg, model)]
    del model, loss
    torch.cuda.empty_cache()

    mesh = mesh_mod.make_mesh((AR_SHARES,), ("data",), [dev] * AR_SHARES)
    ar = compression.make_compressed_allreduce(mesh, "data", AR_BLOCK)
    gen = torch.Generator(device=dev).manual_seed(8)
    err1 = err20 = bound_ratio = ms = cpu_check_s = 0.0
    n = codes_equal = 0
    encode = compression.encode_shares
    checker = concurrent.futures.ThreadPoolExecutor(1)
    pending = None

    def check(shares, codes, scale):
        t0 = time.perf_counter()
        return _codes_equal_cpu(shares, codes, scale), \
            time.perf_counter() - t0

    def settle():
        nonlocal codes_equal, cpu_check_s
        if pending is not None:
            ok, took = pending.result()
            codes_equal += ok
            cpu_check_s += took

    for path, g in grads:
        shares = torch.stack([g * (1 + 0.5 * torch.randn(
            g.shape, generator=gen, device=dev)) for _ in range(AR_SHARES)])
        zero = torch.zeros_like(g)
        exact = sum(x.double() for x in shares) / AR_SHARES
        step = compression.common_scale(list(shares), [zero] * AR_SHARES,
                                        AR_BLOCK)
        step = step.double().expand(-1, AR_BLOCK).reshape(-1)[:g.numel()]
        errs = {"g": zero.expand(AR_SHARES, *g.shape)}
        made = []

        def keeping(*args, **kw):
            out = encode(*args, **kw)
            made.append(out[:2])
            return out

        settle()
        compression.encode_shares = keeping
        try:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            mean, errs = ar({"g": shares}, errs)
            end.record()
            torch.cuda.synchronize()
        finally:
            compression.encode_shares = encode
        ms += start.elapsed_time(end)
        pending = checker.submit(check, shares, *made.pop())
        e1 = (mean["g"].full().double() - exact).abs().reshape(-1)
        bound_ratio = max(bound_ratio, float(
            (e1 / torch.clamp(step, min=1e-30)).max()))
        err1 = max(err1, float(e1.max()))
        del e1, step
        acc = torch.zeros_like(exact)
        for _ in range(AR_REPEATS):
            mean, errs = ar({"g": shares}, errs)
            acc += mean["g"].full().double()
        err20 = max(err20, float((acc / AR_REPEATS - exact).abs().max()))
        n += 1
        del shares, exact, errs, mean, acc
    settle()
    checker.shutdown()
    torch.cuda.empty_cache()
    row = dict(shares=AR_SHARES, block=AR_BLOCK, leaves=n,
               entries_per_share=sum(g.numel() for _, g in grads),
               ms_per_allreduce=ms, max_err_first=err1,
               max_err_over_step_first=bound_ratio,
               max_err_mean_of_repeats=err20, repeats=AR_REPEATS,
               leaves_codes_equal_cpu=codes_equal,
               codes_checked="all, of the timed call",
               cpu_check_s=cpu_check_s)
    log("ALLREDUCE", json.dumps(row))
    if bound_ratio > AR_STEP_BOUND or not err20 < err1 / 2 or \
            codes_equal != n:
        raise AssertionError(f"compressed all-reduce: {row}")
    return row


def _quant_banks(dev, ctx: dict) -> dict:
    """(f): ``QuantTensor`` of every expert bank of granite-moe's (b)
    initial state on the card, codes and scales equal to the CPU's."""
    import torch

    from repro_torch.core import mixed_precision as mp

    moe = ctx["tree0"]["params"]["layers"]["moe"]
    equal = n = 0
    t_card = 0.0
    for name in ("wg", "wu", "wd"):
        for w in moe[name]:
            host = torch.from_numpy(w)
            card = host.to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qc = mp.QuantTensor.quantize(card)
            torch.cuda.synchronize()
            t_card += time.perf_counter() - t0
            qh = mp.QuantTensor.quantize(host)
            equal += torch.equal(qc.q.cpu(), qh.q) and torch.equal(
                qc.scale.cpu(), qh.scale)
            n += 1
    row = dict(banks=n, shape=list(moe["wg"].shape[1:]), codes_equal_cpu=equal,
               card_quantize_ms_per_bank=t_card / n * 1e3)
    log("QUANT BANKS", json.dumps(row))
    if equal != n:
        raise AssertionError(f"QuantTensor card vs CPU: {row}")
    return row


def dryrun_worker(arch: str, shape: str) -> tuple:
    """One (arch, shape) at both production meshes, in a worker process."""
    from repro_torch.launch import dryrun

    out = str(ROOT / "build" / "dryrun_torch")
    os.makedirs(out, exist_ok=True)
    return dryrun.run_grid([(arch, shape)], [False, True], out=out,
                           log=lambda *a: None)


def _dryrun_cells():
    from repro_torch import configs

    return [(a, s) for a in configs.ARCHS for s in configs.shapes_for(a)]


def _dryrun_subset(cells):
    """One cell per (family, kind), the first in ``configs.ARCHS`` order."""
    from repro_torch import configs
    from repro_torch.configs import base

    seen, out = set(), []
    for a, s in cells:
        key = (configs.get(a).make_config().family, base.SHAPES[s]["kind"])
        if key not in seen:
            seen.add(key)
            out.append((a, s))
    return out


def distributed_phase(dev) -> dict:
    """Phase 15: (e) starts in DRYRUN_WORKERS processes, then (a), (b),
    (d), (c) and (f) run on the card; (e) is read last."""
    import concurrent.futures
    import multiprocessing

    import torch

    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    cells = _dryrun_cells()
    pool = concurrent.futures.ProcessPoolExecutor(
        DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    futures = {pool.submit(dryrun_worker, a, s): (a, s) for a, s in cells}
    try:
        out = {"pipeline": _pipeline_run(dev)}
        out["mesh_step"], ctx = _mesh_steps(dev)
        out["elastic"] = _elastic_run(dev, ctx)
        out["allreduce"] = _allreduce_run(dev, ctx)
        out["quant_banks"] = _quant_banks(dev, ctx)
        del ctx
        torch.cuda.empty_cache()
        done, late = concurrent.futures.wait(
            futures, timeout=max(0.0, DRYRUN_BUDGET_S - (
                time.perf_counter() - t_start)))
        if late:
            # Too slow for the budget: one cell per (family, kind).
            keep = set(_dryrun_subset(cells))
            for fut in late:
                if futures[fut] not in keep:
                    fut.cancel()
            done, _ = concurrent.futures.wait(
                [f for f in futures if futures[f] in keep])
        records, failures, skipped = [], [], []
        for fut, cell in futures.items():
            if fut.cancelled() or not fut.done():
                skipped.append("/".join(cell))
                continue
            recs, fails = fut.result()
            records += recs
            failures += fails
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for r in records:
        log(f"DRYRUN {r['arch']} {r['shape']} {r['mesh']}: trace "
            f"{r['trace_s']:.2f} s, args {r['memory']['argument_bytes'] / 1e9:.3f}"
            f" GB/device, {r['flops_per_device']:.4e} FLOP/device")
    out["dryrun"] = dict(cells=len(records), failures=failures,
                         skipped=skipped, workers=DRYRUN_WORKERS,
                         trace_s_total=sum(r["trace_s"] for r in records) / 2,
                         ended_s=time.perf_counter() - t_start)
    log("DRYRUN", json.dumps(out["dryrun"]))
    if failures or not records:
        raise AssertionError(f"dry run: {out['dryrun']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.analysis import kernel_budget
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log("card:", smi, "|", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for kernel, report in ptxas_report(text):
            log(f"ptxas[{name}] {kernel}: {report}")
    # Phase 13 reads the shapes of every kernel launch of phases 2-12 and
    # 14.
    recording = contextlib.ExitStack()
    recorded = recording.enter_context(kernel_budget.record_launches())

    k2, k2_rows = check_k2(dev)
    log(f"phase 2 (K2): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ops.reset_launches()
    fitted, rows = {}, []
    for name in TABLE2_DATASETS:
        row, fitted[name] = table2_row(name, dev)
        rows.append(row)
    counts = ops.launch_counts()
    log("launches on the main path:", json.dumps(counts))
    if min(counts["kernel_matrix"], counts["solver"]) < 1:
        raise AssertionError(f"a kernel did not run on the main path: {counts}")
    check_balance(rows[0])
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ops.reset_launches()
    for name, est in fitted.items():
        dse_dataset(name, est, dev)
    dse_synthetic(dev)
    monte_carlo_phase(fitted["balance"], dev)
    log("launches on the design-space / Monte-Carlo path (it reaches no "
        "hand kernel):", json.dumps(ops.launch_counts()))
    log(f"phases 8-9: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scale, har12, padded = scaleout_phase(dev)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k2_rows += check_k2_har12(dev, har12, padded)
    k1, k1_rows = check_k1(dev, {**fitted, "har12": har12})
    log(f"phase 2 (K2 on the har12 fit, K1): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serving = fleet_phase(dev, {**fitted, "har12": har12}, padded)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    # Each served window and the trainer's mesh leg zero the counters just
    # before they run and read them just after.
    served = {f"{c['target']}_{c['decider']}/{run}":
              s["launches"]["kernel_matrix"]
              for c in serving["configs"] for run, s in c["runs"].items()}
    mesh_k2 = serving["mesh_d1"]["cv_grid_mesh1_k2_launches"]
    log("K1 launches in each served window:", json.dumps(served))
    if sum(served.values()) < 1 or mesh_k2 < 1:
        raise AssertionError(f"a kernel did not run on the fleet serving "
                             f"path: K1 {served}, K2 {mesh_k2}")
    del padded

    t0 = time.perf_counter()
    check_small_input(dev)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    k3_rows = check_k3(dev)
    k3_family_rows = check_k3_families(dev)
    k4 = check_k4(dev)
    k4_mamba2 = check_k4(dev, "mamba2-2.7b")
    torch.cuda.empty_cache()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, serve_counts = serve_path()
    torch.cuda.empty_cache()
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_small_prefill(dev)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    family_rows = {family: serve_family(dev, family)
                   for family in FAMILY_SERVES}
    for name in SMALL_PREFILLS:
        check_small_family_prefill(dev, name)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    training = training_phase(dev)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    recording.close()

    t0 = time.perf_counter()
    analysis = static_analysis_phase(dev, recorded, fitted, har12,
                                     serving["fleet"])
    del har12
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dist = distributed_phase(dev)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    full = training["full"]
    trained = {**training["configs"], **training["ssm"]}
    k3_paths = {"hymba-1.5b": serve_counts["flash_attention"],
                **{r["arch"]: r["k3_launches"] for r in family_rows.values()},
                f"{TRAIN_ARCH} train step":
                    full["launches_step_2"]["flash_attention"],
                **{f"{arch} train step": r["launches_step_2"][
                    "flash_attention"]
                   for arch, r in trained.items()},
                f"{PIPE_ARCH} pipeline": dist["pipeline"]["k3_launches"],
                f"{MESH_ARCH} mesh step": dist["mesh_step"][
                    "launches_last_step"]["flash_attention"]}
    k4_paths = {"hymba-1.5b": serve_counts["ssd"],
                **{r["arch"]: r["k4_launches"] for r in family_rows.values()},
                **{f"{arch} train step": r["launches_step_2"]["ssd"]
                   for arch, r in training["ssm"].items()},
                f"{PIPE_ARCH} pipeline": dist["pipeline"]["k4_launches"]}
    k4b_paths = {f"{arch} train step": r["launches_step_2"]["ssd_bwd"]
                 for arch, r in training["ssm"].items()}
    k4b = [r for r in training["k4_bwd"] if "ms" in r]
    k3_tc = serve_counts["flash_attention_bf16_wgmma"] + sum(
        r["k3_tensor_core"] for r in family_rows.values()) + \
        full["launches_step_2"]["flash_attention_bf16_wgmma"] + sum(
            r["launches_step_2"]["flash_attention_bf16_wgmma"]
            for r in trained.values()) + dist["pipeline"]["k3_launches"] + \
        dist["mesh_step"]["launches_last_step"]["flash_attention_bf16_wgmma"]
    k3b = next(r for r in training["k3_bwd"] if r["dtype"] == "bfloat16"
               and r["shape"] == "granite-moe training")
    k3b_paths = {f"{TRAIN_ARCH} train step":
                     full["launches_step_2"]["flash_attention_bwd"],
                 **{f"{arch} train step": r["launches_step_2"][
                     "flash_attention_bwd"]
                    for arch, r in trained.items()},
                 f"{MESH_ARCH} mesh step": dist["mesh_step"][
                     "launches_last_step"]["flash_attention_bwd"]}

    # K3's entry is the SWA layer in bf16 (29 of the 32 launches); the
    # global layer's row rides along.
    k3 = next(r for r in k3_rows if r["layer"] == "swa" and
              r["dtype"] == "bfloat16")
    k3_global = next(r for r in k3_rows if r["layer"] == "global" and
                     r["dtype"] == "bfloat16")
    kernels = [
        dict(name="kernel_matrix", route="cuda",
             budget=analysis["budgets"]["kernel_matrix"],
             source="src/repro_torch/kernels/csrc/kernel_matrix.cu",
             replaces="src/repro/kernels/rbf.py:110",
             design="no shared memory: 4 support vectors per thread in "
                    "registers, up to 8 query rows each, float4 streaming "
                    "stores; d <= 5 unrolled at compile time; sech2 in "
                    "product form (one exp per dimension)",
             launches=counts["kernel_matrix"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], device_ms=k1["device_ms"], host_ms=k1["host_ms"],
             device_launches_per_call=k1["device_launches_per_call"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, shape=k1["shape"],
             har12_rbf_predict_launches=scale["deciders"][1][
                 "k1_launches_votes_predict"],
             har12_width={f"{r['kind']}_{key}": r[key] for r in k1_rows
                          if r["name"] == "har12/padded-training-set"
                          for key in ("ms", "bound_ms")},
             har12_banks={r["name"]: {key: r[key] for key in (
                 "shape", "ms", "plain_ms", "bound_ms", "max_abs_err")}
                 for r in k1_rows if r["name"] in ("har12/rbf",
                                                   "har12/rbf_float")},
             fleet_dispatch=dict(serving["k1_fleet_dispatch"],
                                 served_launches=sum(served.values()))),
        dict(name="solver", route="cuda",
             budget=analysis["budgets"]["solver"],
             source="src/repro_torch/kernels/csrc/solver.cu",
             replaces="src/repro/kernels/solver.py:126",
             design="one warp per lane; the lanes of a (pair, gamma) share "
                    "a CTA and each K' slab in shared memory",
             launches=counts["solver"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, shape=k2["shape"],
             har12_fit_launches=scale["fit_launches"]["solver"],
             trainer_mesh_launches=mesh_k2,
             har12_fit_lanes={
                 f"{r['name']}/{r['kind']}/{r['epochs']}": {
                     key: r[key] for key in (
                         "shape", "ms", "plain_ms", "bound_ms", "max_abs_err",
                         "beyond_tolerance", "f64_drift")}
                 for r in k2_rows if r["name"].startswith("har12/")}),
        dict(name="flash_attention", route="cuda",
             budget=analysis["budgets"]["flash_attention"],
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:90",
             design="bf16: flash_wgmma_kernel (TMA + mbarrier ring + wgmma, "
                    "tensor cores); f32: flash_kernel (CUDA cores)",
             launches=sum(k3_paths.values()), launches_by_path=k3_paths,
             launches_by_variant={
                 "bf16_wgmma": k3_tc,
                 "f32_cuda_cores":
                     serve_counts["flash_attention_f32_cuda_cores"]},
             max_abs_err=max(r["max_abs_err"] for r in k3_rows
                             + k3_family_rows),
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             shape=k3["shape"], window=k3["window"],
             global_layer={key: k3_global[key] for key in
                           ("ms", "plain_ms", "bound_ms", "library_ms")},
             families={f"{r['case']}/{r['dtype']}": {key: r[key] for key in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err", "rel_l2")}
                 for r in k3_family_rows},
             training_shape={key: k3b[key] for key in (
                 "dims", "k3_forward_ms", "k3_forward_with_lse_ms",
                 "k3_forward_plain_ms", "k3_forward_library_ms",
                 "k3_forward_bound_ms")}),
        dict(name="ssd", route="cuda",
             budget=analysis["budgets"]["ssd"],
             source="src/repro_torch/kernels/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:83",
             design="chunk-parallel: chunk states over every (batch, "
                    "chunk, head) tile, a state pass over the chunks, then "
                    "every tile's output; 3 device launches per call",
             launches=sum(k4_paths.values()), launches_by_path=k4_paths,
             max_abs_err=max(k4["max_abs_err"], k4_mamba2["max_abs_err"]),
             ms=k4["ms"], device_ms=k4["device_ms"],
             device_launches_per_call=k4["device_launches_per_call"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None, shape=k4["shape"],
             library_note="no single PyTorch call computes the chunked scan",
             mamba2={key: k4_mamba2[key] for key in (
                 "shape", "ms", "pass1_ms", "device_ms", "device_ms_by_pass",
                 "plain_ms", "bound_ms", "bound_by", "max_abs_err")}),
        dict(name="flash_attention_bwd", route="cuda",
             budget=analysis["budgets"]["flash_attention_bwd"],
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="none: K3's gradient; the reference differentiates its "
                      "jnp attention (src/repro/models/attention.py:122)",
             design="bf16: tensor cores (TMA + mbarrier ring + wgmma): an "
                    "lse / D pre-pass, dK / dV per 128 keys (two consumer "
                    "warpgroups, a producer warpgroup, setmaxnreg), dQ per "
                    "128 query rows; f32: CUDA cores; no atomics; 3 device "
                    "launches per call",
             launches=sum(k3b_paths.values()), launches_by_path=k3b_paths,
             launches_by_variant={
                 "bf16_wgmma": full["launches_step_2"][
                     "flash_attention_bwd_bf16_wgmma"] + sum(
                     r["launches_step_2"]["flash_attention_bwd_bf16_wgmma"]
                     for r in trained.values()) + dist["mesh_step"][
                     "launches_last_step"]["flash_attention_bwd_bf16_wgmma"],
                 "f32_cuda_cores": full["launches_step_2"][
                     "flash_attention_bwd_f32_cuda_cores"]},
             max_abs_err=k3b["max_abs_err"], rel_l2={
                 g: e["rel_l2"] for g, e in k3b["errors"].items()},
             ms=k3b["ms"], plain_ms=k3b["plain_ms"], bound_ms=k3b["bound_ms"],
             bound_by=k3b["bound_by"], library_ms=k3b["library_ms"],
             library_note="SDPA (enable_gqa) forward + backward minus its "
                          "forward",
             shape=k3b["dims"],
             shapes={f"{r['shape']}/{r['dtype']}": {key: r[key] for key in (
                 "dims", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "max_abs_err")}
                 for r in training["k3_bwd"]}),
        dict(name="ssd_bwd", route="cuda",
             budget=analysis["budgets"]["ssd_bwd"],
             source="src/repro_torch/kernels/csrc/ssd_bwd.cu",
             replaces=None,
             replaces_note="none: K4's gradient; the reference "
                           "differentiates its jnp ssd_chunked "
                           "(src/repro/models/ssm.py:74)",
             design="split-TF32 products on the tensor cores "
                    "(mma.sync.m16n8k8, three TF32 products each); a CTA "
                    "per (batch, chunk, slice of <= 8 heads of a group), "
                    "operands by cp.async into a two-stage ring, dB / dC "
                    "summed over the slice on chip (no per-head scratch); "
                    "chunk states, reverse state pass, intra-chunk terms, "
                    "state terms with da, slice sum: 5 device launches per "
                    "call, no atomics",
             launches=sum(k4b_paths.values()), launches_by_path=k4b_paths,
             max_abs_err=max(r["max_abs_err"] for r in training["k4_bwd"]),
             rel_l2=max(r["rel_l2"] for r in training["k4_bwd"]),
             ms=k4b[0]["ms"], plain_ms=k4b[0]["plain_ms"],
             bound_ms=k4b[0]["bound_ms"], bound_by=k4b[0]["bound_by"],
             library_ms=None,
             library_note="no single PyTorch call computes the scan's "
                          "gradient",
             shape=k4b[0]["shape"],
             shapes={r["arch"]: {key: r[key] for key in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "bound_f32_ms", "bound_f32_group_ms", "scratch_bytes")}
                 for r in k4b},
             tensor_core_instructions=analysis["k4b_tensor_cores"],
             device_ms_per_step={arch: r["traced_last_step"].get(
                 "device_ms", {}).get("K4-bwd", "not measured")
                 for arch, r in training["ssm"].items()}),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
