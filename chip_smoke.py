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
   lanes (n = 1582, d = 5) before the main path; K1 runs after
   it, on the kernel banks the main path deployed, and at har12's width
   (1875 queries x 1582 rows of a padded training set, d = 5).
3. The main path, paper Algorithm 1, for balance, seeds and vertebral at
   the estimator's defaults: ``datasets.load`` -> ``fit`` -> ``deploy`` for
   all six targets -> ``predict`` -> ``score`` -> ``hwcost.system_cost``,
   printing each Table II row with the fit wall time and each target's
   predict wall times (first call, then median / min / max).  The launch
   counters are zeroed just before and read just after; both kernels must
   have run.  Balance must meet the properties of tests/test_system.py.
4. A small input (the 150-row balance subsample) fit on the card and with
   the plain versions on the CPU: the same kernel picks, (gamma, C),
   support sets and scores.
5. The LM kernels against their plain versions on the card at the shapes
   of hymba-1.5b's prefill of 4 x 2048 tokens: K3 (flash attention) on a
   global layer (causal) and an SWA layer (window 1024), in bf16 (the
   tensor-core kernel) and f32 (the CUDA-core kernel), with
   ``scaled_dot_product_attention`` timed on the same tensors; the
   tensor-core kernel with its window narrowed by one kv block must fail
   the bf16 check (a planted fault); K4 (SSD
   scan) at (b, s, nh, dh, ds) = (4, 2048, 50, 64, 16), chunk 128.
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

Then it prints the ``kernels`` JSON line, the ``nvidia-smi`` line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
BF16_TC_OPS_PER_S = 989e12

#: The LM serving path: hymba-1.5b at full width, 4 prompts of 2048 tokens,
#: 32 sampled tokens each (cap = 2048 + 32 + 8).
SERVE_ARGV = ["--arch", "hymba-1.5b", "--no-reduced", "--batch", "4",
              "--prompt-len", "2048", "--gen", "32", "--seed", "0"]

TABLE2_DATASETS = ("balance", "seeds", "vertebral")


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
            k = re.search(r"\d+([A-Za-z_]+_kernel)ILi(\d+)E", m.group(1))
            kernel = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)[:60]
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


#: f32 operations per kernel value, transcendentals counted as one each:
#: linear d FMAs; rbf d FMAs + norm combine, scale and exp; sech2 per
#: dimension a difference, a scale and two stable softplus, then one exp.
def tile_ops(kind: str, d: int) -> int:
    return {"linear": 2 * d, "rbf": 2 * d + 5, "sech2": 17 * d + 1,
            "gram": 0}[kind]


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
    import numpy as np
    import torch

    from repro_torch.core import quant, trainer
    from repro_torch.data import datasets
    from repro_torch.kernels import rbf

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
    ds = datasets.load("har12")
    padded = trainer.pad_pairs(ds.x_train, ds.y_train, ds.n_classes)
    sv = padded.x[np.argsort(padded.n_true)[::-1][:4]]
    x = torch.as_tensor(np.ascontiguousarray(ds.x_test),
                        dtype=torch.float32, device=dev)
    sv = torch.as_tensor(np.ascontiguousarray(sv), dtype=torch.float32,
                         device=dev)
    gamma = torch.as_tensor(trainer.DEFAULT_RBF_GAMMAS[:4],
                            dtype=torch.float32, device=dev)
    for kind in ("rbf", "sech2"):
        cases.append(("har12/padded-training-set", kind, x, sv, gamma))

    rows, entry = [], None
    for name, kind, x, sv, gamma in cases:
        args = (x, sv, gamma, kind)
        got = rbf.kernel_matrix_cuda(*args, v_scale=1.0)
        want = rbf.kernel_matrix_plain(*args, v_scale=1.0)
        torch.cuda.synchronize()
        atol = max(5e-6, 2e-6 * float(gamma.max()))
        ok, err = within(got, want, atol, 1e-5)
        if not ok:
            raise AssertionError(f"K1 {kind} {name}: max err {err}")
        ms = cuda_ms(lambda: rbf.kernel_matrix_cuda(*args, v_scale=1.0),
                     reps=20)
        plain = cuda_ms(
            lambda: rbf.kernel_matrix_plain(*args, v_scale=1.0), reps=3)
        p, m, d = sv.shape
        n_out = p * x.shape[0] * m
        b, by = bound_ms(4 * (x.numel() + sv.numel() + p + n_out),
                         n_out * tile_ops(kind, d))
        row = dict(name=name, kind=kind, shape=[p, x.shape[0], m, d],
                   max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                   bound_by=by)
        rows.append(row)
        log("K1", json.dumps(row))
        if entry is None:
            entry = row
    return entry, rows


def check_k2(dev) -> tuple[dict, list]:
    import torch

    from repro_torch.core import svm, trainer
    from repro_torch.kernels import ref, solver

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
        else:
            xs, ys, cb = x, y, c_box
            gs = gam[:, :1].contiguous() if kind == "linear" else gam
        kp = None
        if kind == "gram":
            kp = kp_hw if name == "balance" else svm.callable_grams(
                hw_kernel, xs, kp_gammas[:, :1].expand(xs.shape[0], -1)
            ).contiguous()
            run = lambda: solver.solve_lanes_gram_cuda(kp, ys, cb, epochs)
            plain = lambda: ref.solve_lanes_gram(kp, ys, cb, epochs)
        else:
            run = lambda: solver.solve_lanes_cuda(xs, ys, cb, gs, kind,
                                                  epochs)
            plain = lambda: ref.solve_lanes(xs, ys, cb, gs, kind, epochs)
        a, f = run()
        a_p, f_p = plain()
        torch.cuda.synchronize()
        scale = cb.amax(-1).clamp(min=1.0)[:, None, :, None]   # per lane C
        ok_a, err_a = within(a / scale, a_p / scale, 5e-4, 1e-3)
        ok_f, err_f = within(f / scale, f_p / scale, 5e-3, 1e-3)
        pad_ok = bool((a[cb[:, None].expand_as(a) == 0] == 0).all())
        if not (ok_a and ok_f and pad_ok):
            raise AssertionError(
                f"K2 {kind} {name}: alpha err {err_a} f err {err_f} "
                f"masked rows exact {pad_ok}")
        ms = cuda_ms(run, reps=3, warmup=1)
        plain_ms = cuda_ms(plain, reps=1, warmup=0)
        p, n = ys.shape
        g = kp.shape[1] if kind == "gram" else gs.shape[1]
        lanes = p * g * cb.shape[1]
        d = 0 if kind == "gram" else xs.shape[2]
        n_bytes = 4 * (p * n * (d + 1) + cb.numel() + 2 * lanes * n
                       + (kp.numel() if kind == "gram" else gs.numel()))
        n_true = (torch.as_tensor(padded_h.n_true)[top.cpu()]
                  if name == "har12" else padded.n_true)
        b, by = bound_ms(n_bytes, k2_ops(cb, n_true, g, epochs, kind, d))
        steps = (epochs + 1) * -(-n // 16)   # coordinate blocks + final pass
        row = dict(name=name, kind=kind, shape=[p, g, cb.shape[1], n, d],
                   epochs=epochs, serial_chain=epochs * n,
                   us_per_block_step=ms * 1e3 / steps,
                   max_abs_err=max(float((a - a_p).abs().max()),
                                   float((f - f_p).abs().max())),
                   max_rel_lane_err=max(err_a, err_f), ms=ms,
                   plain_ms=plain_ms, bound_ms=b, bound_by=by)
        rows.append(row)
        log("K2", json.dumps(row))
        if name == "balance" and kind == "rbf":
            entry = row
    return entry, rows


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


def attn_live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs a causal / windowed mask leaves visible."""
    total = 0
    for qpos in range(sq):
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


def check_k4(dev) -> dict:
    """K4 at the prefill shape: x (4, 2048, 50, 64), a (4, 2048, 50), B and
    C (4, 2048, 1, 16), chunk 128.  No single PyTorch call computes the
    chunked scan, so ``library_ms`` is null."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref, ssd

    cfg = configs.get("hymba-1.5b").make_config()
    b, s, nh, dh = 4, 2048, cfg.n_ssm_heads, cfg.ssm_head_dim
    g, ds, chunk = cfg.ssm_groups, cfg.ssm_state, 128
    gen = torch.Generator(device=dev).manual_seed(13)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, a = draw(b, s, nh, dh) * 0.3, -draw(b, s, nh).abs() * 0.3
    bm, cm = draw(b, s, g, ds) * 0.3, draw(b, s, g, ds) * 0.3
    run = lambda: ssd.ssd_scan_cuda(x, a, bm, cm, chunk)
    plain = lambda: ref.ssd_scan(x, a, bm, cm, chunk)
    (y, sf), (y_p, sf_p) = run(), plain()
    torch.cuda.synchronize()
    ok_y, err_y = within(y, y_p, 1e-4, 0.0)
    ok_s, err_s = within(sf, sf_p, 1e-4, 0.0)
    if not (ok_y and ok_s):
        raise AssertionError(f"K4: max err y {err_y}, state {err_s}")
    n_bytes = 4 * (2 * x.numel() + a.numel() + bm.numel() + cm.numel()
                   + sf.numel())
    bnd, by = bound_ms(n_bytes, ssd_ops(b, s, nh, dh, ds, chunk))
    row = dict(shape=[b, s, nh, dh, g, ds], chunk=chunk,
               max_abs_err=max(err_y, err_s), tolerance=1e-4,
               ms=cuda_ms(run, reps=10), plain_ms=cuda_ms(plain, reps=3),
               library_ms=None, bound_ms=bnd, bound_by=by)
    log("K4", json.dumps(row))
    return row


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
        elif "ssd_kernel" in name:
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


def _prefill_last(cfg, params, toks, attention=None, scan=None):
    """Last-token logits (f32) and SSM states of one prefill on the card,
    through K3 and K4 or through the functions given in their place."""
    from repro_torch.kernels import ops
    from repro_torch.serving import engine

    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention = attention or saved[0]
    ops.ssd_scan = scan or saved[1]
    try:
        st, lg = engine.prefill(cfg, params, {"tokens": toks},
                                toks.shape[1] + 40)
    finally:
        ops.flash_attention, ops.ssd_scan = saved
    return lg.float(), st["ssm"]


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
    k16, _ = _prefill_last(cfg, params, toks)
    p16, _ = _prefill_last(cfg, params, toks, **plain)
    m16, _ = _prefill_last(cfg, params, toks, _k3_dropping_a_kv_block)
    params = params.float()
    k32, sk32 = _prefill_last(cfg32, params, toks)
    p32, sp32 = _prefill_last(cfg32, params, toks, **plain)
    m32, _ = _prefill_last(cfg32, params, toks, _k3_dropping_a_kv_block)
    del params

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    k2, k2_rows = check_k2(dev)

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

    k1, k1_rows = check_k1(dev, fitted)

    check_small_input(dev)

    k3_rows = check_k3(dev)
    k4 = check_k4(dev)
    torch.cuda.empty_cache()
    _, serve_counts = serve_path()
    torch.cuda.empty_cache()
    check_small_prefill(dev)

    # K3's entry is the SWA layer in bf16 (29 of the 32 launches); the
    # global layer's row rides along.
    k3 = next(r for r in k3_rows if r["layer"] == "swa" and
              r["dtype"] == "bfloat16")
    k3_global = next(r for r in k3_rows if r["layer"] == "global" and
                     r["dtype"] == "bfloat16")
    kernels = [
        dict(name="kernel_matrix", route="cuda",
             source="src/repro_torch/kernels/csrc/kernel_matrix.cu",
             replaces="src/repro/kernels/rbf.py:110",
             launches=counts["kernel_matrix"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, shape=k1["shape"]),
        dict(name="solver", route="cuda",
             source="src/repro_torch/kernels/csrc/solver.cu",
             replaces="src/repro/kernels/solver.py:126",
             design="one warp per lane; the lanes of a (pair, gamma) share "
                    "a CTA and each K' slab in shared memory",
             launches=counts["solver"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, shape=k2["shape"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:90",
             design="bf16: flash_wgmma_kernel (TMA + mbarrier ring + wgmma, "
                    "tensor cores); f32: flash_kernel (CUDA cores)",
             launches=serve_counts["flash_attention"],
             launches_by_variant={
                 "bf16_wgmma": serve_counts["flash_attention_bf16_wgmma"],
                 "f32_cuda_cores":
                     serve_counts["flash_attention_f32_cuda_cores"]},
             max_abs_err=max(r["max_abs_err"] for r in k3_rows),
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             shape=k3["shape"], window=k3["window"],
             global_layer={key: k3_global[key] for key in
                           ("ms", "plain_ms", "bound_ms", "library_ms")}),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:83",
             launches=serve_counts["ssd"], max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None, shape=k4["shape"],
             library_note="no single PyTorch call computes the chunked scan"),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
