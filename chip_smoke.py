#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:

1. Environment and build: the card's name and power limit, f32 matmuls
   without TF32, and the hand kernels built from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel).
2. Each hand kernel against its plain PyTorch version on the card: max abs
   error, kernel and plain times (CUDA events after warm-up) and the least
   time the card could take.  K2 runs on the Table II CV lanes and on
   har12-width lanes (n = 1582, d = 5) before the main path; K1 runs after
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

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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
    kp_hw = svm.callable_grams(
        trainer._training_kernel(hw.kernel_response, dev), x,
        torch.as_tensor(trainer.hw_gamma_grid(hw), dtype=torch.float32,
                        device=dev)[None].expand(x.shape[0], -1)).contiguous()
    cases = [("balance", kind, cv_epochs) for kind in
             ("linear", "rbf", "sech2", "gram")]
    cases += [("har12", kind, 3) for kind in ("rbf", "sech2")]
    for name, kind, epochs in cases:
        if name == "har12":
            _, padded_h, xh, yh, ch, gh = lanes_inputs("har12", dev)
            top = torch.argsort(torch.tensor(padded_h.n_true),
                                descending=True)[:2].to(dev)
            xs, ys = xh[top].contiguous(), yh[top].contiguous()
            cb, gs = ch[top][:, :2].contiguous(), gh[top][:, :1].contiguous()
        else:
            xs, ys, cb = x, y, c_box
            gs = gam[:, :1].contiguous() if kind == "linear" else gam
        if kind == "gram":
            run = lambda: solver.solve_lanes_gram_cuda(kp_hw, ys, cb, epochs)
            plain = lambda: ref.solve_lanes_gram(kp_hw, ys, cb, epochs)
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
        g = kp_hw.shape[1] if kind == "gram" else gs.shape[1]
        lanes = p * g * cb.shape[1]
        d = 0 if kind == "gram" else xs.shape[2]
        n_bytes = 4 * (p * n * (d + 1) + cb.numel() + 2 * lanes * n
                       + (kp_hw.numel() if kind == "gram" else gs.numel()))
        n_true = (torch.as_tensor(padded_h.n_true)[top.cpu()]
                  if name == "har12" else padded.n_true)
        b, by = bound_ms(n_bytes, k2_ops(cb, n_true, g, epochs, kind, d))
        row = dict(name=name, kind=kind, shape=[p, g, cb.shape[1], n, d],
                   epochs=epochs, serial_chain=epochs * n,
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
    build.library("kernel_matrix")
    build.library("solver")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"ptxas[{name}]:", line.strip())

    k2, k2_rows = check_k2(dev)

    ops.reset_launches()
    fitted, rows = {}, []
    for name in TABLE2_DATASETS:
        row, fitted[name] = table2_row(name, dev)
        rows.append(row)
    counts = ops.launch_counts()
    log("launches on the main path:", json.dumps(counts))
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: {counts}")
    check_balance(rows[0])

    k1, k1_rows = check_k1(dev, fitted)

    check_small_input(dev)

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
             launches=counts["solver"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, shape=k2["shape"]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
