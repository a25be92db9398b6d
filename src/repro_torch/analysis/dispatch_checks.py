"""Pass 1 — dispatch checks over the port's hot entry points.

The port's counterpart of ``repro/analysis/jaxpr_checks.py`` (a file named
after jaxprs would mislead a reader of a torch package).  The reference
traced each jitted entry point and walked its jaxpr; PyTorch runs eagerly,
so each registered entry point (``analysis.entrypoints``) runs once under
a ``TorchDispatchMode`` that records every aten op with its output dtypes,
its devices and its index arguments, and the bytes it copies from the
host to a device.  On a card the run also sits under
``torch.cuda.set_sync_debug_mode("warn")``.

``F64-IN-HOT`` (was F64-IN-JIT)
    A float64 tensor produced inside a hot entry point.  Every kernel and
    bank is f32; an f64 tensor doubles its buffers and, on the card, runs
    at 1/64 of the f32 rate.  Host numpy in f64 is outside the mode and
    stays allowed.

``HOST-SYNC`` (was HOST-CALLBACK)
    An op that waits for the device when its tensor is on a card: on the
    CPU ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, ...),
    ``nonzero``, ``masked_select``, ``unique*``, ``equal`` /
    ``is_nonzero``, a boolean-mask ``index`` and ``repeat_interleave``
    without ``output_size`` (their output shapes depend on the data); on
    the card every warning of the sync-debug window.

``UPLOAD-PER-CALL`` (was CONST-BAKE)
    More than ``max_upload_bytes`` (1 MiB) copied from host to device per
    call: data that should live on the device is re-sent with every batch.
    The recorder counts these bytes at the ops that make the copies
    (:func:`upload_bytes`), so the count does not depend on a profiler
    trace keeping every event; a run on the CPU copies nothing.

``SLOT-REUSE`` (was DONATION-DROPPED)
    PyTorch has no buffer donation; the serving engine's slot rotation
    stands in for it (``serving/svm_engine.py``): every bucket owns
    ``pipeline_depth + 1`` staging slots, a dispatch writes its labels
    into its slot's own ``out`` buffer (the same ``data_ptr``), and on the
    card the allocator's live allocation count does not grow over 100
    dispatches.
"""
from __future__ import annotations

import contextlib
import os
import traceback
import warnings
from typing import Any

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding

#: Host-to-device bytes per call above which UPLOAD-PER-CALL fires.
MAX_UPLOAD_BYTES = 1 << 20   # 1 MiB, the reference's CONST-BAKE limit

#: Ops whose output shape (or value) the host needs: each one waits for
#: the device when its input is on a card.
SYNC_OPS = {
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
    "aten.equal", "aten.is_nonzero",
}

#: Dispatches of one engine bucket slot in the SLOT-REUSE allocation check.
SLOT_DISPATCHES = 100


class OpRecorder(TorchDispatchMode):
    """Record every aten op: its name, its outputs' dtypes, devices and
    shapes, whether it is a host sync on a card, and the bytes it copies
    from the host to a device (summed in ``htod_bytes``)."""

    def __init__(self):
        super().__init__()
        self.ops: list[dict] = []
        self.htod_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket._qualified_op_name).replace("::", ".")
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops.append(dict(
            op=name,
            dtypes=sorted({str(t.dtype) for t in outs}),
            devices=sorted({str(t.device) for t in outs}),
            shapes=[tuple(t.shape) for t in outs],
            sync=_is_sync(name, args, kwargs)))
        self.htod_bytes += upload_bytes(name, args, out)
        return out


def _is_sync(name: str, args: tuple, kwargs: dict) -> bool:
    if name in SYNC_OPS:
        return True
    if name == "aten.index":
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in indices)
    if name == "aten.repeat_interleave":
        return kwargs.get("output_size") is None
    return False


def check_ops(ops: list[dict], *, path: str, symbol: str
              ) -> tuple[list[Finding], dict]:
    """F64-IN-HOT and HOST-SYNC over one run's recorded ops."""
    f64: dict[str, list] = {}
    for o in ops:
        if {"torch.float64", "torch.complex128"} & set(o["dtypes"]):
            f64.setdefault(o["op"], o["shapes"])
    syncs = sorted({o["op"] for o in ops if o["sync"]})
    findings = [Finding(
        rule="F64-IN-HOT", path=path, symbol=symbol,
        message=(f"{op} produces a float64 tensor {shapes} inside a hot "
                 f"entry point — the kernels and banks are f32; cast at "
                 f"the host boundary")) for op, shapes in sorted(f64.items())]
    findings += [Finding(
        rule="HOST-SYNC", path=path, symbol=symbol,
        message=(f"{op} inside a hot entry point waits for the device when "
                 f"its input is on a card (its result's shape or value "
                 f"goes to the host)")) for op in syncs]
    return findings, {"ops": len(ops), "f64_ops": sorted(f64),
                      "sync_ops": syncs}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _on_host(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cpu"


def upload_bytes(name: str, args: tuple, out) -> int:
    """Bytes that one aten op copies from the host to a device: a
    ``.to()`` (``_to_copy``) or ``copy_`` from a host tensor into a
    device one, and ``lift_fresh`` of a device tensor (``torch.tensor(
    data, device=...)`` builds its data on the host and copies it up
    before the mode sees it)."""
    if name == "aten._to_copy":
        src = args[0]
        if _on_host(src) and isinstance(out, torch.Tensor) \
                and not _on_host(out):
            return _nbytes(src)
    elif name == "aten.copy_":
        dst, src = args[0], args[1]
        if _on_host(src) and isinstance(dst, torch.Tensor) \
                and not _on_host(dst):
            return _nbytes(src)
    elif name == "aten.lift_fresh":
        src = args[0]
        if isinstance(src, torch.Tensor) and not _on_host(src):
            return _nbytes(src)
    return 0


def check_uploads(bytes_per_call: float, *, path: str, symbol: str,
                  max_upload_bytes: int = MAX_UPLOAD_BYTES) -> list[Finding]:
    """UPLOAD-PER-CALL for one entry point's HtoD bytes per call."""
    if bytes_per_call <= max_upload_bytes:
        return []
    return [Finding(
        rule="UPLOAD-PER-CALL", path=path, symbol=symbol,
        message=(f"{bytes_per_call:,.0f} B copied host -> device per call "
                 f"(> {max_upload_bytes:,} B) — keep what every call needs "
                 f"on the device"))]


def check_slot_reuse(engine, *, path: str, symbol: str,
                     dispatches: int = SLOT_DISPATCHES
                     ) -> tuple[list[Finding], dict]:
    """SLOT-REUSE on an engine: ``pipeline_depth + 1`` slots per bucket;
    ``dispatches`` dispatches of each bucket's first slot write the labels
    into that slot's own ``out`` and, on a card, leave the allocator's
    live allocation count where it was."""
    findings = []

    def fire(msg):
        findings.append(Finding(rule="SLOT-REUSE", path=path, symbol=symbol,
                                message=msg))

    want = engine.pipeline_depth + 1
    for bucket, slots in engine._staging.items():
        if len(slots) != want:
            fire(f"bucket {bucket} owns {len(slots)} staging slots, not "
                 f"pipeline_depth + 1 = {want}")
    on_card = engine.devices[0].type == "cuda"
    live = {}
    for bucket, slots in engine._staging.items():
        slot = slots[0]
        ptr = slot.out.data_ptr()
        for launch in engine._forward(slot):      # warm the allocator
            launch.wait()
        before = _live_allocations() if on_card else 0
        for _ in range(dispatches):
            slot.ov[:] = -1
            for launch in engine._forward(slot):
                launch.wait()
        after = _live_allocations() if on_card else 0
        live[bucket] = (before, after)
        want_labels = engine.fleet._labels(
            torch.as_tensor(slot.xv).to(engine.fleet.device),
            torch.as_tensor(slot.iv).to(engine.fleet.device)).cpu()
        if slot.out.data_ptr() != ptr:
            fire(f"bucket {bucket}: the slot's out buffer moved")
        if not torch.equal(slot.out, want_labels.to(slot.out.dtype)):
            fire(f"bucket {bucket}: the dispatch did not write its labels "
                 f"into the slot's own out buffer")
        if after > before:
            fire(f"bucket {bucket}: {after - before} more live allocations "
                 f"after {dispatches} dispatches of one slot")
    return findings, {"slots_per_bucket": want, "buckets":
                      sorted(engine._staging), "dispatches": dispatches,
                      "live_allocations": live if on_card else None}


def _live_allocations() -> int:
    torch.cuda.synchronize()
    return int(torch.cuda.memory_stats()["allocation.all.current"])


#: The sync-debug mode's warning text for one synchronizing operation.
SYNC_WARNING = "called a synchronizing CUDA operation"


def _port_frame() -> str:
    """The innermost frame of the port's own code outside this analyzer:
    where a synchronizing call was made."""
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace(os.sep, "/")
        if "/repro_torch/" in path and "/repro_torch/analysis/" not in path:
            return f"{path[path.index('repro_torch/'):]}:{fr.lineno} " \
                   f"({fr.name})"
    return "outside the port's code"


@contextlib.contextmanager
def _sync_warnings(on_card: bool):
    """Where each synchronizing operation inside the context was called
    from (card only): ``torch.cuda.set_sync_debug_mode("warn")`` warns at
    the call, and the warning hook reads the Python stack there."""
    caught: list[str] = []
    if not on_card:
        yield caught
        return
    prior = torch.cuda.get_sync_debug_mode()

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            caught.append(_port_frame())

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(prior)


def _settle(out, on_card: bool) -> None:
    """Wait for an entry's outputs: its launches' events where it returned
    launches (the engine and the sharded leg), then the whole card."""
    if isinstance(out, list):
        for launch in out:
            if hasattr(launch, "wait"):
                launch.wait()
    if on_card:
        torch.cuda.synchronize()


def run_entrypoint(entry, *, on_card: bool = False
                   ) -> tuple[list[Finding], dict]:
    """Run one registry entry (``analysis.entrypoints.EntryPoint``, built
    on the card when ``on_card``) under the recorder, and on a card under
    the sync-debug window, and apply every Pass 1 rule to it.  The window holds the call alone: waiting for its result comes
    after.  A run that raises is itself a finding (an entry point that
    stopped running has broken its contract)."""
    info: dict[str, Any] = {"symbol": entry.symbol, "path": entry.path}
    findings: list[Finding] = []
    try:
        _settle(entry.fn(), on_card)             # warm-up: caches, replicas
        rec = OpRecorder()
        with _sync_warnings(on_card) as syncs:
            with rec:
                out = entry.fn()
        _settle(out, on_card)
    except Exception as e:   # noqa: BLE001 — any failure is a finding
        findings.append(Finding(
            rule="HOST-SYNC", path=entry.path, symbol=entry.symbol,
            message=f"entry point failed to run: {e!r}"))
        info["error"] = repr(e)
        return findings, info
    fnds, oinfo = check_ops(rec.ops, path=entry.path, symbol=entry.symbol)
    findings += fnds
    info.update(oinfo)
    info["htod_bytes_per_call"] = rec.htod_bytes
    findings += check_uploads(rec.htod_bytes, path=entry.path,
                              symbol=entry.symbol,
                              max_upload_bytes=entry.max_upload_bytes)
    if on_card:
        info["card_syncs"] = len(syncs)
        findings += [Finding(
            rule="HOST-SYNC", path=entry.path, symbol=entry.symbol,
            message=f"a synchronizing CUDA operation on the card, called "
                    f"at {site}") for site in sorted(set(syncs))]
    if entry.engine is not None:
        fnds, sinfo = check_slot_reuse(entry.engine, path=entry.path,
                                       symbol=entry.symbol)
        findings += fnds
        info["slot_reuse"] = sinfo
    return findings, info
