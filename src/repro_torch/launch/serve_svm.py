"""SVM fleet serving entry point: stream near-sensor queries through the engine.

The port of ``repro.launch.serve_svm``.  Fits one machine per dataset
(Algorithm 1), co-batches them into a :class:`~repro_torch.api.FleetMachine`
and drives a Poisson query stream through
:class:`~repro_torch.serving.SVMEngine`: many tenants, continuous small
queries, one device dispatch per padded bucket.

The reference's controls: ``--deadline-ms`` / ``--priority-classes``
attach deadlines and priority classes to the stream, ``--queue-bound`` /
``--shed-expired`` switch on admission control (shed requests are
reported), ``--mesh-devices`` serves through the data-parallel forward on a
``make_serving_mesh``, and ``--pipeline-depth`` sets how many batches
overlap staging and compute.  Beside them: ``--device`` (default: the card,
raising without one), ``--fleet`` to serve a saved fleet whose member ids
are dataset names (nothing is fitted), ``--concurrency`` for a closed loop
that keeps that many requests outstanding instead of the Poisson stream,
and ``--trace-queries`` for the device's idle share of one traced window.
On a card the stats carry each bucket's device time per dispatch, and the
summary the hand kernels' launches in the served traffic alone.

It prints the fleet layout and the ``ServingStats`` JSON, and checks every
answered request against its member machine's own labels (equal wherever
the member's scores are off ties, |score| > 1e-5: the engine scores a row
in a padded batch of another height, and on a card the rails' matmuls may
sum in another order there).

  PYTHONPATH=src python -m repro_torch.launch.serve_svm --device cpu \\
      --datasets balance --n-epochs 20 --n-queries 500
  python -m repro_torch.launch.serve_svm \\
      --datasets balance,seeds --rate 5000 --n-queries 4000 \\
      --deadline-ms 25 --priority-classes 2 --queue-bound 2048 \\
      --shed-expired --pipeline-depth 2
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

#: Scores this close to the comparator threshold are ties (DESIGN.md §1.4).
TIE_EPS = 1e-5


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", default="balance,seeds",
                    help="comma-separated fleet tenants")
    ap.add_argument("--target", default="circuit")
    ap.add_argument("--n-epochs", type=int, default=60)
    ap.add_argument("--n-queries", type=int, default=4000)
    ap.add_argument("--rate", type=float, default=5000.0,
                    help="open-loop Poisson arrival rate (queries/s)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="per-device max bucket rows")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request completion deadline (default: none)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="spread requests uniformly over this many "
                         "priority classes (0 = lowest)")
    ap.add_argument("--queue-bound", type=int, default=None,
                    help="pending-row bound; overflow sheds expired then "
                         "lowest-priority work (default: unbounded)")
    ap.add_argument("--shed-expired", action="store_true",
                    help="drop queued requests whose deadline passed "
                         "instead of serving them")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="batches in flight before blocking on the oldest")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="serve through a make_serving_mesh over this "
                         "many devices (default: single-device dispatch)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the fleet (default: the card)")
    ap.add_argument("--fleet", default=None,
                    help="serve this saved fleet (member ids are dataset "
                         "names) instead of fitting one")
    ap.add_argument("--concurrency", type=int, default=None,
                    help="closed loop: keep this many requests "
                         "outstanding (ignores --rate)")
    ap.add_argument("--trace-queries", type=int, default=0,
                    help="after the run, stream this many more queries "
                         "under torch.profiler and report the device's "
                         "idle share of that window")
    return ap


def drive(eng, pools: dict, n_queries: int, rng, rate: float = 5000.0,
          concurrency=None, deadline_ms=None, priority_classes: int = 1):
    """Submit ``n_queries`` single-row requests drawn from ``pools`` (one
    row array per member id): a Poisson stream at ``rate``, or a closed
    loop with ``concurrency`` requests outstanding (each submit past the
    first ``concurrency`` waits for the request that many places before
    it).  Returns ``(requests as (model id, row, priority, future), wall
    s, backpressured submits)``; the wall ends when every future has
    resolved."""
    names = list(pools)
    futures, backpressured = [], 0
    next_t = time.perf_counter()
    t0 = next_t
    for i in range(n_queries):
        name = names[rng.randint(len(names))]
        pool = pools[name]
        x = pool[rng.randint(len(pool))]
        prio = int(rng.randint(priority_classes)) \
            if priority_classes > 1 else 0
        if eng.backpressure:
            backpressured += 1
        if concurrency is not None and i >= concurrency:
            futures[i - concurrency][3].exception(timeout=60.0)  # window full
        fut = eng.submit(x, name, deadline_ms=deadline_ms, priority=prio)
        futures.append((name, x, prio, fut))
        if concurrency is None:
            next_t += rng.exponential(1.0 / rate)
            pause = next_t - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
    for *_, f in futures:
        f.exception(timeout=60.0)
    return futures, time.perf_counter() - t0, backpressured


def check_against_members(fleet, futures) -> dict:
    """Every answered request against its member machine's own labels
    through the fleet's decision front, one batched predict per member;
    equal wherever the member's scores are off ties, or AssertionError."""
    from repro_torch.api import CompiledMachine
    from repro_torch.serving import ShedError

    rows: dict = {}
    for name, x, _, f in futures:
        try:
            lab = f.result()
        except ShedError:
            continue
        rows.setdefault(name, ([], []))
        rows[name][0].append(x)
        rows[name][1].append(lab)
    checked = ties = 0
    for name, (xs, labs) in rows.items():
        m = fleet.member(name)
        if m.decider != fleet.decider:
            m = CompiledMachine(m.n_classes, m._linear_banks,
                                m._kernel_banks, kernel_map=m.kernel_map,
                                decider=fleet.decider, device=m.device)
        x = np.stack(xs)
        want = m.predict(x)
        clear = (np.abs(m.decision_scores(x)) > TIE_EPS).all(axis=1)
        bad = int((np.asarray(labs)[clear] != want[clear]).sum())
        if bad:
            raise AssertionError(f"routing mismatch for {name}: {bad} of "
                                 f"{int(clear.sum())} requests off ties")
        checked += int(clear.sum())
        ties += int((~clear).sum())
    return {"checked_off_ties": checked, "skipped_ties": ties}


def traced_window(fn) -> dict:
    """One ``torch.profiler`` trace of ``fn()``: its wall time, the union
    of the device's busy intervals (kernels and copies) and the idle share
    of the wall; "not measured" where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"wall_ms": wall_ms, "device": "not measured"}
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy_us += hi - lo
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_events": len(spans),
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)}


def load_fleet(args, dev):
    """The fleet to serve and each member's query pool (its test rows)."""
    from repro_torch.api import FleetMachine, MixedKernelSVM, compile_fleet
    from repro_torch.data import datasets

    if args.fleet is not None:
        fleet = FleetMachine.load(args.fleet, device=dev)
        pools = {name: np.asarray(datasets.load(name).x_test, np.float32)
                 for name in fleet.model_ids}
        return fleet, pools
    names = [n.strip() for n in args.datasets.split(",") if n.strip()]
    members, pools = {}, {}
    for name in names:
        ds = datasets.load(name)
        t0 = time.time()
        est = MixedKernelSVM(n_epochs=args.n_epochs, seed=args.seed,
                             device=dev).fit(ds.x_train, ds.y_train)
        members[name] = est.deploy(args.target)
        pools[name] = np.asarray(ds.x_test, np.float32)
        print(f"fit+deploy [{name}] in {time.time() - t0:.1f}s "
              f"(K={members[name].n_classes}, d={members[name].n_features})")
    return compile_fleet(members), pools


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import ShedError, SVMEngine

    dev = resolve_device(args.device)
    fleet, pools = load_fleet(args, dev)
    print(fleet.describe())

    mesh = None
    if args.mesh_devices is not None:
        mesh = make_serving_mesh(args.mesh_devices) if dev.type == "cuda" \
            else make_serving_mesh(devices=[dev] * args.mesh_devices)
        print(f"mesh: {args.mesh_devices} device(s) on the "
              f"'{mesh.axis_names[0]}' axis")

    with SVMEngine(fleet, max_batch=args.max_batch,
                   max_wait_ms=args.max_wait_ms, mesh=mesh,
                   pipeline_depth=args.pipeline_depth,
                   queue_bound=args.queue_bound,
                   shed_expired=args.shed_expired) as eng:
        eng.warmup()
        ops.reset_launches()
        stream = dict(rate=args.rate, concurrency=args.concurrency,
                      deadline_ms=args.deadline_ms,
                      priority_classes=args.priority_classes)
        futures, wall, backpressured = drive(
            eng, pools, args.n_queries, np.random.RandomState(args.seed),
            **stream)
        # The kernel launches of the served traffic: zeroed just before
        # the window, read just after it, while the batcher idles (only it
        # launches while the engine runs).
        launches = ops.launch_counts()
        summary = eng.stats.summary()
        if args.trace_queries:
            summary["trace"] = traced_window(lambda: drive(
                eng, pools, args.trace_queries,
                np.random.RandomState(args.seed + 1), **stream))
            summary["trace"]["queries"] = args.trace_queries
    shed = [p for _, _, p, f in futures
            if isinstance(f.exception(), ShedError)]
    summary["wall_s"] = wall
    summary["offered_rate"] = None if args.concurrency else args.rate
    summary["launches"] = launches
    if args.concurrency:
        summary["concurrency"] = args.concurrency
    if shed or args.queue_bound is not None or args.shed_expired:
        summary["shed_futures"] = len(shed)
        summary["shed_by_priority"] = {
            str(p): shed.count(p) for p in sorted(set(shed))}
        summary["backpressured_submits"] = backpressured
    summary["routing"] = check_against_members(fleet, futures)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
