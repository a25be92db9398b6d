"""The port's SVM serving engine and its serving entry point.

On the CPU (``device="cpu"``), mirroring tests/test_serving_svm.py case by
case at its shapes (hand-built machines, no training):

* the bucket policy's edges; the engine's routing (labels equal the member
  machines' exactly on the CPU, and the reference members' off ties), its
  bucket edges (1, max_batch and max_batch + 1 rows), stats accounting,
  lifecycle, the flat stats memory;
* the batch former driven directly: priority classes with EDF backfill,
  expiry shedding, bounded-queue admission, and the end-to-end overload
  burst (only the lowest class shed), watermarks, the carried request
  leading the next batch, ``pipeline_depth`` over depth + 1 slots;
* the reference's compile-count check has no twin (there is no jit cache):
  every dispatch lands on a bucket height and the staging holds exactly one
  set of slots per bucket;
* a serving mesh of one CPU device equals the plain engine, and a 4-device
  CPU mesh serves mixed models end to end;
* what the reference leaves undefined: an error raised at dispatch or
  surfacing at a batch's wait fails that batch's futures and stops the
  engine; a slot is never restaged while its batch is in flight;
* ``launch.serve_svm`` end to end on a saved fleet.
"""
import math
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro_torch.api import compile_fleet
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serving import BucketPolicy, ServingStats, ShedError, SVMEngine
from repro_torch.serving.svm_engine import _Request
from test_torch_fleet import TIE_EPS, tiny_machine


def _queries(gen, n, d):
    return gen.normal(size=(n, d)).astype(np.float32)


# -- BucketPolicy ------------------------------------------------------------


def test_bucket_policy_edges():
    p = BucketPolicy(max_batch=64, min_bucket=8)
    assert p.buckets == (8, 16, 32, 64)
    assert p.bucket_for(1) == 8
    assert p.bucket_for(8) == 8
    assert p.bucket_for(9) == 16
    assert p.bucket_for(64) == 64
    with pytest.raises(ValueError):
        p.bucket_for(0)
    with pytest.raises(ValueError):
        p.bucket_for(65)
    with pytest.raises(ValueError, match="powers of two"):
        BucketPolicy(max_batch=48)
    with pytest.raises(ValueError, match="min_bucket"):
        BucketPolicy(max_batch=8, min_bucket=16)


# -- SVMEngine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_fleet():
    return compile_fleet({
        "a": tiny_machine(20, d=3, m=6, n_classes=3),
        "b": tiny_machine(21, d=4, m=8, n_classes=3),
    })


def test_engine_routing_matches_members(engine_fleet):
    fleet = engine_fleet
    gen = np.random.default_rng(0)
    with SVMEngine(fleet, max_batch=32, max_wait_ms=1.0) as eng:
        eng.warmup()
        futs = []
        for _ in range(100):
            mid = fleet.model_ids[int(gen.integers(0, 2))]
            m = fleet.member(mid)
            x = _queries(gen, 1, m.n_features)[0]     # 1-D -> scalar label
            futs.append((mid, x, eng.submit(x, mid)))
        for mid, x, f in futs:
            want = int(fleet.member(mid).predict(x[None])[0])
            assert f.result(timeout=30.0) == want


def test_engine_matches_reference_members_off_ties():
    """The port's engine against the reference's member machines built
    from the same models: labels equal wherever the scores are off ties."""
    ref = {"a": tiny_machine(20, pkg="ref"),
           "b": tiny_machine(2, d=4, analog_pairs=(1,), pkg="ref")}
    fleet = compile_fleet({"a": tiny_machine(20),
                           "b": tiny_machine(2, d=4, analog_pairs=(1,))})
    gen = np.random.default_rng(4)
    with SVMEngine(fleet, max_batch=16, max_wait_ms=0.5) as eng:
        eng.warmup()
        reqs = [(mid, _queries(gen, 5, ref[mid].n_features))
                for mid in ("a", "b") * 8]
        futs = [eng.submit(x, mid) for mid, x in reqs]
        for (mid, x), f in zip(reqs, futs):
            scores = np.asarray(ref[mid].decision_scores(x))
            clear = (np.abs(scores) > TIE_EPS).all(axis=1)
            np.testing.assert_array_equal(
                f.result(timeout=30.0)[clear],
                np.asarray(ref[mid].predict(x))[clear])


def test_engine_bucket_edge_batches(engine_fleet):
    """1 row, exactly max_batch rows, and max_batch + 1 rows (carry into a
    second batch) all produce correct labels."""
    fleet = engine_fleet
    m = fleet.member("a")
    gen = np.random.default_rng(1)
    with SVMEngine(fleet, max_batch=32, max_wait_ms=1.0) as eng:
        eng.warmup()
        for n in (1, 32, 33):
            x = _queries(gen, n, m.n_features)
            want = m.predict(x)
            if n <= 32:                     # one multi-row request
                got = eng.predict(x, "a")
                np.testing.assert_array_equal(np.atleast_1d(got), want)
            # same rows as single-row requests (n=33 spans two batches)
            futs = [eng.submit(x[i], "a") for i in range(n)]
            got = np.asarray([f.result(timeout=30.0) for f in futs])
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="rows"):
            eng.submit(_queries(gen, 33, m.n_features), "a")


def test_engine_dispatches_land_on_bucket_heights():
    """The padded-bucket contract: every dispatch (warm-up and mixed
    traffic) has a bucket's height, and the staging holds exactly one set
    of pipeline_depth + 1 slots per bucket (the port's twin of the
    reference's one-compile-per-bucket check)."""
    fleet = compile_fleet({"a": tiny_machine(30), "b": tiny_machine(31)})
    gen = np.random.default_rng(2)
    heights = []
    with SVMEngine(fleet, max_batch=32, min_bucket=8,
                   max_wait_ms=0.5) as eng:
        orig = eng._forward

        def record(slot):
            heights.append(int(slot.x.shape[0]))
            return orig(slot)

        eng._forward = record
        eng.warmup()
        assert eng.n_buckets == 3           # 8, 16, 32
        assert heights == [8, 16, 32]
        futs = [eng.submit(_queries(gen, int(k), 3), "a")
                for k in gen.integers(1, 33, size=40)]
        for f in futs:
            f.result(timeout=30.0)
    assert set(heights) <= set(eng.policy.buckets) and len(heights) > 3
    assert sorted(eng._staging) == list(eng.policy.buckets)
    for b, slots in eng._staging.items():
        assert len(slots) == eng.pipeline_depth + 1
        assert all(s.x.shape == (b, fleet.n_features) for s in slots)
        assert not any(s.in_flight for s in slots)


def test_engine_stats_accounting(engine_fleet):
    fleet = engine_fleet
    gen = np.random.default_rng(3)
    stats = ServingStats()
    assert stats.summary() == {"n_requests": 0, "n_queries": 0,
                               "n_batches": 0}
    with SVMEngine(fleet, max_batch=16, max_wait_ms=1.0,
                   stats=stats) as eng:
        eng.warmup()
        futs = [eng.submit(_queries(gen, 3, 3), "a") for _ in range(20)]
        for f in futs:
            f.result(timeout=30.0)
    s = stats.summary()
    assert s["n_requests"] == 20
    assert s["n_queries"] == 60             # rows, not requests
    assert 1 <= s["n_batches"] <= 20
    assert 0.0 < s["batch_occupancy"] <= 1.0
    assert s["latency_ms"]["p50"] <= s["latency_ms"]["p99"] \
        <= s["latency_ms"]["max"]
    assert s["queue_wait_ms_p50"] >= 0.0
    # each dispatch's host time per bucket; no device timing on the CPU
    assert sum(d["n"] for d in s["dispatch"].values()) == s["n_batches"]
    assert all(d["host_ms"] > 0 and d["device_ms"] is None
               for d in s["dispatch"].values())
    stats.reset()
    assert stats.n_requests == 0


def test_engine_lifecycle_and_bare_machine():
    machine = tiny_machine(40)
    eng = SVMEngine(machine, max_batch=8)   # bare machine -> 1-member fleet
    assert eng.fleet.model_ids == ["default"]
    assert eng.devices == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit(np.zeros(3, np.float32))
    with eng:
        with pytest.raises(RuntimeError, match="already started"):
            eng.start()
        lab = eng.predict(np.zeros(3, np.float32))
        assert lab == int(machine.predict(np.zeros((1, 3), np.float32))[0])
    with pytest.raises(RuntimeError):
        eng.submit(np.zeros(3, np.float32))
    with pytest.raises(TypeError, match="cannot serve"):
        SVMEngine(object())


def test_engine_decider_override(engine_fleet):
    """``decider=`` rebuilds the fleet around the same members."""
    eng = SVMEngine(engine_fleet, max_batch=8, decider="dag")
    assert eng.fleet.decider == "dag"
    assert eng.fleet._members == engine_fleet._members
    gen = np.random.default_rng(12)
    x = _queries(gen, 6, 4)
    with eng:
        np.testing.assert_array_equal(
            eng.predict(x, "b"),
            eng.fleet.predict(x, "b"))


# -- ServingStats memory bound -----------------------------------------------


class _FakeReq:
    def __init__(self, t0, wait, service, n_rows=1, deadline=None):
        self.t_enqueue = t0
        self.t_dispatch = t0 + wait
        self.t_complete = t0 + wait + service
        self.n_rows = n_rows
        self.deadline = math.inf if deadline is None else deadline


def test_stats_memory_stays_flat_with_tolerable_percentiles():
    """Streaming totals are exact and the latency sample is a fixed-size
    reservoir: feeding 200x the reservoir capacity must not grow memory,
    and reservoir percentiles must track the exact ones."""
    stats = ServingStats(reservoir=512, seed=0)
    gen = np.random.default_rng(0)
    exact = []
    n_total = 512 * 200
    batch = 64
    footprint = stats._res.nbytes
    t = 0.0
    for _ in range(0, n_total, batch):
        reqs = []
        for _ in range(batch):
            wait = float(gen.exponential(0.001))
            service = float(gen.exponential(0.002))
            reqs.append(_FakeReq(t, wait, service))
            exact.append((wait + service) * 1e3)
            t += 1e-4
        stats.observe_batch(batch, 64, reqs, host_ms=0.1, device_ms=0.05)
    assert stats._res.nbytes == footprint
    assert stats._res.shape == (512, 2)
    assert not any(isinstance(v, list) and len(v) > 1024
                   for v in vars(stats).values())
    assert len(stats._dispatch) == 1        # one accumulator per bucket
    s = stats.summary()
    assert s["n_requests"] == n_total
    assert s["n_queries"] == n_total
    assert s["latency_ms"]["mean"] == pytest.approx(
        float(np.mean(exact)), abs=5e-4)
    assert s["latency_ms"]["max"] == pytest.approx(
        float(np.max(exact)), abs=5e-4)
    for q in (50, 95, 99):
        want = float(np.percentile(exact, q))
        got = s["latency_ms"][f"p{q}"]
        assert got == pytest.approx(want, rel=0.25), (q, got, want)
    assert s["latency_sample_n"] == 512
    assert s["dispatch"]["64"]["device_ms"] == pytest.approx(0.05)


# -- deadline / priority batch former ----------------------------------------


def _mk_req(eng, seq, *, n_rows=1, priority=0, deadline=None, t0=None):
    """Hand-built queued request for direct batch-former tests."""
    now = time.perf_counter() if t0 is None else t0
    d = eng.fleet.n_features
    return _Request(x=np.zeros((n_rows, d), np.float32), model_idx=0,
                    n_rows=n_rows, scalar=n_rows == 1, future=Future(),
                    t_enqueue=now, priority=priority, seq=seq,
                    deadline=math.inf if deadline is None else deadline)


def test_batch_former_priority_and_edf_backfill(engine_fleet):
    """Selection order: expiring requests EDF across classes (backfill),
    then strictly by priority class; low-priority non-expiring work never
    precedes high-priority work (no inversion)."""
    eng = SVMEngine(engine_fleet, max_batch=32, max_wait_ms=1.0)
    now = time.perf_counter()
    horizon = eng._horizon(now)
    a = _mk_req(eng, 0, priority=2)                       # high, no deadline
    b = _mk_req(eng, 1, priority=0)                       # low, no deadline
    c = _mk_req(eng, 2, priority=0, deadline=horizon)     # low, expiring
    d = _mk_req(eng, 3, priority=2, deadline=horizon - 1e-4)  # high, expiring
    with eng._cond:
        for r in (a, b, c, d):
            eng._enqueue(r)
        order = [eng._select_locked(now) for _ in range(4)]
    assert [r.seq for r in order] == [3, 2, 0, 1]
    e = _mk_req(eng, 4, priority=0, deadline=horizon)
    f = _mk_req(eng, 5, priority=1, deadline=horizon)
    with eng._cond:
        eng._enqueue(e)
        eng._enqueue(f)
        assert eng._select_locked(now).seq == 5
        assert eng._select_locked(now).seq == 4


def test_batch_former_sheds_expired_when_enabled(engine_fleet):
    eng = SVMEngine(engine_fleet, max_batch=32, shed_expired=True)
    now = time.perf_counter()
    dead = _mk_req(eng, 0, deadline=now - 1.0)
    live = _mk_req(eng, 1)
    with eng._cond:
        eng._enqueue(dead)
        eng._enqueue(live)
        assert eng._select_locked(now).seq == 1
        assert eng._select_locked(now) is None
    with pytest.raises(ShedError, match="expired"):
        dead.future.result(timeout=0)
    assert eng.stats.summary()["shed"]["reasons"] == {"expired": 1}
    eng2 = SVMEngine(engine_fleet, max_batch=32)
    stale = _mk_req(eng2, 0, deadline=now - 1.0)
    with eng2._cond:
        eng2._enqueue(stale)
        assert eng2._select_locked(now).seq == 0


def test_admission_sheds_expired_then_lowest_priority(engine_fleet):
    """Bounded-queue admission: room is made by shedding already-expired
    work first, then strictly lower-priority work (latest deadline
    first); an incoming request with no lower class is itself shed."""
    eng = SVMEngine(engine_fleet, max_batch=32, queue_bound=4)
    now = time.perf_counter()
    expired = _mk_req(eng, 0, priority=5, deadline=now - 1.0)
    lo_late = _mk_req(eng, 1, priority=0, deadline=now + 9.0)
    lo_soon = _mk_req(eng, 2, priority=0, deadline=now + 1.0)
    with eng._cond:
        for r in (expired, lo_late, lo_soon):
            eng._enqueue(r)
        incoming = _mk_req(eng, 3, priority=1, n_rows=3)
        eng._admit_over_bound(incoming, now)
        assert eng._pending_rows == 4      # lo_soon (1) + incoming (3)
    with pytest.raises(ShedError, match="expired"):
        expired.future.result(timeout=0)
    with pytest.raises(ShedError, match="overflow"):
        lo_late.future.result(timeout=0)
    assert not lo_soon.future.done()
    assert not incoming.future.done()
    with eng._cond:
        loser = _mk_req(eng, 4, priority=0, n_rows=3)
        eng._admit_over_bound(loser, now)
    with pytest.raises(ShedError, match="overflow"):
        loser.future.result(timeout=0)
    assert not lo_soon.future.done()
    assert eng.stats.summary()["shed"]["reasons"] == \
        {"expired": 1, "overflow": 2}


def _slowed(eng, seconds):
    orig = eng._forward

    def slow_forward(slot):
        time.sleep(seconds)
        return orig(slot)

    eng._forward = slow_forward


def test_overload_burst_sheds_only_lowest_priority(engine_fleet):
    """End-to-end overload: a burst larger than the queue bound against a
    slowed-down device sheds SOME priority-0 work and NO priority-1 work;
    everything not shed completes correctly."""
    fleet = engine_fleet
    eng = SVMEngine(fleet, max_batch=8, max_wait_ms=0.5, queue_bound=16,
                    shed_expired=True)
    _slowed(eng, 0.02)
    gen = np.random.default_rng(5)
    with eng:
        eng.warmup()
        x = _queries(gen, 1, 3)[0]
        lo = [eng.submit(x, "a", priority=0) for _ in range(120)]
        hi = [eng.submit(x, "a", priority=1) for _ in range(12)]
        want = int(fleet.member("a").predict(x[None])[0])
        shed_lo = 0
        for f in lo:
            try:
                assert f.result(timeout=60.0) == want
            except ShedError as e:
                assert e.reason in ("overflow", "expired")
                shed_lo += 1
        for f in hi:          # high priority is NEVER shed here
            assert f.result(timeout=60.0) == want
    assert shed_lo > 0
    assert eng.stats.n_shed == shed_lo


def test_backpressure_watermarks(engine_fleet):
    eng = SVMEngine(engine_fleet, max_batch=8, max_wait_ms=0.5,
                    queue_bound=64, high_watermark=32, low_watermark=8)
    _slowed(eng, 0.01)
    gen = np.random.default_rng(6)
    with eng:
        eng.warmup()
        assert eng.backpressure is False
        futs = [eng.submit(_queries(gen, 8, 3), "a") for _ in range(6)]
        assert eng.backpressure is True        # 48 pending rows >= 32
        for f in futs:
            f.result(timeout=60.0)
        deadline = time.monotonic() + 10.0
        while eng.backpressure and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.backpressure is False       # drained below low watermark


def test_carry_leads_next_batch_with_original_enqueue(engine_fleet):
    """A request that overflows the forming batch is carried and MUST be
    row 0 of the next dispatch, keeping its original enqueue time (its
    max-wait anchor) — large requests cannot starve behind small ones."""
    dispatched = []
    eng = SVMEngine(engine_fleet, max_batch=8, max_wait_ms=30.0)
    orig = eng._dispatch

    def record(batch, rows):
        dispatched.append(list(batch))
        orig(batch, rows)

    eng._dispatch = record
    gen = np.random.default_rng(7)
    with eng:
        eng.warmup()
        dispatched.clear()
        f1 = eng.submit(_queries(gen, 5, 3), "a")
        time.sleep(0.005)                      # batcher anchors on f1
        f2 = eng.submit(_queries(gen, 6, 3), "a")   # 5 + 6 > 8 -> carry
        r1 = f1.result(timeout=30.0)
        r2 = f2.result(timeout=30.0)
        assert len(r1) == 5 and len(r2) == 6
    assert len(dispatched) >= 2
    assert [r.n_rows for r in dispatched[0]] == [5]
    carry_batch = dispatched[1]
    assert carry_batch[0].n_rows == 6          # carried -> batch[0]
    assert carry_batch[0].t_enqueue <= dispatched[0][0].t_dispatch


def test_pipeline_depth_k(engine_fleet):
    """pipeline_depth=k keeps at most k batches in flight over k+1 staging
    slots and still resolves every request correctly."""
    fleet = engine_fleet
    m = fleet.member("a")
    gen = np.random.default_rng(8)
    with pytest.raises(ValueError, match="pipeline_depth"):
        SVMEngine(fleet, pipeline_depth=0)
    peak = []
    with SVMEngine(fleet, max_batch=16, max_wait_ms=0.2,
                   pipeline_depth=3) as eng:
        assert all(len(slots) == 4 for slots in eng._staging.values())
        orig = eng._forward

        def record(slot):
            peak.append(len(eng._inflight))
            return orig(slot)

        eng._forward = record
        eng.warmup()
        xs = [_queries(gen, 3, 3) for _ in range(50)]
        futs = [eng.submit(x, "a") for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_array_equal(f.result(timeout=30.0),
                                          m.predict(x))
    assert max(peak) <= 3


def test_slot_is_not_restaged_while_in_flight(engine_fleet):
    eng = SVMEngine(engine_fleet, max_batch=8)
    eng._staging[8][0].in_flight = True
    with pytest.raises(AssertionError, match="in flight"):
        eng._dispatch([_mk_req(eng, 0)], 1)


# -- failures ------------------------------------------------------------------


class _FailingLaunch:
    start = None

    def wait(self):
        raise RuntimeError("CUDA error: an illegal memory access")


def test_error_at_the_wait_fails_the_batch_and_stops_the_engine(engine_fleet):
    eng = SVMEngine(engine_fleet, max_batch=8, max_wait_ms=0.5)
    orig = eng._forward
    calls = []

    def failing(slot):
        calls.append(slot)
        launches = orig(slot)
        return [_FailingLaunch()] if len(calls) > 1 else launches

    eng._forward = failing
    with eng:
        ok = eng.submit(np.zeros(3, np.float32), "a")
        assert ok.result(timeout=30.0) in (0, 1, 2)
        bad = eng.submit(np.zeros(3, np.float32), "a")
        with pytest.raises(RuntimeError, match="illegal memory access"):
            bad.result(timeout=30.0)
        deadline = time.monotonic() + 10.0
        while eng._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not eng._thread.is_alive()     # the batcher did not carry on
        with pytest.raises(RuntimeError, match="failed batch"):
            eng.submit(np.zeros(3, np.float32), "a")


def test_error_at_dispatch_fails_every_pending_future(engine_fleet):
    eng = SVMEngine(engine_fleet, max_batch=8, max_wait_ms=50.0)

    def broken(slot):
        raise ValueError("launch refused")

    eng._forward = broken
    with eng:
        futs = [eng.submit(np.zeros((3, 3), np.float32), "a")
                for _ in range(5)]
        errors = [f.exception(timeout=30.0) for f in futs]
    assert isinstance(errors[0], ValueError)
    assert all(isinstance(e, (ValueError, RuntimeError)) for e in errors)
    assert any(isinstance(e, RuntimeError) and
               isinstance(e.__cause__, ValueError) for e in errors)


# -- mesh-sharded dispatch ---------------------------------------------------------


def test_engine_mesh_on_one_device(engine_fleet):
    """mesh= dispatch on a 1-device serving mesh: labels identical to the
    plain engine, buckets become per-device sizes."""
    fleet = engine_fleet
    mesh = mesh_mod.make_serving_mesh(devices=["cpu"])
    gen = np.random.default_rng(9)
    xs = {mid: _queries(gen, 11, fleet.member(mid).n_features)
          for mid in fleet.model_ids}
    with SVMEngine(fleet, max_batch=16, max_wait_ms=0.5) as plain:
        want = {mid: plain.predict(x, mid) for mid, x in xs.items()}
    with SVMEngine(fleet, max_batch=16, max_wait_ms=0.5, mesh=mesh) as eng:
        assert eng.n_devices == 1 and eng.max_rows == 16
        eng.warmup()
        for mid, x in xs.items():
            got = eng.predict(x, mid)
            np.testing.assert_array_equal(got, want[mid])
            np.testing.assert_array_equal(got, fleet.member(mid).predict(x))


def test_engine_through_a_four_device_mesh():
    """The engine end to end through a 4-device CPU serving mesh: mixed
    models with deadlines, buckets of whole per-device slices."""
    fleet = compile_fleet({
        "tiny": tiny_machine(0, d=3, m=6, n_classes=3),
        "wide": tiny_machine(1, d=5, m=8, n_classes=4),
        "analog": tiny_machine(2, d=4, m=6, n_classes=3, analog_pairs=(1,)),
    })
    mesh = mesh_mod.make_serving_mesh(devices=["cpu"] * 4)
    gen = np.random.default_rng(0)
    with SVMEngine(fleet, max_batch=16, max_wait_ms=1.0, mesh=mesh) as eng:
        assert eng.max_rows == 16 * 4
        assert all(s.x.shape[0] == 4 * b for b, slots in eng._staging.items()
                   for s in slots)
        eng.warmup()
        futs = []
        for i in range(40):
            mid = fleet.model_ids[i % 3]
            q = _queries(gen, 3, fleet.member(mid).n_features)
            futs.append((mid, q, eng.submit(q, mid, deadline_ms=5e3)))
        for mid, q, f in futs:
            np.testing.assert_array_equal(
                f.result(timeout=60.0), fleet.member(mid).predict(q))


# -- the serving entry point --------------------------------------------------------


def test_serve_svm_main_on_a_saved_fleet(tmp_path):
    """``launch.serve_svm`` on the CPU: a saved fleet whose members are
    named after datasets, served open loop, closed loop and through a
    2-device mesh, every answered request checked against its member."""
    from repro_torch.launch import serve_svm

    fleet = compile_fleet({"balance": tiny_machine(50, d=4),
                           "seeds": tiny_machine(51, d=5, analog_pairs=(1,))})
    path = str(tmp_path / "fleet")
    fleet.save(path)
    base = ["--device", "cpu", "--fleet", path, "--n-queries", "300",
            "--max-batch", "32"]
    s = serve_svm.main(base + ["--rate", "20000", "--trace-queries", "50"])
    assert s["n_queries"] == 300 and s["offered_rate"] == 20000.0
    assert s["trace"]["queries"] == 50 and s["trace"]["wall_ms"] > 0
    assert s["launches"]["kernel_matrix"] == 0   # plain versions on the CPU
    assert s["routing"]["checked_off_ties"] + \
        s["routing"]["skipped_ties"] == 300
    s = serve_svm.main(base + ["--concurrency", "64", "--mesh-devices", "2"])
    assert s["n_queries"] == 300 and s["concurrency"] == 64
    assert s["offered_rate"] is None
    s = serve_svm.main(base + ["--rate", "50000", "--deadline-ms", "25",
                               "--priority-classes", "2", "--queue-bound",
                               "64", "--shed-expired", "--pipeline-depth",
                               "2"])
    assert s["n_queries"] + s["shed_futures"] == 300
    assert sum(s["shed_by_priority"].values()) == s["shed_futures"]
    assert set(s["shed_by_priority"]) <= {"0", "1"}


def test_concurrent_producers_under_a_short_switch_interval(engine_fleet):
    """Eight producer threads submit at once while the interpreter switches
    threads every microsecond: every request resolves to its member's
    label and the stats count every one (a lost update in the queues, the
    pending-row count or the stats would break one of the three)."""
    import sys
    import threading

    fleet = engine_fleet
    gen = np.random.default_rng(13)
    xs = {mid: _queries(gen, 40, fleet.member(mid).n_features)
          for mid in fleet.model_ids}
    want = {mid: fleet.member(mid).predict(x) for mid, x in xs.items()}
    results, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with SVMEngine(fleet, max_batch=32, max_wait_ms=0.5,
                       pipeline_depth=2) as eng:
            def produce(t):
                try:
                    mid = fleet.model_ids[t % 2]
                    futs = [(mid, i, eng.submit(xs[mid][i], mid))
                            for i in range(40)]
                    results.extend((mid, i, f.result(timeout=60.0))
                                   for mid, i, f in futs)
                except Exception as e:       # reported below
                    errors.append(e)

            threads = [threading.Thread(target=produce, args=(t,))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(results) == 8 * 40
    for mid, i, lab in results:
        assert lab == want[mid][i]
    assert eng.stats.n_requests == 8 * 40
    assert eng._pending_rows == 0
