"""The port's request gateway, on the CPU (and one case on the card).

The cases of ``tests/test_gateway.py`` are held to the same contracts on
the port: size and deadline flush triggers, power-of-two pad widths,
maintenance shed strictly before any request is rejected, read-your-writes
under threaded clients, and an idempotent, concurrency-safe close with no
hanging future. The reference's flat jit cache becomes the port's own
contract: every flush lands on a warmed power-of-two width in [min_pad,
max_batch], and after ``warmup()`` the kernel library is neither built nor
loaded again. The waves the port's gateway dispatched, replayed through
the JAX router's ``apply_wave``, give the same results and contents. The
kernel library's first load is built once however many threads race to
it. The passthrough baseline serves one request per wave (one of each op
kind under concurrent clients), its waves replayed through the JAX
router; the completion hook runs once per completed future, never for a
failed wave or a rejected request. A ``gpu`` case runs the gateway over
the overlapped tuner on CUDA.

Every join, wait and result here has a timeout, and running into it fails
the test.
"""
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
from repro.core import ShardedUpLIF as JaxRouter
from repro.core.sharded import MixedWave as JaxMixedWave
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import ShardedUpLIF, UpLIFConfig
from repro_torch.core.shapes import (
    bucket_width,
    grow_capacity,
    padded_width,
    pow2_at_least,
)
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.serve import (
    AdmissionController,
    GatewayClosed,
    GatewayConfig,
    PrefixCacheIndex,
    RequestGateway,
    RetryAfter,
)
from repro_torch.tuning import A_RETRAIN_SHARD, SelfTuner
from tests.conftest import make_keys
from tests.test_torch_sharded import assert_same_state

WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mk_index(n=2048, shards=2, seed=0, device="cpu"):
    keys = make_keys(n, seed)
    return ShardedUpLIF(
        keys, keys * 2 + 1,
        UpLIFConfig(batch_bucket=256, bmat_capacity=1 << 13),
        n_shards=shards, device=device,
    ), keys


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# ---------------------------------------------------------------- shapes


def test_shapes_quantization_family():
    assert [pow2_at_least(n) for n in (0, 1, 2, 3, 255, 256, 257)] == [
        1, 1, 2, 4, 256, 256, 512,
    ]
    for need in (1, 7, 256, 1000):
        cap = grow_capacity(need)
        assert cap >= 2 * need and cap & (cap - 1) == 0
    assert bucket_width(10, 256) == 256
    assert bucket_width(300, 256) == 512
    assert bucket_width(1000, 256) == 1024
    assert bucket_width(1025, 256) == 1280  # non-pow2 multiple (bulk path)
    assert padded_width(1) == 256
    assert padded_width(257) == 512
    assert padded_width(5000, floor=256, ceiling=1024) == 1024
    widths = {padded_width(n, floor=256, ceiling=2048) for n in range(1, 2049)}
    assert widths == {256, 512, 1024, 2048}


# ------------------------------------------------------------ flush triggers


def test_size_flush_fires_before_deadline():
    idx, keys = _mk_index()
    gw = RequestGateway(
        idx, config=GatewayConfig(max_batch=8, max_delay_s=30.0)
    )
    try:
        futs = [gw.submit_lookup(int(k)) for k in keys[:8]]
        for f, k in zip(futs, keys[:8]):
            found, v = f.result(WAIT_S)
            assert found and v == int(k) * 2 + 1
        st = gw.stats()
        assert st["flush_triggers"]["size"] >= 1
        assert st["flush_triggers"]["deadline"] == 0
    finally:
        gw.close()


def test_deadline_flush_fires_below_size():
    idx, keys = _mk_index()
    gw = RequestGateway(
        idx, config=GatewayConfig(max_batch=1024, max_delay_s=0.01)
    )
    try:
        futs = [gw.submit_lookup(int(k)) for k in keys[:3]]
        for f in futs:
            assert f.result(WAIT_S)[0]
        rk, rv = gw.submit_range(int(keys[0]), int(keys[10])).result(WAIT_S)
        hits = rk[rk < np.iinfo(np.int64).max]
        assert len(hits) == 11 and int(hits[0]) == int(keys[0])
        np.testing.assert_array_equal(rv, rk * 2 + 1)
        st = gw.stats()
        assert st["flush_triggers"]["deadline"] >= 1
        assert st["flush_triggers"]["size"] == 0
        assert all(f.queue_latency_s < 5.0 for f in futs)
    finally:
        gw.close()


# --------------------------------------- padding + the flat-library contract


def test_pad_widths_quantized_and_jit_cache_flat(monkeypatch):
    """The reference pins a flat jit cache after warmup. The port has no
    jit: every flush lands on a warmed power-of-two width in [min_pad,
    max_batch], and the kernel library is neither built nor loaded again
    after ``warmup()``."""
    builds = []
    real_build = kbuild.build

    def counting_build():
        builds.append(time.perf_counter())
        return real_build()

    monkeypatch.setattr(kbuild, "build", counting_build)
    idx, keys = _mk_index(4096)
    gw = RequestGateway(
        idx, config=GatewayConfig(max_batch=512, max_delay_s=0.002)
    )
    try:
        primed = gw.warmup()
        assert primed["lookup"] == [256, 512]
        assert primed["insert"] == [256, 512] == primed["delete"]
        assert primed["range"] == [256]
        info0, n_builds0 = kbuild.library.cache_info(), len(builds)
        rng = np.random.default_rng(7)
        futs = []
        for burst in (1, 3, 17, 130, 300, 511, 97):
            pick = rng.choice(keys, burst)
            futs += [gw.submit_lookup(int(k)) for k in pick]
            futs.append(gw.submit_insert(int(pick[0]), 5))
            futs.append(gw.submit_delete(int(pick[-1])))
            time.sleep(0.004)
        for f in futs:
            f.result(WAIT_S)
        st = gw.stats()
        assert st["waves"] >= 2
        for op, hist in st["pad_widths"].items():
            for w in hist:
                assert w & (w - 1) == 0, (op, w)
                assert 256 <= w <= 512, (op, w)
                assert w in primed[op], (op, w)
        assert kbuild.library.cache_info().misses == info0.misses
        assert len(builds) == n_builds0
    finally:
        gw.close()


def test_warmup_reads_one_slot_key():
    """Warmup finds the first live slot key on the device (one element
    comes back) and primes inserts with it, as the reference does with the
    whole slot array on the host."""
    idx, keys = _mk_index(4096)
    gw = RequestGateway(idx, config=GatewayConfig(max_batch=256))
    try:
        sk = idx.state.slots.keys.numpy().ravel()
        want = int(sk[sk < np.iinfo(np.int64).max][0])
        assert gw._first_slot_key() == want == int(keys[0])
        before = idx.state
        gw.warmup()
        f, v = idx.lookup(keys)
        assert f.all() and np.array_equal(v, keys * 2 + 1)
        assert idx.size == len(keys) and idx.state is not before
    finally:
        gw.close()


# ------------------------------------------------------- overload ladder


def test_admission_ladder_sheds_maintenance_strictly_first():
    adm = AdmissionController(capacity=100)
    assert adm.level(49) == 0
    assert adm.level(50) == 1     # maintenance shed here ...
    assert adm.level(89) == 1
    assert adm.level(90) == 2     # ... requests only here
    # structural: a growing backlog crosses level 1 before level 2; the
    # port refuses the inverted ladder with a ValueError, not an assert
    with pytest.raises(ValueError):
        AdmissionController(
            capacity=100, shed_maintenance_at=0.9, shed_requests_at=0.5
        )
    assert 0.001 <= adm.retry_after(95, 0.0) <= 5.0
    assert adm.retry_after(200, 10.0) >= adm.retry_after(95, 10.0)


def test_scheduler_sheds_under_pressure():
    idx, _ = _mk_index()
    tuner = SelfTuner().attach(idx)
    sched = tuner.scheduler
    tuner.set_pressure(1)
    b0 = sched._budget
    tuner.after_wave(1000, 0.5)
    assert sched.n_shed_waves == 1
    assert sched._budget == b0          # no refill while shedding
    assert not sched._admit(idx, A_RETRAIN_SHARD, 0, False)
    tuner.set_pressure(0)
    tuner.after_wave(1000, 0.5)
    assert sched._budget > b0           # healthy again: budget accrues
    assert tuner.stats()["shed_waves"] == 1
    tuner.close()


class _SlowIndex:
    """Router wrapper: every wave takes ``delay``, so backlog builds fast."""

    def __init__(self, inner, delay=0.05):
        self._inner = inner
        self.delay = delay

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def apply_wave(self, wave):
        time.sleep(self.delay)
        return self._inner.apply_wave(wave)


class _StubTuner:
    def __init__(self):
        self.pressure_calls = []

    def set_pressure(self, level):
        self.pressure_calls.append((time.perf_counter(), level))

    def observe_inserts(self, keys):
        pass

    def after_wave(self, n_ops, seconds):
        pass


def test_overload_sheds_maintenance_before_rejecting_reads():
    idx, keys = _mk_index()
    tuner = _StubTuner()
    gw = RequestGateway(
        _SlowIndex(idx), tuner=tuner,
        config=GatewayConfig(max_batch=8, max_delay_s=0.001, max_pending=40),
    )
    try:
        rejected_at = None
        futs = []
        for i in range(200):
            try:
                futs.append(gw.submit_lookup(int(keys[i % len(keys)])))
            except RetryAfter as e:
                rejected_at = time.perf_counter()
                assert 0.0 < e.retry_after_s <= 5.0
                break
        assert rejected_at is not None, "overload never hit level 2"
        shed_at = [t for t, lvl in tuner.pressure_calls if lvl >= 1]
        assert shed_at, "maintenance was never shed"
        assert shed_at[0] < rejected_at, (
            "requests were rejected before maintenance was shed"
        )
        assert gw.first_reject_t is not None
        for f in futs:
            f.result(WAIT_S)
    finally:
        gw.close()
    assert tuner.pressure_calls[-1][1] == 0


# ------------------------------------------------------ read-your-writes


def test_threaded_clients_read_their_own_writes():
    idx, _ = _mk_index(4096)
    gw = RequestGateway(
        idx, config=GatewayConfig(max_batch=64, max_delay_s=0.001)
    )
    errors = []

    def client(tid):
        try:
            base = (1 << 45) + tid * 10_000
            for r in range(15):
                k, v = base + r, tid * 1000 + r
                assert gw.submit_insert(k, v).result(WAIT_S) is True
                found, got = gw.submit_lookup(k).result(WAIT_S)
                assert found and got == v, (tid, r, found, got)
                if r % 3 == 0:
                    assert gw.submit_delete(k).result(WAIT_S) is True
                    found, _ = gw.submit_lookup(k).result(WAIT_S)
                    assert not found, (tid, r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    try:
        ts = [threading.Thread(target=client, args=(i,), daemon=True)
              for i in range(16)]
        for t in ts:
            t.start()
        _join(ts)
        assert not errors, errors[:3]
    finally:
        gw.close()


# ---------------------------------------------------------------- close


def test_close_is_idempotent_and_concurrent_safe():
    idx, keys = _mk_index()
    gw = RequestGateway(
        _SlowIndex(idx, delay=0.02),
        config=GatewayConfig(max_batch=4, max_delay_s=0.001),
    )
    futs = [gw.submit_lookup(int(k)) for k in keys[:40]]
    closers = [threading.Thread(target=gw.close, daemon=True)
               for _ in range(4)]
    for t in closers:
        t.start()
    # every pre-close future completes: a value or GatewayClosed, no hang
    for f in futs:
        try:
            found, v = f.result(WAIT_S)
            assert found
        except GatewayClosed:
            pass
    _join(closers)
    with pytest.raises(GatewayClosed):
        gw.submit_lookup(int(keys[0]))
    gw.close()  # idempotent
    assert gw.backlog == 0


def test_prefix_cache_index_close_idempotent_and_gateway_aware():
    pci = PrefixCacheIndex(capacity_hint=4096, tuner=SelfTuner(),
                           device="cpu")
    gw = pci.open_gateway(GatewayConfig(max_batch=16, max_delay_s=0.001))
    assert pci.open_gateway() is gw          # open is idempotent too
    found, _ = gw.submit_lookup(12345).result(WAIT_S)
    assert not found                          # nothing admitted yet
    closers = [threading.Thread(target=pci.close, daemon=True)
               for _ in range(4)]
    for t in closers:
        t.start()
    _join(closers)
    assert gw.closed
    with pytest.raises(GatewayClosed):
        gw.submit_lookup(1)
    with pytest.raises(RuntimeError):
        pci.open_gateway()
    pci.close()  # idempotent


# ---------------------------------------------- replayed through the JAX router


class _Recorder:
    """Router wrapper that keeps a copy of every dispatched wave and the
    port's result."""

    def __init__(self, inner):
        self._inner = inner
        self.waves = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def apply_wave(self, wave):
        res = self._inner.apply_wave(wave)
        self.waves.append((dataclasses.asdict(wave), res))
        return res


def _same_result(a, b, what):
    for field in ("lookup_found", "lookup_vals", "delete_hit"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), (what, field)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {field}")
    assert a.n_overflow == b.n_overflow, what
    assert (a.range_keys is None) == (b.range_keys is None), what
    for field in ("range_keys", "range_vals"):
        xs, ys = getattr(a, field) or [], getattr(b, field) or []
        assert len(xs) == len(ys), what
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {field}")


def test_gateway_waves_replay_identically_through_jax():
    """Threaded clients upsert, delete, look up and scan through the port's
    gateway; every wave it dispatched (warmup's too), replayed in order
    through the JAX router's ``apply_wave``, gives the same results, and
    both routers end with the same contents and stacked arrays."""
    keys = make_keys(6000, 81)
    cfg = dict(batch_bucket=256, bmat_capacity=1 << 13)
    rec = _Recorder(ShardedUpLIF(keys, keys * 2 + 1, UpLIFConfig(**cfg),
                                 n_shards=3, device="cpu"))
    gw = RequestGateway(rec, config=GatewayConfig(max_batch=256,
                                                  max_delay_s=0.002))
    errors = []

    def client(tid):
        rng = np.random.default_rng(100 + tid)
        try:
            for r in range(40):
                k = int(keys[rng.integers(len(keys))])
                p = rng.random()
                if p < 0.5:
                    gw.submit_lookup(k).result(WAIT_S)
                elif p < 0.8:
                    fresh = (1 << 47) + tid * 1000 + r
                    gw.submit_insert(fresh if r % 2 else k, tid).result(WAIT_S)
                elif p < 0.9:
                    gw.submit_delete(k).result(WAIT_S)
                else:
                    gw.submit_range(k, k + (1 << 40)).result(WAIT_S)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    try:
        gw.warmup()
        ts = [threading.Thread(target=client, args=(i,), daemon=True)
              for i in range(8)]
        for t in ts:
            t.start()
        _join(ts)
    finally:
        gw.close()
    assert not errors, errors[:3]
    assert gw.last_error is None
    assert len(rec.waves) >= 10
    jidx = JaxRouter(keys, keys * 2 + 1, JaxConfig(**cfg), n_shards=3)
    for i, (wave, res) in enumerate(rec.waves):
        _same_result(jidx.apply_wave(JaxMixedWave(**wave)), res, f"wave {i}")
    assert_same_state(jidx.state, rec.state, "after the replay")
    probe = np.concatenate([keys, (1 << 47) + np.arange(8000)])
    jf, jv = jidx.lookup(probe)
    tf, tv = rec.lookup(probe)
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jv, tv)


# ------------------------------------ the passthrough baseline and the hook


def test_passthrough_serves_one_request_per_wave_as_jax_would():
    """``passthrough=True`` is the batch-size-1 baseline: ``max_batch`` 1
    and no delay. One client waiting on each answer gets one wave per
    request; concurrent clients get at most one request of each op kind a
    wave (the flusher drains every queue up to ``max_batch``). Every wave,
    replayed through the JAX router, gives the same results and state."""
    keys = make_keys(3000, 83)
    cfg = dict(batch_bucket=256, bmat_capacity=1 << 13)
    rec = _Recorder(ShardedUpLIF(keys, keys * 2 + 1, UpLIFConfig(**cfg),
                                 n_shards=2, device="cpu"))
    gcfg = GatewayConfig(passthrough=True, max_pending=2048)
    assert (gcfg.max_batch, gcfg.max_delay_s) == (1, 0.0)
    gw = RequestGateway(rec, config=gcfg)
    errors = []

    def client(tid, n):
        rng = np.random.default_rng(300 + tid)
        try:
            for r in range(n):
                k = int(keys[rng.integers(len(keys))])
                p = rng.random()
                if p < 0.5:
                    found, v = gw.submit_lookup(k).result(WAIT_S)
                    assert found, k
                elif p < 0.8:
                    fresh = (1 << 47) + tid * 1000 + r
                    assert gw.submit_insert(fresh, r).result(WAIT_S)
                    assert gw.submit_lookup(fresh).result(WAIT_S) == (True, r)
                elif p < 0.9:
                    gw.submit_delete((1 << 46) + r).result(WAIT_S)
                else:
                    gw.submit_range(k, k + (1 << 40)).result(WAIT_S)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def ops_of(wave):  # requests of each op kind the wave holds
        return [len(wave[f]) for f in ("insert_keys", "delete_keys",
                                       "lookup_keys", "range_lo")
                if wave[f] is not None and len(wave[f])]

    try:
        client(0, 30)
        assert not errors, errors[:3]
        served = gw.n_ops
        assert gw.n_waves == served >= 30
        assert all(ops_of(w) == [1] for w, _ in rec.waves)
        ts = [threading.Thread(target=client, args=(i, 25), daemon=True)
              for i in range(1, 7)]
        for t in ts:
            t.start()
        _join(ts)
    finally:
        gw.close()
    assert not errors, errors[:3]
    assert gw.last_error is None
    assert all(set(ops_of(w)) == {1} for w, _ in rec.waves)
    assert gw.n_ops == sum(sum(ops_of(w)) for w, _ in rec.waves)
    assert gw.n_waves == len(rec.waves) and gw.n_ops > served
    widths = gw.stats()["pad_widths"]
    assert all(list(w) == [256] for w in widths.values() if w), widths
    jidx = JaxRouter(keys, keys * 2 + 1, JaxConfig(**cfg), n_shards=2)
    for i, (wave, res) in enumerate(rec.waves):
        _same_result(jidx.apply_wave(JaxMixedWave(**wave)), res, f"wave {i}")
    assert_same_state(jidx.state, rec.state, "after the replay")


class _FlakyIndex:
    """Router wrapper whose waves fail while ``fail`` is set and wait for
    ``release`` before they run."""

    def __init__(self, inner):
        self._inner = inner
        self.fail = False
        self.release = threading.Event()
        self.release.set()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def apply_wave(self, wave):
        assert self.release.wait(WAIT_S), "the test never released the wave"
        if self.fail:
            raise RuntimeError("injected wave failure")
        return self._inner.apply_wave(wave)


def test_on_complete_runs_once_per_completed_future():
    """The hook runs on the flusher thread once for each future of a wave
    that succeeded, after every result of that wave is set, in the order
    insert, delete, lookup, range; never for a failed wave's futures and
    never for a request turned away with ``RetryAfter``."""
    idx, keys = _mk_index()
    flaky = _FlakyIndex(idx)
    seen = []

    def hook(fut):
        seen.append((fut, fut.done(), time.perf_counter(),
                     threading.current_thread().name, gw.n_waves))

    gw = RequestGateway(flaky, config=GatewayConfig(
        max_batch=8, max_delay_s=30.0, max_pending=16, on_complete=hook))
    try:
        # one size-flushed wave of every op kind, submitted out of order
        wave = [gw.submit_range(int(keys[0]), int(keys[5])),
                gw.submit_delete(int(keys[1])),
                gw.submit_insert(1 << 45, 7), gw.submit_insert(1 << 46, 8)]
        wave += [gw.submit_lookup(int(k)) for k in keys[10:18]]
        for f in wave:
            f.result(WAIT_S)
        # a failed wave: its futures raise and the hook never sees them
        flaky.fail = True
        failed = [gw.submit_lookup(int(k)) for k in keys[20:28]]
        for f in failed:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(WAIT_S)
        flaky.fail = False
        # overload: the flusher holds one wave while the queue fills
        flaky.release.clear()
        held = [gw.submit_lookup(int(k)) for k in keys[30:38]]
        queued, rejected = [], 0
        for k in keys[40:80]:
            try:
                queued.append(gw.submit_lookup(int(k)))
            except RetryAfter:
                rejected += 1
        assert rejected > 0 and queued
        flaky.release.set()
        gw.close()
        for f in held + queued:
            assert f.result(WAIT_S)[0]
    finally:
        flaky.release.set()
        gw.close()
    assert gw.last_error is not None and "injected" in gw.last_error
    completed = wave + held + queued
    hooked = [s[0] for s in seen]
    assert len(hooked) == len(completed)
    assert {id(f) for f in hooked} == {id(f) for f in completed}
    assert all(done and name == "gateway-flusher"
               for _, done, _, name, _ in seen)
    # the first wave: in op order, each hook after the last result was set
    first = [s for s in seen if s[4] == 0]
    assert [s[0].op for s in first] == (["insert"] * 2 + ["delete"]
                                        + ["lookup"] * 8 + ["range"])
    assert min(s[2] for s in first) >= max(f.t_done for f in wave)


# ------------------------------------------- the kernel library's first load


def test_library_first_load_builds_once_across_threads(monkeypatch):
    """Eight threads reach ``library()`` first at once: the build runs once
    and every thread gets the one loaded library."""
    calls = []
    count_lock = threading.Lock()

    def slow_build():
        with count_lock:
            calls.append(threading.get_ident())
        time.sleep(0.2)
        return "librepro_torch_kernels-stub.so", "", 0.2

    def stub_cdll(path):
        return types.SimpleNamespace(
            **{name: types.SimpleNamespace() for name in kbuild.SIGNATURES})

    monkeypatch.setattr(kbuild, "build", slow_build)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", stub_cdll)
    kbuild._load.cache_clear()
    try:
        barrier = threading.Barrier(8)
        out = []

        def first_call():
            barrier.wait(timeout=WAIT_S)
            out.append(kbuild.library())

        ts = [threading.Thread(target=first_call, daemon=True)
              for _ in range(8)]
        for t in ts:
            t.start()
        _join(ts)
        assert len(calls) == 1
        assert len(out) == 8 and all(lib is out[0] for lib in out)
        assert kbuild.library.cache_info().misses == 1
        for name, argtypes in kbuild.SIGNATURES.items():
            assert getattr(out[0], name).argtypes == argtypes
    finally:
        kbuild._load.cache_clear()


# ---------------------------------------------------------------- the card


@pytest.mark.gpu
def test_gateway_overlapped_tuner_on_cuda(cuda):
    """The gateway over a 4-shard router on CUDA with the overlapped tuner:
    every client reads its own acknowledged writes, loaded keys read back
    their values, K1, K2 and K3 launch, the library is not loaded again
    after warmup, and the drained contents equal the loaded and
    acknowledged keys."""
    keys = make_keys(24_000, 71)
    idx = ShardedUpLIF(keys, keys * 2 + 1, UpLIFConfig(batch_bucket=256),
                       n_shards=4, device=cuda)
    tuner = SelfTuner.overlapped(max_concurrent_builds=2,
                                 commit_replay_cap=4096).attach(idx)
    assert tuner.forecaster.cfg.use_kernel
    gw = RequestGateway(idx, tuner=tuner,
                        config=GatewayConfig(max_batch=256,
                                             max_delay_s=0.002))
    errors, acked = [], {}
    try:
        gw.warmup()
        torch.cuda.synchronize()
        info0 = kbuild.library.cache_info()
        ops.reset_launch_counts()

        def client(tid):
            rng = np.random.default_rng(200 + tid)
            mine = {}
            try:
                for r in range(60):
                    k = int(keys[rng.integers(len(keys))])
                    if r % 3 == 0:
                        fresh = (1 << 47) + tid * 10_000 + r
                        assert gw.submit_insert(fresh, r).result(WAIT_S)
                        mine[fresh] = r
                    found, v = gw.submit_lookup(k).result(WAIT_S)
                    assert found and v == 2 * k + 1, (k, found, v)
                    if mine:
                        own = list(mine)[rng.integers(len(mine))]
                        found, v = gw.submit_lookup(own).result(WAIT_S)
                        assert found and v == mine[own], (own, found, v)
                acked.update(mine)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        ts = [threading.Thread(target=client, args=(i,), daemon=True)
              for i in range(16)]
        for t in ts:
            t.start()
        _join(ts)
    finally:
        gw.close()
    assert not errors, errors[:3]
    assert gw.last_error is None
    counts = ops.launch_counts()
    for name in ("fused_locate", "bmat_rank", "gmm_estep"):
        assert counts[name] > 0, counts
    assert kbuild.library.cache_info().misses == info0.misses
    tuner.drain(timeout=WAIT_S)
    assert tuner.stats()["last_build_error"] is None
    fresh = np.fromiter(acked, np.int64)
    f, v = idx.lookup(fresh)
    assert f.all() and np.array_equal(v, [acked[k] for k in fresh.tolist()])
    f, v = idx.lookup(keys)
    assert f.all() and np.array_equal(v, keys * 2 + 1)
    assert idx.size == len(keys) + len(fresh)
    tuner.close()
