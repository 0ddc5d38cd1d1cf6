"""The port's ``input_service`` and ``elastic`` (``GroupView``,
``shard_batch``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_input_service.py`` but the
``auto_resume_fit`` one (ROADMAP.md A10), each stream held bit for bit
against the reference service's inline stream on the same arrays (each
package's ``gluon.data.ArrayDataset``): inline order, reset and
``set_epoch``; rank streams tiling the global batch; a mid-epoch resume;
``elastic_rebuild`` from 8 ranks to 4 mid-epoch; a scripted
``io.worker_kill`` with respawn and exactly-once replay; injected and real
corruption with the quarantine entries equal to the reference's
(uri, byte offset, why, pool); ``max_skip`` raising the typed error; the
restart budget; the heartbeat (a scripted ``io.decode_stall`` of one
worker incarnation, where the reference's test uses a dataset that
sleeps once: the port's workers import no test module); the starvation
span; no leaked threads, processes or shared-memory segments; no worker
initialising CUDA. Tolerance: none, every comparison is exact. Each
worker-pool test bounds its own wall time.
"""
import glob
import json
import threading
import time
import zlib

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import elastic as jel
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import input_service as jis
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import chaos, elastic, gluon, io
from incubator_mxnet_tpu_torch import telemetry as tel
from incubator_mxnet_tpu_torch.elastic import GroupView, shard_batch
from incubator_mxnet_tpu_torch.input_service import (InputCorruptionError,
                                                     InputService,
                                                     InputServiceError,
                                                     InputWorkerError,
                                                     RecordFileDataset,
                                                     quarantine_path,
                                                     record_skips)
from incubator_mxnet_tpu_torch.io import DataBatch, DataIter
from incubator_mxnet_tpu_torch.recordio import MXRecordIO

ROWS, DIM = 64, 3
POOL_LIMIT_S = 120      # the wall-time bound of every worker-pool test


@pytest.fixture(autouse=True)
def _port_chaos():
    """The port's chaos points, like the reference's (conftest), never
    leak from one test into the next."""
    chaos.reset()
    with tmx.cpu():
        yield
    chaos.reset()


def _arrays(n=ROWS, dim=DIM):
    rs = np.random.RandomState(42)
    return (rs.rand(n, dim).astype(np.float32),
            np.arange(n, dtype=np.float32).reshape(n, 1))


def _ds(n=ROWS):
    return gluon.data.ArrayDataset(*_arrays(n))


def _jds(n=ROWS):
    return jgluon.data.ArrayDataset(*_arrays(n))


def _drain(it, limit=1000):
    """A stream as nested numpy (data rows + label rows)."""
    out = []
    for _ in range(limit):
        try:
            b = it.next()
        except StopIteration:
            return out
        arrs = list(b.data) + list(b.label or [])
        out.append([np.asarray(a.asnumpy()).copy() for a in arrs])
    raise AssertionError("stream did not terminate")


def _ref_stream(batch=8, epochs=(0,), **kw):
    """The reference service's inline stream of each epoch, concatenated."""
    out = []
    with jis.InputService(_jds(), batch, num_workers=0, **kw) as svc:
        for e in epochs:
            svc.set_epoch(e)
            svc.reset()
            out += _drain(svc)
    return out


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert len(sa) == len(sb)
        for x, y in zip(sa, sb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _io_thread_names():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("mxtpu-io"))


def _shm_segments(pids):
    """The shared-memory segments named for worker processes ``pids``
    (``mxtpu<pid>x<tag>``): other test processes make their own."""
    return {f for pid in pids for f in glob.glob(f"/dev/shm/mxtpu{pid}x*")}


def _seed_for(point, prob, fire_by=4, horizon=64, workers=2,
              incarnations=3):
    """A chaos seed where ``point`` fires for slot 0's FIRST incarnation
    within its first ``fire_by`` draws and for no other (slot,
    incarnation) pair within ``horizon`` draws: exactly one scripted
    fault. Replicates chaos._Point's stream: ``Random(seed ^
    crc32(f"{point}|{salt}"))`` with the salt the supervisor exports per
    incarnation (``io:<slot>:<respawns>``)."""
    import random as _random

    def fires(seed, salt, n):
        rng = _random.Random(seed ^ zlib.crc32(f"{point}|{salt}".encode()))
        return [rng.random() < prob for _ in range(n)]

    for seed in range(20000):
        if not any(fires(seed, "io:0:0", fire_by)):
            continue
        if all(not any(fires(seed, f"io:{s}:{inc}", horizon))
               for s in range(workers) for inc in range(incarnations)
               if not (s == 0 and inc == 0)):
            return seed
    raise AssertionError("no suitable chaos seed in range")


# ------------------------------------------------------------- elastic
def test_group_view_and_shard_batch_match_the_reference():
    for world in (1, 2, 3, 4, 8):
        for ranks in (tuple(range(world)), tuple(range(1, 2 * world, 2))):
            tv, jv = GroupView(3, ranks), jel.GroupView(3, ranks)
            assert tv.world == jv.world == world
            for n in (1, 7, 8, 128):
                got = [shard_batch(n, tv, r) for r in ranks]
                assert got == [jel.shard_batch(n, jv, r) for r in ranks]
                assert got[0][0] == 0 and got[-1][1] == n
    with pytest.raises(ValueError, match="not in view"):
        shard_batch(8, GroupView(0, (0, 1)), 5)
    for name in ("ElasticPolicy", "SimulatedMembership", "PSMembership",
                 "ElasticController"):
        with pytest.raises(NotImplementedError, match="A10"):
            getattr(elastic, name)
    assert issubclass(elastic.ElasticError, RuntimeError)


# ------------------------------------------------------ inline semantics
def test_inline_sequential_stream_content_and_len():
    x, y = _arrays()
    with InputService(_ds(), 8, num_workers=0) as svc:
        assert len(svc) == 8
        got = _drain(svc)
    assert len(got) == 8
    for step, (xb, yb) in enumerate(got):
        np.testing.assert_array_equal(xb, x[step * 8:(step + 1) * 8])
        np.testing.assert_array_equal(yb, y[step * 8:(step + 1) * 8])
    _assert_streams_equal(got, _ref_stream())
    b = InputService(_ds(), 8, num_workers=0).next()
    assert b.data[0].context == tmx.cpu() and b.index == 0 and b.pad == 0


def test_shuffle_deterministic_reset_replays_set_epoch_rekeys():
    with InputService(_ds(), 8, num_workers=0, shuffle=True, seed=7) as a:
        ep0 = _drain(a)
        a.reset()
        _assert_streams_equal(_drain(a), ep0)      # reset: same epoch
        a.set_epoch(1)
        a.reset()
        ep1 = _drain(a)
        assert not all(
            np.array_equal(u[1], v[1]) for u, v in zip(ep0, ep1))
        a.set_epoch(0)
        a.reset()
        _assert_streams_equal(_drain(a), ep0)      # epoch is the only key
    _assert_streams_equal(ep0 + ep1, _ref_stream(epochs=(0, 1), shuffle=True,
                                                 seed=7))
    with InputService(_ds(), 8, num_workers=0, shuffle=True, seed=7) as b:
        _assert_streams_equal(_drain(b), ep0)


def test_rank_streams_tile_the_global_batch_exactly():
    view = GroupView(0, (0, 1))
    full = _ref_stream(shuffle=True, seed=3)
    svc = InputService(_ds(), 8, num_workers=0, shuffle=True, seed=3,
                       view=view)
    s0, s1 = svc.stream(0), svc.stream(1)
    r0, r1 = shard_batch(8, view, 0), shard_batch(8, view, 1)
    with svc:
        for step in range(len(svc)):
            b0, b1 = s0.next(), s1.next()      # lockstep consumers
            for part in range(2):              # data then label
                a0 = (list(b0.data) + b0.label)[part].asnumpy()
                a1 = (list(b1.data) + b1.label)[part].asnumpy()
                np.testing.assert_array_equal(a0,
                                              full[step][part][r0[0]:r0[1]])
                np.testing.assert_array_equal(a1,
                                              full[step][part][r1[0]:r1[1]])
                np.testing.assert_array_equal(np.concatenate([a0, a1]),
                                              full[step][part])


def test_stream_attach_after_consume_is_refused():
    with InputService(_ds(), 8, num_workers=0) as svc:
        svc.next()
        with pytest.raises(RuntimeError, match="before consuming"):
            svc.stream(1)


def test_resume_mid_epoch_suffix_bit_identical():
    clean = _ref_stream(shuffle=True, seed=5)
    with InputService(_ds(), 8, num_workers=0, shuffle=True, seed=5) as b:
        b.set_epoch(0)
        for _ in range(3):                     # the already-done prefix
            b.next()
        _assert_streams_equal(_drain(b), clean[3:])


def test_elastic_rebuild_8_to_4_mid_epoch_bit_identical():
    v8 = GroupView(0, tuple(range(8)))
    v4 = GroupView(1, tuple(range(4)))
    full = _ref_stream(shuffle=True, seed=9)
    rows = []
    for pkg, view in ((tmx, (v8, v4)), (jmx, (jel.GroupView(*v8),
                                              jel.GroupView(*v4)))):
        mod = tmx.input_service if pkg is tmx else jis
        ds = _ds() if pkg is tmx else _jds()
        svc = mod.InputService(ds, 8, num_workers=0, shuffle=True, seed=9,
                               view=view[0], rank=0)
        with svc:
            got8 = [[a.asnumpy() for a in svc.next().data]
                    for _ in range(4)]
            svc.elastic_rebuild(view[1])
            assert svc.view.world == 4
            rows.append((got8, _drain(svc)))
    (t8, t4), (j8, j4) = rows
    _assert_streams_equal(t8, j8)
    _assert_streams_equal(t4, j4)
    lo8, hi8 = shard_batch(8, v8, 0)
    lo4, hi4 = shard_batch(8, v4, 0)
    assert (hi4 - lo4) > (hi8 - lo8)           # the slice really widened
    for step, b in enumerate(t8):
        np.testing.assert_array_equal(b[0], full[step][0][lo8:hi8])
    for off, row in enumerate(t4):
        np.testing.assert_array_equal(row[0], full[4 + off][0][lo4:hi4])
        np.testing.assert_array_equal(row[1], full[4 + off][1][lo4:hi4])


def test_device_prefetcher_rebuilds_its_service_mid_epoch():
    """``DevicePrefetcher.elastic_rebuild`` quiesces and hands the view to
    the service: rank 0's rows widen from its 8-rank slice to its
    4-rank slice of the same global stream, as the reference's do."""
    v8, v4 = GroupView(0, tuple(range(8))), GroupView(1, tuple(range(4)))
    full = _ref_stream(shuffle=True, seed=6)
    svc = InputService(_ds(), 8, num_workers=0, shuffle=True, seed=6,
                       view=v8, rank=0)
    pf = io.DevicePrefetcher(svc, depth=1, device="cpu")
    try:
        first = pf.next().data[0].asnumpy()
        pf.elastic_rebuild(v4)
        assert svc.view == v4
        rest = _drain(pf)
    finally:
        pf.close()
        svc.close()
    lo8, hi8 = shard_batch(8, v8, 0)
    np.testing.assert_array_equal(first, full[0][0][lo8:hi8])
    lo4, hi4 = shard_batch(8, v4, 0)
    # the quiesced prefetcher's queued batches are dropped: delivery
    # resumes at the service's cursor, each row the 4-rank slice
    assert rest
    for row in rest:
        step = next(i for i, f in enumerate(full)
                    if np.array_equal(f[0][lo4:hi4], row[0]))
        np.testing.assert_array_equal(row[1], full[step][1][lo4:hi4])


# ------------------------------------------------------------ quarantine
def test_quarantine_counts_injected_corruptions_exactly(tmp_path):
    entries = []
    for mod, chaos_mod, ds, tag in ((tmx.input_service, chaos, _ds(), "t"),
                                    (jis, jmx.chaos, _jds(), "j")):
        qfile = str(tmp_path / f"quarantine_{tag}.jsonl")
        counter = (tel if mod is not jis else jmx.telemetry).counter(
            "mxtpu_io_records_skipped_total")
        c0 = counter.value(reason="chaos")
        chaos_mod.arm("io.record_corrupt", prob=1.0, times=3)
        with mod.InputService(ds, 8, num_workers=0, quarantine=qfile) as s:
            got = _drain(s)                    # completes despite skips
            stats = s.stats()
        chaos_mod.reset()
        assert len(got) == 8 and stats["skipped"] == 3
        assert counter.value(reason="chaos") == c0 + 3
        entries.append([json.loads(line) for line in open(qfile)])
        assert all(xb.shape == (8, DIM) for xb, _ in got)
    assert entries[0] == entries[1] and len(entries[0]) == 3
    for entry in entries[0]:
        assert entry["pool"] == "input_service"
        assert "io.record_corrupt" in entry["why"]


def _payload_rows(raw):
    return np.frombuffer(raw, dtype=np.uint8).astype(np.int32)


def test_real_corruption_quarantines_exact_uri_and_offset(tmp_path):
    rec_path = str(tmp_path / "data.rec")
    w = MXRecordIO(rec_path, "w")
    for i in range(12):
        w.write(bytes([i]) * 24)
    w.close()
    ds = RecordFileDataset(rec_path, transform=_payload_rows)
    jds = jis.RecordFileDataset(rec_path, transform=_payload_rows)
    assert len(ds) == len(jds) == 12
    assert [ds.describe(i) for i in range(12)] == \
        [jds.describe(i) for i in range(12)]
    uri5, off5 = ds.describe(5)
    with open(rec_path, "r+b") as f:           # flip record 5's magic
        f.seek(off5)
        f.write(b"\xde\xad\xbe\xef")
    c0 = tel.counter("mxtpu_io_records_skipped_total").value(
        reason="invalid magic")
    lines, streams = [], []
    for mod, d, tag in ((tmx.input_service, ds, "t"), (jis, jds, "j")):
        qfile = str(tmp_path / f"q_{tag}.jsonl")
        with mod.InputService(d, 4, num_workers=0, quarantine=qfile) as svc:
            streams.append(_drain(svc))
        lines.append([json.loads(line) for line in open(qfile)])
    _assert_streams_equal(streams[0], streams[1])
    assert lines[0] == lines[1]
    assert tel.counter("mxtpu_io_records_skipped_total").value(
        reason="invalid magic") == c0 + 1
    got = streams[0]
    assert len(got) == 3
    assert len(lines[0]) == 1
    assert lines[0][0]["uri"] == uri5 == rec_path
    assert lines[0][0]["offset"] == off5
    assert lines[0][0]["why"].startswith("invalid magic")
    np.testing.assert_array_equal(
        got[1][0], np.repeat([[4], [4], [6], [7]], 24, axis=1))


def test_max_skip_exceeded_raises_typed_error_not_a_wedge(tmp_path):
    qfile = str(tmp_path / "q.jsonl")
    chaos.arm("io.record_corrupt", prob=0.5, seed=3)
    svc = InputService(_ds(), 8, num_workers=0, max_skip=4,
                       quarantine=qfile)
    t0 = time.monotonic()
    with pytest.raises(InputCorruptionError) as ei:
        _drain(svc)
    assert time.monotonic() - t0 < 30, "skip-budget overrun wedged"
    err = ei.value
    assert isinstance(err, InputServiceError)   # typed, ladder-visible
    assert isinstance(err, tmx.MXTPUError)
    assert err.skipped > 4
    assert err.quarantine == qfile
    assert "MXTPU_IO_MAX_SKIP" in str(err)
    svc.close()


def test_loader_and_record_iter_skips_reach_the_quarantine_file(
        tmp_path, monkeypatch):
    """``ImageRecordIter``'s process route and the DataLoader's pool
    count their skips through ``record_skips``, as the reference's do:
    counted and written to the quarantine file."""
    qfile = str(tmp_path / "q.jsonl")
    monkeypatch.setenv("MXTPU_IO_QUARANTINE", qfile)
    assert quarantine_path() == qfile
    c0 = tel.counter("mxtpu_io_records_skipped_total").value(reason="decode")
    assert record_skips([["a.rec", -1, "decode: bad"]] * 2,
                        pool="imgrec") == 2
    assert record_skips([], pool="dataloader") == 0
    assert tel.counter("mxtpu_io_records_skipped_total").value(
        reason="decode") == c0 + 2
    lines = [json.loads(line) for line in open(qfile)]
    assert lines == [{"uri": "a.rec", "offset": -1, "why": "decode: bad",
                      "pool": "imgrec"}] * 2


# ----------------------------------------------------------- worker pool
def _pool_run(monkeypatch, spec=None, **kw):
    """Drain a worker-pool service (under ``MXTPU_CHAOS=spec`` if given):
    (stream, stats, the service), every thread and segment it made gone."""
    if spec:
        monkeypatch.setenv("MXTPU_CHAOS", spec)
    pids, popen = [], tmx.input_service._subprocess.Popen

    def spawn(*a, **k):
        proc = popen(*a, **k)
        pids.append(proc.pid)
        return proc
    monkeypatch.setattr(tmx.input_service._subprocess, "Popen", spawn)
    threads0 = _io_thread_names()
    svc = InputService(_ds(), 8, shuffle=True, seed=1, **kw)
    t0 = time.monotonic()
    try:
        got = _drain(svc)
        stats = svc.stats()
    finally:
        svc.close()
    assert time.monotonic() - t0 < POOL_LIMIT_S
    assert all(p.poll() is not None for p in svc._procs)
    assert _io_thread_names() == threads0      # readers + supervisor gone
    assert pids and _shm_segments(pids) == set()   # zero leaked segments
    assert svc.worker_reports and not any(
        r["cuda_initialized"] for r in svc.worker_reports)
    assert all(r["cuda_visible_devices"] == "" for r in svc.worker_reports)
    return got, stats, svc


def test_worker_pool_matches_the_reference_and_leaks_nothing(monkeypatch):
    clean = _ref_stream(shuffle=True, seed=1)
    got, stats, svc = _pool_run(monkeypatch, num_workers=2)
    _assert_streams_equal(got, clean)
    assert stats["restarts"] == 0
    svc.close()                                 # idempotent


def test_worker_kill_respawn_stream_bit_identical(monkeypatch):
    """A scripted ``io.worker_kill`` kills one decode worker; the
    supervisor respawns the slot, replays its in-flight items exactly
    once, and the delivered stream is the reference's."""
    prob = 0.02
    seed = _seed_for("io.worker_kill", prob)
    restarts0 = tel.counter("mxtpu_io_worker_restarts_total").value(
        reason="exit", pool="input_service")
    got, stats, _ = _pool_run(monkeypatch, f"io.worker_kill:{prob}:{seed}",
                              num_workers=2, max_restarts=4)
    _assert_streams_equal(got, _ref_stream(shuffle=True, seed=1))
    assert stats["restarts"] == 1, stats
    assert tel.counter("mxtpu_io_worker_restarts_total").value(
        reason="exit", pool="input_service") == restarts0 + 1


def test_heartbeat_detects_stalled_worker_and_recovers(monkeypatch):
    """One worker incarnation stalls past the heartbeat (a scripted
    ``io.decode_stall`` of 30 s); the supervisor kills it, respawns the
    slot and replays its work: the stream is the reference's."""
    prob = 0.05
    seed = _seed_for("io.decode_stall", prob, fire_by=2, horizon=16,
                     workers=1)
    monkeypatch.setenv("MXTPU_IO_STALL_S", "30")
    hb0 = tel.counter("mxtpu_io_worker_restarts_total").value(
        reason="heartbeat", pool="input_service")
    t0 = time.monotonic()
    got, stats, _ = _pool_run(monkeypatch, f"io.decode_stall:{prob}:{seed}",
                              num_workers=1, heartbeat_s=0.75, window=4)
    assert time.monotonic() - t0 < 30          # not waited out
    _assert_streams_equal(got, _ref_stream(shuffle=True, seed=1))
    assert stats["restarts"] == 1, stats
    assert tel.counter("mxtpu_io_worker_restarts_total").value(
        reason="heartbeat", pool="input_service") == hb0 + 1


def test_restart_budget_exhaustion_escalates_typed(monkeypatch):
    monkeypatch.setenv("MXTPU_CHAOS", "io.worker_kill:1.0:0")
    svc = InputService(_ds(), 8, num_workers=1, max_restarts=1)
    t0 = time.monotonic()
    with pytest.raises(InputWorkerError, match="MXTPU_IO_WORKER_RESTARTS"):
        _drain(svc)
    assert time.monotonic() - t0 < POOL_LIMIT_S, "restart ladder wedged"
    svc.close()
    assert _io_thread_names() == []


# ----------------------------------------------- starvation observability
def test_starvation_share_and_prefetch_wait_span_observed(monkeypatch):
    chaos.arm("io.decode_stall", prob=1.0)
    monkeypatch.setenv("MXTPU_IO_STALL_S", "0.02")
    with InputService(_ds(), 8, num_workers=0) as svc:
        _drain(svc)
        share = svc.starvation_share()
        stats = svc.stats()
    # inline decode counts as consumer wait: a stalled decoder must
    # dominate the inter-delivery wall time
    assert 0.2 < share <= 1.0
    assert stats["starvation_share"] == pytest.approx(share)
    assert tel.phase_share("prefetch_wait") > 0.0


def test_device_prefetcher_takes_the_service_as_a_source():
    clean = _ref_stream(shuffle=True, seed=4)
    svc = InputService(_ds(), 8, num_workers=0, shuffle=True, seed=4)
    pf = io.DevicePrefetcher(svc, depth=2, device="cpu")
    try:
        got = _drain(pf)
    finally:
        pf.close()
        svc.close()
    _assert_streams_equal(got, clean)


# ------------------------------------ PrefetchingIter error attribution
class _FailingSourceIter(DataIter):
    """A DataIter that serves ``fail_after`` batches, then raises an
    attributed IOError, as recordio's corruption errors are."""

    def __init__(self, fail_after=2):
        super().__init__(4)
        self._i = 0
        self.fail_after = fail_after

    @property
    def provide_data(self):
        return [io.DataDesc("data", (4, 2))]

    @property
    def provide_label(self):
        return [io.DataDesc("label", (4, 1))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self.fail_after:
            err = IOError("corrupt RecordIO file /data/train.rec: "
                          "invalid magic 0xdead @ byte 4096")
            err.mxtpu_uri = "/data/train.rec"
            err.mxtpu_offset = 4096
            raise err
        self._i += 1
        return DataBatch(data=[tmx.nd.zeros((4, 2))],
                         label=[tmx.nd.zeros((4, 1))], pad=0, index=self._i)


def test_prefetching_iter_error_names_shard_and_record_with_cause():
    threads0 = sorted(t.name for t in threading.enumerate())
    pi = io.PrefetchingIter(_FailingSourceIter())
    try:
        assert pi.iter_next() and pi.iter_next()
        with pytest.raises(RuntimeError) as ei:
            while pi.iter_next():
                pass
    finally:
        pi.close()
    err = ei.value
    assert "worker 0" in str(err)
    assert "shard 0/1" in str(err)
    assert "/data/train.rec @ byte 4096" in str(err)
    assert isinstance(err.__cause__, IOError)
    assert err.mxtpu_shard == 0
    assert err.mxtpu_uri == "/data/train.rec"
    assert err.mxtpu_offset == 4096
    assert sorted(t.name for t in threading.enumerate()) == threads0
