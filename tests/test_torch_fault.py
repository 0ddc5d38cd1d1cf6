"""The port's checkpoints (``fault.py``: ``CheckpointManager``,
``auto_resume_fit``, ``Trainer.snapshot_states``) on the CPU.

The cases mirror the reference's ``tests/test_chaos_checkpoint.py``: the
SHA-256 manifest, corrupt, truncated and missing files skipped for the
newest intact step, a crash injected at every stage of a save
(``ckpt.save`` chaos) leaving ``latest()`` intact, and the mid-epoch resume
of ``auto_resume_fit``. Then the port against the JAX package: the same
``auto_resume_fit`` run (a Dense(1) net from the same weights, Adam, the
same batches, a kill and a resume) ends at the same weights within 1e-5,
and an async save restores the same optimizer state as a sync one, bit
for bit.
"""
import json
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import chaos, gluon, nd
from incubator_mxnet_tpu_torch.fault import CheckpointManager, auto_resume_fit

N_SAVE_STAGES = 6   # chaos.maybe_fail("ckpt.save") call sites in save()


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _small_state():
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(mx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    with mx.autograd.record():
        loss = net(nd.ones((2, 3))).sum()
    loss.backward()
    trainer.step(2)
    return net, trainer


def test_manifest_written_and_verified(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, net=net, trainer=tr)
    with open(tmp_path / "step-1" / "meta.json") as f:
        meta = json.load(f)
    assert set(meta["manifest"]) == {"params.npz", "trainer.bin", "rng.bin"}
    assert all(len(h) == 64 for h in meta["manifest"].values())
    assert mgr.verify(1)


def test_corrupt_checkpoint_detected_and_skipped(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, net=net, trainer=tr)
    w1 = net.weight.data().asnumpy().copy()
    net.weight.set_data(nd.ones((4, 3)))
    mgr.save(2, net=net, trainer=tr)
    with open(tmp_path / "step-2" / "params.npz", "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef")
    assert not mgr.verify(2)
    assert mgr.latest() == 1
    assert mgr.latest(intact_only=False) == 2
    net.weight.set_data(nd.zeros((4, 3)))
    meta = mgr.restore(net=net, trainer=tr)
    assert meta["step"] == 1
    assert meta["fallback_from"] == [2]
    np.testing.assert_allclose(net.weight.data().asnumpy(), w1)


def test_restore_explicit_corrupt_step_raises(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, net=net, trainer=tr)
    os.unlink(tmp_path / "step-5" / "rng.bin")
    with pytest.raises(IOError):
        mgr.restore(net=net, trainer=tr, step=5)


def test_truncated_param_file_fails_verify(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, net=net, trainer=tr)
    w1 = net.weight.data().asnumpy().copy()
    net.weight.set_data(nd.ones((4, 3)))
    mgr.save(2, net=net, trainer=tr)
    p = tmp_path / "step-2" / "params.npz"
    with open(p, "r+b") as f:
        f.truncate(8)
    assert not mgr.verify(2)
    meta = mgr.restore(net=net, trainer=tr)
    assert meta["step"] == 1 and meta["fallback_from"] == [2]
    np.testing.assert_allclose(net.weight.data().asnumpy(), w1)
    with open(p, "r+b") as f:
        f.truncate(0)
    assert not mgr.verify(2)


def test_manifest_entry_with_missing_file_fails_verify(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, net=net, trainer=tr)
    assert mgr.verify(4)
    os.unlink(tmp_path / "step-4" / "params.npz")
    assert not mgr.verify(4)
    with pytest.raises(IOError):
        mgr.restore(net=net, trainer=tr, step=4)


def test_missing_manifest_file_fails_verify(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, net=net, trainer=tr)
    os.unlink(tmp_path / "step-3" / "trainer.bin")
    assert not mgr.verify(3)
    assert mgr.restore(net=net, trainer=tr) is None


def test_crash_at_every_save_stage_keeps_latest_intact(tmp_path):
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(0, net=net, trainer=tr)
    fired_stages = 0
    for k in range(N_SAVE_STAGES):
        chaos.arm("ckpt.save", prob=1.0, skip=k, times=1)
        try:
            mgr.save(10 + k, net=net, trainer=tr)
        except chaos.ChaosError:
            fired_stages += 1
        chaos.disarm("ckpt.save")
        latest = mgr.latest()
        assert latest is not None
        assert mgr.verify(latest), f"stage {k} left corrupt latest"
        meta = mgr.restore(net=net, trainer=tr)
        assert meta["step"] == latest
        residue = [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
        assert residue == [], residue
    assert fired_stages >= N_SAVE_STAGES - 2


def _regression(seed, n):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, 5).astype(np.float32)
    return xs, (xs @ rng.rand(5, 1)).astype(np.float32)


def _build(pkg, xs, ys, w0):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.Dense(1, in_units=5)
    net.initialize(pkg.init.Xavier())
    net.weight.set_data(pkg.nd.array(w0))
    net.bias.set_data(pkg.nd.zeros((1,)))
    tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01})
    it = pkg.io.NDArrayIter(xs, ys, batch_size=16, label_name="lbl")
    return net, tr, it


def test_auto_resume_skips_replayed_epoch_prefix(tmp_path):
    """A kill mid-epoch resumes at the recorded batch (no replayed prefix),
    and the killed-and-resumed run ends at the JAX package's weights for
    the same kill and resume (within 1e-5)."""
    xs, ys = _regression(0, 64)
    w0 = np.random.RandomState(2).randn(1, 5).astype(np.float32)

    class Boom(Exception):
        pass

    def run(pkg, fit, root):
        seen = []

        def killer(step, loss):
            seen.append(step)
            if step == 6:        # mid epoch 1, after the step-3 save
                raise Boom()
        net, tr, it = _build(pkg, xs, ys, w0)
        with pytest.raises(Boom):
            fit(net, tr, pkg.gluon.loss.L2Loss(), it, ckpt_dir=root,
                num_epochs=3, save_every=3, on_step=killer)
        seen.clear()
        net2, tr2, it2 = _build(pkg, xs, ys, w0)
        res = fit(net2, tr2, pkg.gluon.loss.L2Loss(), it2, ckpt_dir=root,
                  num_epochs=3, save_every=3,
                  on_step=lambda s, l: seen.append(s))
        return res, list(seen), net2.weight.data().asnumpy()

    res, seen, w = run(mx, auto_resume_fit, str(tmp_path / "port"))
    meta = CheckpointManager(str(tmp_path / "port")).restore()
    assert res["resumed_from"] == 3
    assert seen == [4, 5, 6, 7, 8, 9, 10, 11, 12]
    assert res["final_step"] == 12 and meta["step"] == 12
    from incubator_mxnet_tpu.fault import auto_resume_fit as jfit
    jres, jseen, jw = run(jmx, jfit, str(tmp_path / "jax"))
    assert (jres["resumed_from"], jseen) == (3, seen)
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=1e-5)


def test_auto_resume_falls_back_past_corrupt_newest(tmp_path, caplog):
    import logging
    xs, ys = _regression(1, 32)
    w0 = np.random.RandomState(3).randn(1, 5).astype(np.float32)
    net, tr, it = _build(mx, xs, ys, w0)
    auto_resume_fit(net, tr, gluon.loss.L2Loss(), it,
                    ckpt_dir=str(tmp_path), num_epochs=2, save_every=2)
    mgr = CheckpointManager(str(tmp_path))
    newest = mgr.latest()
    with open(tmp_path / f"step-{newest}" / "params.npz", "r+b") as f:
        f.write(b"\x00\x00\x00\x00")
    net2, tr2, it2 = _build(mx, xs, ys, w0)
    with caplog.at_level(logging.WARNING, "incubator_mxnet_tpu_torch.fault"):
        res = auto_resume_fit(net2, tr2, gluon.loss.L2Loss(), it2,
                              ckpt_dir=str(tmp_path), num_epochs=2,
                              save_every=2)
    assert res["resumed_from"] < newest
    assert any("degraded resume" in r.message for r in caplog.records)


def test_async_save_matches_sync_and_elastic_raises(tmp_path):
    """``save_async`` (``Trainer.snapshot_states``: device copies now,
    bytes later) restores the optimizer state a sync save does, bit for
    bit, even after the live state moved on; ``elastic=`` names A10c."""
    net, tr = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, net=net, trainer=tr)
    mgr.save_async(2, net=net, trainer=tr)
    with mx.autograd.record():
        loss = net(nd.ones((2, 3))).sum()
    loss.backward()
    tr.step(2)                      # the live state moves on
    mgr.wait()
    assert mgr.verify(2)
    with open(tmp_path / "step-1" / "trainer.bin", "rb") as a, \
            open(tmp_path / "step-2" / "trainer.bin", "rb") as b:
        import pickle
        sa, sb = pickle.loads(a.read())[0], pickle.loads(b.read())[0]
    for k in sa:
        for x, y in zip(sa[k], sb[k]):
            np.testing.assert_array_equal(x, y)
    mgr.close()
    with pytest.raises(NotImplementedError, match="A10c"):
        auto_resume_fit(net, tr, gluon.loss.L2Loss(), None,
                        ckpt_dir=str(tmp_path), num_epochs=1,
                        elastic=object())


@pytest.mark.parametrize("sync_every", [1, 3])
def test_auto_resume_fit_with_guard_changes_nothing_clean(tmp_path,
                                                          sync_every):
    """A guard on a clean run (losses read every step, or queued 3 at a
    time with the fused step's census bound to the trainer) trips nothing
    and leaves the run where the unguarded one ends, bit for bit."""
    from incubator_mxnet_tpu_torch.guard import GuardPolicy
    xs, ys = _regression(5, 48)
    w0 = np.random.RandomState(6).randn(1, 5).astype(np.float32)
    ends = []
    for guard in (None, GuardPolicy(check_every=1)):
        net, tr, it = _build(mx, xs, ys, w0)
        res = auto_resume_fit(net, tr, gluon.loss.L2Loss(), it,
                              ckpt_dir=str(tmp_path / str(guard is None)),
                              num_epochs=2, save_every=2, guard=guard,
                              sync_every=sync_every)
        assert res["final_step"] == 6
        ends.append((res["guard"], net.weight.data().asnumpy()))
    assert ends[0][0] is None
    assert ends[1][0]["trips"] == {} and ends[1][0]["rollbacks"] == 0
    np.testing.assert_array_equal(ends[0][1], ends[1][1])
