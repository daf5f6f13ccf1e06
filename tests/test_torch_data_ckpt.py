"""The port's data pipeline and checkpoint manager against the JAX
package's, on the CPU.

* ``SyntheticLM`` and ``TokenFileDataset`` batches equal the reference's
  bit for bit for the same seed, step and host sharding;
  ``shard_assignment`` equals the reference's; ``Prefetcher`` yields the
  deterministic batches, through its straggler (timeout) path too;
* a ``codec="takum16"`` checkpoint's words equal the reference ``save``'s
  ``arrays.npz`` for the same leaves (same keys, names and manifest);
* round trip, retention, atomicity (a stale ``.tmp-<step>`` from a
  crashed save is replaced, never read), ``restore(device=)``,
  ``CheckpointManager``'s async save and ``PreemptionGuard`` turning a
  SIGTERM into a save at the next step boundary.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.data import pipeline as jdp
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data import pipeline as dp


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 2, 3),
                                                  (100352, 2048, 1, 0),
                                                  (1000, 33, 4, 7)])
def test_synthetic_batches_equal_the_reference(vocab, seq, batch, seed):
    ds = dp.SyntheticLM(vocab, seq, batch, seed=seed)
    ref = jdp.SyntheticLM(vocab, seq, batch, seed=seed)
    for step in (0, 1, 5):
        got, want = ds.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    unl = dp.SyntheticLM(vocab, seq, batch, seed=seed, with_labels=False)
    assert set(unl.batch_at(0)) == {"tokens"}


def test_token_file_and_shards_equal_the_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(1).integers(0, 1000, 5000, dtype=np.int32).tofile(
        path)
    for host in range(3):
        ds = dp.TokenFileDataset(path, 32, 4, host_id=host, num_hosts=3)
        ref = jdp.TokenFileDataset(path, 32, 4, host_id=host, num_hosts=3)
        for step in (0, 2, 40):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(ds.batch_at(step)[k],
                                              ref.batch_at(step)[k])
    assert dp.shard_assignment(16, 4, backups=2) == jdp.shard_assignment(
        16, 4, backups=2)
    assert dp.make_batch_fn(ds)(3)["tokens"].shape == (4, 32)


def test_prefetcher_and_straggler_path():
    ds = dp.SyntheticLM(100, 16, 2, seed=1)
    pf = dp.Prefetcher(ds.batch_at, depth=2, timeout_s=5.0)
    got = [pf.next() for _ in range(5)]
    pf.close()
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g["tokens"], ds.batch_at(i)["tokens"])

    # a producer slower than the timeout: every batch comes from the
    # backup path, still the deterministic one
    def slow(step):
        time.sleep(0.2)
        return ds.batch_at(step)

    pf2 = dp.Prefetcher(slow, depth=1, timeout_s=0.01)
    out = [pf2.next() for _ in range(3)]
    pf2.close()
    assert pf2.stats["timeouts"] >= 1
    for i, g in enumerate(out):
        np.testing.assert_array_equal(g["tokens"], ds.batch_at(i)["tokens"])


def _tree():
    rng = np.random.default_rng(4)
    return {"w": (rng.normal(size=(3, 4)) * np.exp(
                rng.normal(size=(3, 4)) * 5)).astype(np.float32),
            "b": {"x": np.int32([1, 2, 3]),
                  "y": np.float32([0.1, -2.5, 1e5, 0.0, np.inf, np.nan])},
            "layers": [np.float32([1.5, -3.25]), np.float64([1e-3, 7.0])]}


def test_takum16_words_equal_the_reference_save(tmp_path):
    tree = _tree()
    d, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(7, tree, d, codec="takum16")
    jckpt.save(7, tree, jd, codec="takum16")
    got = np.load(os.path.join(d, "step_0000000007", "arrays.npz"))
    want = np.load(os.path.join(jd, "step_0000000007", "arrays.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    man = [json.load(open(os.path.join(x, "step_0000000007",
                                       "manifest.json"))) for x in (d, jd)]
    assert man[0] == man[1]
    # either package restores the other's checkpoint to the same floats
    a, _ = ckpt.restore(jd, tree)
    b, _ = jckpt.restore(d, tree)
    for x, y in zip((a["w"], a["b"]["y"], a["layers"][1]),
                    (b["w"], b["b"]["y"], b["layers"][1])):
        np.testing.assert_array_equal(x, y)


def test_roundtrip_retention_atomicity_and_device(tmp_path):
    tree = _tree()
    d = str(tmp_path / "ck")
    # a crashed save left its temporary directory behind
    os.makedirs(os.path.join(d, ".tmp-40"))
    open(os.path.join(d, ".tmp-40", "junk"), "w").close()
    for s in [10, 20, 30, 40]:
        ckpt.save(s, tree, d, keep=2)
    assert ckpt.latest_step(d) == 40
    assert sorted(ckpt._all_steps(d)) == [30, 40]
    assert not os.path.exists(os.path.join(d, ".tmp-40"))
    assert not os.path.exists(os.path.join(d, "step_0000000040", "junk"))
    got, step = ckpt.restore(d, tree)
    assert step == 40
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["b"]["x"], tree["b"]["x"])
    assert got["layers"][1].dtype == np.float64
    # torch leaves in, torch leaves out on the named device
    ttree = {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "s": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(1, ttree, str(tmp_path / "t"))
    back, _ = ckpt.restore(str(tmp_path / "t"), ttree, device="cpu")
    assert isinstance(back["p"], torch.Tensor)
    assert torch.equal(back["p"], ttree["p"]) and int(back["s"]) == 3
    # takum16: floats within wire precision, integers exact, half the bytes
    d2, d3 = str(tmp_path / "ck16"), str(tmp_path / "ck32")
    ckpt.save(1, tree, d2, codec="takum16")
    ckpt.save(1, tree, d3)
    got2, _ = ckpt.restore(d2, tree)
    np.testing.assert_allclose(got2["w"], tree["w"], rtol=2e-3, atol=1e-6)
    np.testing.assert_array_equal(got2["b"]["x"], tree["b"]["x"])
    sz = [os.path.getsize(os.path.join(x, "step_0000000001", "arrays.npz"))
          for x in (d2, d3)]
    assert sz[0] < sz[1]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


@pytest.fixture
def sigterm_restored():
    """Whatever SIGTERM handler the process had, back after the test."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def test_manager_async_save_and_preemption(tmp_path, sigterm_restored):
    d = str(tmp_path / "mgr")
    mgr = ckpt.CheckpointManager(d, keep=2, codec="takum16", save_interval=4)
    # the guard took SIGTERM (or the kill below would end this process)
    assert signal.getsignal(signal.SIGTERM) == mgr.guard._handler
    tree = {"p": torch.linspace(-1, 1, 10)}
    assert not mgr.maybe_save(3, tree)          # not on the interval
    assert mgr.maybe_save(4, tree)
    mgr.wait()
    assert ckpt.latest_step(d) == 4
    # SIGTERM -> save at the next step boundary, off the interval
    os.kill(os.getpid(), signal.SIGTERM)
    assert mgr.guard.should_save()
    assert mgr.maybe_save(5, tree)
    mgr.wait()
    assert not mgr.guard.should_save()
    assert ckpt.latest_step(d) == 5
    back, step = mgr.restore_latest(tree, device="cpu")
    assert step == 5
    torch.testing.assert_close(back["p"], tree["p"], rtol=2e-3, atol=1e-6)
    assert mgr.maybe_save(6, tree, force=True)
    mgr.wait()
    assert sorted(ckpt._all_steps(d)) == [5, 6]
