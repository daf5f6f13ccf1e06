"""Multi-rank functional selftest of ``repro_torch.dist``.

``python -m repro_torch.dist.selftest --world N`` (default 8, as the
reference's) spawns N ranks on the CPU, joined by a gloo process group,
and runs the reference's checks (``repro/dist/selftest.py``) on the
port's rings; it prints ``SELFTEST OK`` and exits 0. ``--world 1`` runs
the single-rank checks in-process.

Covered (N ranks):

* ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_all_reduce``
  against the sums and concatenations they compute, exactly
  (integer-valued floats: the order of addition cannot show);
* the takum16-compressed all-reduce: every rank's result the same bit
  for bit, the median relative error of the wire below 2e-3;
* ``annotate`` under ``use_rules`` on a ``(2, N/2)`` mesh: each rank
  holds its local shard, so ``annotate`` returns its input; the mesh's
  axis groups hold the ranks of this rank's row and column.

Covered (one rank): the size-1 collectives are the identity with a zero
residual, ``wire_roundtrip`` takes both spec families (``QuantSpec``
and the registry's ``FormatSpec``), and ``param_spec``'s placements of
representative parameter names.

:func:`rank_main` also runs a list of ring cases from a file and writes
each rank's outputs and residuals (``tests/test_torch_dist.py`` holds
them against the reference's rings bit for bit).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import formats
from repro_torch.core.quant import QuantSpec
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import RANK_TIMEOUT

TAKUM16 = QuantSpec(fmt="takum", n=16, scale="none")


def wire_spec(key: str):
    """A ring case's wire spec: ``"none"``, a registry name, or
    ``"q:<fmt>:<n>"``, an unscaled ``QuantSpec``."""
    if key == "none":
        return None
    if key.startswith("q:"):
        _, fmt, n = key.split(":")
        return QuantSpec(fmt=fmt, n=int(n), scale="none")
    return formats.get(key)


def _world():
    import torch.distributed as dist
    return dist.group.WORLD


def _gather_all(t: torch.Tensor, size: int) -> torch.Tensor:
    """Every rank's ``t`` [c], stacked [size, c] (an exact ring)."""
    return coll.ring_all_gather(t.reshape(-1), _world(), size).reshape(
        size, -1)


def check_reduce_scatter(rank: int, size: int) -> None:
    g = size * 16
    x = np.random.default_rng(0).integers(-8, 8, size=(size, g)).astype(
        np.float32)
    got, _ = coll.ring_reduce_scatter(torch.from_numpy(x[rank]), _world(),
                                      size)
    want = x.sum(axis=0)[rank * 16:(rank + 1) * 16]
    np.testing.assert_array_equal(got.numpy(), want)


def check_all_gather(rank: int, size: int) -> None:
    x = np.random.default_rng(1).integers(-8, 8, size=(size, 16)).astype(
        np.float32)
    got = coll.ring_all_gather(torch.from_numpy(x[rank]), _world(), size)
    np.testing.assert_array_equal(got.numpy(), x.reshape(-1))


def check_all_reduce(rank: int, size: int, spec, exact: bool) -> None:
    c = 40   # not a multiple of the ring: the internal padding
    rng = np.random.default_rng(2)
    base = rng.integers(-8, 8, size=(size, c)).astype(np.float32)
    if not exact:
        base = base * 10.0 ** rng.uniform(-3, 3, size=(size, c)).astype(
            np.float32)
    y, resid = coll.ring_all_reduce(torch.from_numpy(base[rank]), _world(),
                                    size, spec=spec)
    want = base.sum(axis=0)
    if exact:
        np.testing.assert_array_equal(y.numpy(), want)
        np.testing.assert_array_equal(resid.numpy(), np.zeros_like(want))
        return
    # every rank holds the same wire result, bit for bit
    every = _gather_all(y, size).numpy()
    for r in range(size):
        np.testing.assert_array_equal(every[r], y.numpy())
    ok = want != 0
    rel = np.abs(y.numpy()[ok] - want[ok]) / np.abs(want[ok])
    assert np.median(rel) < 2e-3, np.median(rel)   # takum16 wire error


def check_annotate(rank: int, size: int) -> None:
    """On a (2, size/2) mesh: annotate returns the local shard it is given
    (the identity outside rules too), and each axis group holds the ranks
    of this rank's line."""
    from repro_torch.launch.mesh import make_mesh
    tp = size // 2
    mesh = make_mesh((2, tp), ("data", "model"))
    x = torch.zeros((4, 3, 8))
    with shd.use_rules(mesh, shd.RULES_2D):
        assert shd.annotate(x, "batch", "seq", "ff") is x
        try:
            shd.annotate(x, "batch", "seq")
        except ValueError:
            pass
        else:
            raise AssertionError("annotate took 2 names for a rank-3 input")
    assert shd.annotate(x, "batch", "seq", "ff") is x
    d, t = divmod(rank, tp)
    assert mesh.coords == (d, t), (mesh.coords, rank)
    me = torch.tensor([float(rank)])
    row = coll.ring_all_gather(me, mesh.group("model"), tp)
    assert row.tolist() == [float(d * tp + i) for i in range(tp)], row
    col = coll.ring_all_gather(me, mesh.group("data"), 2)
    assert col.tolist() == [float(t), float(tp + t)], col


def check_param_spec() -> None:
    rules = shd.RULES_2D
    sizes = {"data": 2, "model": 4}
    assert shd.param_spec("blk/attn/wq", (64, 128), rules,
                          axis_sizes=sizes) == ("data", "model")
    assert shd.param_spec("blk/attn/wo", (128, 64), rules,
                          axis_sizes=sizes) == ("model", "data")
    assert shd.param_spec("blk/norm/scale", (64,), rules,
                          axis_sizes=sizes) == ()
    assert shd.param_spec("embed/embed_tokens", (1024, 64), rules,
                          axis_sizes=sizes) == ("model", "data")
    # a stacked layer dim stays whole
    spec = shd.param_spec("stack/mlp/w1", (12, 64, 256), rules,
                          axis_sizes=sizes)
    assert spec[0] is None and spec[2] == "model", spec
    # the divisibility guard
    assert shd.param_spec("blk/attn/wq", (63, 127), rules,
                          axis_sizes=sizes) == (None, None)


def check_size1() -> None:
    """The single-rank contract: every collective is the identity with a
    zero residual, and ``wire_roundtrip`` takes a ``QuantSpec`` and a
    registry ``FormatSpec`` alike."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(40,)).astype(
        np.float32))
    assert torch.equal(coll.ring_reduce_scatter(x, None, 1)[0], x)
    assert torch.equal(coll.ring_all_gather(x, None, 1), x)
    assert torch.equal(coll.ring_all_reduce(x, None, 1)[0], x)
    assert not coll.ring_all_reduce(x, None, 1)[1].any()
    for spec in (None, TAKUM16, formats.resolve("takum16"),
                 formats.resolve("none")):
        y, res = coll.wire_roundtrip(x, spec)
        np.testing.assert_allclose((y + res).numpy(), x.numpy(), rtol=0,
                                   atol=1e-6)
        if spec is None or getattr(spec, "is_identity", False):
            assert not res.any()


def run_cases(rank: int, size: int, inputs: str, out: str) -> None:
    """The ring cases of ``inputs`` (an ``.npz``: ``names`` "op|spec|mean"
    and ``x<i>`` [size, n] each) on this rank's row; writes ``y<i>`` and
    ``r<i>`` (the residual; the all-gather has none) to ``out``."""
    data = np.load(inputs)
    res = {}
    for i, name in enumerate(data["names"]):
        op, key, mean = str(name).split("|")
        spec, x = wire_spec(key), torch.from_numpy(data[f"x{i}"][rank])
        if op == "all_gather":
            y, r = coll.ring_all_gather(x, _world(), size, spec=spec), None
        else:
            fn = (coll.ring_reduce_scatter if op == "reduce_scatter"
                  else coll.ring_all_reduce)
            y, r = fn(x, _world(), size, spec=spec, mean=mean == "1")
        res[f"y{i}"] = y.numpy()
        if r is not None:
            res[f"r{i}"] = r.numpy()
    np.savez(out, **res)


def rank_main(rank: int, size: int, tmp: str, inputs=None) -> None:
    """One rank of the selftest job (``torch.multiprocessing.spawn``'s
    target): the gloo group from a file in ``tmp``, the checks, and the
    cases of ``inputs`` into ``tmp/rings_<rank>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            world_size=size, rank=rank,
                            timeout=RANK_TIMEOUT)
    try:
        check_reduce_scatter(rank, size)
        check_all_gather(rank, size)
        check_all_reduce(rank, size, None, exact=True)
        check_all_reduce(rank, size, TAKUM16, exact=False)
        if size % 2 == 0:
            check_annotate(rank, size)
        if inputs is not None:
            run_cases(rank, size, inputs,
                      os.path.join(tmp, f"rings_{rank}.npz"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(world: int, inputs=None, tmp=None) -> None:
    """The whole selftest at ``world`` ranks (raises on a failed check)."""
    if world > 1:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as own:
            tmp = tmp or own
            mp.spawn(rank_main, args=(world, tmp, inputs), nprocs=world,
                     join=True)
    check_size1()
    check_param_spec()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=8,
                    help="ranks to spawn (gloo, CPU)")
    args = ap.parse_args(argv)
    run(args.world)
    print("SELFTEST OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
