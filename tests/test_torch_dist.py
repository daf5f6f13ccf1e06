"""The port's distribution layer against the JAX package's, on the CPU.

* **The rings**, bit for bit: the reference's ``ring_reduce_scatter``,
  ``ring_all_gather`` and ``ring_all_reduce`` run in one child process
  over 4 forced host devices, each under ``jax.jit(shard_map(...))``
  (un-jitted ``shard_map`` dispatches primitive by primitive and takes
  minutes), and the port's rings in one 4-rank gloo job
  (``repro_torch.dist.selftest``) on the same seeded inputs: integer
  valued floats exactly, the all-reduce of 40 columns (padding) with
  ``mean``, and compressed rings (takum16 as a ``QuantSpec``, the
  registry's takum8 and posit8) on values spread over 10^+-3. Every
  rank's output **and residual** must equal the reference's, bit for bit
  (tolerance 0).
* **``wire_roundtrip``** in-process against the reference's, for every
  registered wire format and both spec families, the identity and
  ``None`` included: linear takum and posit bit for bit; logarithmic
  takum pays one ``log``/``exp`` (tests/test_torch_lns.py), so its words
  are the reference's or a neighbour and, where equal, the values within
  2 ulp.
* The size-1 contract, ``param_spec`` (the reference's own cases and
  every leaf of reduced phi3), ``batch_spec_axes`` and
  ``plan_elastic_remesh`` against the reference's.
* ``python -m repro_torch.dist.selftest --world 4`` and ``--world 1``
  print ``SELFTEST OK``.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.configs import get_arch as jget_arch
from repro.core.quant import QuantSpec as JQuantSpec
from repro.dist import collectives as jcoll
from repro.dist import sharding as jshd
from repro.ft.watchdog import plan_elastic_remesh as jremesh
from repro.launch.mesh import batch_spec_axes as jbatch_spec_axes
from repro.models import model as jmodel
from repro_torch import formats
from repro_torch.core.bitops import carrier
from repro_torch.core.quant import QuantSpec
from repro_torch.dist import collectives as coll
from repro_torch.dist import selftest
from repro_torch.dist import sharding as shd
from repro_torch.ft.watchdog import plan_elastic_remesh
from repro_torch.launch.mesh import batch_spec_axes

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

# (op, wire spec, mean, integer-valued, columns a rank)
RING_CASES = [
    ("reduce_scatter", "none", False, True, 64),
    ("all_gather", "none", False, True, 16),
    ("all_reduce", "none", False, True, 40),
    ("all_reduce", "none", True, True, 40),
    ("reduce_scatter", "q:takum:16", False, False, 64),
    ("reduce_scatter", "posit8", True, False, 64),
    ("all_gather", "takum8", False, False, 16),
    ("all_reduce", "q:takum:16", False, False, 40),
    ("all_reduce", "takum8", False, False, 40),
    ("all_reduce", "posit8", True, False, 40),
]

# the reference's rings, each under jax.jit(shard_map(...)), in a child
# with 4 forced host devices (the test process keeps one)
REF_CHILD = r"""
import functools, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro import formats
from repro.core.quant import QuantSpec
from repro.dist import collectives as coll

W = 4
mesh = jax.make_mesh((W,), ("data",))

def spec_of(key):
    if key == "none":
        return None
    if key.startswith("q:"):
        _, fmt, n = key.split(":")
        return QuantSpec(fmt=fmt, n=int(n), scale="none")
    return formats.get(key)

def gather(v, spec):
    return coll.ring_all_gather(v[0], "data", W, spec=spec)[None]

def scatter(v, spec, mean):
    y, r = coll.ring_reduce_scatter(v[0], "data", W, spec=spec, mean=mean)
    return y[None], r[None]

def reduce(v, spec, mean):
    y, r = coll.ring_all_reduce(v[0], "data", W, spec=spec, mean=mean)
    return y[None], r[None]

data = np.load(sys.argv[1])
fns, xs, specs = [], [], []
for i, name in enumerate(data["names"]):
    op, key, mean = str(name).split("|")
    spec = spec_of(key)
    xs.append(data["x%d" % i])
    if op == "all_gather":
        fns.append(functools.partial(gather, spec=spec))
        specs.append(P("data", None))
    else:
        fns.append(functools.partial(
            scatter if op == "reduce_scatter" else reduce, spec=spec,
            mean=mean == "1"))
        specs.append((P("data", None), P("data", None)))

def every(*vs):
    return tuple(f(v) for f, v in zip(fns, vs))

# one program for every case: one compile
res = jax.jit(shard_map(every, mesh=mesh, in_specs=(P("data"),) * len(xs),
                        out_specs=tuple(specs), check_rep=False))(*xs)
out = {}
for i, r in enumerate(res):
    if isinstance(r, tuple):
        out["y%d" % i], out["r%d" % i] = map(np.asarray, r)
    else:
        out["y%d" % i] = np.asarray(r)
np.savez(sys.argv[2], **out)
"""


def _ring_inputs():
    rng = np.random.default_rng(2)
    names, arrays = [], {}
    for i, (op, key, mean, ints, cols) in enumerate(RING_CASES):
        x = rng.integers(-8, 8, size=(WORLD, cols)).astype(np.float32)
        if not ints:
            x = x * 10.0 ** rng.uniform(-3, 3, size=x.shape).astype(
                np.float32)
        names.append(f"{op}|{key}|{int(mean)}")
        arrays[f"x{i}"] = x
    return np.array(names), arrays


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_rings_equal_the_reference_bit_for_bit(tmp_path):
    names, arrays = _ring_inputs()
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, names=names, **arrays)
    ref = subprocess.Popen([sys.executable, "-c", REF_CHILD, str(inputs),
                            str(tmp_path / "ref.npz")], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        # meanwhile, the port's rings in one 4-rank gloo job (and the
        # selftest's checks)
        selftest.run(WORLD, inputs=str(inputs), tmp=str(tmp_path))
        _, err = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    want = np.load(tmp_path / "ref.npz")
    for r in range(WORLD):
        got = np.load(tmp_path / f"rings_{r}.npz")
        for i, name in enumerate(names):
            for key in (f"y{i}", f"r{i}"):
                if key not in want.files:
                    continue          # the all-gather has no residual
                np.testing.assert_array_equal(
                    got[key].view(np.uint32), want[key][r].view(np.uint32),
                    err_msg=f"rank {r} {name} {key[0]}")
    # the compressed cases did compress: non-zero residuals somewhere
    assert any(np.load(tmp_path / "rings_0.npz")[f"r{i}"].any()
               for i, c in enumerate(RING_CASES)
               if c[1] != "none" and c[0] != "all_gather")


def _roundtrip_inputs():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(512,)) * 10.0 ** rng.uniform(-3, 3, size=(512,)))
    return np.concatenate([x, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)


def _specs():
    """(port spec, reference spec, id): every registered wire format, the
    identity, None, and unscaled QuantSpecs of each family."""
    out = [(formats.get(n), jformats.get(n), n) for n in formats.wire_names()]
    assert [s[2] for s in out] == [s.name for s in jformats.wire_formats()]
    out += [(formats.get("none"), jformats.get("none"), "none"),
            (None, None, "None")]
    for fmt, n in (("takum", 16), ("takum", 8), ("posit", 16),
                   ("takum_lns", 16), ("none", 16)):
        out.append((QuantSpec(fmt=fmt, n=n, scale="none"),
                    JQuantSpec(fmt=fmt, n=n, scale="none"), f"q:{fmt}{n}"))
    return out


def _is_lns(spec) -> bool:
    return getattr(spec, "kind", None) == "lns" or \
        getattr(spec, "fmt", None) == "takum_lns"


@pytest.mark.parametrize("spec,jspec,name", _specs(),
                         ids=[s[2] for s in _specs()])
def test_wire_roundtrip_equals_the_reference(spec, jspec, name):
    x = _roundtrip_inputs()
    y, res = coll.wire_roundtrip(torch.from_numpy(x), spec)
    jy, jres = jax.jit(lambda v: jcoll.wire_roundtrip(v, jspec))(
        jnp.asarray(x))
    jy, jres = np.asarray(jy), np.asarray(jres)
    if not _is_lns(spec):
        np.testing.assert_array_equal(y.numpy().view(np.uint32),
                                      jy.view(np.uint32), err_msg=name)
        np.testing.assert_array_equal(res.numpy().view(np.uint32),
                                      jres.view(np.uint32), err_msg=name)
    else:
        # LNS: the reference's word or its neighbour; equal words decode
        # within 2 ulp (one exp each side)
        fmt = coll._wire_format(spec)[0]
        words, _ = coll.encode_hop(torch.from_numpy(x), spec)
        jw = np.asarray(jformats.resolve(fmt.name).encode_tile(
            jnp.asarray(x)))
        w = carrier(words).numpy().view(jw.dtype).astype(np.int64)
        jw = jw.astype(np.int64)
        assert np.abs(w - jw).max() <= 1, name
        same = w == jw
        ulp = np.abs(y.numpy()[same].view(np.int32).astype(np.int64)
                     - jy[same].view(np.int32).astype(np.int64))
        assert ulp.max() <= 2, (name, ulp.max())
    # the residual is what the wire dropped, and the wire is a fixed point
    np.testing.assert_array_equal((x - y.numpy()).view(np.uint32),
                                  res.numpy().view(np.uint32))
    y2, res2 = coll.wire_roundtrip(y, spec)
    assert torch.equal(y2, y) and not res2.any(), name


def test_size1_collectives_are_the_identity():
    selftest.check_size1()
    x = torch.arange(12, dtype=torch.float32)
    y, r = coll.ring_all_reduce(x, None, 1, mean=True)
    assert torch.equal(y, x) and not r.any()
    y, r = coll.ring_reduce_scatter(x, None, 1, spec=formats.get("takum8"))
    assert torch.equal(y, x) and not r.any()
    assert coll.ring_all_gather(x, None, 1,
                                spec=formats.get("takum8")) is x


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tuple(tree.shape)


def test_param_spec_equals_the_reference():
    selftest.check_param_spec()
    cases = [("blk/attn/wq", (64, 128)), ("blk/attn/wo", (128, 64)),
             ("blk/norm/scale", (64,)), ("embed/embed_tokens", (1024, 64)),
             ("stack/mlp/w1", (12, 64, 256)), ("blk/attn/wq", (63, 127)),
             ("blk/mlp/w2", (192, 64)), ("blk/ffn/down", (256, 64))]
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jget_arch("phi3-medium-14b").reduced))
    cases += list(_leaves(params))
    assert len(cases) > 12
    for rules in (shd.RULES_2D, shd.RULES_3D):
        jrules = jshd.RULES_2D if rules is shd.RULES_2D else jshd.RULES_3D
        for sizes in (None, {"data": 2, "model": 4},
                      {"pod": 2, "data": 2, "model": 2}):
            for name, shape in cases:
                got = shd.param_spec(name, shape, rules, axis_sizes=sizes)
                want = jshd.param_spec(name, shape, jrules,
                                       axis_sizes=sizes)
                assert got == tuple(want), (name, shape, sizes, got, want)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape,batches", [
    ({"data": 16, "model": 16}, (1, 32, 24, 16, 8)),
    ({"pod": 2, "data": 16, "model": 16}, (1, 64, 2, 3, 32, 48)),
    ({"model": 4}, (1, 4)),
])
def test_batch_spec_axes_equals_the_reference(shape, batches):
    mesh = _FakeMesh(shape)
    for b in batches:
        try:
            want = jbatch_spec_axes(mesh, b)
        except ValueError as e:
            with pytest.raises(ValueError) as ei:
                batch_spec_axes(mesh, b)
            assert str(ei.value) == str(e)
            continue
        assert batch_spec_axes(mesh, b) == want


def test_plan_elastic_remesh_equals_the_reference():
    for model_axis in (1, 2, 16):
        for n in (0, 1, 7, 8, 16, 31, 256, 504, 512, 1000):
            assert plan_elastic_remesh(n, model_axis=model_axis) == \
                jremesh(n, model_axis=model_axis), (n, model_axis)


@pytest.mark.parametrize("world", [1, 4])
def test_selftest_cli(world):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.selftest", "--world",
         str(world)], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "SELFTEST OK" in out.stdout
