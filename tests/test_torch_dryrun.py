"""The dry run's placements and the kernels' fake branches
(``repro_torch/launch/dryrun.py``, ``repro_torch/kernels/cost.py``).

* A device's argument bytes under the reference's placements equal the
  JAX package's for every arch x shape x production mesh (and for the
  train cells under ``--dp-mode manual`` too), group by group
  (parameters, AdamW or flat state, cache, decode position, batch), the
  port's trees paired with the reference's layout through
  ``convert.py``'s stacking. The reference's side is its own
  ``build_cell`` on an ``AbstractMesh`` (its structs and
  ``NamedSharding``s; no compile): each leaf's ``shard_shape``. Token
  ids are int64 in the port, int32 in the reference, so the port's
  batch holds the reference's token bytes twice. A leaf whose placement
  does not divide (the reference's ``shard_shape`` refuses it) is
  listed by both.
* The placement functions (``zero1ify``, ``cache_spec``) equal the
  reference's ``_zero1ify`` and ``_cache_spec`` leaf by leaf.
* Each kernel's fake branch gives its plain version's shapes and dtypes,
  launches nothing and never calls the plain version.
* ``resolve_device`` takes ``cuda`` without a card only inside
  ``fake_cuda``; a dry-run cell refuses a process that already has a
  process group.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
(its first lines); the module fixture restores the variable, so no later
child process of this worker inherits it.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import os

import numpy as np
import pytest
import torch

from repro_torch import formats
from repro_torch.configs import SHAPES, get_arch, list_archs, shape_applicable
from repro_torch.device import fake_cuda, fake_device, resolve_device
from repro_torch.kernels import cost, lns_matmul, quantize, ref
from repro_torch.kernels import takum_attention, takum_codec, takum_matmul
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (PRODUCTION_MESHES, Mesh,
                                     batch_spec_axes)
from repro_torch.models import model


@pytest.fixture(scope="module")
def jd():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def _ref_groups(jd, arch, shape_name, multi_pod, dp_mode="gspmd"):
    """The reference's per-device bytes of a cell, by group, and its
    uneven leaves, from its own ``build_cell`` on an ``AbstractMesh``."""
    import jax
    from jax.sharding import AbstractMesh
    shp, names = PRODUCTION_MESHES[multi_pod]
    _, args = jd.build_cell(arch, shape_name, AbstractMesh(shp, names),
                            dp_mode=dp_mode)
    kind = SHAPES[shape_name].kind
    groups = {"train": ("params", "opt_state", "batch"),
              "prefill": ("params", "batch", "cache"),
              "decode": ("params", "batch", "cache", "pos")}[kind]
    out, uneven, tokens = {}, {}, 0
    for group, tree in zip(groups, args):
        total, bad = 0, 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            try:
                sh = leaf.sharding.shard_shape(leaf.shape)
            except ValueError:
                bad += 1
                continue
            b = int(np.prod(sh)) * leaf.dtype.itemsize
            total += b
            if group == "batch" and str(leaf.dtype) == "int32":
                tokens += b
        out[group], uneven[group] = total, bad
    return out, uneven, tokens


def _mesh(multi_pod):
    shp, names = PRODUCTION_MESHES[multi_pod]
    return Mesh(names, shp, (0,) * len(shp), (None,) * len(shp))


@pytest.mark.parametrize("arch", list_archs())
def test_argument_bytes_equal_the_reference_s(jd, arch):
    cfg = get_arch(arch).config
    with fake_cuda():
        dev = resolve_device("cuda")
        params = dryrun._fake_params(cfg, dev, "")
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            from repro_torch.launch import specs
            batch = specs.input_specs(cfg, shape, device=dev)
            cache = None
            if shape.kind != "train":
                cache = model.init_cache(cfg, shape.global_batch,
                                         shape.seq_len + 64,
                                         enc_len=max(shape.seq_len // 4, 8))
            modes = ("gspmd", "manual") if shape.kind == "train" \
                else ("gspmd",)
            for mp, mode in [(mp, m) for mp in (False, True) for m in modes]:
                mesh = _mesh(mp)
                dp = batch_spec_axes(mesh, shape.global_batch)
                got = dryrun.reference_argument_bytes(
                    params, cache, batch, cfg, shape, dict(mesh.shape),
                    dp_mode=mode, dp=dp)
                want, uneven, tokens = _ref_groups(jd, arch, name, mp, mode)
                where = (arch, name, mp, mode)
                for group, b in want.items():
                    n_bad = sum(u.startswith(group + ":")
                                for u in got.uneven)
                    assert n_bad == uneven[group], where + (group,)
                    g = got.by_group.get(group, 0)
                    if n_bad:
                        assert g > b, where + (group,)
                    elif group == "batch":
                        assert g == b + tokens, where
                    else:
                        assert g == b, where + (group,)


def test_a_cell_reports_the_same_bytes(jd):
    cell = dryrun.run_cell("phi3-medium-14b", "decode_32k", out_dir=None)
    want, _, tokens = _ref_groups(jd, "phi3-medium-14b", "decode_32k", False)
    assert cell["status"] == "error"
    assert "ShardPlan(tp=16) cannot split n_heads=40" in cell["error"]
    assert cell["memory"]["argument_size_in_bytes"] == \
        sum(want.values()) + tokens
    assert cell["n_devices"] == 256 and cell["mesh"] == "pod16x16"
    assert cell["params"] == get_arch("phi3-medium-14b").config.param_count()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placement_functions_are_the_reference_s(jd, multi_pod):
    from jax.sharding import PartitionSpec as P
    from repro.dist import sharding as jshd
    shp, names = PRODUCTION_MESHES[multi_pod]
    sizes = dict(zip(names, shp))

    class JMesh:
        axis_names = names
        shape = sizes

    rules = jshd.RULES_3D if multi_pod else jshd.RULES_2D
    cfg = get_arch("phi3-medium-14b").config
    shapes = [(100352, 5120), (40, 5120, 17920), (40, 17920, 5120),
              (40, 5120), (7, 12, 32), (256, 32), (49155, 1536)]
    for name in ("['embed_tokens']", "['groups']/[0]/['b0']/['mlp']/['w2']",
                 "['groups']/[0]/['b0']/['attn']/['wq']"):
        for s in shapes:
            base = jshd.param_spec(name, s, rules)
            want = jd._zero1ify(base, s, JMesh, True)
            got = dryrun.zero1ify(tuple(base), s, sizes, True)
            assert P(*got) == want, (name, s)
    for b in (1, 32, 128, 256):
        dp = batch_spec_axes(_mesh(multi_pod), b)
        shape = SHAPES["decode_32k"]
        for s in [(40, b, 32832, 10, 128), (b, 32832, 10, 128), (40,), (),
                  (b, 8192, 1024), (26, b, 2560), (32, b, 4, 2560)]:
            want = jd._cache_spec("x", s, cfg, type(shape)(
                shape.name, shape.seq_len, b, shape.kind), dp, JMesh)
            got = dryrun.cache_spec(s, b, dp, sizes)
            assert P(*got) == want, (b, s)


# --- the kernels' fake branches ---------------------------------------------


def _inputs(dev, gen=None):
    """The wrappers' arguments on ``dev`` (real values on the CPU, empty
    fakes on the fake device)."""
    def f(*shape, dtype=torch.float32):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        return torch.randn(shape, generator=gen).to(dtype)

    def words(spec, *shape):
        if gen is None:
            return torch.empty(shape, dtype=spec.word_dtype, device=dev)
        return takum_codec.encode(f(*shape), spec)

    t8, l8, p16 = (formats.get(n) for n in ("takum8", "lns-takum8",
                                            "posit16"))
    calls = {
        "decode": lambda: takum_codec.decode(words(t8, 5, 7), t8),
        "decode_f64": lambda: takum_codec.decode(words(p16, 6), p16,
                                                 dtype=torch.float64),
        "decode_bf16": lambda: takum_codec.decode(words(t8, 3, 4), t8,
                                                  dtype=torch.bfloat16),
        "encode": lambda: takum_codec.encode(f(4, 9), p16),
        "fake_quant": lambda: quantize.fake_quant(f(4, 9), t8,
                                                  dtype=torch.bfloat16),
        "qmatmul": lambda: takum_matmul.qmatmul(f(3, 64), words(t8, 64, 32),
                                                t8),
        "lns_matmul": lambda: lns_matmul.lns_matmul(words(l8, 3, 32),
                                                    words(l8, 32, 16), l8),
        "lns_gauss": lambda: lns_matmul.lns_matmul(
            words(l8, 2, 32), words(l8, 32, 8), l8, "gauss", state=True),
        "attention": lambda: takum_attention.attention(
            f(2, 2, 8, 16), words(t8, 2, 40, 2, 16), words(t8, 2, 40, 2, 16),
            30, spec=t8, tq=2),
    }
    if gen is not None:
        table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
        pos = torch.tensor([9, 3], dtype=torch.int32)
    else:
        table = torch.empty((2, 2), dtype=torch.int32, device=dev)
        pos = torch.empty((2,), dtype=torch.int32, device=dev)
    calls["paged_attention"] = lambda: takum_attention.paged_attention(
        f(2, 2, 4, 16), words(t8, 4, 8, 2, 16), words(t8, 4, 8, 2, 16), pos,
        None, table, spec=t8)

    def append():
        kc, vc = words(t8, 2, 12, 2, 16), words(t8, 2, 12, 2, 16)
        takum_codec.kv_append(f(2, 3, 2, 16), f(2, 3, 2, 16), kc, vc, t8,
                              pos=4)
        return kc, vc
    calls["kv_append"] = append
    return calls


def _shapes(out):
    if isinstance(out, tuple):
        return tuple(_shapes(o) for o in out)
    return (tuple(out.shape), out.dtype)


_PLAIN = ("decode_ref", "encode_ref", "kv_append_ref", "fake_quant_ref",
          "qmatmul_ref", "lns_matmul_plain", "attention_ref",
          "paged_attention_ref")


def test_fake_branches_give_the_plain_shapes(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    want = {k: _shapes(fn()) for k, fn in _inputs("cpu", gen).items()}
    launches = {f: f.launches for f in (
        takum_codec.decode, takum_codec.encode, takum_codec.kv_append,
        quantize.fake_quant, takum_matmul.qmatmul, lns_matmul.lns_matmul,
        takum_attention.attention, takum_attention.paged_attention)}

    def plain(*a, **k):
        raise AssertionError("a fake input reached a plain version")
    for name in _PLAIN:
        monkeypatch.setattr(ref, name, plain)
    with fake_cuda():
        dev = resolve_device("cuda")
        assert dev == fake_device()
        counter = cost.CostCounter()
        with counter:
            got = {k: _shapes(fn()) for k, fn in _inputs(dev).items()}
    assert got == want
    assert {f: f.launches for f in launches} == launches
    k = counter.kernels
    assert k["qmatmul"] == {"calls": 1, "flops": 2 * 3 * 64 * 32,
                            "bytes": 3 * 64 * 4 + 64 * 32 + 3 * 32 * 4}
    assert k["lns_matmul"]["calls"] == 2
    assert k["takum_decode"]["calls"] == 3
    # contiguous attention: keys up to (pos + tq - 1) // tile + 1 tiles
    # of 40 (the cache rounded up to 8), 4 flops a key, row and lane
    assert k["attention"]["flops"] == 4 * 2 * 2 * 8 * 40 * 16
    assert k["paged_attention"]["flops"] == 4 * 2 * 2 * 4 * 16 * 16
    assert k["kv_append"]["bytes"] == 2 * 2 * 3 * 2 * 16 * 4 + 2 * 2 * 3 * 32


def test_fake_branches_check_as_the_card_does():
    with fake_cuda():
        dev = resolve_device("cuda")
        t8 = formats.get("takum8")
        x = torch.empty((3, 64), device=dev)
        with pytest.raises(TypeError, match="takes takum8/16"):
            takum_matmul.qmatmul(
                x, torch.empty((64, 8), dtype=torch.uint16, device=dev),
                formats.resolve("takum12"))
        with pytest.raises(ValueError, match="head_dim 24"):
            takum_attention.attention(
                torch.empty((1, 1, 2, 24), device=dev),
                torch.empty((1, 8, 1, 24), dtype=torch.uint8, device=dev),
                torch.empty((1, 8, 1, 24), dtype=torch.uint8, device=dev),
                0, spec=t8, tq=2)


def test_cuda_without_a_card_only_inside_fake_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a real device here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with fake_cuda():
        assert resolve_device() == fake_device()
        t = torch.empty(3, device=resolve_device())
        assert cost.is_fake(t) and cost.on_card(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_a_cell_refuses_an_existing_process_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        cell = dryrun.run_cell("rwkv6-1.6b", "decode_32k", out_dir=None)
    finally:
        dist.destroy_process_group()
    assert cell["status"] == "error"
    assert "already has one (gloo, 1 ranks)" in cell["error"]
