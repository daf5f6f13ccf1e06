"""The port's CUDA kernels against their plain versions, on the card.

Small shapes; the full-width checks live in ``chip_smoke.py``. Every
test here is marked ``gpu`` and skips, inside its fixture, on a host
with no CUDA device (the kernels build with nvcc on first use and have
no CPU mode). Run on a GPU host with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the card's host has none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.core import takum
from repro_torch.kernels import ops, ref, takum_attention, takum_codec
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine, quantize_weights

pytestmark = pytest.mark.gpu

SPECS = [formats.get("takum8"), formats.get("takum16")]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _words(spec):
    return torch.arange(2 ** spec.n, dtype=torch.int64).to(spec.word_dtype)


def _floats(rng, size):
    with np.errstate(over="ignore"):      # beyond f32 range -> +-inf
        x = (rng.normal(size=size) * 10.0 ** rng.integers(-45, 39, size)
             ).astype(np.float32)
    raw = rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.1754942e-38, 3.4028235e38, -3.4028235e38],
                       np.float32)
    return np.concatenate([x, raw.view(np.float32), special])


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_decode_every_word_bit_exact(dev, spec):
    words = _words(spec)
    got = takum_codec.decode(words.to(dev), spec).cpu()
    want = takum.takum_to_float(words, spec.n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_encode_bit_exact(dev, spec):
    x = torch.from_numpy(_floats(np.random.default_rng(0), 100_000))
    got = takum_codec.encode(x.to(dev), spec).cpu()
    want = takum.float_to_takum(x, spec.n)
    assert torch.equal(got.to(torch.int64), want.to(torch.int64))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("mkn", [(4, 128, 64), (16, 320, 192),
                                 (37, 256, 128), (256, 512, 64),
                                 (3, 100, 60)])
def test_qmatmul_matches_plain(dev, spec, mkn):
    m, k, n = mkn
    g = torch.Generator().manual_seed(5)
    x = torch.randn((m, k), generator=g)
    w = takum.float_to_takum(torch.randn((k, n), generator=g) / k ** 0.5,
                             spec.n)
    got = ops.quant_matmul(x.to(dev), w.to(dev), spec).cpu()
    want = ref.qmatmul_ref(x.to(dev), w.to(dev), spec).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _cache(spec, shape, g):
    return takum.float_to_takum(torch.randn(shape, generator=g), spec.n)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("window", [0, 24])
def test_contiguous_attention_matches_plain(dev, spec, hd, window):
    g = torch.Generator().manual_seed(1)
    b, tq, hkv, grp, tmax = 2, 9, 2, 3, 72
    q = torch.randn((b, tq, hkv * grp, hd), generator=g)
    kw = _cache(spec, (b, tmax, hkv, hd), g)
    vw = _cache(spec, (b, tmax, hkv, hd), g)
    start = torch.tensor([0, 5], dtype=torch.int32)
    for pos, block in ((0, 32), (40, None), (50, 24)):
        kwargs = dict(pos=pos, start=start, window=window)
        got = ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                                  block=block, **kwargs).cpu()
        want = ref.attention_ref(q, kw, vw, 0, spec, **kwargs)
        # rows with qpos < start are garbage on every path: compare the rest
        valid = (pos + torch.arange(tq))[None, :] >= start[:, None].long()
        torch.testing.assert_close(got[valid], want[valid], rtol=0,
                                   atol=2e-5)


def _pool(spec, g, p=11, ps=16, hkv=2, hd=16):
    return (_cache(spec, (p, ps, hkv, hd), g), _cache(spec, (p, ps, hkv, hd), g))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("window", [0, 7])
def test_paged_attention_matches_plain(dev, spec, window):
    g = torch.Generator().manual_seed(2)
    kw, vw = _pool(spec, g)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 0, 0],
                          [0, 0, 0, 0]], dtype=torch.int32)
    # seq 3 is an idle slot whose stale pos ran past its table
    pos = torch.tensor([63, 37, 20, 900], dtype=torch.int32)
    start = torch.tensor([0, 5, 3, 0], dtype=torch.int32)
    q = torch.randn((4, 1, 4, 16), generator=g)
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev), window=window).cpu()
    want = ref.paged_attention_ref(q, kw, vw, table, spec, pos=pos,
                                   start=start, window=window)
    assert torch.isfinite(got).all()
    # every row, the idle slot's too (with a window no page is in range:
    # 0 on both paths)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_paged_nar_poisons_only_its_rows(dev):
    spec = formats.get("takum16")
    g = torch.Generator().manual_seed(3)
    kw, vw = _pool(spec, g)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    kw[5, 8, 0, 0] = takum.nar_word(16)     # seq 1, position 8, kv head 0
    pos = torch.tensor([63, 37], dtype=torch.int32)
    q = torch.randn((2, 1, 4, 16), generator=g)
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev)).cpu()
    assert torch.isnan(got[1, 0, :2]).all()
    assert torch.isfinite(got[1, 0, 2:]).all() and torch.isfinite(got[0]).all()


def test_wrappers_count_launches(dev):
    spec = formats.get("takum8")
    before = takum_codec.encode.launches
    takum_codec.encode(torch.zeros(8, device=dev), spec)
    assert takum_codec.encode.launches == before + 1
    takum_codec.encode(torch.zeros(8), spec)          # CPU: plain version
    assert takum_codec.encode.launches == before + 1
    n0 = takum_attention.paged_attention.launches
    g = torch.Generator().manual_seed(4)
    kw, vw = _pool(spec, g)
    ops.paged_attention(torch.randn((1, 1, 4, 16), device=dev), kw.to(dev),
                        vw.to(dev), torch.tensor([[1]], device=dev), spec,
                        pos=torch.tensor([3], device=dev))
    assert takum_attention.paged_attention.launches == n0 + 1


def _reduced(kv):
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant=kv)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    return cfg, quantize_weights(params, kv, mode="wire", verbose=False)


@pytest.mark.parametrize("kv", ["takum8", "takum16"])
def test_reduced_serving_card_matches_cpu(dev, kv):
    cfg, params = _reduced(kv)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (16, 9, 4, 13)]
    outs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(params, cfg, max_len=48, page_size=16, device=d)
        outs[str(d)] = (eng.generate(prompts, 6), eng.generate(prompts, 6))
    assert outs["cpu"] == outs["cuda"]
