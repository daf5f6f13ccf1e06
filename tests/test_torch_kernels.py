"""The port's ops against the JAX package's kernels, on the CPU.

Inputs are made with numpy; the JAX side runs its Pallas kernels in
interpret mode (``use_kernel=True, interpret=True``), the port runs the
plain versions its wrappers take for CPU tensors. Tolerances are the
reference tests': ``rtol=1e-5, atol=1e-4`` for the wire matmul
(tests/test_kernels.py) and ``atol=2e-5`` for attention
(tests/test_paged_attention.py). Also checked: the kernel wrappers' CPU
paths and launch counters, ``WireMatrix``, and the paged append of
``models/layers.py``.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref, takum_attention, takum_codec
from repro_torch.kernels import takum_matmul
from repro_torch.models import layers as L

WIDTHS = [8, 16]


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(rng, shape, n, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.asarray(jtakum.float_to_takum(jnp.asarray(x), n))


# -- wire matmul ---------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("mkn", [(128, 128, 128), (256, 384, 128),
                                 (100, 130, 60), (4, 320, 64)])
def test_quant_matmul_matches_reference_kernel(n, mkn):
    m, k, nn = mkn
    rng = np.random.default_rng(5)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = _words(rng, (k, nn), n, scale=k ** -0.5)
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), n,
                                        True, True))
    got = ops.quant_matmul(_t(x), _t(w), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_quant_matmul_leading_dims_and_wire_matrix():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    wm = ops.WireMatrix.encode(_t(w), fmt="takum16")
    jwm = jops.WireMatrix.encode(jnp.asarray(w), fmt="takum16")
    np.testing.assert_array_equal(wm.words.numpy(), np.asarray(jwm.words))
    got = (_t(x) @ wm).numpy()
    want = np.asarray(jnp.asarray(x) @ jwm)
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert wm.shape == (64, 32) and wm.dtype == torch.float32
    with pytest.raises(ValueError, match="identity"):
        ops.WireMatrix.encode(_t(w), fmt="none")


# -- contiguous attention ----------------------------------------------------------


def _attn_case(rng, n, b=2, tq=5, hkv=2, g=2, hd=16, tmax=40):
    q = rng.normal(size=(b, tq, hkv * g, hd)).astype(np.float32)
    kw = _words(rng, (b, tmax, hkv, hd), n)
    vw = _words(rng, (b, tmax, hkv, hd), n)
    return q, kw, vw


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("pos,window,block", [(0, 0, None), (17, 0, 16),
                                              (30, 12, 8), (35, 0, None)])
def test_takum_attention_matches_reference_kernel(n, pos, window, block):
    rng = np.random.default_rng(11 + pos)
    q, kw, vw = _attn_case(rng, n)
    start = np.array([0, 3], np.int32)
    kwargs = dict(pos=pos, start=start, window=window, block=block)
    want = np.asarray(jops.takum_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), n, f"takum{n}",
        use_kernel=True, interpret=True, **kwargs))
    got = ops.takum_attention(_t(q), _t(kw), _t(vw), n, f"takum{n}",
                              **kwargs).numpy()
    # rows before a sequence's start are garbage on every path
    valid = (pos + np.arange(q.shape[1]))[None, :] >= start[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=2e-5)


def test_attention_wrapper_cpu_path_is_the_plain_version():
    rng = np.random.default_rng(12)
    q, kw, vw = _attn_case(rng, 8, tq=3)
    spec = formats.get("takum8")
    q4 = takum_attention.to_rows(_t(q), 2)
    before = takum_attention.attention.launches
    out4 = takum_attention.attention(q4, _t(kw), _t(vw), 9,
                                     torch.zeros(2, dtype=torch.int32),
                                     spec=spec, bk=16, tq=3)
    assert takum_attention.attention.launches == before   # no launch on CPU
    want = ref.attention_ref(_t(q), _t(kw), _t(vw), 8, spec, pos=9)
    torch.testing.assert_close(takum_attention.from_rows(out4, 3), want, rtol=0, atol=0)


# -- paged attention -------------------------------------------------------------

P, PS, HKV, G, HD, NP, B = 11, 16, 2, 2, 16, 4, 4


def _pool(rng, spec_name):
    kf = rng.normal(size=(P, PS, HKV, HD)).astype(np.float32)
    vf = rng.normal(size=(P, PS, HKV, HD)).astype(np.float32)
    if spec_name == "none":
        kw, vw = kf, vf
    else:
        n = int(spec_name[5:])
        kw = np.array(jtakum.float_to_takum(jnp.asarray(kf), n))
        vw = np.array(jtakum.float_to_takum(jnp.asarray(vf), n))
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, NP), np.int32)
    table[0] = perm[:NP]
    table[1] = perm[NP:2 * NP]
    table[2, :2] = perm[8:10]
    return kw, vw, table


def _paged_both(q, kw, vw, table, name, **kw_):
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        name, use_kernel=True, interpret=True,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw_.items()}))
    got = ops.paged_attention(_t(q), _t(kw), _t(vw), _t(table), name,
                              **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                                 for k, v in kw_.items()}).numpy()
    return got, want


@pytest.mark.parametrize("name", ["none", "takum8", "takum16"])
def test_paged_attention_matches_reference_kernel(name):
    rng = np.random.default_rng(0)
    kw, vw, table = _pool(rng, name)
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    got, want = _paged_both(q, kw, vw, table, name,
                            pos=np.array([NP * PS - 1, 37, 20, 0], np.int32),
                            start=np.array([0, 5, 3, 0], np.int32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("window", [7, 24])
def test_paged_window_matches_reference_kernel(window):
    rng = np.random.default_rng(1)
    kw, vw, table = _pool(rng, "takum16")
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    got, want = _paged_both(q, kw, vw, table, "takum16", window=window,
                            pos=np.array([60, 37, 20, 0], np.int32))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("window", [0, 7])
def test_paged_pages_out_of_range_match_reference_kernel(window):
    """An idle slot whose stale pos ran past its table (with a window, no
    page is in range: the kernel's empty accumulator gives 0), a start
    past pos (every key masked), and a NaR V word on a page past pos:
    every row, as the reference kernel computes it."""
    rng = np.random.default_rng(9)
    kw, vw, table = _pool(rng, "takum16")
    vw[table[2, 1], 3, 1, 5] = 1 << 15      # NaR on a page past seq 2's pos
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    got, want = _paged_both(q, kw, vw, table, "takum16", window=window,
                            pos=np.array([60, 37, 12, 10 * NP * PS], np.int32),
                            start=np.array([0, 40, 0, 0], np.int32))
    assert np.isfinite(got).all()
    if window:
        assert (want[3] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_paged_idle_slot_drift_and_stale_words():
    """A stale pos past the table is clamped; words past a sequence's pos
    on its pages (a previous owner's) do not change its output."""
    rng = np.random.default_rng(4)
    kw, vw, table = _pool(rng, "takum8")
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    pos = np.array([20, 37, 20, 10 * NP * PS], np.int32)
    got, want = _paged_both(q, kw, vw, table, "takum8", pos=pos)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    kw2 = kw.copy()
    kw2[table[0, 1], 5:] = 201
    kw2[table[0, 2:]] = 77
    got2, _ = _paged_both(q, kw2, vw, table, "takum8", pos=pos)
    np.testing.assert_array_equal(got2[:3], got[:3])


def test_paged_nar_poisons_only_attending_rows():
    rng = np.random.default_rng(5)
    kw, vw, table = _pool(rng, "takum16")
    kw[table[1, 0], 8, 0, 0] = 1 << 15                # NaR
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    got, want = _paged_both(q, kw, vw, table, "takum16",
                            pos=np.array([NP * PS - 1, 37, 20, 0], np.int32))
    for out in (got, want):
        assert np.isnan(out[1, 0, :G]).all()
        assert np.isfinite(out[1, 0, G:]).all()
        assert np.isfinite(out[0]).all() and np.isfinite(out[2:]).all()


def test_paged_rejects_prefill_shapes():
    rng = np.random.default_rng(6)
    kw, vw, table = _pool(rng, "takum8")
    with pytest.raises(ValueError, match="decode-only"):
        ops.paged_attention(torch.zeros((B, 2, HKV * G, HD)), _t(kw), _t(vw),
                            _t(table), "takum8", pos=torch.zeros(B))


def test_paged_wrapper_cpu_path_is_the_plain_version():
    rng = np.random.default_rng(8)
    kw, vw, table = _pool(rng, "takum8")
    q = _t(rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32))
    pos = torch.tensor([20, 37, 20, 0], dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32)
    before = takum_attention.paged_attention.launches
    out4 = takum_attention.paged_attention(
        takum_attention.to_rows(q, HKV), _t(kw), _t(vw), pos, start, _t(table),
        spec=formats.get("takum8"))
    assert takum_attention.paged_attention.launches == before
    want = ref.paged_attention_ref(q, _t(kw), _t(vw), _t(table), "takum8",
                                   pos=pos, start=start)
    torch.testing.assert_close(takum_attention.from_rows(out4, 1), want, rtol=0, atol=0)


def test_codec_and_matmul_wrappers_do_not_launch_on_cpu():
    spec = formats.get("takum16")
    counts = (takum_codec.decode.launches, takum_codec.encode.launches,
              takum_matmul.qmatmul.launches)
    w = takum_codec.encode(torch.randn(64, 64), spec)
    takum_codec.decode(w, spec)
    takum_matmul.qmatmul(torch.randn(3, 64), w, spec)
    assert (takum_codec.decode.launches, takum_codec.encode.launches,
            takum_matmul.qmatmul.launches) == counts


@pytest.mark.parametrize("bits", [8, 16])
def test_qmatmul_launch_plan_covers_every_k_tile(bits):
    """Every K row lies in exactly one split (the last split is not
    empty), decode batches stream and prefill chunks take the tensor
    cores, a streaming block's x slice fits its stage, and the partial
    sums never outweigh a quarter of the weight words."""
    kt_rows = takum_matmul.KTILE
    for m, k, n in [(4, 5120, 5120), (4, 5120, 1280), (4, 5120, 17920),
                    (4, 17920, 5120), (256, 5120, 5120), (256, 5120, 1280),
                    (256, 5120, 17920), (256, 17920, 5120), (16, 64, 64),
                    (1, 100, 60), (16, 320, 192), (17, 250, 130),
                    (3, 17920, 37), (256, 31, 9)]:
        variant, split, per = takum_matmul.launch_plan(m, k, n, bits)
        kt = -(-k // kt_rows)
        assert variant == (0 if m <= takum_matmul.STREAM_M else 1)
        assert split * per >= kt and (split - 1) * per < kt
        if variant == 1 and split > 1:
            # K is split only to fill the SMs
            bm, bn = takum_matmul.TC_BLOCKS[bits]
            assert -(-m // bm) * -(-n // bn) < 2 * takum_matmul.SMS
        if variant == 0:
            mc = takum_matmul.STREAM_BLOCKS[bits][0]
            assert mc * per * kt_rows <= takum_matmul.STREAM_X_FLOATS
            if split > 1:
                assert split * m * n * 4 <= k * n * bits // 8 // 4 + m * n * 4


# -- the model's paged branch -----------------------------------------------------


def test_layers_paged_branch_matches_reference():
    """The append lands at (table[b, pos // ps], pos % ps), words and
    output agree with the JAX layer on the same weights and cache."""
    import jax
    jcfg = dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                               kv_quant="takum16")
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant="takum16")
    jparams = jL.attn_init(jax.random.PRNGKey(0), cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd)
    params = {k: _t(v) for k, v in jparams.items()}
    rng = np.random.default_rng(7)
    words = np.asarray(jtakum.float_to_takum(jnp.asarray(
        rng.normal(size=(7, 16, cfg.n_kv_heads, cfg.hd)).astype(np.float32)),
        16))
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pos = np.array([33, 17], np.int32)
    start = np.array([0, 4], np.int32)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jcache = {"k": jnp.asarray(words), "v": jnp.asarray(words[::-1]),
              "table": jnp.asarray(table), "pos": jnp.asarray(pos),
              "start": jnp.asarray(start)}
    step = jax.jit(lambda p, x_, pos_, c: jL.attention(p, x_, jcfg, pos_,
                                                       cache=c))
    jout, jnew = step(jparams, jnp.asarray(x), jnp.asarray(pos[:, None]),
                      jcache)
    cache = {"k": _t(words), "v": _t(words[::-1]), "table": _t(table),
             "pos": _t(pos), "start": _t(start)}
    out, new = L.attention(params, _t(x), cfg, _t(pos[:, None]), cache=cache)
    np.testing.assert_array_equal(new["pos"].numpy(), pos + 1)
    np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(jnew["k"]))
    np.testing.assert_array_equal(cache["v"].numpy(), np.asarray(jnew["v"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=2e-5)


def test_layers_paged_branch_is_decode_only():
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant="takum8")
    g = torch.Generator().manual_seed(0)
    params = L.attn_init(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros((3, 8, cfg.n_kv_heads, cfg.hd), dtype=torch.uint8),
             "v": torch.zeros((3, 8, cfg.n_kv_heads, cfg.hd), dtype=torch.uint8),
             "table": torch.zeros((1, 2), dtype=torch.int32),
             "pos": torch.zeros(1, dtype=torch.int32),
             "start": torch.zeros(1, dtype=torch.int32)}
    with pytest.raises(ValueError, match="decode-only"):
        L.attention(params, torch.zeros((1, 4, cfg.d_model)), cfg,
                    torch.zeros((1, 4), dtype=torch.int32), cache=cache)
