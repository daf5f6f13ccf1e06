"""The port's LNS matmul, its ops and attention over LNS KV words against
the JAX package's kernels, on the CPU.

The JAX side runs ``lns_matmul_kernel_call`` and the attention kernels
in interpret mode, as its own tests do; the port runs the plain versions
its wrappers take for CPU tensors. Tolerances, each with its reason:

* linear accumulation: ``rtol=2e-5, atol=1e-6`` (tests/test_lns_kernel.py):
  both exponentiate the same exact ``ell`` sums, one ``exp`` per product
  (XLA's and torch's differ by an ulp or two) and f32 sums in another
  order; within 2 ulp at K = 1, where nothing is summed;
* gauss accumulation: the integer state is bit-exact (the fold is integer
  only and runs k = 0..K-1 in order on both sides); the output, one
  ``exp`` of it, within 2 ulp;
* attention over LNS KV words: ``atol=2e-5`` (tests/test_paged_attention.py);
* ``WireMatrix`` against the reference's CPU route (the oracle
  ``lns_qmatmul_ref``: decode both operands and dot, one more f32
  rounding per product than the kernel): ``rtol=2e-5, atol=1e-6``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.core import lns as jlns
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import formats
from repro_torch.core import takum
from repro_torch.core.bitops import carrier
from repro_torch.kernels import lns_matmul as klns
from repro_torch.kernels import ops, ref
from repro_torch.serve.engine import quantize_weights

# the module, not the op of the same name that repro.kernels re-exports
jklns = importlib.import_module("repro.kernels.lns_matmul")

WIDTHS = [8, 16]
BLOCKS = [(8, 8, 8), (8, 16, 8)]     # the JAX tests' blocks


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def _lns_words(x, n):
    """Seeded floats -> lns-takum words, the inputs both sides receive."""
    w = takum.float_to_lns_takum(torch.from_numpy(np.asarray(x, np.float32)),
                                 n)
    return carrier(w).numpy().view(np.uint8 if n == 8 else np.uint16)


def _operands(n, m, k, nn, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, nn)) / k ** 0.5).astype(np.float32)
    return _lns_words(x, n), _lns_words(w, n)


def _ref_kernel(xw, ww, n, accum, block):
    """The JAX kernel in interpret mode on operands padded to its blocks
    (zero words, as ops.py pads), unpadded."""
    bm, bn, bk = block
    m, k = xw.shape
    nn = ww.shape[1]
    xp = np.pad(xw, ((0, -m % bm), (0, -k % bk)))
    wp = np.pad(ww, ((0, -k % bk), (0, -nn % bn)))
    out = jklns.lns_matmul_kernel_call(
        jnp.asarray(xp), jnp.asarray(wp), jformats.get(f"lns-takum{n}"),
        accum=accum, bm=bm, bn=bn, bk=bk, interpret=True)
    return np.asarray(out)[:m, :nn]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# -- the kernel's plain version --------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("block", BLOCKS)
def test_lns_matmul_linear_matches_reference_kernel(n, block):
    xw, ww = _operands(n, 13, 29, 11, seed=10 + n)
    want = _ref_kernel(xw, ww, n, "linear", block)
    got = ref.lns_matmul_plain(_t(xw), _t(ww), f"lns-takum{n}").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n", WIDTHS)
def test_lns_matmul_mul_only_within_2_ulp(n):
    """K = 1: the exact ell sum and one exp on both sides."""
    rng = np.random.default_rng(20 + n)
    x = rng.normal(size=(16, 1)) * np.exp(rng.normal(size=(16, 1)) * 2)
    xw, ww = _lns_words(x, n), _lns_words(rng.normal(size=(1, 16)), n)
    want = _ref_kernel(xw, ww, n, "linear", (8, 8, 8))
    got = ref.lns_matmul_plain(_t(xw), _t(ww), f"lns-takum{n}").numpy()
    assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("block", BLOCKS)
def test_lns_matmul_gauss_state_bit_exact(n, block):
    xw, ww = _operands(n, 13, 29, 11, seed=30 + n)
    spec, jspec = formats.get(f"lns-takum{n}"), jformats.get(f"lns-takum{n}")
    out, ell, flags = ref.lns_matmul_plain(_t(xw), _t(ww), spec, "gauss",
                                           state=True)
    # the JAX kernel's fold over the unpadded K, from the empty sum
    wf = takum.frac_width(n)
    xe, xf = jspec.lns_parts(jnp.asarray(xw))
    we, wg = jspec.lns_parts(jnp.asarray(ww))
    shape = (xw.shape[0], ww.shape[1])
    state = (jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32),
             jnp.ones(shape, jnp.int32), jnp.zeros(shape, jnp.int32))
    s, je, z, nar = jklns._gauss_fold(xe, xf, we, wg, jlns.gauss_tables(wf),
                                      state, wf=wf)
    np.testing.assert_array_equal(ell.numpy(), np.asarray(je))
    np.testing.assert_array_equal(flags.numpy(),
                                  np.asarray(s | (z << 1) | (nar << 2)))
    want = _ref_kernel(xw, ww, n, "gauss", block)
    assert _ulps(out.numpy(), want).max() <= 2


@pytest.mark.parametrize("accum", ["linear", "gauss"])
def test_lns_matmul_nar_becomes_nan(accum):
    n = 16
    xw, ww = _operands(n, 9, 20, 10, seed=40)
    xw[3, 7] = 1 << (n - 1)
    ww[12, 4] = 1 << (n - 1)
    want = _ref_kernel(xw, ww, n, accum, (8, 8, 8))
    got = ref.lns_matmul_plain(_t(xw), _t(ww), f"lns-takum{n}", accum).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]).all() and np.isnan(got[:, 4]).all()
    assert np.isnan(got).sum() == got.shape[0] + got.shape[1] - 1
    fin = ~np.isnan(want)
    if accum == "linear":
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-6)
    else:
        assert _ulps(got[fin], want[fin]).max() <= 2


@pytest.mark.parametrize("n", WIDTHS)
def test_lns_qmatmul_oracle_matches_reference(n):
    """The oracle (x onto the LNS grid, decode both, dot) against the
    reference's: equal up to f32 sum order, and the kernel's plain version
    within half an ulp per product of it."""
    rng = np.random.default_rng(45 + n)
    x = rng.normal(size=(7, 40)).astype(np.float32)
    ww = _lns_words(rng.normal(size=(40, 9)) / 6.0, n)
    want = np.asarray(jref.lns_qmatmul_ref(jnp.asarray(x), jnp.asarray(ww), n))
    got = ref.lns_qmatmul_ref(_t(x), _t(ww), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    plain = ops.lns_matmul(_t(x), _t(ww), n)
    torch.testing.assert_close(plain, got, rtol=2e-5, atol=1e-6)


def test_lns_matmul_plain_chunks_do_not_change_the_sum_bound():
    """The chunked K loop (what runs on the card at full width) against a
    single chunk: the same products, f32 sums in another order."""
    xw, ww = _operands(8, 6, 300, 17, seed=41)
    one = ref.lns_matmul_plain(_t(xw), _t(ww), "lns-takum8")
    many = ref.lns_matmul_plain(_t(xw), _t(ww), "lns-takum8",
                                chunk_elems=6 * 17 * 7)
    torch.testing.assert_close(many, one, rtol=2e-5, atol=1e-6)


# -- wrapper, ops and routing --------------------------------------------------------


def test_lns_matmul_wrapper_cpu_path_is_the_plain_version():
    spec = formats.get("lns-takum8")
    xw, ww = _operands(8, 5, 40, 9, seed=42)
    before = klns.lns_matmul.launches
    got = klns.lns_matmul(_t(xw), _t(ww), spec)
    torch.testing.assert_close(got, ref.lns_matmul_plain(_t(xw), _t(ww), spec),
                               rtol=0, atol=0)
    out, ell, flags = klns.lns_matmul(_t(xw), _t(ww), spec, "gauss",
                                      state=True)
    assert ell.dtype == flags.dtype == torch.int32 and out.shape == (5, 9)
    assert klns.lns_matmul.launches == before          # no launch on CPU
    with pytest.raises(ValueError, match="gauss"):
        klns.lns_matmul(_t(xw), _t(ww), spec, state=True)


def test_lns_launch_plan_covers_every_k_tile():
    for m, k, n in [(4, 5120, 1280), (4, 5120, 17920), (4, 17920, 5120),
                    (16, 5120, 5120), (17, 5120, 1280), (256, 5120, 1280),
                    (256, 17920, 5120), (3, 100, 60)]:
        for bits in (8, 16):
            variant, split, per = klns.launch_plan(m, k, n, bits=bits)
            kt = -(-k // klns.KTILE[variant])
            assert variant == (1 if m > klns.STREAM_M else 0)
            assert split * per >= kt > (split - 1) * per
    # the streaming kernel's 560 column strips of 4x5120x17920 fill the
    # card without a K split (no second launch)
    assert klns.launch_plan(4, 5120, 17920, bits=8)[1] == 1
    assert klns.launch_plan(64, 5120, 5120, "gauss")[1] == 1   # never split


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("accum", ["linear", "gauss"])
def test_ops_lns_matmul_matches_reference(n, accum):
    rng = np.random.default_rng(50 + n)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    ww = _lns_words(rng.normal(size=(24, 20)) / 5.0, n)
    want = np.asarray(jops.lns_matmul(jnp.asarray(x), jnp.asarray(ww), n,
                                      accum, True, True, (8, 8, 8)))
    got = ops.lns_matmul(_t(x), _t(ww), n, accum).numpy()
    assert got.shape == (2, 5, 20)
    if accum == "linear":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    else:
        assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("n", WIDTHS)
def test_wire_matrix_routes_lns_words_through_lns_matmul(n):
    name = f"lns-takum{n}"
    rng = np.random.default_rng(60 + n)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32) / 8.0
    wm = ops.WireMatrix.encode(_t(w), fmt=name)
    jwm = jops.WireMatrix.encode(jnp.asarray(w), fmt=name)
    np.testing.assert_array_equal(carrier(wm.words).numpy(),
                                  np.asarray(jwm.words).view(
                                      np.int16 if n == 16 else np.uint8))
    got = _t(x) @ wm
    torch.testing.assert_close(got, ops.lns_matmul(_t(x), wm.words, name),
                               rtol=0, atol=0)
    # the reference's CPU route is its oracle (decode, then dot)
    want = np.asarray(jnp.asarray(x) @ jwm)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(wm.decode(), takum.lns_takum_to_float(
        wm.words, n))


def test_matmul_route_guards():
    """The reference's refusals, with its messages
    (tests/test_formats_registry.py)."""
    x = torch.ones((4, 8))
    w_lns = formats.get("lns-takum8").encode_tile(torch.ones((8, 4)))
    with pytest.raises(ValueError, match="lns_matmul"):
        ops.quant_matmul(x, w_lns, "lns-takum8")
    w_lin = formats.get("takum8").encode_tile(torch.ones((8, 4)))
    with pytest.raises(ValueError, match="quant_matmul"):
        ops.lns_matmul(x, w_lin, "takum8")
    # a bare width means the LNS takum of that width here
    torch.testing.assert_close(ops.lns_matmul(x, w_lns, 8),
                               ops.lns_matmul(x, w_lns, "lns-takum8"))


def test_quantize_weights_wires_lns_projections(capsys):
    from repro_torch.configs import get_arch
    from repro_torch.models import model
    cfg = get_arch("phi3-medium-14b").reduced
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    wp = quantize_weights(params, "lns-takum16", mode="wire")
    assert "quantize_weights[lns-takum16/wire]: 21 wired" in \
        capsys.readouterr().out
    layer = wp["layers"][0]
    for name in ("wq", "wk", "wv", "wo"):
        assert layer["attn"][name].spec.has_lns_parts
    for name in ("wg", "w1", "w2"):
        assert layer["mlp"][name].words.dtype == torch.uint16


# -- attention over LNS KV words -----------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("pos,window,block", [(17, 0, 16), (30, 12, 8)])
def test_attention_over_lns_kv_matches_reference_kernel(n, pos, window,
                                                        block):
    name = f"lns-takum{n}"
    rng = np.random.default_rng(70 + pos)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    kw = _lns_words(rng.normal(size=(2, 40, 2, 16)), n)
    vw = _lns_words(rng.normal(size=(2, 40, 2, 16)), n)
    start = np.array([0, 3], np.int32)
    kwargs = dict(pos=pos, start=start, window=window, block=block)
    want = np.asarray(jops.takum_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), n, name,
        use_kernel=True, interpret=True, **kwargs))
    got = ops.takum_attention(_t(q), _t(kw), _t(vw), n, name,
                              **kwargs).numpy()
    valid = (pos + np.arange(q.shape[1]))[None, :] >= start[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", WIDTHS)
def test_paged_attention_over_lns_kv_matches_reference_kernel(n):
    name = f"lns-takum{n}"
    rng = np.random.default_rng(80 + n)
    kw = _lns_words(rng.normal(size=(11, 16, 2, 16)), n)
    vw = _lns_words(rng.normal(size=(11, 16, 2, 16)), n)
    kw[5, 8, 0, 0] = 1 << (n - 1)        # a NaR word: seq 1, kv head 0
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 0, 0],
                      [0, 0, 0, 0]], np.int32)
    pos = np.array([63, 37, 20, 40], np.int32)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        name, pos=jnp.asarray(pos), use_kernel=True, interpret=True))
    got = ops.paged_attention(_t(q), _t(kw), _t(vw), _t(table), name,
                              pos=_t(pos)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 0, :2]).all() and np.isfinite(got[1, 0, 2:]).all()
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=2e-5)
