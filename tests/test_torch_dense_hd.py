"""Head dims 192 and 256, and the dense relu2/gelu configs on their float
cache, against the JAX package, on the CPU.

* Head dims 192 (nemotron-4-340b's) and 256 (recurrentgemma-2b's): the
  plain contiguous attention with a sliding window and the plain paged
  attention against the reference's Pallas kernels in interpret mode, at
  the tolerance of tests/test_torch_paged_split.py (``atol=2e-5``), the
  paged one with the CUDA kernel's partition plan; an f32 cache refused
  by name at these head dims.
* The reduced minitron-4b, starcoder2-15b and nemotron-4-340b with
  takum8 wire weights on the config's own float cache (f32 in the reduced
  configs) through both engines' schedulers: greedy tokens identical,
  prefix tree cold and warm, and a right-padded prefill chunk's logits
  within 1e-4 (tests/test_torch_dense_act.py's check).
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import takum
from repro_torch.core.bitops import carrier
from repro_torch.kernels import ops, ref
from repro_torch.kernels import takum_attention as kattn
from test_torch_dense_act import ARCHS, check_scheduler

ATOL = 2e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_on_the_float_cache(arch):
    check_scheduler(arch, "none")


def _words(rng, shape, n):
    """takum words of normal values, by the port's codec (bit for bit the
    reference's: tests/test_torch_codec.py), without a JAX compile per
    shape."""
    x = rng.normal(size=shape).astype(np.float32)
    w = takum.float_to_takum(torch.from_numpy(x), n)
    return carrier(w).numpy().view(np.uint8 if n == 8 else np.uint16)


# (hd, word bits, pos, window): a prefill chunk of 5 rows over a 40-key
# cache under a sliding window, as recurrentgemma's local attention
CONTIGUOUS = [(192, 8, 21, 12), (256, 16, 35, 16)]


@pytest.mark.parametrize("hd,n,pos,window", CONTIGUOUS)
def test_contiguous_attention_matches_reference_kernel(hd, n, pos, window):
    rng = np.random.default_rng(hd + n)
    b, tq, hkv, g, tmax = 2, 5, 1, 3, 40
    q = rng.normal(size=(b, tq, hkv * g, hd)).astype(np.float32)
    kw = _words(rng, (b, tmax, hkv, hd), n)
    vw = _words(rng, (b, tmax, hkv, hd), n)
    start = np.array([0, 3], np.int32)
    kwargs = dict(pos=pos, start=start, window=window, block=16)
    want = np.asarray(jops.takum_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), n, f"takum{n}",
        use_kernel=True, interpret=True, **kwargs))
    got = ops.takum_attention(torch.from_numpy(q), torch.from_numpy(kw),
                              torch.from_numpy(vw), n, f"takum{n}",
                              **kwargs).numpy()
    valid = (pos + np.arange(tq))[None, :] >= start[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=ATOL)


# (hd, word bits, window): a decode step of 3 sequences (one of them
# idle at a stale pos past its table) over 16-position pages
PAGED = [(192, 8, 0), (192, 16, 0), (256, 8, 20), (256, 16, 0)]


@pytest.mark.parametrize("hd,n,window", PAGED)
def test_paged_attention_matches_reference_kernel(hd, n, window):
    rng = np.random.default_rng(hd * n + window)
    npool, ps, hkv, g, npg, b = 8, 16, 2, 2, 3, 3
    kw = _words(rng, (npool, ps, hkv, hd), n)
    vw = _words(rng, (npool, ps, hkv, hd), n)
    table = np.array([[3, 5, 1], [2, 7, 0], [0, 0, 0]], np.int32)
    pos = np.array([40, 20, 900], np.int32)
    start = np.array([0, 4, 0], np.int32)
    q = rng.normal(size=(b, 1, hkv * g, hd)).astype(np.float32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        f"takum{n}", pos=jnp.asarray(pos), start=jnp.asarray(start),
        window=window, use_kernel=True, interpret=True))
    pk = kattn.paged_partition_keys(hd, n)
    assert pk == 32       # 8 partitions a 256-position page
    got = ref.paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kw), torch.from_numpy(vw),
        torch.from_numpy(table), f"takum{n}", pos=torch.from_numpy(pos),
        start=torch.from_numpy(start), window=window, partitions=pk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_f32_cache_is_refused_past_hd_128():
    """A key of hd 192 or 256 f32 words is more than a warp's lanes in the
    paged kernel: the partition plan refuses it by name."""
    for hd in (192, 256):
        with pytest.raises(ValueError, match=f"hd {hd}"):
            kattn.paged_partition_keys(hd, 32)
        assert kattn.paged_partition_keys(hd, 16) == 32
