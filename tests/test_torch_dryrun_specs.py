"""The dry run's inputs against the JAX package's: ``SHAPES``,
``shape_applicable``, the parameter counts, ``input_specs`` and
``dummy_batch`` (``repro_torch/configs/base.py``,
``repro_torch/launch/specs.py``).

For all ten archs, full and reduced: the counts equal the reference's;
``input_specs`` gives the reference's shapes and dtypes (token ids int64
where the reference's are int32: the port's embeddings take int64) as
tensors without data (``meta``); ``dummy_batch`` draws the reference's
numbers in its order, so its arrays equal the reference's bit for bit.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_arch, list_archs, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs

ARCHS = list_archs()


def test_ten_archs_and_the_reference_s_shapes():
    assert len(ARCHS) == 10
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_and_counts(arch):
    for which in ("config", "reduced"):
        cfg = getattr(get_arch(arch), which)
        jcfg = getattr(jget_arch(arch), which)
        assert cfg.param_count() == jcfg.param_count(), which
        assert cfg.active_param_count() == jcfg.active_param_count(), which
        for name in SHAPES:
            assert shape_applicable(cfg, SHAPES[name]) == \
                jshape_applicable(jcfg, JSHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes_and_dtypes(arch):
    cfg, jcfg = get_arch(arch).config, jget_arch(arch).config
    for name in SHAPES:
        got = specs.input_specs(cfg, SHAPES[name], device="meta")
        want = jspecs.input_specs(jcfg, JSHAPES[name])
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.is_meta
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            if k in ("tokens", "labels"):
                assert str(want[k].dtype) == "int32"
                assert t.dtype == torch.int64
            else:
                assert str(want[k].dtype) == "float32"
                assert t.dtype == torch.float32
        assert specs.media_shape(cfg, SHAPES[name]) == \
            jspecs.media_shape(jcfg, JSHAPES[name])


def test_input_specs_default_to_the_card():
    cfg = get_arch("phi3-medium-14b").config
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            specs.input_specs(cfg, SHAPES["decode_32k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_dummy_batch_bit_for_bit(arch):
    cfg, jcfg = get_arch(arch).config, jget_arch(arch).config
    for name, shape in SHAPES.items():
        # each shape's kind at a small batch (full-width media are GBs)
        b, t = 2, min(shape.seq_len, 40)
        got = specs.dummy_batch(cfg, b, t, seed=3, kind=shape.kind,
                                device="cpu")
        want = jspecs.dummy_batch(jcfg, b, t, seed=3, kind=shape.kind)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            w = np.asarray(want[k])
            assert tuple(v.shape) == w.shape
            if k == "media":
                assert v.dtype == torch.float32
                assert np.array_equal(v.numpy().view(np.uint32),
                                      w.view(np.uint32))
            else:
                assert v.dtype == torch.int64
                assert np.array_equal(v.numpy(), w.astype(np.int64))


def test_long_500k_only_for_sub_quadratic_families():
    long = SHAPES["long_500k"]
    runs = sorted(a for a in ARCHS
                  if shape_applicable(get_arch(a).config, long)[0])
    assert runs == ["recurrentgemma-2b", "rwkv6-1.6b"]
    ok, reason = shape_applicable(get_arch("phi3-medium-14b").config, long)
    assert not ok and "pure full-attention" in reason
    assert isinstance(long, ShapeConfig)
