"""Training of the served families against the JAX package, on the CPU:
the dense relu2 and gelu configs and the rwkv6 family here
(tests/test_torch_train_families_media.py holds the hybrid RG-LRU,
encdec and vlm families, tests/test_torch_train_families_moe.py the moe
family and the train steps; tests/test_torch_train.py the dense SwiGLU
family). The helpers below serve all three files.

Each reduced config with the reference's ``model.init`` weights
(PRNGKey 0), carried over with ``convert.params_from_numpy``; a
``SyntheticLM(seed=4)`` batch (with seeded numpy media where the family
reads them). Checked:

* ``loss_fn(remat=True)`` under ``torch.autograd`` against the
  reference's ``jax.jit(jax.value_and_grad(loss_fn))``: the loss within
  ``LOSS_RTOL``, moe ``aux`` within ``AUX_RTOL``, the gradient trees equal
  in structure (through ``convert.params_to_numpy``) and every leaf within
  ``GRAD_TOL``, at T = 64, B = 2 and, for the chunked or tied paths, at
  T = ``model.CHUNK_XENT_T``, B = 1 (the chunked cross entropy; here
  through rwkv6's 32 WKV chunks);
* remat gives the gradients of no remat, bit for bit (the same ops
  recomputed).

rwkv6's gradients are held at ``RWKV6_GRAD_TOL``: see its comment.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import RuntimeConfig as JRuntimeConfig
from repro.data import pipeline as jdp
from repro.models import model as jmodel
from repro.optim import adamw as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.configs.base import RuntimeConfig
from repro_torch.convert import (adamw_state_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.models import model
from repro_torch.optim import adamw as opt
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves, tree_map
from test_torch_train import (GRAD_TOL, LOSS_RTOL, MICRO_ATOL, MICRO_RTOL,
                              STEP_RTOL)

# tests/test_torch_moe.py: the load-balance term's f32 means summed in
# another order
AUX_RTOL = 1e-6
# rwkv6's chunked WKV takes its decay exp(cl_{t-1} - cl_s) as the
# difference of two cumulative sums of log w, which reach |cl| = 286 within
# a 64-token chunk of the reduced config (f32 ulp 2^-15 there): the
# difference carries ~3e-5 absolute error, a relative error of the decay
# near the diagonal. Both packages compute the same formula; against a
# float64 evaluation of the port each is off by ~4e-5 relative L2 on the
# first layer's leaves and embed_tokens (the reference 3.9e-5, the port
# 4.3e-5; with cl and its differences in float64 the port's error falls to
# 1.1e-5), and the two disagree by up to 2.9e-4 on an embed_tokens element
# of magnitude 2.5 (1.58x GRAD_TOL's 1e-4 + 1e-4 |w|, 11 of 32768 elements
# over it) at T = 64, and 1.2x at T = 2048 (ROADMAP.md section 3)
RWKV6_GRAD_TOL = 4e-4
SEED = 4
# AdamW after three steps (ROADMAP.md section 3, "AdamW elementwise"): a
# gradient element within a few eps of 0 turns its summation-order error
# into an O(1) relative error of m / (sqrt(v) + eps), so single elements
# of the two packages' parameters and moments part by more than the
# reordered-sum tolerance MICRO_RTOL/MICRO_ATOL that holds every other
# element. Measured on granite-moe and seamless (lr 1e-3): at most 2 of
# 98304 and 1 of 8192 elements a leaf (1.2e-4 of a leaf), by up to
# 4.6e-5, while each leaf agrees to 8.0e-6 in relative L2. Such elements
# may be at most AMPLIFIED_SHARE of a leaf and move by no more than the
# steps can (2 lr a step); each leaf is held to STEP_REL_L2
AMPLIFIED_SHARE = 1e-3
STEP_REL_L2 = 2e-5


def cfgs(arch):
    return jget_arch(arch).reduced, get_arch(arch).reduced


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  cfgs(arch)[0])


def port_params(arch):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                    ref_params(arch)),
                             cfgs(arch)[1], "cpu")


def media(cfg, b, frames, seed=0):
    """Seeded numpy media of the config's frontend: encdec's audio frames
    [B, frames, d], vlm's patch embeddings [B, n_media_tokens, d_media]
    (tests/test_torch_encdec.py ``_audio``, tests/test_torch_vlm.py
    ``_media``); None for a text-only family."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return rng.normal(size=(b, frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        return rng.normal(size=(b, cfg.n_media_tokens,
                                cfg.d_media or cfg.d_model)).astype(
            np.float32)
    return None


def batch_of(arch, t, b, frames=16, seed=SEED):
    """``SyntheticLM(seed)``'s first batch of [b, t] tokens, with the
    family's media, as numpy arrays."""
    cfg = cfgs(arch)[1]
    batch = jdp.SyntheticLM(cfg.vocab, t, b, seed=seed).batch_at(0)
    m = media(cfg, b, frames)
    if m is not None:
        batch["media"] = m
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(v) for k, v in batch.items()}


def ref_value_and_grad(arch, batch):
    jcfg = cfgs(arch)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.loss_fn(p, x, jcfg, remat=True),
        has_aux=True))(ref_params(arch),
                       {k: jnp.asarray(v) for k, v in batch.items()})


def port_value_and_grad(arch, params, batch, remat=True):
    """(loss, metrics, gradient tree) of the port's ``loss_fn``."""
    cfg = cfgs(arch)[1]
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(live, torch_batch(batch), cfg,
                                  remat=remat)
    loss.backward()
    return loss.detach(), metrics, tree_map(lambda x: x.grad, live)


def grad_tol(arch):
    return RWKV6_GRAD_TOL if cfgs(arch)[1].family == "rwkv6" else GRAD_TOL


def check_loss_and_grads(arch, t, b, frames=16):
    """The port's loss, aux and gradients against ``jax.value_and_grad``
    of the reference's on one batch; returns the port's gradients."""
    cfg = cfgs(arch)[1]
    batch = batch_of(arch, t, b, frames)
    (jl, jm), jg = ref_value_and_grad(arch, batch)
    loss, metrics, grads = port_value_and_grad(arch, port_params(arch),
                                               batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    if cfg.family == "moe":
        assert float(jm["aux"]) > 0.0
        np.testing.assert_allclose(float(metrics["aux"].detach()),
                                   float(jm["aux"]), rtol=AUX_RTOL)
    else:
        assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    got = params_to_numpy(grads, cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jg))
    tol = grad_tol(arch)
    for (path, a), w in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_leaves(jg)):
        assert np.isfinite(a).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))
    return grads


def check_remat_equals_no_remat(arch, t=64, b=2, frames=16):
    params = port_params(arch)
    batch = batch_of(arch, t, b, frames)
    l1, _, g1 = port_value_and_grad(arch, params, batch, remat=True)
    l0, _, g0 = port_value_and_grad(arch, params, batch, remat=False)
    assert torch.equal(l1, l0)
    for a, w in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, w)


def assert_adamw_close(got, want, reach):
    """A leaf after AdamW steps of the two packages: every element within
    ``MICRO_RTOL``/``MICRO_ATOL`` except at most ``AMPLIFIED_SHARE`` of
    them, which stay within ``reach`` (what the steps can move an element
    by), and the leaf within ``STEP_REL_L2`` in relative L2."""
    d = np.abs(got - want)
    out = d > MICRO_ATOL + MICRO_RTOL * np.abs(want)
    assert out.sum() <= AMPLIFIED_SHARE * out.size, (
        f"{int(out.sum())} of {out.size} elements beyond MICRO_RTOL, "
        f"largest {d.max()}")
    assert d.max() <= reach, d.max()
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= STEP_REL_L2, rel


def check_train_steps(arch, steps=3):
    """``steps`` steps of ``trainer.make_train_step`` against the
    reference's jitted ``make_train_step_gspmd`` from the same parameters
    on the same batches (``SyntheticLM(seed=3)``, the family's media
    seeded a step), as tests/test_torch_train.py's
    ``test_train_steps_match_the_reference``: losses within
    ``STEP_RTOL``, grad norms within ``GRAD_TOL``, parameters and both
    moments within ``MICRO_RTOL``/``MICRO_ATOL``; then the reference's
    moments carried over by ``convert.adamw_state_from_numpy`` equal the
    port's. Elementwise with ``assert_adamw_close``: see
    ``AMPLIFIED_SHARE``."""
    jcfg, cfg = cfgs(arch)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ds = jdp.SyntheticLM(cfg.vocab, 64, 2, seed=3)
    batches = []
    for s in range(steps):
        b = ds.batch_at(s)
        m = media(cfg, 2, 16, seed=s)
        if m is not None:
            b["media"] = m
        batches.append(b)
    jstep = jax.jit(jtrainer.make_train_step_gspmd(
        jcfg, jocfg, JRuntimeConfig(remat="block")))
    jp, jst = ref_params(arch), jopt.init_state(ref_params(arch))
    jlosses, jnorms = [], []
    for b in batches:
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        jlosses.append(float(jm["loss"]))
        jnorms.append(float(jm["grad_norm"]))
    step = trainer.make_train_step(cfg, ocfg, RuntimeConfig(remat="block"))
    params = port_params(arch)
    state = opt.init_state(params)
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_RTOL)
    np.testing.assert_allclose(norms, jnorms, rtol=GRAD_TOL)
    assert int(state.step) == steps
    for got, want in ((params, jp), (state.m, jst.m), (state.v, jst.v)):
        got = params_to_numpy(got, cfg)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want))
        for a, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert_adamw_close(a, np.asarray(w), reach=2 * steps * ocfg.lr)
    carried = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst.m),
        jax.tree_util.tree_map(np.asarray, jst.v), int(jst.step), cfg, "cpu")
    assert int(carried.step) == steps
    for a, w in zip(tree_leaves(carried.m) + tree_leaves(carried.v),
                    tree_leaves(state.m) + tree_leaves(state.v)):
        assert a.shape == w.shape
        assert_adamw_close(a.numpy(), w.numpy(), reach=2 * steps * ocfg.lr)


ARCHS = ("minitron-4b", "nemotron-4-340b", "starcoder2-15b", "rwkv6-1.6b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch, 64, 2)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b"])
def test_chunked_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch, model.CHUNK_XENT_T, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    check_remat_equals_no_remat(arch)


def test_rwkv6_gap_is_the_reference_formula_in_f32():
    """The rwkv6 gradient gap is the f32 cancellation in the WKV decay's
    exponent, not another formula: on one chunk, the port's gradients of
    r, k, v and log w agree with the reference's to GRAD_TOL once both
    evaluate in float64 (the formula is the same), and the f32 decay
    exponent of the reduced config's first chunk differs from its float64
    value by more than 1e-6 (the cancellation)."""
    from repro.models import rwkv6 as jrk
    from repro_torch.models import rwkv6
    rng = np.random.default_rng(7)
    b, L, h, d = 1, 64, 2, 8
    r, k, v = (rng.normal(size=(b, L, h, d)) for _ in range(3))
    logw = -np.exp(rng.uniform(-1.0, 1.5, size=(b, L, h, d)))
    u = rng.normal(size=(h, d)) * 0.3
    S = np.zeros((b, h, d, d))
    gout = rng.normal(size=(b, L, h, d))

    with jax.enable_x64(True):
        def jf(r, k, v, logw):
            _, o = jrk._wkv_chunk(jnp.asarray(S), (r, k, v, logw),
                                  jnp.asarray(u))
            return jnp.sum(o * gout)
        jgrads = jax.grad(jf, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (r, k, v, logw)))
        jgrads = [np.asarray(g) for g in jgrads]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (r, k, v, logw)]
    _, o = rwkv6._wkv_chunk(torch.from_numpy(S), *ins, torch.from_numpy(u))
    (o * torch.from_numpy(gout)).sum().backward()
    for t, want in zip(ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    cl = np.cumsum(logw, axis=1)
    cl32 = np.cumsum(logw.astype(np.float32), axis=1, dtype=np.float32)
    assert np.abs(cl).max() > 64
    expo = cl[:, 1:] - cl[:, :-1]
    expo32 = cl32[:, 1:] - cl32[:, :-1]
    assert np.abs(expo32 - expo).max() > 1e-6
