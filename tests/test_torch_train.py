"""The port's training path against the JAX package, on the CPU.

The reduced phi3-medium-14b config with the reference's ``model.init``
weights (PRNGKey 0) carried over with ``convert.params_from_numpy``;
gradients come back through ``convert.params_to_numpy`` and compare leaf
by leaf. Checked:

* AdamW, structured and flat, the LR schedule and global-norm clipping
  against the reference's functions on the same seeded trees (f32
  transcendentals of two libraries: ``ADAM_TOL``);
* ``loss_fn``'s value and gradients against ``jax.value_and_grad`` at
  T = 64 (the masked attention and the plain cross entropy) and at
  T = 2048 (the chunked attention and the chunked cross entropy);
* three steps of ``make_train_step`` against the reference's jitted
  ``make_train_step_gspmd`` from the same parameters on the same
  ``SyntheticLM`` batches: losses within ``STEP_RTOL``, parameters and
  moments within tests/test_substrate.py's tolerance for gradients summed
  in another order (``MICRO_RTOL``/``MICRO_ATOL``);
* microbatch 2 equals the full batch, remat equals no remat, and a run
  saved at step 3, restored and resumed equals the uninterrupted one
  (tests/test_substrate.py's semantics), also through a takum16
  checkpoint against the same rounding done in memory;
* the manual data-parallel step raises, naming the roadmap item.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
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
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_arch
from repro_torch.configs.base import RuntimeConfig
from repro_torch.convert import (adamw_state_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core import takum
from repro_torch.data import pipeline as dp
from repro_torch.models import model
from repro_torch.optim import adamw as opt
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves, tree_map

# two f32 implementations of the same elementwise update: pow/cos/sqrt
# of two libraries differ by an ulp or so
ADAM_TOL = 1e-6
# loss_fn: f32 sums of the same terms in other orders (forward through 3
# layers, then a mean over the tokens)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# tests/test_substrate.py::test_train_restart_resume_equivalence: the
# same program run twice
STEP_RTOL, STEP_ATOL = 1e-5, 1e-7
# tests/test_substrate.py::test_microbatching_matches_full_batch: the same
# gradients summed in another order. This also holds the port's steps to
# the reference's: AdamW divides m by sqrt(v), so a gradient element near
# 0 turns its summation-order error into a relative error of its update
# (measured: 1.7e-6 absolute, 9e-5 relative, on 1 of 32768 elements
# after three steps at lr 1e-3)
MICRO_RTOL, MICRO_ATOL = 2e-4, 2e-6


def _tree(seed, shapes=(("a", (3, 4)), ("b", (5,)), ("c", (2, 3, 2)))):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes}


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _close(got, want, rtol, atol=0.0):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.fixture(scope="module")
def ref_params():
    return jmodel.init(jax.random.PRNGKey(0),
                       jget_arch("phi3-medium-14b").reduced)


@pytest.fixture(scope="module")
def cfgs():
    return jget_arch("phi3-medium-14b").reduced, \
        get_arch("phi3-medium-14b").reduced


def _port(ref_params, cfg):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, "cpu")


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_schedule_and_clip_match_the_reference(schedule):
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20,
                           schedule=schedule)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20,
                            schedule=schedule)
    for s in (0, 1, 3, 4, 7, 19, 20, 30):
        np.testing.assert_allclose(
            float(opt.schedule_lr(ocfg, torch.tensor(s))),
            float(jopt.schedule_lr(jcfg, jnp.asarray(s))), rtol=ADAM_TOL)
    tree = _tree(1)
    for max_norm in (0.5, 1e3):
        got, gn = opt.clip_by_global_norm(
            tree_map(torch.from_numpy, tree), max_norm)
        want, wn = jopt.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=ADAM_TOL)
        _close(_np(got), want, ADAM_TOL)


def test_adamw_structured_and_flat_match_the_reference():
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    p = tree_map(torch.from_numpy, _tree(2))
    jp = _tree(2)
    st, jst = opt.init_state(p), jopt.init_state(jp)
    for i in range(3):
        g = _tree(10 + i)
        p, st = opt.apply_update(p, tree_map(torch.from_numpy, g), st, ocfg)
        jp, jst = jopt.apply_update(jp, g, jst, jcfg)
    assert int(st.step) == int(jst.step) == 3
    for got, want in ((p, jp), (st.m, jst.m), (st.v, jst.v)):
        _close(_np(got), want, ADAM_TOL, 1e-8)

    # flat: the same update on one vector, padded
    fp, spec = opt.flatten_like(p, pad_to=8)
    jfp, jspec = jopt.flatten_like(jp, pad_to=8)
    np.testing.assert_allclose(fp.numpy(), np.asarray(jfp), rtol=ADAM_TOL)
    fg, _ = opt.flatten_like(tree_map(torch.from_numpy, _tree(20)), pad_to=8)
    jfg, _ = jopt.flatten_like(_tree(20), pad_to=8)
    fm, fv = opt.flatten_like(st.m, 8)[0], opt.flatten_like(st.v, 8)[0]
    jfm, jfv = jopt.flatten_like(jst.m, 8)[0], jopt.flatten_like(jst.v, 8)[0]
    got = opt.flat_adamw_update(fp, fg, fm, fv, torch.tensor(4), ocfg)
    want = jopt.flat_adamw_update(jfp, jfg, jfm, jfv, jnp.asarray(4), jcfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ADAM_TOL,
                                   atol=1e-8)
    back = opt.unflatten_like(got[0], spec)
    _close(_np(back), jopt.unflatten_like(want[0], jspec), ADAM_TOL, 1e-8)


@pytest.mark.parametrize("t", [64, model.CHUNK_XENT_T])
def test_loss_and_grads_match_the_reference(ref_params, cfgs, t):
    jcfg, cfg = cfgs
    b = 2 if t < model.CHUNK_XENT_T else 1
    batch = jdp.SyntheticLM(cfg.vocab, t, b, seed=4).batch_at(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.loss_fn(p, x, jcfg), has_aux=True))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port(ref_params, cfg)
    live = tree_map(lambda x: x.requires_grad_(True), params)
    loss, metrics = model.loss_fn(
        live, {k: torch.from_numpy(v).long() for k, v in batch.items()}, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    grads = params_to_numpy(tree_map(lambda x: x.grad, live), cfg)
    assert (jax.tree_util.tree_structure(grads)
            == jax.tree_util.tree_structure(jg))
    for got, want in zip(jax.tree_util.tree_leaves(grads),
                         jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def _run_port(step, params, state, ds, s0, s1):
    losses = []
    for s in range(s0, s1):
        params, state, m = step(params, state, ds.batch_at(s))
        losses.append(float(m["loss"]))
    return params, state, losses


def test_train_steps_match_the_reference(ref_params, cfgs):
    jcfg, cfg = cfgs
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ds = dp.SyntheticLM(cfg.vocab, 64, 2, seed=3)
    jstep = jax.jit(jtrainer.make_train_step_gspmd(
        jcfg, jocfg, JRuntimeConfig(remat="block")))
    jp, jst = ref_params, jopt.init_state(ref_params)
    jlosses, jnorms = [], []
    for s in range(3):
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in ds.batch_at(s).items()})
        jlosses.append(float(jm["loss"]))
        jnorms.append(float(jm["grad_norm"]))
    step = trainer.make_train_step(cfg, ocfg, RuntimeConfig(remat="block"))
    params = _port(ref_params, cfg)
    state = opt.init_state(params)
    norms = []
    losses = []
    for s in range(3):
        params, state, m = step(params, state, ds.batch_at(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_RTOL)
    np.testing.assert_allclose(norms, jnorms, rtol=GRAD_TOL)
    assert int(state.step) == 3
    for got, want in ((params, jp), (state.m, jst.m), (state.v, jst.v)):
        got = params_to_numpy(got, cfg)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=MICRO_RTOL,
                                       atol=MICRO_ATOL)

    # the reference's moments carried over resume where the port's are
    carried = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst.m),
        jax.tree_util.tree_map(np.asarray, jst.v), int(jst.step), cfg, "cpu")
    for a, b in zip(tree_leaves(carried.m), tree_leaves(state.m)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
    assert int(carried.step) == 3


def test_microbatch_and_remat_equal_the_full_batch(ref_params, cfgs):
    _, cfg = cfgs
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="const",
                           clip_norm=1e9)
    params = _port(ref_params, cfg)
    batch = dp.SyntheticLM(cfg.vocab, 64, 4, seed=5).batch_at(0)
    out = {}
    for key, rt in (("full", RuntimeConfig(remat="none")),
                    ("micro", RuntimeConfig(remat="none", microbatch=2)),
                    ("remat", RuntimeConfig(remat="block"))):
        step = trainer.make_train_step(cfg, ocfg, rt)
        out[key] = step(params, opt.init_state(params), batch)
    for key in ("micro", "remat"):
        np.testing.assert_allclose(float(out[key][2]["loss"]),
                                   float(out["full"][2]["loss"]),
                                   rtol=MICRO_RTOL)
        for a, b in zip(tree_leaves(out[key][0]),
                        tree_leaves(out["full"][0])):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=MICRO_RTOL, atol=MICRO_ATOL)
    # remat recomputes the same ops: the same bits
    for a, b in zip(tree_leaves(out["remat"][0]), tree_leaves(out["full"][0])):
        assert torch.equal(a, b)


def test_restart_resume_equivalence(ref_params, cfgs, tmp_path):
    _, cfg = cfgs
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="const")
    step = trainer.make_train_step(cfg, ocfg, RuntimeConfig(remat="none"))
    ds = dp.SyntheticLM(cfg.vocab, 64, 2, seed=3)
    params = _port(ref_params, cfg)
    state = opt.init_state(params)
    pA, _, _ = _run_port(step, params, state, ds, 0, 6)
    pB, stB, _ = _run_port(step, params, state, ds, 0, 3)
    for codec in ("none", "takum16"):
        d = str(tmp_path / codec)
        tree = {"params": pB, "m": stB.m, "v": stB.v}
        ckpt.save(3, tree, d, codec=codec)
        got, s = ckpt.restore(d, tree, device="cpu")
        assert s == 3
        stC = opt.AdamWState(got["m"], got["v"], torch.tensor(s,
                                                              dtype=torch.int32))
        pC, _, _ = _run_port(step, got["params"], stC, ds, 3, 6)
        if codec == "none":
            want = pA
        else:
            # the same takum16 rounding done in memory, then resumed
            rt = tree_map(lambda x: takum.takum_to_float(
                takum.float_to_takum(x, 16), 16), tree)
            want, _, _ = _run_port(step, rt["params"], opt.AdamWState(
                rt["m"], rt["v"], torch.tensor(3, dtype=torch.int32)),
                ds, 3, 6)
        for a, b in zip(tree_leaves(want), tree_leaves(pC)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)


def test_manual_dp_raises_naming_the_roadmap_item(cfgs):
    _, cfg = cfgs
    with pytest.raises(NotImplementedError, match="section 1 item 6"):
        trainer.make_train_step_manual(cfg, opt.AdamWConfig(),
                                       RuntimeConfig())
    with pytest.raises(NotImplementedError, match="section 1 item 6"):
        trainer.init_flat_state({}, dp=2)
