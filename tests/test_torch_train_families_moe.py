"""Training of the moe family against the JAX package, on the CPU
(tests/test_torch_train_families.py has the helpers and says what is
held): granite-moe-3b-a800m and kimi-k2-1t-a32b, whose router and
load-balance term ``aux`` enter the loss, at T = 64, B = 2; remat
against no remat; microbatching; three train steps of granite-moe.

Microbatch 2 does not equal the full batch for a moe config, in either
package: ``aux`` is a product of batch means (the share of tokens an
expert takes times its mean router probability), so its mean over two
half batches is another number than its value over the whole batch, and
its gradient reaches every leaf through the router (on granite-moe's
reduced config, B = 4: 0.8-8% relative L2 a leaf). With ``aux``'s weight
set to 0 the two agree to 2.7e-7. So the port's microbatched gradients
are held against the reference's microbatched ``_grads_fn`` (``aux``
drops out of the metrics in both), and against the full batch with
``AUX_WEIGHT`` = 0.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import RuntimeConfig as JRuntimeConfig
from repro.train import trainer as jtrainer
from repro_torch.configs.base import RuntimeConfig
from repro_torch.convert import params_to_numpy
from repro_torch.models import model
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves
from test_torch_train import GRAD_TOL, LOSS_RTOL, MICRO_ATOL, MICRO_RTOL
from test_torch_train_families import (batch_of, cfgs, check_loss_and_grads,
                                       check_remat_equals_no_remat,
                                       check_train_steps, port_params,
                                       ref_params)

ARCHS = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b")
MICRO = "granite-moe-3b-a800m"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch, 64, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    check_remat_equals_no_remat(arch)


def test_microbatch_matches_the_reference():
    jcfg, cfg = cfgs(MICRO)
    batch = batch_of(MICRO, 64, 4, seed=5)
    jl, jm, jg = jax.jit(jtrainer._grads_fn(
        jcfg, JRuntimeConfig(remat="none", microbatch=2)))(
            ref_params(MICRO), {k: jnp.asarray(v) for k, v in batch.items()})
    params = port_params(MICRO)
    tb = trainer._device_batch(batch, "cpu")
    loss, met, grads = trainer._grads_fn(
        cfg, RuntimeConfig(remat="none", microbatch=2))(params, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert float(met["aux"]) == float(jm["aux"]) == 0.0
    assert float(met["xent"]) == float(met["loss"])
    got = params_to_numpy(grads, cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jg))
    for a, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_microbatch_equals_the_full_batch_without_aux(monkeypatch):
    _, cfg = cfgs(MICRO)
    params = port_params(MICRO)
    tb = trainer._device_batch(batch_of(MICRO, 64, 4, seed=5), "cpu")
    monkeypatch.setattr(model, "AUX_WEIGHT", 0.0)
    full = trainer._grads_fn(cfg, RuntimeConfig(remat="none"))(params, tb)
    micro = trainer._grads_fn(cfg, RuntimeConfig(remat="none",
                                                 microbatch=2))(params, tb)
    assert float(full[1]["aux"]) > 0.0 and float(micro[1]["aux"]) == 0.0
    np.testing.assert_allclose(float(micro[0]), float(full[0]),
                               rtol=MICRO_RTOL)
    for a, w in zip(tree_leaves(micro[2]), tree_leaves(full[2])):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=MICRO_RTOL,
                                   atol=MICRO_ATOL)


def test_train_steps_match_the_reference():
    check_train_steps(MICRO)
