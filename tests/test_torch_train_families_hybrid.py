"""Training of the hybrid RG-LRU family against the JAX package, on the
CPU (tests/test_torch_train_families.py has the helpers and says what is
held): recurrentgemma-2b, whose RG-LRU, local window and tied embeddings
run under autograd, at T = 64, B = 2 and at T = ``model.CHUNK_XENT_T``,
B = 1 (the chunked cross entropy over ``embed_tokens.T``, the local
window inside the chunked attention); remat against no remat."""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from repro_torch.models import model
from test_torch_train_families import (check_loss_and_grads,
                                       check_remat_equals_no_remat, cfgs,
                                       ref_params)

ARCH = "recurrentgemma-2b"


@pytest.mark.parametrize("t,b", [(64, 2), (model.CHUNK_XENT_T, 1)],
                         ids=["t64", "chunked"])
def test_loss_and_grads_match_the_reference(t, b):
    # tied: the reference has no unembed leaf, so the gradient of the
    # unembedding reaches embed_tokens in both
    assert cfgs(ARCH)[1].tie_embeddings
    assert "unembed" not in ref_params(ARCH)
    check_loss_and_grads(ARCH, t, b)


def test_remat_equals_no_remat():
    check_remat_equals_no_remat(ARCH)
