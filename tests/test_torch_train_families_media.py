"""Training of the encdec and vlm families against the JAX package, on
the CPU (tests/test_torch_train_families.py has the helpers and says what
is held): seamless-m4t-large-v2 (the encoder and the decoder, each under
remat, with seeded audio frames) and llama-3.2-vision-11b (the cross
blocks with seeded patch embeddings), at T = 64, B = 2 and at T =
``model.CHUNK_XENT_T``, B = 1; remat against no remat; three train
steps of seamless against the reference's."""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from repro_torch.models import model
from test_torch_train_families import (check_loss_and_grads,
                                       check_remat_equals_no_remat,
                                       check_train_steps)

ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-11b")
# seamless's frames at T = 2048 (vlm's media are its n_media_tokens)
FRAMES_LONG = 64


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch, 64, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch, model.CHUNK_XENT_T, 1, frames=FRAMES_LONG)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    check_remat_equals_no_remat(arch)


def test_train_steps_match_the_reference():
    """Media in every batch, two stacks: three steps of seamless."""
    check_train_steps("seamless-m4t-large-v2")
