"""The port serving with lns-takum16 weights against the JAX package, on
the CPU: the checks of tests/test_torch_lns_serve.py (tokens, layer-0
K/V words, step logits; tolerances and their reasons there), with
lns-takum8, lns-takum16 and takum8 KV caches."""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from test_torch_lns_serve import KVS, check_combo, wired_for


@pytest.fixture(scope="module")
def wired16():
    return wired_for("lns-takum16")


@pytest.mark.parametrize("kv", KVS)
def test_lns16_weights_generate_tokens_and_step_logits(wired16, kv):
    check_combo(*wired16, "lns-takum16", kv)
