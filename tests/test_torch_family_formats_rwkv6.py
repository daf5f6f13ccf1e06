"""lns-takum8 weights on the rwkv6 family (rwkv6-1.6b: its fake-quantised
decay LoRA, ``ww``, mixes and bonus; prompts left-padded to its 64-token
chunk), against the JAX package, on the CPU:
tests/test_torch_family_formats.py says what is checked and holds the
helpers; posit8 weights are in
tests/test_torch_family_formats_rwkv6_posit.py (a file a format: the JAX
engine compiles its generate and prefill for each)."""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from test_torch_family_formats import (check_audit_and_words,
                                       check_generate, check_prefill_logits)

ARCH = "rwkv6-1.6b"
FMT = "lns-takum8"


@pytest.mark.parametrize("mode", ["wire", "fake"])
def test_quantize_weights_audit_and_words(mode, capsys):
    check_audit_and_words(ARCH, FMT, mode, capsys)


def test_generate_tokens():
    check_generate(ARCH, FMT)


def test_prefill_logits():
    check_prefill_logits(ARCH, FMT)
