"""lns-takum8 weights on the encdec family (seamless-m4t-large-v2, with
seeded audio frames and its float cache), against the JAX package, on
the CPU: tests/test_torch_family_formats.py says what is checked and
holds the helpers; posit8 weights are in
tests/test_torch_family_formats_encdec_posit.py (a file a format: the
JAX engine compiles its generate and prefill for each)."""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from test_torch_family_formats import (check_audit_and_words,
                                       check_generate, check_prefill_logits)

ARCH = "seamless-m4t-large-v2"
FMT = "lns-takum8"


@pytest.mark.parametrize("mode", ["wire", "fake"])
def test_quantize_weights_audit_and_words(mode, capsys):
    check_audit_and_words(ARCH, FMT, mode, capsys)


def test_generate_tokens():
    check_generate(ARCH, FMT)


def test_prefill_logits():
    check_prefill_logits(ARCH, FMT)
