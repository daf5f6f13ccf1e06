"""posit8 weights on the hybrid RG-LRU family (recurrentgemma-2b: the
RG-LRU's fake-quantised leaves, its local window), against the JAX
package, on the CPU: tests/test_torch_family_formats.py says what is
checked and holds the helpers; lns-takum8 weights are in
tests/test_torch_family_formats_rglru.py (a file a format: the JAX
engine compiles its generate and prefill for each)."""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from test_torch_family_formats import (check_audit_and_words,
                                       check_generate, check_prefill_logits)

ARCH = "recurrentgemma-2b"
FMT = "posit8"


@pytest.mark.parametrize("mode", ["wire", "fake"])
def test_quantize_weights_audit_and_words(mode, capsys):
    check_audit_and_words(ARCH, FMT, mode, capsys)


def test_generate_tokens():
    check_generate(ARCH, FMT)


def test_prefill_logits():
    check_prefill_logits(ARCH, FMT)
