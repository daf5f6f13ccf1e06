"""seamless-m4t-large-v2 [audio]: encoder-decoder, multimodal.
[arXiv:2308.11596; hf]

The reference's configuration, copied as the reference has it: 24
encoder and 24 decoder layers (the w2v-BERT-24 and NLLB-24 stacks), d
1024, multi-head attention of 16 heads of 64, a GELU MLP of 8192, and a
256206-token vocabulary. The audio frontend is a stub: the encoder takes
precomputed frame embeddings [B, T_a, 1024]. The decoder's
cross-attention holds encoder state outside the paged pool's layout, so
the family is served through lockstep generation."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder layers
    n_enc_layers=24,        # encoder layers
    d_model=1_024,
    n_heads=16,
    n_kv_heads=16,          # MHA
    d_ff=8_192,
    vocab=256_206,
    head_dim=64,
    activation="gelu",
    frontend="audio",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, head_dim=16, dtype="f32")


@register_arch("seamless-m4t-large-v2")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2308.11596; hf")
