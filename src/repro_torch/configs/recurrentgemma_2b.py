"""recurrentgemma-2b [hybrid]: RG-LRU blocks and local attention, two
recurrent blocks to one attention block. [arXiv:2402.19427; hf]

The reference's configuration, copied as the reference has it: 26
layers in the pattern (rec, rec, attn) (8 super-blocks and a (rec, rec)
remainder), d 2560, multi-query attention of 10 heads of 256 over one KV
head with a 2048-token window, an RG-LRU of width 2560, a GELU MLP of
7680, and a 256000-token vocabulary whose embedding is tied to the
unembedding. The recurrent blocks carry O(1) state, so the family is
served through lockstep generation, not the paged scheduler."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid_rglru",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,          # MQA
    d_ff=7680,
    vocab=256_000,
    head_dim=256,
    activation="gelu",
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    window=2048,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab=512, head_dim=32, lru_width=64, window=32, dtype="f32")


@register_arch("recurrentgemma-2b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2402.19427; hf")
