"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8.

The reference's approximation of the published model
(hf:moonshotai/Kimi-K2-Instruct config.json, not checked from this
repository), copied as the reference has it. Where it departs from the
published model: grouped-query attention with 8 KV heads of 112 in
place of multi-head latent attention (64 heads, latent K/V); no shared
expert; every layer moe (the published first layer is dense); routing
drops at capacity factor 1.0 (the published model drops none). Widths,
depth, vocab and the expert counts are the published ones."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7_168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2_048,            # per-expert hidden
    vocab=163_840,
    head_dim=112,
    activation="swiglu",
    n_experts=384,
    top_k=8,
    capacity_factor=1.0,   # at 384e the dispatch buffer dominates; cf=1
)

# reduced: capacity_factor = E/k = drop-free (see granite config note)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, head_dim=16, n_experts=16, top_k=4, capacity_factor=4.0,
    dtype="f32")


@register_arch("kimi-k2-1t-a32b")
def spec() -> ArchSpec:
    return ArchSpec(
        CONFIG, REDUCED,
        "hf:moonshotai/Kimi-K2-Instruct config.json (unverified); GQA hd "
        "112 for MLA, no shared expert, no dense first layer")
