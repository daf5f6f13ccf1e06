"""granite-moe-3b-a800m [moe]: top-8 MoE.

The structured spec field says 40 experts; the inline provenance comment
says 32. The structured field wins.

The reference's configuration, copied as the reference has it; its
widths, depth, heads, vocab and expert counts are those of
hf:ibm-granite/granite-3.0-3b-a800m-base (config.json, not checked from
this repository; the reference cites the 1b-a400m model). Where it
departs from the published model: the published embedding, attention,
residual and logit multipliers are not modelled, and routing drops at
capacity factor 1.25 (the published model drops none)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1_536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,              # per-expert hidden
    vocab=49_155,
    head_dim=64,
    activation="swiglu",
    n_experts=40,
    top_k=8,
)

# reduced: capacity_factor = E/k makes dispatch drop-free, so the
# cache path is bit-comparable with the batched forward in tests
REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, head_dim=16, n_experts=8, top_k=2, capacity_factor=4.0,
    dtype="f32")


@register_arch("granite-moe-3b-a800m")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED,
                    "hf:ibm-granite/granite-3.0-3b-a800m-base config.json "
                    "(unverified); no muP multipliers")
