"""rwkv6-1.6b [ssm]: Finch, data-dependent decay, attention-free.
[arXiv:2404.05892]

The reference's configuration, copied as the reference has it: 24
RWKV-6 layers (time mix and channel mix), d 2048 in 32 heads of 64, a
channel mix of 7168, and a 65536-token vocabulary. The layers carry
O(1) state a sequence and no attention, so the family is served through
lockstep generation, not the paged scheduler."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    n_layers=24,
    d_model=2_048,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=7_168,
    vocab=65_536,
    rwkv_head_dim=64,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, d_ff=128, vocab=512, rwkv_head_dim=16,
    dtype="f32")


@register_arch("rwkv6-1.6b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2404.05892; unverified")
