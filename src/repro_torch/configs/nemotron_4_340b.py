"""nemotron-4-340b [dense]: GQA, squared-ReLU MLP. [arXiv:2402.16819]

The reference's configuration, copied as the reference has it: 96
layers, d 18432, 96/8 heads of 192, d_ff 73728, vocab 256000; the MLP
is relu(x w1)^2 w2. Its head dim 192 is the attention kernels' widest
after recurrentgemma's 256."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab=256_000,
    head_dim=192,
    activation="relu2",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384,
    vocab=512, head_dim=16, dtype="f32")


@register_arch("nemotron-4-340b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2402.16819; unverified")
