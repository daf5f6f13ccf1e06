"""Architecture configs served by the port (importing registers them)."""

from repro_torch.configs import (granite_moe_3b_a800m,  # noqa: F401
                                  kimi_k2_1t_a32b, llama_3_2_vision_11b,
                                  minitron_4b, nemotron_4_340b,
                                  phi3_medium_14b, recurrentgemma_2b,
                                  rwkv6_1_6b, seamless_m4t_large_v2,
                                  starcoder2_15b)
from repro_torch.configs.base import (SHAPES, ArchSpec, ModelConfig,
                                      QuantConfig, RuntimeConfig,
                                      ShapeConfig, get_arch, list_archs,
                                      parse_kv_quant, register_arch,
                                      shape_applicable)

__all__ = ["ModelConfig", "ArchSpec", "QuantConfig", "RuntimeConfig",
           "ShapeConfig", "SHAPES", "get_arch", "list_archs",
           "register_arch", "parse_kv_quant", "shape_applicable"]
