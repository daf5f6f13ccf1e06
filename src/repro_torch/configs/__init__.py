"""Architecture configs served by the port (importing registers them)."""

from repro_torch.configs import (granite_moe_3b_a800m,  # noqa: F401
                                  kimi_k2_1t_a32b, phi3_medium_14b)
from repro_torch.configs.base import (ArchSpec, ModelConfig, get_arch,
                                      list_archs, parse_kv_quant)

__all__ = ["ModelConfig", "ArchSpec", "get_arch", "list_archs",
           "parse_kv_quant"]
