"""Architecture configs served by the port (importing registers them)."""

from repro_torch.configs import phi3_medium_14b  # noqa: F401
from repro_torch.configs.base import (ArchSpec, ModelConfig, get_arch,
                                      list_archs, parse_kv_quant)

__all__ = ["ModelConfig", "ArchSpec", "get_arch", "list_archs",
           "parse_kv_quant"]
