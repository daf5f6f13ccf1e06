"""Wire-format registry (see ``registry``)."""

from repro_torch.formats.registry import (IDENTITY, LUT_DEFAULT_CUDA,
                                          FormatSpec, get, lut_enabled, names,
                                          posit8_lut_decode, resolve,
                                          resolve_lns, resolve_wire,
                                          wire_names)

__all__ = ["FormatSpec", "IDENTITY", "get", "resolve", "resolve_lns",
           "resolve_wire", "names", "wire_names", "lut_enabled",
           "posit8_lut_decode", "LUT_DEFAULT_CUDA"]
