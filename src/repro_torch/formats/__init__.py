"""Wire-format registry (see ``registry``)."""

from repro_torch.formats.registry import (IDENTITY, FormatSpec, get, names,
                                          resolve, resolve_lns, resolve_wire,
                                          wire_names)

__all__ = ["FormatSpec", "IDENTITY", "get", "resolve", "resolve_lns",
           "resolve_wire", "names", "wire_names"]
