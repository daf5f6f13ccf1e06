"""The kernels' fake branches and the cost counter of the dry run.

Inside ``device.fake_cuda()`` every tensor is a ``FakeTensor``: it has a
shape, a dtype and a device (``cuda`` too, with no card) and no data.
Each kernel wrapper (``takum_codec.decode``/``encode``/``kv_append``,
``quantize.fake_quant``, ``takum_matmul.qmatmul``,
``lns_matmul.lns_matmul``, ``takum_attention.attention``/
``paged_attention``) checks its inputs as it does on the card, then, for
a fake input, returns outputs of the kernel's shapes and dtypes and
:func:`charge`\\ s the kernel's work to the active :class:`CostCounter`.
It builds and loads no library, launches nothing (its ``launches``
count stays as it was) and never takes its plain version: the dry run
traces the program the card runs.

:class:`CostCounter` is one ``TorchDispatchMode``. Per aten op it adds
the flops of ``torch.utils.flop_counter``'s formulas (matmuls,
convolutions, attention; elementwise ops count none) and the op's
input plus output bytes (views, allocations and metadata reads move no
bytes); per kernel the counts the wrappers charge: ``2 M K N`` for the
matmuls, ``4 rows keys hd`` a (sequence, KV head) for attention over
the keys the kernel visits, no flops for the codec and fake-quant, and
each kernel's inputs read once and outputs written once. It also
tracks the bytes of live storages, whose peak less the arguments' is
the step's temporary memory.
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import is_fake as _is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["is_fake", "on_card", "in_fake_mode", "charge", "nbytes",
           "CostCounter"]

# the active counters, innermost last
_ACTIVE: List["CostCounter"] = []


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (the dry run's). A plain tensor,
    what every call on the card passes, is answered by its type alone."""
    if type(t) is torch.Tensor:
        return False
    return isinstance(t, torch.Tensor) and _is_fake(t)


def on_card(t) -> bool:
    """Whether a kernel wrapper treats ``t`` as the card's: a CUDA tensor,
    or a fake one (the dry run's fake card, ``device.fake_device``)."""
    return t.is_cuda or is_fake(t)


def in_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is active."""
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def charge(kernel: str, flops: int, moved: int) -> None:
    """Add one call of ``kernel`` (``flops`` operations, ``moved``
    bytes) to the innermost active :class:`CostCounter`, if any."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(kernel, flops, moved)


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


# ops that read or write no tensor memory
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "sym_size",
         "sym_numel", "sym_stride", "sym_storage_offset", "is_same_size",
         "lift_fresh", "set_")


class CostCounter(TorchDispatchMode):
    """Flops, bytes and live memory of everything run inside it (enter it
    inside the fake mode, so it sees each op first). ``kernels`` maps a
    kernel's name to ``{"calls", "flops", "bytes"}``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    # -- kernels ------------------------------------------------------------

    def add_kernel(self, kernel: str, flops: int, moved: int) -> None:
        k = self.kernels.setdefault(kernel, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(moved)
        self.flops += int(flops)
        self.bytes += int(moved)

    # -- memory -------------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (a step's
        arguments, made before the counter started); returns the bytes
        newly counted."""
        before = self.live
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track_one(t)
        return self.live - before

    def _track_one(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    # -- the dispatch -------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        name = func._overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track_one(t)
        if name in _FREE or func.is_view:
            return out
        formula = _flop_registry().get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(nbytes(t) for t in ins + outs)
        return out
