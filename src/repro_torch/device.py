"""Where the port's public entry points put their tensors, and the dry
run's fake CUDA device (:func:`fake_cuda`)."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "check_generator", "fake_cuda", "fake_device"]

# how many fake_cuda() contexts are open
_FAKE_CUDA = 0


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; no quiet CPU fallback.
    Without a card ``cuda`` raises, except inside :func:`fake_cuda`,
    where it names the fake device the dry run traces on."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        if _fake_cuda_active():
            return fake_device()
        raise RuntimeError("no CUDA device: the port runs on the GPU; "
                           "pass device='cpu' to run its plain versions")
    return device


def fake_device() -> torch.device:
    """The device of the dry run's fake card: ``cuda`` where PyTorch is
    built with CUDA, else ``meta`` (a build without CUDA has no CUDA
    device guard, which indexing a ``cuda`` tensor binds even when the
    tensor is fake). The kernel wrappers take their fake branches for a
    fake tensor on either."""
    return torch.device("cuda" if torch.backends.cuda.is_built()
                        else "meta")


def _fake_cuda_active() -> bool:
    if not _FAKE_CUDA:
        return False
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


@contextlib.contextmanager
def fake_cuda():
    """A ``FakeTensorMode`` in which tensors have shapes, dtypes and
    devices and no data: ``cuda`` needs no card there (it names
    :func:`fake_device`), the kernel wrappers take their fake branches
    (``kernels/cost.py``), and nothing is allocated. Real tensors met
    inside become fake. Yields the mode."""
    global _FAKE_CUDA
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    _FAKE_CUDA += 1
    try:
        with mode:
            yield mode
    finally:
        _FAKE_CUDA -= 1


def check_generator(gen: torch.Generator, device: torch.device) -> None:
    """Raise unless ``gen`` draws on ``device``'s type (torch cannot draw
    CUDA tensors from a CPU generator, nor the reverse)."""
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device} cannot draw parameters "
                         f"on {device}: pass a generator on that device")
