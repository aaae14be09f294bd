"""Backend and device choice for the port's kernels.

Three backends, reduced from the reference's ``ExecutionContext``:

* ``"auto"`` — launch the CUDA kernel for a CUDA tensor, take the plain
  PyTorch version for a CPU tensor. The tensor's device decides, nothing
  else: there is no fallback from a failed kernel to the plain version.
* ``"torch"`` — the plain version, only when a caller asks for it (the
  tests, and ``chip_smoke.py``'s kernel-vs-plain comparison).
* ``"cuda"`` — the kernel; raises for a CPU tensor.

:func:`resolve_device` is the entry points' device rule: ``None`` means
``cuda``, and asking for ``cuda`` without a card raises instead of running
on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """The route (``"cuda"`` or ``"torch"``) for ``tensor`` under
    ``backend``."""
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if backend == "torch":
        return "torch"
    if backend == "cuda":
        if not tensor.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors, got a "
                             f"tensor on {tensor.device}")
        return "cuda"
    raise ValueError(f"unknown backend {backend!r}: expected one of "
                     f"{BACKENDS}")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
