"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU.  With
no card and no explicit ``device="cpu"`` it raises: the port never carries on
quietly on the CPU, because a CPU run says nothing about the card.

``"meta"`` is a third explicit choice, never a default: tensors with shapes
and dtypes and no data, on which the dry run (``launch.dryrun``) traces a
step to count its bytes and flops.  The kernel wrappers take it too: on
meta tensors they do their host-side launch math, return the kernel's
outputs as empty meta tensors and count the kernel's work
(``kernels.bounds.META``).
"""

from __future__ import annotations

import torch


DEVICES = ("cuda", "cpu", "meta")


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current card (raises without one);
    ``"cpu"`` -> the CPU, where kernels take their plain versions;
    ``"meta"`` (only when asked for) -> shapes without data."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' (or --device cpu) to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in DEVICES:
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    return dev


def generator(device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` for draws on ``device``: the device's own, or
    the CPU's for ``meta``, whose draws hold no values."""
    return torch.Generator(device="cpu" if device.type == "meta" else device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def of(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on (``cuda``, ``cpu`` or
    ``meta``); raises if they differ.  The kernel wrappers dispatch on it."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in DEVICES:
        raise ValueError(f"unsupported device {dev}")
    return dev
