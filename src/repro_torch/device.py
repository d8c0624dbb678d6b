"""Device resolution shared by every entry point of the port.

Entry points take ``device=None``, which means ``"cuda"``.  A caller that
wants the CPU asks for it (``device="cpu"``, as the tests do); a missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when CUDA is requested
    and no CUDA device is present.  The planner's backend is the result's
    ``type`` (``"cuda"`` or ``"cpu"``); ``"meta"`` gives shapes only."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
