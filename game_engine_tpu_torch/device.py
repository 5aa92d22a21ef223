"""The port's device rule: every entry point runs on the card unless its
caller asks for the CPU. There is no fallback: asking for the card where
there is none raises."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT = "cuda"


def resolve(device: Union[str, torch.device]) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device without a card
    and for any type other than cuda and cpu."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
