"""Device resolution for the port's entry points.

Entry points run on the card by default. The CPU is used only when the caller
asks for it (`device="cpu"`, as the tests do); there is no silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pearl_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on `device`, seeded (never the global RNG)."""
    return torch.Generator(device=device).manual_seed(int(seed))
