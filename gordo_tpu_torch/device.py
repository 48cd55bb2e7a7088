"""
The device an entry point runs on.

The port runs on the card. The CPU is used only when a caller asks for
it by name (``device="cpu"``, as the tests do): a missing card is an
error, never a silent fallback that would hide where the work ran.
"""

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """
    ``None`` -> ``cuda`` (raises ``RuntimeError`` without a card); an
    explicit device is returned as a ``torch.device`` after the same
    check for CUDA devices.
    """
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gordo_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run on the CPU explicitly'
        )
    return resolved
