"""Device selection for the port's entry points.

Every entry point takes ``device=``; the default is the card. Asking for
CUDA where there is none raises instead of quietly running on the CPU, so a
measurement can never come from the wrong device. The tests pass
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
