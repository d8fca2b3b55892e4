"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument.  ``None`` means ``cuda``:
the port exists to run on the GPU, so a run that silently fell back to the
CPU would report CPU numbers under a GPU name.  ``"cpu"`` is an explicit
request (the tests make it); ``"cuda"`` without a usable GPU raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises
    ``RuntimeError`` when CUDA is asked for and unavailable, and
    ``ValueError`` for device types the port has no path for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
