"""Host arrays as tensors of the same bytes."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host array's bytes (no copy when the array is
    contiguous): uint32 words as int32 and uint16 codes as int16, the views
    torch computes with. Sections are often read-only views of a container;
    the port never writes through these tensors, so torch's warning about
    non-writable arrays is silenced."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def checked_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device raises where there is no
    card, naming `who` (the plain PyTorch path runs with device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device='cuda') needs a CUDA device; none is available "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
