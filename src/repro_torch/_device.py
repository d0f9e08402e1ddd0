"""Device and dtype resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Only an explicit ``"cpu"`` gives the CPU:
    without CUDA and without that request this raises instead of carrying
    on somewhere slower."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a ``torch.dtype`` passes through)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; "
                         f"one of {sorted(_DTYPES)}") from None
