"""Device selection for every entry point of the port.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
Asking for CUDA where no card is visible raises: there is no silent
CPU path. The CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev
