"""Device resolution for the port's entry points.

Every entry point (``TransformerLM(...)``, ``ServingEngine(...)``, the
ops) takes a ``device`` argument and resolves it here: the default is
the card (``cuda``), and a missing card RAISES — nothing falls back to
the CPU behind the caller's back. The CPU runs only when the caller
asks for it by name (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` only on request; a CUDA device
    raises ``RuntimeError`` when ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev!s} (use 'cuda' or 'cpu')")
