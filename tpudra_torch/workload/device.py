"""Device resolution for the port's entry points.

Entry points take ``device`` and default to CUDA.  With no CUDA device they
raise instead of quietly running on the CPU: the CPU runs only the plain
PyTorch versions of the kernels, and only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises
    RuntimeError when a CUDA device is asked for and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
