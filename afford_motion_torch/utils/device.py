"""The device an entry point runs on: the card unless the caller says
otherwise, and never a silent CPU run."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch


def resolve_device(cfg: Any, device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` (an argument of the entry), else the ``device=`` config
    override, else ``cuda:<cfg.gpu>``. Raises when a CUDA device is asked
    for and PyTorch sees none (or not that many)."""
    spec = device if device is not None else cfg.get("device", None)
    if spec is None:
        spec = f"cuda:{int(cfg.get('gpu', 0))}"
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {spec!r} was asked for but PyTorch sees no CUDA device; "
                "pass device=cpu to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {spec!r}: only {torch.cuda.device_count()} "
                               "CUDA device(s) present")
    return dev
