"""Device selection for the port's entry points.

Entry points (``LM`` init, the engines, the serve launcher) default to the
card. Without one they raise instead of quietly running on the CPU: the
CPU runs the kernels' plain versions, which is a test path, not a serve
path, so a caller has to ask for it by name.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU. On CUDA, fp32 matmuls and convs are pinned to full
    fp32 (the parity contract of the port: no TF32), and convs to
    deterministic cuDNN algorithms (a step repeats bitwise)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port's entry points run "
                "on the card by default — pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

