"""Device selection shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and with no card present they raise instead of
falling back.  The CPU is for the parity tests, which ask for it by name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for but absent.

    On the card, float32 matrix products and convolutions are pinned to full
    float32 (TF32 off): the serving path keeps fp32 parameters and
    activations, as the JAX engine does, and TF32 would keep only about
    three decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
