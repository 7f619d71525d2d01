"""Where the port runs: the card, unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when the caller names none.  Asking for the
    card where there is none raises: there is no quiet step back to the CPU
    (pass ``"cpu"``, or ``--device cpu`` on a command line, to ask for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
