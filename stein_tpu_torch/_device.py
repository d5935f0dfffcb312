"""The port's device rule: an entry point given no device takes the current
card, and raises without one (there is no fallback to the CPU; a caller that
wants the CPU asks for it)."""

import torch


def resolve_device(device, what):
    """The given device, else the current card. ``what`` names the entry
    point in the error."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}(device={str(device)!r}): no CUDA device is "
                "available to this process"
            )
        if device.index is None:
            # Tensors report their card's index; compare like with like.
            device = torch.device("cuda", torch.cuda.current_device())
    return device
