"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default) requires a CUDA device and raises without one:
    a run never moves to the CPU unless the caller asks for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait until the work queued on ``dev``'s current stream has run: the
    stream's synchronize on a card; nothing on the CPU, whose operations
    have run when they return."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
