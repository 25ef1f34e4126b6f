"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Any, Iterator

import torch


def resolve(device: str | torch.device) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises when CUDA is asked for and there is none: the port never carries
    on quietly on the CPU.  Pass ``device="cpu"`` to run the plain versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device {dev}: expected 'cuda' or 'cpu'")
    return dev


def to_device(device: str | torch.device, *arrays):
    """``resolve(device)`` and every array (a tensor, or anything
    ``torch.as_tensor`` takes) as a tensor there, with no copy if it is
    there already."""
    dev = resolve(device)
    return (dev, *(torch.as_tensor(a, device=dev) for a in arrays))


def tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts (other leaves are
    skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from tensors(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from tensors(item)


def block_until_ready(tree: Any) -> Any:
    """Wait until the card has finished every CUDA tensor of ``tree``, on
    each tensor's own device (``torch.cuda.synchronize()`` alone waits on
    the current device, which another thread may not share); returns
    ``tree``.  Without it a clock read after a launch times the launch, not
    the work."""
    for dev in {t.device for t in tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree
