"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
with no card and no explicit ``device="cpu"`` it raises, and it never
drops quietly to the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda:0``.  A CUDA device without a card raises; the
    CPU is used only when asked for by name."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_devices(device: Optional[Union[str, torch.device, Sequence[
        Union[str, torch.device]]]] = None) -> List[torch.device]:
    """The devices a sharded entry point spreads over, one shard each.

    ``None`` -> every visible card, ``cuda:0 .. cuda:{n-1}`` (inside a
    worker granted k cards, the k cards of its ``CUDA_VISIBLE_DEVICES``);
    without a card it raises, as ``resolve_device`` does.  One device
    (``"cpu"``, ``"cuda:0"``) is one shard.  A sequence is taken as given,
    a device repeated in it included (``["cpu"] * 8`` is 8 shards on the
    CPU); it must name one device type, and only cards that exist."""
    if device is None:
        resolve_device(None)                   # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(device, (str, torch.device)):
        device = [device]
    devs = [torch.device(d) for d in device]
    if not devs:
        raise ValueError("an empty device list")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices of more than one type: {devs}")
    devs = [resolve_device(d) for d in devs]
    missing = [d for d in devs if d.type == "cuda"
               and d.index >= torch.cuda.device_count()]
    if missing:
        raise RuntimeError(f"no such card: {missing} "
                           f"({torch.cuda.device_count()} visible)")
    return devs
