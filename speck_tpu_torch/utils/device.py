"""Device introspection: the torch device's name, count and memory, and the
rule for the port's entry points: the first CUDA card unless the caller
passes ``device="cpu"``; without a card that default raises."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when it is None. A CUDA device
    without a card raises: the CPU runs only when asked for by name."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "speck_tpu_torch: no CUDA card is available; pass device=\"cpu\" "
            "to run on the CPU (the kernels' plain torch versions)")
    return device


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str          # "gpu" or "cpu"
    device_kind: str       # torch.cuda.get_device_name, or "cpu"
    num_devices: int
    memory_bytes: Optional[int]

    @classmethod
    def current(cls, device=None) -> "DeviceInfo":
        device = resolve_device(device)
        if device.type != "cuda":
            return cls("cpu", "cpu", 1, None)
        props = torch.cuda.get_device_properties(device)
        return cls("gpu", torch.cuda.get_device_name(device),
                   torch.cuda.device_count(), int(props.total_memory))

    def summary(self) -> str:
        mem = (f"{self.memory_bytes / 2**30:.1f} GiB" if self.memory_bytes
               else "?")
        return (f"{self.device_kind} ({self.platform}), "
                f"{self.num_devices} device(s), memory {mem}")


def device_info(device=None) -> DeviceInfo:
    return DeviceInfo.current(device)
