"""Device introspection: the torch device's name, count and memory."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str          # "gpu" or "cpu"
    device_kind: str       # torch.cuda.get_device_name, or "cpu"
    num_devices: int
    memory_bytes: Optional[int]

    @classmethod
    def current(cls, device=None) -> "DeviceInfo":
        device = torch.device(device if device is not None else
                              ("cuda" if torch.cuda.is_available() else "cpu"))
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
