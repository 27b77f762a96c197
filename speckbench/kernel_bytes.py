"""The kernels' bytes and the card's peak: the yardstick of the rooflines.

Frozen copies, so that a later change to the program's probes cannot move
the measure:

- ``k1_bytes`` and ``k3_bytes``: ``speck_tpu_torch/probes/contract_profile.py``
  lines 47-62 (``VALUE_BYTES``, ``k1_bytes``, ``k3_bytes``), as of the
  commit that added this file. K1 (``stream_contract``) reads rid (a plane
  only), col and val and writes last and sums; K3 (``contract_runs``), the
  same without rid.
- ``k2_bytes``: ``speck_tpu_torch/probes/sort_profile.py`` line 65 (the
  bound ``8 * (1 + n_pay) * R * W``): the key and each payload read once
  and written once, 4 bytes each way a slot, at the width the caller asked
  for (the pad to a power of two is the kernel's cost, not the input's).
- ``HBM_BYTES_PER_S``: NVIDIA's data sheet for the H100 SXM, 3.35 TB/s
  (``HBM_BYTES_PER_MS`` in both probes), the published peak at the full
  700 W; a run prints the card's power limit beside its shares.

The launch shapes are the program's counters: ``ops/contract.py``
``LAUNCH_SHAPES`` ((R, W, "plane" or "row", dtype)) and
``RUNS_LAUNCH_SHAPES`` ((R, W, dtype)), ``ops/bitonic.py``
``LAUNCH_SHAPES`` ((R, W, payloads)).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

VALUE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def k1_bytes(R: int, W: int, kind: str, dtype: str = "float32") -> int:
    """Device bytes of one K1 call: 17 and 13 bytes a slot in float32 (a
    rid plane or not), 25 and 21 in float64, 13 and 9 in 16 bits."""
    vb = VALUE_BYTES[dtype]
    return ((4 if kind == "plane" else 0) + 4 + 2 * vb + 1) * R * W


def k3_bytes(R: int, W: int, dtype: str = "float32") -> int:
    """Device bytes of one K3 call: 13 bytes a slot in float32."""
    return (5 + 2 * VALUE_BYTES[dtype]) * R * W


def k2_bytes(R: int, W: int, n_payloads: int) -> int:
    """Device bytes of one K2 sort: 8 a slot for the key and each payload."""
    return 8 * (1 + n_payloads) * R * W
