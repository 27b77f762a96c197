"""The benchmark's inputs: a configuration's structure and its value sets.

A generator (``speckbench/generators/<name>.py``, named by the
configuration's ``generator``) makes the structure on the host from the
seed; every value set is drawn here, on the device, from the seed and the
set's number, in the configuration's value type and distribution. Set 0
is the one the inputs carry; the ``reuse`` traffic multiplies sets 1 to K.
The reference draws the same sets again from the same numbers, so it takes
no value from the program. Imports torch and numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass
class Structure:
    """A CSR structure on the host: sorted, distinct columns in each row.
    ``value_index`` (one int per entry) ties entries to one drawn value,
    as both entries of an undirected edge; None draws one per entry."""

    rows: int
    cols: int
    indptr: np.ndarray          # (rows + 1,) int64
    indices: np.ndarray         # (nnz,) int32
    value_index: Optional[np.ndarray] = None
    n_values: Optional[int] = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


def seed_of(seed: int, *keys: int) -> int:
    """A 63-bit seed for a torch or numpy generator from the run's seed and
    ``keys`` (any whole numbers, the run's seed may exceed 32 bits)."""
    ss = np.random.SeedSequence([seed % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def value_dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["value_dtype"]]


def draw_values(st: Structure, cfg: dict, seed: int, k: int,
                device) -> torch.Tensor:
    """Value set ``k`` of ``st`` on ``device``: ``cfg["values"]`` is
    "normal" (standard normal) or "uniform" ([0, 1)), in the configuration's
    value type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 1, k))
    n = st.nnz if st.value_index is None else int(st.n_values)
    draw = {"normal": torch.randn, "uniform": torch.rand}[cfg["values"]]
    v = draw(n, generator=gen, device=device, dtype=value_dtype(cfg))
    if st.value_index is not None:
        v = v[torch.as_tensor(st.value_index, device=device)]
    return v
