"""The named operands of a cell's calls and the steps over them, as a
traffic mix states them.

``"A"`` is the configuration's structure with value set ``k``
(``inputs.draw_values``). A traffic mix may name more operands under
``"operands"``, ``{name: {"generator": g, ...}}``: each is made by
``generators/<g>.py``'s ``operand(cfg, params)``, a ``Structure`` with its
fixed float64 values, the same for every seed and value set. A call's
steps (``"steps"``) are ``[name, op, operand...]``, each op over operands
named before it: ``"spgemm"`` (two) or ``"transpose"`` (one); the last
step is a product, the call's output. The program's entries
(``window.py``) and the reference (``reference.py``) both take their
inputs from here, so the reference takes nothing that the program made.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .inputs import Structure, draw_values

ARITY = {"spgemm": 2, "transpose": 1}
Step = Sequence[str]


def check_steps(steps: Sequence[Step], names) -> None:
    """Raise ValueError unless every step has an op of ``ARITY`` over
    operands named before it, and the last is a product."""
    known = set(names)
    for step in steps:
        name, op, *args = step
        if len(args) != ARITY.get(op) or not set(args) <= known:
            raise ValueError(f"step {list(step)}: not an op of {list(ARITY)}"
                             f" over the operands {sorted(known)}")
        known.add(name)
    if not steps or steps[-1][1] != "spgemm":
        raise ValueError("the last step of a chain must be a spgemm")


class Inputs:
    """A cell's operands: ``A`` from the configuration and the seed, and
    the traffic's own, found by their generators' names in ``bench``."""

    def __init__(self, bench, traffic: dict, st: Structure, cfg: dict,
                 seed: int):
        self.st, self.cfg, self.seed = st, cfg, seed
        ops = traffic.get("operands", {})
        if "A" in ops:
            raise ValueError("the operand A is the configuration's")
        self.fixed = {name: bench.generator(p["generator"]).operand(cfg, p)
                      for name, p in ops.items()}

    def named(self, k: int, device
              ) -> Dict[str, Tuple[Structure, torch.Tensor]]:
        """Every operand with its values on ``device``, A's value set
        ``k``."""
        out = {"A": (self.st, draw_values(self.st, self.cfg, self.seed, k,
                                          device))}
        for name, (st, v) in self.fixed.items():
            out[name] = (st, torch.as_tensor(v, device=device))
        return out
