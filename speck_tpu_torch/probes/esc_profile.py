"""Where ``esc_fixed``'s time goes on the card, on bench config 1
(``make_banded(65536, 16, seed=3)``, A·A, float32, cap 2048):

    python -m speck_tpu_torch.probes.esc_profile

Prints the stage split of one warm call (CUDA events around the stages of
``ops.esc.esc_fixed``, run one by one: the expand with its owner fill,
the column sort, the contract, the count and the compaction), then
``torch.profiler``'s device time by kernel over one whole call, the device
total against the call's host time (the idle share), each line with the
card's name and power limit.
"""

from __future__ import annotations

import torch


def stage_split(args, cap: int, n_cols: int):
    """(stage, ms) of esc_fixed's stages, each timed with CUDA events."""
    from ..ops import esc

    (a_indptr, a_indices, a_data, b_start, b_len, b_indices,
     b_data) = args
    m = a_indptr.shape[0] - 1
    dev = a_indptr.device
    out = []

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        out.append((name, start.elapsed_time(end)))
        return res

    rows = torch.arange(m, dtype=torch.int32, device=dev)
    valid = torch.ones((m,), dtype=torch.bool, device=dev)
    col, val, _ = timed("expand (owner fill: 2 K2 sorts and the fill)",
                        lambda: esc._expand(
                            rows, valid, a_indptr, a_indices, a_data,
                            b_start, b_len, b_indices, b_data, cap, n_cols,
                            with_values=True))
    col_s, (val_s,) = timed("column sort (K2)",
                            lambda: esc._sort_rows(col, [val]))
    last, run_sum = timed("contract (K3)",
                          lambda: esc._contract(col_s, val_s, n_cols))
    timed("count", lambda: last.sum(dim=1, dtype=torch.int32))
    timed("compaction (rank sort, K2)",
          lambda: esc._compact_by_rank(last, col_s, run_sum))
    return out


def main():
    from .. import entry as tentry
    from ..ops.esc import esc_fixed
    from ..utils.device import resolve_device
    from ..utils.generators import make_banded
    from .timing import card, device_us, profile_call

    resolve_device(None)
    smi = card()
    h = make_banded(65536, half_band=16, seed=3)
    cap = tentry.fixed_cap(h, h)
    args = tentry.esc_args(h, h, "cuda")
    esc_fixed(*args, cap=cap, n_cols=h.cols)          # warm-up
    torch.cuda.synchronize()

    split = stage_split(args, cap, h.cols)
    for name, ms in split:
        print(f"stage {name}: {ms:.3f} ms [{smi}]", flush=True)

    host_ms, total_ms, kernels = profile_call(
        lambda: esc_fixed(*args, cap=cap, n_cols=h.cols))
    for e in kernels[:15]:
        print(f"kernel {e.key[:90]}: {device_us(e) / 1e3:.3f} ms over "
              f"{e.count} launches [{smi}]", flush=True)
    print(f"profiled call: host {host_ms:.2f} ms, device {total_ms:.2f} ms "
          f"over {sum(e.count for e in kernels)} kernels, idle share "
          f"{1 - total_ms / host_ms:.3f} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
