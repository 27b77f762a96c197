"""Where K2's time goes on the card (``ops/bitonic.row_sort``):

    python -m speck_tpu_torch.probes.sort_profile

1. By key range and payload count, at esc_fixed's two sort widths
   (65536, 4096) and (65536, 2048) and at the stream's (512, 8192): keys
   that are all equal (no digit pass) and keys of 8, 16, 24 and 32 bits
   (1 to 4 passes) with no payload, then 16-bit keys with 1 to 3 payloads;
   each beside one clone of the same inputs (a copy moves the bytes the
   bound counts) and the bound (those bytes at 3.35 TB/s). The steps give
   the cost of a digit pass and of a payload.
2. Rows wider than a tile (tiles, then merge passes): (2, 2^20) and the
   giant-row finish's (1, 2^24), 1 payload, keys below 2^24 with an eighth
   of INT32_MAX, against one torch.sort + gather, equal to sort_plain.

Times: CUDA events, medians of 7 taken in turns with the clone or the
library call; each line carries the card's name and power limit.
"""

from __future__ import annotations

import statistics

import torch

I32_MAX = 2 ** 31 - 1
HBM_BYTES_PER_MS = 3.35e12 / 1e3


def _keys(gen, R, W, bits):
    dev = torch.device("cuda")
    if bits == 0:
        return torch.full((R, W), 5, dtype=torch.int32, device=dev)
    if bits == 32:
        return torch.randint(-2 ** 31, I32_MAX, (R, W), generator=gen,
                             device=dev, dtype=torch.int32)
    return torch.randint(0, 1 << bits, (R, W), generator=gen, device=dev,
                         dtype=torch.int32)


def main():
    from ..ops import bitonic
    from ..utils.device import resolve_device
    from .timing import card, cuda_ms_turns

    resolve_device(None)
    smi = card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    for R, W in [(65536, 4096), (65536, 2048), (512, 8192)]:
        for bits, n_pay in [(0, 0), (8, 0), (16, 0), (24, 0), (32, 0),
                            (16, 1), (16, 2), (16, 3)]:
            key = _keys(gen, R, W, bits)
            pays = [torch.randint(0, 1000, (R, W), generator=gen,
                                  device="cuda", dtype=torch.int32)
                    for _ in range(n_pay)]
            t = cuda_ms_turns(
                {"kernel": lambda: bitonic.row_sort(key, pays),
                 "clone": lambda: (key.clone(), [p.clone() for p in pays])},
                7)
            ms, cl = (statistics.median(t[k]) for k in ("kernel", "clone"))
            print(f"K2 ({R}, {W}) {bits}-bit keys, {n_pay} payloads: kernel "
                  f"{ms:.4f} ms, clone of the inputs {cl:.4f} ms, bound "
                  f"{8 * (1 + n_pay) * R * W / HBM_BYTES_PER_MS:.4f} ms "
                  f"[{smi}]", flush=True)
            del key, pays
        torch.cuda.empty_cache()

    for R, W in [(2, 1 << 20), (1, 1 << 24)]:
        key = _keys(gen, R, W, 24)
        key[:, : W // 8] = I32_MAX
        pays = [torch.randn((R, W), generator=gen, device="cuda")]
        k, p = bitonic.row_sort(key, pays)
        k_p, p_p = bitonic.sort_plain(key, pays)
        if not (torch.equal(k, k_p) and torch.equal(p[0], p_p[0])):
            raise RuntimeError(f"K2 differs from sort_plain at {(R, W)}")
        del k, p, k_p, p_p

        def library():
            key_s, perm = torch.sort(key, dim=1)
            return key_s, [torch.gather(q, 1, perm) for q in pays]

        plan = bitonic.sort_plan(R, W, 1)
        t = cuda_ms_turns({"kernel": lambda: bitonic.row_sort(key, pays),
                           "library": library}, 7)
        ms, lib = (statistics.median(t[k]) for k in ("kernel", "library"))
        print(f"K2 ({R}, {W}) 1 payload, tile {plan.tile} + "
              f"{plan.merge_passes} merge passes: kernel {ms:.4f} ms, "
              f"torch.sort + gather {lib:.4f} ms, bound "
              f"{16 * R * W / HBM_BYTES_PER_MS:.4f} ms [{smi}]", flush=True)
        del key, pays
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
