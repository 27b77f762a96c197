"""The port's gather probes (speck_tpu_torch/probes) against the functions
that the probe scripts' XLA lines compute, on the CPU, where the wrappers
run their plain versions. The Pallas bodies are nested in the scripts'
``main()``; their XLA lines compute the same functions:
``jnp.take_along_axis(tab, idx, axis=0)`` (gather_microbench2.py:166) and
``src[(offs[:, None] + arange(L)).reshape(-1)]`` (expand_microbench.py:
143-145). Outputs are copies of inputs, so they must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speck_tpu_torch.probes import gather_microbench2 as gm


def test_sublane_gather_matches_take_along_axis(rng):
    S, rows = 64, 40
    tab = rng.standard_normal((S, 128)).astype(np.float32)
    idx = rng.integers(0, S, (rows, 128)).astype(np.int32)
    got = gm.sublane_gather(torch.from_numpy(idx), torch.from_numpy(tab))
    want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L", [128, 256])
def test_run_copy_matches_xla_pattern(rng, L):
    G, K, n = 6, 5, 3001
    src = rng.standard_normal(n).astype(np.float32)
    offs = rng.integers(0, n - L + 1, (G, K)).astype(np.int32)
    offs[0, 0], offs[-1, -1] = 0, n - L          # both ends of the source
    got = gm.run_copy(torch.from_numpy(offs), torch.from_numpy(src), L)
    ix = (jnp.asarray(offs).reshape(-1, 1)
          + jnp.arange(L, dtype=jnp.int32)[None, :]).reshape(-1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(src)[ix]))


def test_probe_wrappers_on_cpu_do_not_count(rng):
    before = dict(gm.LAUNCHES)
    gm.sublane_gather(torch.zeros((2, 128), dtype=torch.int32),
                      torch.ones((4, 128)))
    gm.run_copy(torch.zeros((1, 2), dtype=torch.int32), torch.ones(256), 128)
    assert gm.LAUNCHES == before


@pytest.mark.parametrize("case", ["idx_lanes", "idx_dtype", "tab_dtype",
                                  "tab_too_tall", "copy_L", "copy_offs_dtype",
                                  "copy_src_2d", "copy_src_short"])
def test_probe_wrappers_reject_what_kernels_do_not_take(case):
    idx = torch.zeros((2, 128), dtype=torch.int32)
    tab = torch.ones((4, 128))
    offs = torch.zeros((2, 3), dtype=torch.int32)
    src = torch.ones(1024)
    with pytest.raises(ValueError):
        if case == "idx_lanes":
            gm.sublane_gather(idx[:, :64].contiguous(), tab)
        elif case == "idx_dtype":
            gm.sublane_gather(idx.long(), tab)
        elif case == "tab_dtype":
            gm.sublane_gather(idx, tab.double())
        elif case == "tab_too_tall":
            gm.sublane_gather(idx, torch.ones((gm.MAX_TABLE_ROWS + 1, 128)))
        elif case == "copy_L":
            gm.run_copy(offs, src, 100)
        elif case == "copy_offs_dtype":
            gm.run_copy(offs.long(), src, 128)
        elif case == "copy_src_2d":
            gm.run_copy(offs, src.reshape(8, 128), 128)
        else:
            gm.run_copy(offs, src[:64], 128)
