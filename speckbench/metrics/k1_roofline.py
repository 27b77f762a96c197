"""k1_roofline (%): the contract kernel's share of its memory roofline over
the profiled calls: the bytes of every launch (the program's launch
counters, ``kernel_bytes.k1_bytes`` and ``k3_bytes``, which share the
kernel) over the published HBM peak, against the device time of
``contract_kernel`` and the scratch clear its launcher runs. Time-weighted
over the launches; nothing where no K1 kernel ran."""

from speckbench.kernel_bytes import HBM_BYTES_PER_S, k1_bytes, k3_bytes
from speckbench.trace import kernel_seconds

KERNELS = ("contract_kernel", "contract_scratch_clear")


def read(rec):
    launches = rec["launches"]
    nbytes = (sum(n * k1_bytes(*shape) for shape, n in launches["k1"].items())
              + sum(n * k3_bytes(*shape)
                    for shape, n in launches["k3"].items()))
    secs = kernel_seconds(rec, KERNELS)
    if not nbytes or not secs:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
