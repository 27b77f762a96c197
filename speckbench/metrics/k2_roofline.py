"""k2_roofline (%): the row sort's share of its memory roofline over the
profiled calls: the bytes of every launch (the program's launch counter,
``kernel_bytes.k2_bytes``) over the published HBM peak, against the device
time of the sort's tile and merge kernels. Time-weighted over the
launches; nothing where no K2 kernel ran."""

from speckbench.kernel_bytes import HBM_BYTES_PER_S, k2_bytes
from speckbench.trace import kernel_seconds

KERNELS = ("radix_tile_kernel", "merge_pass_kernel")


def read(rec):
    nbytes = sum(n * k2_bytes(*shape)
                 for shape, n in rec["launches"]["k2"].items())
    secs = kernel_seconds(rec, KERNELS)
    if not nbytes or not secs:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
