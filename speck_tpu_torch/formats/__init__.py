from .csr import HostCOO, HostCSR, coo_to_csr, csr_transpose  # noqa: F401
from .hicsr import load_hicsr, store_hicsr  # noqa: F401
from .loader import DataLoader, load_matrix  # noqa: F401
from .mtx import load_mtx, store_mtx  # noqa: F401
