from .compare import compare_csr  # noqa: F401
from .config import Config, ProductOverflow, SpgemmConfig  # noqa: F401
from .oracle import oracle_spgemm  # noqa: F401
from .timings import StageTimer, Timings  # noqa: F401
