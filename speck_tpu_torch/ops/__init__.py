from .device_csr import DeviceCSR, device_get_csr, device_put_csr  # noqa: F401
from .spgemm import SpgemmPlan, plan_spgemm, spgemm  # noqa: F401
