"""Multi-device pieces of the port. Only ``padded_to_host_csr`` so far; the
mesh paths wait for their port."""

from .dist import padded_to_host_csr  # noqa: F401
