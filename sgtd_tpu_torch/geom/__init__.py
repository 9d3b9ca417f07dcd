"""Geometry subpackage."""
from sgtd_tpu_torch.geom import se3  # noqa: F401
