"""Descriptor database subpackage."""
from sgtd_tpu_torch.db.database import DBBuildReport, DescriptorDB, tuned_config  # noqa: F401
