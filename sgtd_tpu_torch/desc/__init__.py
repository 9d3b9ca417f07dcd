"""Descriptor subpackage."""
from sgtd_tpu_torch.desc.triangles import Descriptors, build_descriptors  # noqa: F401
from sgtd_tpu_torch.desc import keys  # noqa: F401
