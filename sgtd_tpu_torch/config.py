"""Configuration shared with the JAX package.

``sgtd_tpu.config`` is plain dataclasses with no JAX import (and
``sgtd_tpu/__init__.py`` imports nothing else), so both packages take the
same config objects.
"""

from sgtd_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    CapacityConfig,
    DescriptorConfig,
    GicpConfig,
    SearchConfig,
    SGTDConfig,
)
