"""SLAM orchestration subpackage."""
from sgtd_tpu_torch.slam.multisession import (  # noqa: F401
    SessionResult,
    localize_and_optimize_session,
)
