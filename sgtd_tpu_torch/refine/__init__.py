"""Registration subpackage: GICP and the LM/GN optimizers."""
from sgtd_tpu_torch.refine.gicp import GicpResult, gicp_align, gicp_rerank, point_covariances  # noqa: F401
from sgtd_tpu_torch.refine.lsq import LsqResult, gn_solve, lm_solve  # noqa: F401
