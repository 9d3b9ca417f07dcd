"""Registration subpackage: GICP, NDT and the LM/GN optimizers (VGICP in
``refine.vgicp``)."""
from sgtd_tpu_torch.refine.gicp import GicpResult, gicp_align, gicp_rerank, point_covariances  # noqa: F401
from sgtd_tpu_torch.refine.lsq import LsqResult, gn_solve, lm_solve  # noqa: F401
from sgtd_tpu_torch.refine.ndt import NdtMap, NdtResult, build_ndt_map, ndt_align  # noqa: F401
