"""Matching subpackage."""
from sgtd_tpu_torch.match.search import CandidateSet, candidate_search  # noqa: F401
from sgtd_tpu_torch.match.verify import VerifyResult, triangle_solver, verify_candidates  # noqa: F401
from sgtd_tpu_torch.match.pipeline import LocalizationResult, localize, localize_batch, localize_descriptors, localize_exact  # noqa: F401
