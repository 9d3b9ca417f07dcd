"""Kernels (B1-B8, K1-K3, each beside its plain PyTorch version) and
small linear algebra; the kernels' launch counts, in ``_build.KERNELS``'s
order."""

from sgtd_tpu_torch.ops._build import launch_counts, reset_launch_counts  # noqa: F401
