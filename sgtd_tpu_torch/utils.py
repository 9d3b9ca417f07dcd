"""Small tensor helpers shared by the batched stages."""

from __future__ import annotations

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """A NumPy array of ``x``: a tensor on any device, copied to the host,
    or anything ``np.asarray`` takes."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def batch_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = x[b, idx[b, ...]]``: per-batch gather on axis 1.

    x (B, N, *rest); idx (B, *shape) integer -> (B, *shape, *rest).
    """
    b = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.dim() - 1)
    )
    return x[b, idx.long()]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    torch's vectorized CPU ``sqrt`` can land one ulp off the correctly
    rounded float32 result that XLA and NumPy give (e.g. sqrt(529.1663)).
    A float64 root rounded to float32 is exact, and one ulp decides gates
    such as ``trunc(side * 1000)`` in the descriptor dedup.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    The Kabsch cross-covariances, the verification transforms and the pose
    products are f32 in the reference; TF32 keeps about three decimal
    digits and would move poses and inlier tests.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
