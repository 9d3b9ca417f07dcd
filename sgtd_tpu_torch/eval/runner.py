"""Map-building helpers of the evaluation runner (port of the part of
sgtd_tpu.eval.runner that large maps need)."""

from __future__ import annotations

import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.desc.triangles import Descriptors, build_descriptors
from sgtd_tpu_torch.graph.types import SemanticGraph

# Frames per descriptor-build call.
BUILD_CHUNK = 32


def build_descriptors_chunked(
    batch: SemanticGraph, config: SGTDConfig, chunk: int = BUILD_CHUNK
) -> Descriptors:
    """Descriptors of a stacked graph batch, ``chunk`` frames per
    :func:`build_descriptors` call, so the build's working memory is
    bounded by the chunk at any map size. Equal to one unchunked call.
    (The reference pads the tail chunk to reuse one compiled program;
    eager calls need no padding.)"""
    n = batch.centers.shape[0]
    outs = [
        build_descriptors(SemanticGraph(*(x[i : i + chunk] for x in batch)), config.desc, config.caps)
        for i in range(0, n, chunk)
    ]
    return Descriptors(*(torch.cat(xs) for xs in zip(*outs)))
