"""Semantic graph subpackage."""
from sgtd_tpu_torch.graph.types import SemanticGraph, make_graph, stack_graphs  # noqa: F401
