"""Kernels (B1-B8, K1-K3, each beside its plain PyTorch version) and
small linear algebra; the wrappers' launch counters."""

import importlib

# (module, counter) of every kernel's wrapper, in B1-B8, K1-K3 order: each
# wrapper adds one where it launches its kernel, and nowhere else.
COUNTERS = (
    ("probe", "LAUNCHES"), ("expand", "LAUNCHES"), ("verify", "LAUNCHES"),
    ("nn", "NN1_LAUNCHES"), ("nn", "KNN_LAUNCHES"), ("probe", "WIDE_LAUNCHES"),
    ("gicp", "LINEARIZE_LAUNCHES"), ("probe", "GATHER_LAUNCHES"),
    ("kabsch", "LAUNCHES"), ("kabsch", "EPILOGUE_LAUNCHES"), ("grouped", "LAUNCHES"),
)


def _module(name: str):
    return importlib.import_module(f"sgtd_tpu_torch.ops.{name}")


def launch_counts() -> list:
    """Every kernel's launches since the last reset, B1-B8, K1-K3."""
    return [getattr(_module(m), a) for m, a in COUNTERS]


def reset_launch_counts() -> None:
    for m, a in COUNTERS:
        setattr(_module(m), a, 0)
