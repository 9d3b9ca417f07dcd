"""sgtd_tpu_torch — the PyTorch/CUDA port of ``sgtd_tpu`` for NVIDIA Hopper.

Module paths mirror ``sgtd_tpu`` so each counterpart is easy to find. The
port imports torch and numpy and never JAX; the only module of
``sgtd_tpu`` it shares is the plain-dataclass configuration
(``sgtd_tpu.config``), so both packages take one config type.

Every stage carries a leading query (or frame) axis in place of the
reference's ``vmap``. Where the reference calls a Pallas kernel, the port
dispatches on the tensors' device: a CUDA tensor launches the hand-written
Hopper kernel (``csrc/``), a CPU tensor takes the kernel's plain PyTorch
version (``ops/``).
"""

from sgtd_tpu_torch.config import DEFAULT_CONFIG, SGTDConfig  # noqa: F401

__version__ = "0.1.0"
