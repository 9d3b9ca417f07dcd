"""Seconds to load and bind the kernel library, without nvcc's build (the program's ``ops.load`` process record); moves setup_s."""

from portbench.spans import kernel_load_s as read  # noqa: F401
