"""The hand-written CUDA kernels of the port and their launch counts.

``csrc/`` holds one CUDA C++ source per kernel (for ``sm_90a``); ``build``
compiles them with ``nvcc`` into ``build/kernels/`` at first use and launches
them through ``ctypes``. The PyTorch-facing wrappers, with the plain
versions beside them, are in ``albedo_tpu_torch.ops``.

``LAUNCHES[name]`` counts the launches of each kernel in this process, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

from albedo_tpu_torch.kernels.build import LAUNCHES

__all__ = ["LAUNCHES", "reset_launches"]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
