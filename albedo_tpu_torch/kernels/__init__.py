"""The hand-written CUDA kernels of the port and their launch counts.

``csrc/`` holds one CUDA C++ source per kernel (for ``sm_90a``; a source
may also export a kernel's variants, ``build.ENTRIES``); ``build``
compiles them with ``nvcc`` into ``build/kernels/`` at first use and launches
them through ``ctypes``. The PyTorch-facing wrappers, with the plain
versions beside them, are in ``albedo_tpu_torch.ops``.

``LAUNCHES[name]`` counts the launches of each kernel that the card ran in
this process, so a run can show that its main path went through the
kernels; a CUDA graph's launches count once for each replay
(``build.LaunchRecord``).
"""

from __future__ import annotations

from albedo_tpu_torch.kernels.build import LAUNCHES, LAUNCHES_LOCK

__all__ = ["LAUNCHES", "launch_counts", "reset_launches"]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    """A consistent copy of every kernel's launch count."""
    with LAUNCHES_LOCK:
        return dict(LAUNCHES)
