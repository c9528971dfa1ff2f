"""Runtime configuration of the PyTorch + CUDA engine.

Device choice is explicit.  The GPU engine runs its kernels on ``cuda``;
the CPU runs their plain PyTorch versions only when the caller asks for
it, through a ``device="cpu"`` argument or ``SEQALIGN_TORCH_DEVICE=cpu``
(what the CPU tests set).  Nothing falls back to the CPU on its own: a
``-g`` request on a host without a usable CUDA device fails with the
reference's MEM_ERROR (see ``api.align_gpu``).
"""

from __future__ import annotations

import os

DEVICE_ENV = "SEQALIGN_TORCH_DEVICE"


def device() -> str:
    """The device of the GPU engine: ``"cuda"`` unless
    ``SEQALIGN_TORCH_DEVICE`` names another torch device (``"cpu"``)."""
    return os.environ.get(DEVICE_ENV, "").strip().lower() or "cuda"


def available_host_bytes() -> int | None:
    """Measured available host RAM (None if unknown) — caps the budget
    of direction words brought to the host (the reference's analog is
    initMemory's free-VRAM query, alignSequenceGPU.cu:372-393)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_dirs_budget() -> int:
    """Budget for direction words brought to host RAM by the wavefront
    route: MAX_HOST_DIRS_BYTES, capped at half the available memory."""
    budget = MAX_HOST_DIRS_BYTES
    avail = available_host_bytes()
    if avail is not None:
        budget = min(budget, avail // 2)
    return budget


# Pairs whose skewed direction words exceed this budget leave the
# wavefront route (fill on the device, words to the host, native walk)
# for the direct route (fill and walk on the device, only the moves come
# back).  Same name and default as the JAX package.
MAX_HOST_DIRS_BYTES = int(
    os.environ.get("SEQALIGN_MAX_HOST_DIRS_BYTES", 8 * 1024**2)
)
