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


def mesh_devices(default=None) -> list[str]:
    """The devices of the default mesh (``parallel/mesh.make_data_mesh``),
    in order: the engine's device (``default``, or ``device()``) when it
    is the CPU or names one card (``cuda:1``); for ``cuda``, every visible
    CUDA device, and none when CUDA is unavailable."""
    default = str(default or device())
    if default != "cuda":
        return [default]
    import torch

    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def sequence_parallel(default=None) -> bool:
    """Whether long single pairs may take the sequence-parallel route
    (``parallel/sequence.py``), the JAX ``config.sequence_parallel``:
    ``SEQALIGN_SEQUENCE_PARALLEL`` ``1`` or ``0`` forces it; otherwise on
    when the default mesh (``mesh_devices(default)``) has more than one
    entry.  Unforced, the route also waits on its gate,
    ``sequence.estimated_speedup`` with the chunk cost measured on the
    card; no output depends on the route."""
    forced = os.environ.get("SEQALIGN_SEQUENCE_PARALLEL", "")
    if forced in ("0", "1"):
        return forced == "1"
    return len(mesh_devices(default)) > 1


def traceback_mode() -> str:
    """Where the strip engine walks its packed words: ``"host"`` (the
    native walk over words on the host, the default) or ``"device"`` (K4
    on the card; only the moves come back).  ``SEQALIGN_TRACEBACK``
    overrides, as in the JAX package."""
    forced = os.environ.get("SEQALIGN_TRACEBACK", "").lower()
    return forced if forced in ("host", "device") else "host"


def pair_engine() -> str:
    """Single-pair engine of linear-gap global and local requests:
    ``"wavefront"`` (the default: the wavefront route, the direct route
    or the checkpoint engine by size), ``"strip"`` (the strip fill, K5,
    over one region or ``ops/tiled.py``) or ``"checkpoint"``
    (the checkpoint engine for every size).  ``SEQALIGN_PAIR_ENGINE``
    overrides, as in the JAX package."""
    forced = os.environ.get("SEQALIGN_PAIR_ENGINE", "").lower()
    if forced in ("wavefront", "strip", "checkpoint"):
        return forced
    return "wavefront"


def int16_cells() -> str:
    """int16 cell mode of the batch fills (``csrc/interpair16.cu``, two DP
    cells a 32-bit register): ``"auto"`` routes each bucket that
    ``int16_cells_ok`` admits over its padded shape to the int16 kernel,
    ``"0"`` never, ``"1"`` every bucket, and refuses (ValueError) one that
    is not admitted.  ``SEQALIGN_INT16_CELLS`` in 0 / 1 / auto overrides,
    as in the JAX package; otherwise ``"0"`` (the JAX default reads a TPU
    validation marker, which says nothing of the card).  It rules the
    batch path (``BatchAligner.score``/``.align``) and the global and
    semi-global search; a local search takes int16 cells wherever
    ``batch_fill.int16_local_ok`` admits a group, whatever it says
    (``parallel/search.py``)."""
    forced = os.environ.get("SEQALIGN_INT16_CELLS", "").lower()
    return forced if forced in ("0", "1", "auto") else "0"


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


def host_dirs_budget(budget: int | None = None) -> int:
    """Budget for direction words brought to host RAM: ``budget``
    (default MAX_HOST_DIRS_BYTES, the wavefront route's), capped at half
    the available memory."""
    if budget is None:
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

# Budget of the strip engine's single-region direction words; pairs
# whose words exceed it (or half the available host memory) take the
# tiled fill (ops/tiled.py).  Same name and default as the JAX package.
MAX_DIRS_BYTES = int(
    os.environ.get("SEQALIGN_MAX_DIRS_BYTES", 4 * 1024**3)
)
