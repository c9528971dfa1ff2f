"""Top-level alignment API: request -> engine dispatch -> response.

Equivalent of the reference's engine entry points (reference:
alignSequenceCPU.cpp:287-333, alignSequenceGPU.cu:463-653):
``Device.CPU`` runs the native C++ oracle; ``Device.GPU`` runs the CUDA
engine (K1 fill and K2 walk, ``ops/``) followed by the native emitter or
traceback on the host.  Both produce byte-identical alignments.
"""

from __future__ import annotations

import sys
from typing import TextIO

import numpy as np

from . import constants, tracing
from .constants import AlignmentType, Device
from .types import Request, Response


def _indices_to_letters(indices: np.ndarray, alphabet: tuple[str, ...]) -> str:
    table = np.frombuffer(
        "".join(alphabet).encode("latin-1"), dtype=np.uint8
    )
    return table[indices].tobytes().decode("latin-1")


def _algo_code(alignment_type: AlignmentType) -> int:
    if alignment_type is AlignmentType.GLOBAL:
        return 0
    if alignment_type is AlignmentType.SEMI_GLOBAL:
        return 2
    return 1


def _respond(response: Response, request: Request, text_idx, pat_idx,
             start_t: int, start_p: int, score: int) -> None:
    response.aligned_text = _indices_to_letters(text_idx, request.alphabet)
    response.aligned_pattern = _indices_to_letters(pat_idx, request.alphabet)
    response.start_in_aligned_text = start_t
    response.start_in_aligned_pattern = start_p
    response.score = score


def align_cpu(request: Request, response: Response,
              err: TextIO = sys.stderr) -> int:
    """Native oracle engine (the reference's CPU path; affine gap costs
    when request.gap_extend is set — an extension)."""
    from .native import bindings

    algo = _algo_code(request.alignment_type)
    args = (algo, request.text, request.pattern, request.score_matrix,
            request.alphabet_size, request.gap_penalty)
    try:
        if request.gap_extend is not None:
            result = bindings.oracle_align_affine(*args, request.gap_extend)
        else:
            result = bindings.oracle_align(*args)
    except MemoryError:
        err.write(constants.MEM_ERROR)
        return 1
    _respond(response, request, *result)
    return 0


def _device_unusable(message: str) -> bool:
    """Whether an engine's RuntimeError says the device ran out of memory
    or cannot be used: torch's untyped "CUDA error: out of memory", a
    kernel launch's ``cudaErrorMemoryAllocation``, CUDA's "busy or
    unavailable" and ``cudaErrorDevicesUnavailable``, and the strings the
    JAX package maps (its api.py), "RESOURCE_EXHAUSTED" and "Unable to
    initialize backend"."""
    lower = message.lower()
    return ("out of memory" in lower or "unavailable" in lower
            or "cudaErrorMemoryAllocation" in message
            or "RESOURCE_EXHAUSTED" in message
            or "Unable to initialize backend" in message)


def align_gpu(request: Request, response: Response,
              err: TextIO = sys.stderr) -> int:
    """CUDA engine on ``config.device()``: linear gap costs, or affine
    (Gotoh) ones when request.gap_extend is set, in every mode.

    A host without a usable CUDA device, a device allocation failure,
    and a RuntimeError that says the device is out of memory or
    unavailable (``_device_unusable``) print the reference's MEM_ERROR
    (on a no-GPU host the reference's cudaMallocs fail and it prints
    MEM_ERROR, alignSequenceGPU.cu:502-546); any other RuntimeError
    propagates.  Matrices with |score| > 127 print ``error: ...``.  All
    exit 1.
    """
    import torch

    from . import config
    from .models import aligner_for

    device = config.device()
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        err.write(constants.MEM_ERROR)
        return 1
    try:
        result = aligner_for(request.alignment_type).align(
            request.text, request.pattern, request.score_matrix,
            request.alphabet_size, request.gap_penalty,
            gap_extend=request.gap_extend, device=device,
        )
    except (MemoryError, torch.cuda.OutOfMemoryError):
        err.write(constants.MEM_ERROR)
        return 1
    except ValueError as e:
        err.write(f"error: {e}\n")
        return 1
    except RuntimeError as e:
        if not _device_unusable(str(e)):
            raise
        err.write(constants.MEM_ERROR)
        return 1
    _respond(response, request, result.aligned_text, result.aligned_pattern,
             result.start_in_aligned_text, result.start_in_aligned_pattern,
             result.score)
    return 0


def align(request: Request, response: Response,
          err: TextIO = sys.stderr) -> int:
    """Runtime dispatch on the request's device (mainDriver.cu:18-21),
    in the request's root span ``api.align`` (``tracing``)."""
    with tracing.span("api.align"):
        tracing.annotate("route", "other")
        if request.device_type is Device.CPU:
            return align_cpu(request, response, err=err)
        return align_gpu(request, response, err=err)
