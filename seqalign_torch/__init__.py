"""seqalign_torch — the PyTorch + CUDA port of seqalign_tpu.

Pairwise alignment of DNA and protein sequences — global
(Needleman-Wunsch), local (Smith-Waterman) and semi-global ("fit") with
linear gap penalties — on an NVIDIA Hopper GPU, byte-identical to the
native C++ oracle.  The fill (K1, ``csrc/wavefront.cu``) and the
traceback walk (K2, ``csrc/walk.cu``) are CUDA kernels built with
``nvcc`` on first use; each has a plain PyTorch version that runs when
its inputs lie on the CPU.
"""

from . import constants
from .api import align, align_cpu, align_gpu
from .cli import main, parse_arguments
from .constants import AlignmentType, Device, SequenceType
from .pretty import pretty_alignment_print
from .types import Request, Response

__version__ = "0.1.0"

__all__ = [
    "align",
    "align_cpu",
    "align_gpu",
    "AlignmentType",
    "constants",
    "Device",
    "main",
    "parse_arguments",
    "pretty_alignment_print",
    "Request",
    "Response",
    "SequenceType",
]
