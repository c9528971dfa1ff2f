"""Host-side layouts of the kernels' inputs.

The port keeps the JAX package's layouts at the kernels' interfaces, so
the same numpy arrays can be handed to both packages:

* ``text_steps`` / ``bottom_in``: (num_blocks, STEPS) int32 — the text
  letter and the strip's top-row value H[i0, t+1] of each sweep step t;
* ``pattern_slots``: (rps, slots/128, 128) int32 — entry (r, su, la) is
  the letter of DP row i0 + rps*(su*128+la) + r + 1;
* the substitution matrix: (k, k) int32.  The CUDA kernel reads it as it
  is (no biased byte planes), but the |score| <= 127 contract of the
  JAX engines stays, so both packages accept and refuse the same input.
"""

from __future__ import annotations

import numpy as np
import torch

STEPS = 256  # sweep steps per block of the text and top-row streams


def pack_score_matrix(score_matrix, k_alpha: int) -> np.ndarray:
    """The (k, k) int32 substitution matrix of the GPU engine.  Raises
    ValueError if any |score| > 127 (the engines' contract)."""
    sm = np.asarray(score_matrix).reshape(-1)[: k_alpha * k_alpha]
    sm = sm.astype(np.int64).reshape(k_alpha, k_alpha)
    if np.abs(sm).max(initial=0) > 127:
        raise ValueError(
            "GPU engines require substitution scores in [-127, 127]; "
            "use the CPU engine for larger magnitudes"
        )
    return np.ascontiguousarray(sm.astype(np.int32))


def padded_width(n: int) -> int:
    """Padded DP-row width, the leading gap column included: the JAX
    package's ``scan_engine.padded_width``, which sizes the score
    buckets of ``BatchAligner``."""
    return max(128, -(-(n + 1) // 128) * 128)


def padded_rows(m: int) -> int:
    """Padded pattern-row count, the gap row excluded (the JAX package's
    ``scan_engine.padded_rows``)."""
    return max(128, -(-m // 128) * 128)


def steps_padded(n: int, slots: int) -> int:
    """Sweep steps of a strip over a text of n letters: n + slots - 1,
    rounded up to whole blocks of STEPS."""
    return -(-(n + slots - 1) // STEPS) * STEPS


def text_steps(text: np.ndarray, steps_pad: int) -> np.ndarray:
    """(steps_pad/STEPS, STEPS) int32: the text, zero-padded."""
    out = np.zeros(steps_pad, dtype=np.int32)
    out[: text.shape[0]] = text
    return out.reshape(-1, STEPS)


def top_row(steps: int, gap: int, zero: bool, device,
            ext: int | None = None) -> torch.Tensor:
    """(steps/STEPS, STEPS) int32 top boundary row H[0, t+1] of strip 0:
    zeros (local, semi-global), -gap*(t+1) (global), or with an affine
    extend cost ``ext`` -(gap + ext*t) (global; gap the open cost)."""
    if zero:
        row = torch.zeros(steps, dtype=torch.int32, device=device)
    elif ext is not None:
        row = (-(gap + ext * torch.arange(steps, device=device))).to(
            torch.int32)
    else:
        row = (-gap * (torch.arange(steps, device=device) + 1)).to(
            torch.int32)
    return row.reshape(-1, STEPS)


def pattern_slots(pattern_rows: np.ndarray, rps: int,
                  slots: int) -> np.ndarray:
    """(rps, slots/128, 128) int32 from the rps*slots pattern letters of
    one strip (zero-padded by the caller)."""
    chunk = np.asarray(pattern_rows, dtype=np.int32).reshape(slots, rps)
    return np.ascontiguousarray(chunk.T).reshape(rps, slots // 128, 128)


def from_reference_arrays(text_steps, bottom_in, pattern_slots,
                          score_matrix, k_alpha: int, device):
    """The JAX wrappers' numpy inputs -> the port's tensors on
    ``device``: (text_steps, bottom_in, pattern_slots, score_matrix),
    int32 and contiguous, in the same layouts (the score matrix cut to
    (k, k) and checked against the |score| <= 127 contract)."""
    def as_tensor(x):
        return torch.as_tensor(
            np.ascontiguousarray(np.asarray(x, dtype=np.int32))
        ).to(device)

    return (
        as_tensor(text_steps),
        as_tensor(bottom_in),
        as_tensor(pattern_slots),
        as_tensor(pack_score_matrix(score_matrix, k_alpha)),
    )
