"""P2: packed int16 (s16x2) operations on Hopper, exactness and rate.

The counterpart of the JAX package's ``scripts/mosaic_micro_probe.py``,
which asked Mosaic, for each int16 op pattern of the int16 cell mode,
whether a TPU lowers it (``MICRO_OK`` / ``MICRO_FAIL``).  On the card
every pattern compiles, so this probe asks what decides the design of
the int16 kernel (``csrc/interpair16.cu``): for each pattern of that
probe, and for each DPX intrinsic the kernel may use, whether the
packed formulation is exact and how fast it runs beside its int32
counterpart.

A word holds two int16 lanes, the low half first (a little-endian
``view(torch.int16)`` of an int32 tensor).  ``apply`` runs a variant on
every word of three word tensors: the kernel (``csrc/probe_dpx16.cu``)
for CUDA tensors, ``apply_plain`` (the same expression in torch.int16
arithmetic, wrapping like jax.numpy's) for CPU ones.  ``run`` holds
every variant's kernel against its plain version on 2^24 random words
and times its rate kernel; ``python -m seqalign_torch.probes.dpx16``
prints one line a variant:

    DPX16_OK <name> <Gop/s> Gop/s (int32 <name32>: <Gop/s> Gop/s)
    DPX16_FAIL <name> <reason>

With ``--sass`` it also counts, from ``cuobjdump -sass`` of the built
library, the instructions of each rate kernel's loop
(``DPX16_SASS <name> <instructions an op> (...)``), which says whether a
rate is that of one instruction an op.

A Gop/s is 10^9 results a second: two a packed word, one an int32.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops._build import build, check_launch, library, nvcc


def _i32(x):
    return x.int()


# (name, plain expression of int16 tensors, int32 counterpart); the order
# is the kernel's variant number.
VARIANTS16 = (
    ("cmp16", lambda a, b, c: torch.where(a > b, a, b + 1), "sel32"),
    ("cmp32_sel16",
     lambda a, b, c: torch.where(_i32(a) > _i32(b), a, b + 1), "sel32"),
    ("cmp16_to_val", lambda a, b, c: (a > b).to(a.dtype) + b, "cmp32"),
    ("cmp32_to_val16",
     lambda a, b, c: (_i32(a) > _i32(b)).to(a.dtype) + b, "cmp32"),
    ("cmp32_val32_narrow",
     lambda a, b, c: (_i32(a) > _i32(b)).int().to(a.dtype) + b, "cmp32"),
    ("max16", lambda a, b, c: torch.maximum(a, b - 1), "max32"),
    ("shr16_var", lambda a, b, c: (a >> (b & 7)) & 0xFF, "shr32_var"),
    ("eq16_arith",
     lambda a, b, c: 1 - torch.abs(a - b).clamp_max(1), "eq32_arith"),
    ("ext_narrow", lambda a, b, c: (_i32(a) + _i32(b)).to(a.dtype),
     "add32"),
    ("add16", lambda a, b, c: a + b, "add32"),
    ("sub16", lambda a, b, c: a - b, "sub32"),
    ("mul16", lambda a, b, c: a * b, "mul32"),
    ("or16", lambda a, b, c: a | b, "or32"),
    ("shl16_const", lambda a, b, c: (a << 1) + b, "shl32_const"),
    ("min16", lambda a, b, c: torch.minimum(a, b - 1), "min32"),
    ("cmp16_zero", lambda a, b, c: torch.where(a > 0, a, b), "sel32_zero"),
    # The DPX intrinsics (__vimax3_s16x2, __viaddmax_s16x2 and its _relu
    # form, __vibmax_s16x2's max and a >= b predicates,
    # __vimax_s16x2_relu), and add.s16x2 written as one PTX instruction.
    ("vimax3", lambda a, b, c: torch.maximum(torch.maximum(a, b), c),
     "vimax3_s32"),
    ("viaddmax", lambda a, b, c: torch.maximum(a + b, c), "viaddmax_s32"),
    ("viaddmax_relu",
     lambda a, b, c: torch.maximum(a + b, c).clamp_min(0),
     "viaddmax_s32_relu"),
    ("vibmax", lambda a, b, c: torch.maximum(a, b) + (a >= b).to(a.dtype),
     "vibmax_s32"),
    ("vimax_relu", lambda a, b, c: torch.maximum(a, b).clamp_min(0),
     "vimax_s32_relu"),
    ("add16_asm", lambda a, b, c: a + b, "add32"),
)

# (name, plain expression of int32 tensors); the kernel's op32 order.
VARIANTS32 = (
    ("sel32", lambda a, b, c: torch.where(a > b, a, b + 1)),
    ("cmp32", lambda a, b, c: (a > b).to(a.dtype) + b),
    ("max32", lambda a, b, c: torch.maximum(a, b - 1)),
    ("shr32_var", lambda a, b, c: (a >> (b & 7)) & 0xFF),
    ("eq32_arith", lambda a, b, c: 1 - torch.abs(a - b).clamp_max(1)),
    ("add32", lambda a, b, c: a + b),
    ("sub32", lambda a, b, c: a - b),
    ("mul32", lambda a, b, c: a * b),
    ("or32", lambda a, b, c: a | b),
    ("shl32_const", lambda a, b, c: (a << 1) + b),
    ("min32", lambda a, b, c: torch.minimum(a, b - 1)),
    ("sel32_zero", lambda a, b, c: torch.where(a > 0, a, b)),
    ("vimax3_s32", lambda a, b, c: torch.maximum(torch.maximum(a, b), c)),
    ("viaddmax_s32", lambda a, b, c: torch.maximum(a + b, c)),
    ("viaddmax_s32_relu",
     lambda a, b, c: torch.maximum(a + b, c).clamp_min(0)),
    ("vibmax_s32",
     lambda a, b, c: torch.maximum(a, b) + (a >= b).to(a.dtype)),
    ("vimax_s32_relu", lambda a, b, c: torch.maximum(a, b).clamp_min(0)),
)

_INDEX = {name: (1, v) for v, (name, *_) in enumerate(VARIANTS16)}
_INDEX.update({name: (0, v) for v, (name, _) in enumerate(VARIANTS32)})
_PLAIN = {name: fn for name, fn, *_ in VARIANTS16 + VARIANTS32}
THREADS = 256   # a block of either kernel
CHAINS = 8      # chains a thread of the rate kernel
UNROLL = 4      # rounds in the rate kernel's unrolled loop body
WORDS = 1 << 24  # words of the exactness check on the card
RATE_REPS = 8192  # rounds of a timed rate launch


def _lanes(name: str) -> int:
    return 2 if _INDEX[name][0] else 1


def _check(name, *words):
    if name not in _INDEX:
        raise ValueError(f"unknown variant {name!r}")
    a = words[0]
    for x in words:
        if (x.dtype != torch.int32 or x.dim() != 1 or x.device != a.device
                or x.shape != a.shape or not x.is_contiguous()):
            raise ValueError("words must be contiguous 1-D int32 tensors of "
                             "one shape on one device")
    if a.numel() < 1:
        raise ValueError("no words")


def apply_plain(name, a, b, c):
    """Variant ``name`` on every word, in plain torch arithmetic (int16
    lanes for the packed variants), on the words' device."""
    _check(name, a, b, c)
    fn = _PLAIN[name]
    if _INDEX[name][0]:
        out = fn(a.view(torch.int16), b.view(torch.int16),
                 c.view(torch.int16))
        return out.to(torch.int16).view(torch.int32)
    return fn(a, b, c).to(torch.int32)


def _kernel():
    fn = library("probe_dpx16").sa_probe_dpx16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, p, p, p, p, ctypes.c_int64, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, which, a, b, c, out, blocks, reps):
    int16, v = _INDEX[name]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _kernel()(int16, v, which, a.data_ptr(), b.data_ptr(),
                       c.data_ptr(), out.data_ptr(), a.numel(), blocks, reps,
                       stream)
    check_launch("probe_dpx16", rc)


def apply(name, a, b, c):
    """Variant ``name`` on every word of the (n,) int32 word tensors a, b
    and c: the apply kernel for CUDA tensors (counted in
    ``apply.launches``), ``apply_plain`` for CPU ones."""
    _check(name, a, b, c)
    if a.device.type == "cpu":
        return apply_plain(name, a, b, c)
    out = torch.empty_like(a)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    blocks = min(-(-a.numel() // THREADS), 8 * sms)
    _launch(name, 0, a, b, c, out, blocks, 0)
    apply.launches += 1
    return out


apply.launches = 0


def rate_plain(name, words, threads, reps):
    """What the rate kernel leaves for ``threads`` threads after ``reps``
    rounds: thread t starts chain k at words[(3t + k) % n] ^
    (0x9E3779B9 * k); in a round, chain k (in order of k) becomes the op
    of itself and chains k + 1 and k + 2 (mod CHAINS, as they stand);
    the thread writes the xor of its chains."""
    _check(name, words)
    n = words.numel()
    t = torch.arange(threads, device=words.device) * 3
    x = []
    for k in range(CHAINS):
        salt = ((0x9E3779B9 * k + (1 << 31)) % (1 << 32)) - (1 << 31)
        x.append(words[(t + k) % n] ^ salt)
    for _ in range(reps):
        for k in range(CHAINS):
            x[k] = apply_plain(name, x[k], x[(k + 1) % CHAINS],
                               x[(k + 2) % CHAINS])
    folded = torch.zeros(threads, dtype=torch.int32, device=words.device)
    for chain in x:
        folded ^= chain
    return folded


def rate_launch(name, words, blocks, reps):
    """The rate kernel of variant ``name`` on CUDA words, ready to launch:
    returns (launch, out); each ``launch()`` runs ``blocks`` blocks of
    THREADS threads, ``reps`` rounds of one op on each of CHAINS chains a
    thread, and counts in ``rate_launch.launches``."""
    _check(name, words)
    if words.device.type != "cuda":
        raise ValueError("the rate kernel runs on a CUDA device")
    out = torch.empty(blocks * THREADS, dtype=torch.int32,
                      device=words.device)

    def launch():
        _launch(name, 1, words, words, words, out, blocks, reps)
        rate_launch.launches += 1

    return launch, out


rate_launch.launches = 0


def ops_of(name, blocks, reps):
    """Results one rate launch computes: threads x reps x CHAINS ops, two
    results a packed op."""
    return blocks * THREADS * reps * CHAINS * _lanes(name)


def random_words(n, seed, device):
    """(n,) int32 words of uniform random bits, from a numpy seed."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(bits.view(np.int32)).to(device)


def _ms(launch, reps=3):
    """Least milliseconds of ``reps`` launches between CUDA events."""
    best = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        best = ms if best is None else min(best, ms)
    return best


def run(words=WORDS, seed=0, rate_reps=RATE_REPS, device="cuda"):
    """Every variant on the card: the apply kernel against the plain
    version on ``words`` random words, the rate kernel against its plain
    version on a few reps, and the rate kernel timed.  Returns one dict a
    variant (int16 ones first): name, exact, bad (lanes that differ),
    detail, apply_ms (CUDA events, best of 3), plain_ms, gops."""
    a, b, c = (random_words(words, seed + s, device) for s in range(3))
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    blocks = 8 * sms  # 2,048 threads an SM
    out = []
    for name in [v[0] for v in VARIANTS16] + [v[0] for v in VARIANTS32]:
        got = apply(name, a, b, c)
        torch.cuda.synchronize()
        apply_ms = _ms(lambda: apply(name, a, b, c))
        plain_ms = _ms(lambda: apply_plain(name, a, b, c), reps=1)
        want = apply_plain(name, a, b, c)
        lane = torch.int16 if _lanes(name) == 2 else torch.int32
        diff = got.view(lane) != want.view(lane)
        bad = int(diff.sum())
        detail = ""
        if bad:
            at = int(diff.nonzero()[0, 0])
            detail = (f"{bad} of {diff.numel()} lanes differ from the "
                      f"plain version (lane {at}: got "
                      f"{int(got.view(lane)[at])}, want "
                      f"{int(want.view(lane)[at])})")
        # The rate kernel computes the op: a short launch against its
        # plain version (a small grid, the plain version steps a rep).
        launch, short = rate_launch(name, a, 4, 16)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(short, rate_plain(name, a, 4 * THREADS, 16)):
            detail = detail or "the rate kernel differs from its plain version"
            bad = bad or 1
        launch, _ = rate_launch(name, a, blocks, rate_reps)
        launch()  # warm
        ms = _ms(launch)
        out.append({"name": name, "exact": bad == 0, "bad": bad,
                    "detail": detail, "apply_ms": apply_ms,
                    "plain_ms": plain_ms, "words": words,
                    "gops": ops_of(name, blocks, rate_reps) / ms / 1e6,
                    "rate_ms": ms})
    return out


def report(results):
    """The DPX16_OK / DPX16_FAIL lines of ``run``'s int16 variants, each
    beside its int32 counterpart's rate."""
    by_name = {r["name"]: r for r in results}
    lines = []
    for name, _, name32 in VARIANTS16:
        r = by_name[name]
        r32 = by_name[name32]
        if r["exact"]:
            lines.append(f"DPX16_OK {name} {r['gops']:.1f} Gop/s (int32 "
                         f"{name32}: {r32['gops']:.1f} Gop/s)")
        else:
            lines.append(f"DPX16_FAIL {name} {r['detail']}")
    for name, _ in VARIANTS32:
        r = by_name[name]
        if not r["exact"]:
            lines.append(f"DPX16_FAIL {name} {r['detail']}")
    return lines


_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                          r"([A-Z][A-Za-z0-9_.]*)([^;]*);")
_RATE = re.compile(r"rate_kernelILi(\d+)ELb(\d)E")


def loop_code(sass):
    """The instructions of the largest loop in one function's ``cuobjdump
    -sass`` text (from a backward branch's target to the branch): a list
    of (address, predicated, opcode, branch target or None)."""
    code = []
    for at, pred, opcode, operands in _INSTRUCTION.findall(sass):
        target = re.search(r"0x([0-9a-f]+)", operands)
        code.append((int(at, 16), bool(pred), opcode,
                     int(target[1], 16) if opcode.startswith("BRA")
                     and target else None))
    best = None
    for at, _, _, target in code:
        if target is not None and target < at and (
                best is None or at - target > best[1] - best[0]):
            best = (target, at)
    if best is None:
        return []
    return [x for x in code if best[0] <= x[0] <= best[1]]


def loop_body(sass):
    """The opcodes of ``loop_code(sass)``, predicates dropped."""
    return [opcode for _, _, opcode, _ in loop_code(sass)]


def sass_counts(path=None):
    """For each variant, the instructions of its rate kernel's unrolled
    loop, from ``cuobjdump -sass`` of the built P2 library: name ->
    (ops in the body, {opcode: count}).  The body holds UNROLL x CHAINS
    ops and the loop's own counter, compare and branch."""
    path = path or build("probe_dpx16")
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    parts = _FUNCTION.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        which = _RATE.search(name)
        if not which:
            continue
        v, int16 = int(which[1]), int(which[2])
        variant = (VARIANTS16 if int16 else VARIANTS32)[v][0]
        opcodes = {}
        for opcode in loop_body(body):
            opcodes[opcode] = opcodes.get(opcode, 0) + 1
        counts[variant] = (UNROLL * CHAINS, opcodes)
    return counts


def sass_report(counts):
    """One ``DPX16_SASS <name> <instructions an op> (...)`` line a
    variant: the loop body's instructions over its ops, and the body's
    opcodes by count."""
    lines = []
    for name in [v[0] for v in VARIANTS16] + [v[0] for v in VARIANTS32]:
        ops, opcodes = counts[name]
        total = sum(opcodes.values())
        mix = ", ".join(f"{op} {n}" for op, n in sorted(
            opcodes.items(), key=lambda item: (-item[1], item[0])))
        lines.append(f"DPX16_SASS {name} {total / ops:.3f} ({total} "
                     f"instructions for {ops} ops: {mix})")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m seqalign_torch.probes.dpx16",
        description="P2: packed int16 operations on the card, exactness "
                    "and rate.")
    parser.add_argument("--sass", action="store_true",
                        help="also count each rate kernel's loop "
                             "instructions (cuobjdump -sass)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("dpx16: no CUDA device", file=sys.stderr)
        return 1
    for line in report(run()):
        print(line, flush=True)
    if args.sass:
        for line in sass_report(sass_counts()):
            print(line, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
