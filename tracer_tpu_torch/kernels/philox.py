"""Philox4x32-10 counter-based random numbers in plain torch.

The CUDA bounce kernels (csrc/bounce.cu) draw their uniforms from the same
generator with the same keying, so a kernel and its plain PyTorch version
consume identical random numbers and can be compared lane by lane. This
takes the place of the TPU's per-core PRNG (``pltpu.prng_random_bits``),
whose bits cannot be reproduced here.

Keying used by the bounce kernels: key = (round seed, stream), counter =
(lane within the tile, draw call, 0, 0). Each call yields four 32-bit
words: call 0 feeds the source regeneration (four uniforms), call 1 the
slope-error epilogue, call 2 the Lambertian lobe, call 3 the
wavelength drawn from a source band, call 4 the Fresnel roulette of a
refractive interface and call 5 a participating medium's free path, HG
polar angle and azimuth. Each draw has its own call, so adding one never
shifts another. The arithmetic runs in int64 so every product
of two 32-bit words stays exact.
"""
from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

# draw-call indices of the bounce kernels
CALL_REGEN = 0
CALL_SLOPE = 1
CALL_LAMBERT = 2
CALL_BAND = 3
CALL_FRESNEL = 4
CALL_SCATTER = 5


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for uint32 values held in int64,
    without an int64 overflow: x is split into 16-bit halves."""
    x_lo = x & 0xFFFF
    x_hi = x >> 16
    p_lo = x_lo * m                  # < 2^48
    p_hi = x_hi * m                  # < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 with ``rounds`` rounds (Random123's philox4x32_R).
    Counters are int64 tensors (or ints) holding uint32 values, keys are
    ints or int64 tensors; returns the four output words as int64
    tensors."""
    def t(v):
        return v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.int64)
    c0, c1, c2, c3 = (t(v) & _MASK32 for v in (c0, c1, c2, c3))
    k0, k1 = t(k0) & _MASK32, t(k1) & _MASK32
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(seed: int, stream, lane, call: int):
    """The four uniforms in (0, 1] of draw ``call`` for each lane:
    ``(x >> 8) * 2^-24 + 1e-12`` in float32, as the kernels compute them
    (the TPU kernels' formula, pallas_intersect.py:1376). ``stream`` and
    ``lane`` are int tensors of one shape (or ints)."""
    lane = torch.as_tensor(lane).to(torch.int64)
    stream = torch.as_tensor(stream, device=lane.device).to(torch.int64)
    words = philox4x32(lane, torch.full_like(lane, call), 0, 0,
                       int(seed), stream)
    return tuple((w >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
                 for w in words)
