"""Counter-based RNG of the transport kernel: Threefry-2x32-20.

Counterpart of the megakernel's in-kernel generator
(montecarloscattering_jl_tpu/ops/pallas_step.py:130-172) and of the
jax.random key plumbing the JAX package derives lane keys with
(``key``, ``fold_in``, the initial gyro phase of ``init_state``).  Every
function here is bit-exact with jax 0.9.0's threefry implementation
(``jax_threefry_partitionable=True``), because the per-lane counter RNG
is an observable contract: the same (lane key, step count) gives the same
eight uniforms in both packages, which is what makes per-lane
comparisons possible.

Words are held in int64 tensors masked to 32 bits: torch's ``uint32``
has no shifts or rotates on the CPU.  Keys travel as two int32 planes
(``key0``, ``key1``: the bit patterns of the two uint32 key words), the
layout the megakernel and K1 take.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on int64 words in [0, 2^32).

    Arguments broadcast; returns the two output words as int64."""
    k0 = _u32(torch.as_tensor(k0))
    k1 = _u32(torch.as_tensor(k1))
    c0 = _u32(torch.as_tensor(c0))
    c1 = _u32(torch.as_tensor(c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK32
    return x0, x1


def to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 word in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` data for the threefry implementation:
    the 64-bit seed split into (high, low) uint32 words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & MASK32, s & MASK32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` on host key data: threefry of the counter
    (0, data) under the key."""
    y0, y1 = threefry2x32(k[0], k[1], 0, int(data) & MASK32)
    return int(y0), int(y1)


def fold_in_lanes(k: tuple[int, int], n: int, device, offset: int = 0):
    """Lane keys ``fold_in(k, offset + j)`` for j < n, as the int32
    planes (key0, key1)."""
    data = (torch.arange(n, dtype=torch.int64, device=device)
            + int(offset)) & MASK32
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(data), data)
    return to_i32(y0), to_i32(y1)


def uniforms(key0: torch.Tensor, key1: torch.Tensor,
             nsteps: torch.Tensor) -> list[torch.Tensor]:
    """The megakernel's 8 f32 uniforms of one step (``_uniforms``,
    pallas_step.py:159-172): the 16-bit halves h of the threefry words
    at counters (nsteps, 0) and (nsteps, 1), as (h + 0.5) / 2^16.
    Returns 8 tensors of nsteps' shape."""
    # both counter blocks in one threefry; `nsteps` may carry leading
    # dimensions (a block of steps) over the lane axis of the keys
    ctr = _u32(nsteps)
    word = torch.arange(2, dtype=torch.int64, device=ctr.device).view(
        2, *([1] * ctr.dim()))
    y0, y1 = threefry2x32(key0, key1, ctr[None], word)
    w = torch.stack([y0[0], y1[0], y0[1], y1[1]])      # w0, w1, w2, w3
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=1).to(torch.float32)
    u = ((halves + 0.5) * (1.0 / 65536.0)).reshape(8, *ctr.shape)
    return list(u.unbind(0))                            # u[0..7]


def lane_uniforms_xla(key0: torch.Tensor, key1: torch.Tensor,
                      nsteps: torch.Tensor) -> torch.Tensor:
    """The XLA engine's 8 f32 uniforms of one step (``_lane_uniforms``,
    ops/step.py:178-195 of the JAX package): k = fold_in(lane_key,
    nsteps), then ``jax.random.bits(k, (4,), uint32)`` -- word j is the
    xor of the two threefry words at counter (0, j) under k -- and the
    uniforms are the low halves of words 0..3 followed by their high
    halves, as (h + 0.5) / 2^16.  `nsteps` may carry leading dimensions
    (a block of steps) over the lane axis of the keys.  Returns a
    float32 tensor [8, *nsteps.shape]."""
    ctr = _u32(nsteps)
    k0, k1 = threefry2x32(key0, key1, torch.zeros_like(ctr), ctr)
    j = torch.arange(4, dtype=torch.int64, device=ctr.device).view(
        4, *([1] * ctr.dim()))
    y0, y1 = threefry2x32(k0[None], k1[None], torch.zeros_like(j), j)
    w = y0 ^ y1                                         # [4, *shape]
    halves = torch.cat([w & 0xFFFF, w >> 16]).to(torch.float32)
    return (halves + 0.5) * (1.0 / 65536.0)


def initial_phase(key0: torch.Tensor, key1: torch.Tensor) -> torch.Tensor:
    """The gyro phase ``init_state`` draws for fresh lanes
    (ops/state.py:207-211 of the JAX package): 2*pi times the float64
    ``jax.random.uniform`` of ``fold_in(lane_key, 0)``, float64."""
    k0, k1 = threefry2x32(key0, key1, torch.zeros_like(_u32(key0)),
                          torch.zeros_like(_u32(key0)))
    # jax.random.bits(64) of a scalar: the threefry of counter (0, 0),
    # high word first; uniform keeps the top 52 bits as the mantissa
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(k0),
                          torch.zeros_like(k0))
    mant = ((b0 << 20) | (b1 >> 12)) & ((1 << 52) - 1)
    u = (mant | (1023 << 52)).view(torch.float64) - 1.0
    u = torch.clamp(u, min=0.0)
    return 2.0 * math.pi * u
