"""Counter-based random numbers equal to ``jax.random``'s (the port's explicit
random generator).

The JAX package draws its RANSAC hypotheses from ``jax.random.PRNGKey(seed)``,
``jax.random.gumbel`` and ``lax.top_k`` (``solvers/ransac.py:61-68``,
``solvers/epnp.py:215-218``) with a seed fixed per frame and candidate
(``pipeline/system.py:459``). ``torch.Generator`` (Philox) would draw other
hypotheses, so this module reproduces JAX's generator bit for bit:

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds (``jax/_src/prng.py::
  _threefry2x32_lowering``);
- ``random_bits``: the partitionable layout JAX uses (``jax_threefry_partitionable``
  on): counter ``i`` of a flat index is the pair (i >> 32, i & 0xffffffff),
  and the 32-bit output is ``bits1 ^ bits2``;
- ``uniform`` on [minval, 1) and ``gumbel`` (mode "low": ``-log(-log(u))`` with
  u on [tiny, 1));
- ``top_k``: the k largest along the last axis, ties to the lower index, as
  ``lax.top_k`` breaks them (a stable descending sort; ``torch.topk`` on CUDA
  does not promise the order of ties).

Integer work runs in int64 with explicit 32-bit masks: ``uint32`` tensors lack
``>>`` on the CPU. A key is a pair of words, each a Python int or a 0-d int64
tensor: a seed computed on the device (the relocalization's ``frame_id * K +
i`` from the device frame counter) gives a key on the device, and drawing
reads nothing back from the card and copies nothing to it either way.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]


def prng_key(seed: Word) -> Key:
    """``jax.random.PRNGKey(seed.astype(uint32))``: the key words (0, seed
    mod 2^32). ``seed`` is a Python int or a 0-d integer tensor (an int32
    seed that wrapped, as JAX's int32 arithmetic wraps, maps to the same
    word as the unwrapped int64 value)."""
    if isinstance(seed, torch.Tensor):
        return 0, seed.reshape(()).to(torch.int64) & MASK32
    return 0, int(seed) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the int64 counter pairs (x0, x1) under ``key``;
    int64 words in [0, 2^32). The key words broadcast: Python ints, or 0-d
    int64 tensors on the counters' device."""
    k0, k1 = key
    ks = (k0, k1, (k0 ^ k1) ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) as int64 values in [0, 2^32)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: Key, shape, minval: float = 0.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, 1.0)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled by
    f32(1 - minval) and shifted by minval, at least minval."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    return torch.clamp(f * float(np.float32(1.0) - np.float32(lo)) + lo, min=lo)


def gumbel(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, device)))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the ``k`` largest along the last axis, in
    descending order, equal values in ascending index order (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
