"""JAX-compatible threefry2x32 stream: split, random bits, uniform, bernoulli.

The reference package draws every random number with ``jax.random`` under
``jax_threefry_partitionable=True`` and the ``threefry2x32`` impl.  Parity
with it needs the same stream, so the port reproduces that generator bit
for bit instead of using a ``torch.Generator`` (jax ``_src/prng.py``:
``threefry_2x32`` :1092, ``_threefry_split_foldlike`` :1156,
``_threefry_random_bits_partitionable`` :1184; ``_src/random.py``:
``_uniform`` :435, ``_randint`` :581, ``_bernoulli`` :1075).

A key is the raw ``uint32[2]`` pair, held as an int64 tensor of two
values in [0, 2^32).  The counter of element ``i`` of a draw of any shape
is its row-major flat index split as (hi, lo) 32-bit words; a 32-bit
draw is ``bits1 ^ bits2`` of the hash.

The plain versions below compute in int64 masked to 32 bits (torch's
uint32 support on the CPU lacks add and shifts).  `split` on a CUDA key
launches kernel **K4a** (``csrc/prng.cu``); the per-element draws of the
main path run inside kernel K4b (`workloads.ycsb.generate`), which holds
the same hash in ``csrc/threefry.cuh``.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch import kernels

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

K4_SPLIT = kernels.Kernel("dt_threefry_split", [
    kernels.P, kernels.I32, kernels.P, kernels.P])


def key_from_seed(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: [0, seed mod 2^32]."""
    if not -2**31 <= seed < 2**31:
        raise ValueError("seed must fit int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of counters (x0, x1) under key
    (k0, k1); every operand and result in [0, 2^32) as int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """Plain ``jax.random.split(key, num)``: int64[num, 2]."""
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b0, b1], dim=1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> int64[num, 2].  CPU keys take the
    plain version; CUDA keys launch K4a."""
    if kernels.on_cpu(key):
        return split_plain(key, num)
    kernels.check("key", key, torch.int64, (2,))
    out = torch.empty((num, 2), dtype=torch.int64, device=key.device)
    K4_SPLIT.launch(kernels.ptr(key), num, kernels.ptr(out),
                    kernels.stream(key))
    return out


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32-bit draws (``jax.random.bits`` uint32), int64 in [0, 2^32)."""
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return (b0 ^ b1).reshape(shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): mantissa bits under exponent 0, minus one."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``."""
    return bits_to_uniform(random_bits(key, shape))


def bernoulli(key: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform < float32(p)."""
    pf = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < pf


def randint(key: torch.Tensor, shape: tuple, lo: int, hi: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi, int32)`` for
    ``0 <= lo``, ``hi < 2^31``: two 32-bit draws from ``split(key)``
    folded into ``[lo, hi)`` by remainders in wrapping uint32 arithmetic,
    the multiplier ``(2^16 % span)^2 % span`` included (it wraps to 0
    once span exceeds 2^16)."""
    k = split_plain(key, 2)
    higher, lower = random_bits(k[0], shape), random_bits(k[1], shape)
    span = hi - lo if hi > lo else 1
    mult = (65536 % span) ** 2 & MASK32
    mult %= span
    off = (((higher % span) * mult & MASK32) + lower % span) & MASK32
    return (lo + off % span).to(torch.int32)
