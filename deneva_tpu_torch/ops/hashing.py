"""Key hashing into the conflict bucket space (port of ``deneva_tpu/ops/hashing.py``).

The padded RW-sets of an epoch are mapped to ``[0, n_buckets)`` and
compared through incidence products (`ops.conflict`).  A bucket
collision can only over-report a conflict, never hide one.  Two
independent families (``Config.conflict_exact``) are ANDed so that a
false conflict needs a collision in both.

torch on the CPU has no uint32 ``>>`` or ``+``, so the uint32 words are
held as int64 in ``[0, 2^32)``: ``>>`` is then the logical shift, and
`mul32` keeps every partial product below 2^49.  On the card the hash
runs inside K5+K6 (``csrc/conflict.cu``); these are its plain versions.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# distinct odd multipliers per family (Knuth multiplicative hashing)
MULTS = (2654435761, 2246822519, 3266489917, 668265263)
TABLE_MUL = 0x9E3779B9
FMIX1 = 0x85EBCA6B
FMIX2 = 0xC2B2AE35


def u32(x) -> torch.Tensor:
    """int64 in [0, 2^32) holding the uint32 cast of ``x`` (negative int32
    keys wrap as ``astype(uint32)`` does)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for a, c in [0, 2^32), without int64 overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def combine_key(table_id, key: torch.Tensor) -> torch.Tensor:
    """Fold (table, key) into one 32-bit identity, as int64 in [0, 2^32)
    (``deneva_tpu/ops/hashing.py:25``)."""
    t = mul32(u32(table_id).to(key.device), TABLE_MUL)
    return mul32(u32(key), MULTS[0]) ^ t


def bucket_hash(ident: torch.Tensor, n_buckets: int, family: int = 0
                ) -> torch.Tensor:
    """Map identities to int32 bucket ids in [0, n_buckets): murmur3
    fmix32 of ``ident ^ MULTS[family]`` (``deneva_tpu/ops/hashing.py:37``)."""
    if n_buckets & (n_buckets - 1):
        raise ValueError("n_buckets must be a power of two")
    h = u32(ident) ^ MULTS[family % len(MULTS)]
    h = h ^ (h >> 16)
    h = mul32(h, FMIX1)
    h = h ^ (h >> 13)
    h = mul32(h, FMIX2)
    h = h ^ (h >> 16)
    return (h & (n_buckets - 1)).to(torch.int32)
