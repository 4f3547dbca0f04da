"""Key sampling: zipfian and HOT (reference `benchmarks/ycsb_query.cpp:181-260`).

The port of ``deneva_tpu/ops/sampling.py``: Gray et al.'s closed-form
zipfian quantile over host-computed zeta constants, evaluated in float32
exactly as the reference evaluates it, constant by constant (each Python
float of the reference is rounded to float32 before it meets the draws).

One deliberate difference: the reference's ``jnp.power`` is XLA's f32
pow, which is not correctly rounded, and no PyTorch or CUDA routine
reproduces it bit for bit.  The port evaluates the power in float64 and
rounds to float32 — a correctly rounded f32 pow in all but vanishingly
rare cases — in the plain version and in kernel K4b alike, so the two
agree with each other.  Against XLA, at theta = 0.9 and n = 2^24, a
fraction of a percent of keys then differs, each by exactly one
(measured in ``tests/test_torch_sampling.py``).  At theta = 0 the sampler
is one correctly rounded multiply and matches bit for bit.

`HotSet` (``deneva_tpu/ops/sampling.py:70``) draws a Bernoulli and two
``randint`` per key on the same threefry stream and has no ``pow``, so
it matches the reference bit for bit.

This module holds the plain versions of K4b's two samplers; the kernel
is launched by `workloads.ycsb.YCSBWorkload.generate`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from deneva_tpu_torch.ops import prng


@lru_cache(maxsize=64)
def _zeta(n: int, theta: float) -> float:
    """sum_{i=1..n} 1/i^theta  (reference `ycsb_query.cpp:181-188`)."""
    if theta == 0.0:
        return float(n)
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(np.sum(1.0 / np.power(i, theta)))


@dataclass(frozen=True)
class Zipfian:
    """Zipfian sampler over ``[0, n)`` with skew ``theta``."""

    n: int
    theta: float

    @property
    def f32_params(self) -> dict:
        """The float32 constants of the quantile, as the reference rounds
        them (weak-typed Python floats meet float32 draws)."""
        f = np.float32
        p = {"n": f(self.n), "theta_zero": self.theta == 0.0}
        if self.theta != 0.0:
            zetan = _zeta(self.n, self.theta)
            alpha = 1.0 / (1.0 - self.theta)
            eta = (1.0 - (2.0 / self.n) ** (1.0 - self.theta)) / (
                1.0 - _zeta(2, self.theta) / zetan)
            p.update(zetan=f(zetan), eta=f(eta), alpha=f(alpha),
                     thresh1=f(1.0 + 0.5 ** self.theta))
        return p

    def sample_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """Zipfian variates from float32 uniforms ``u`` (plain version)."""
        p = self.f32_params

        def c(x):
            return torch.tensor(float(x), dtype=torch.float32,
                                device=u.device)
        if p["theta_zero"]:
            return torch.clamp_max((u * c(p["n"])).to(torch.int32),
                                   self.n - 1)
        uz = u * c(p["zetan"])
        eta = c(p["eta"])
        base = eta * u - eta + c(1.0)
        pw = torch.pow(base.to(torch.float64),
                       float(p["alpha"])).to(torch.float32)
        spread = (c(p["n"]) * pw).to(torch.int32)
        one = torch.ones_like(spread)
        v = torch.where(uz < c(1.0), torch.zeros_like(spread),
                        torch.where(uz < c(p["thresh1"]), one, spread))
        return torch.clamp(v, 0, self.n - 1)

    def sample(self, key: torch.Tensor, shape: tuple) -> torch.Tensor:
        """Zipfian variates, int32 in [0, n)  (`ycsb_query.cpp:190-202`)."""
        return self.sample_uniform(prng.uniform(key, shape))

    def kernel_params(self) -> tuple:
        """K4b's sampler arguments: theta_zero, n, zetan, eta, alpha,
        thresh1, then HOT's eight (`HotSet.kernel_params`) at hot_max 0:
        not HOT."""
        p = self.f32_params
        f = np.float32
        return (int(p["theta_zero"]), p["n"], p.get("zetan", f(0)),
                p.get("eta", f(0)), p.get("alpha", f(0)),
                p.get("thresh1", f(0)), 0, f(0), 0, 0, 0, 0, 0, 0)


@dataclass(frozen=True)
class HotSet:
    """HOT skew sampler (reference `ycsb_query.cpp:205-260`,
    config.h:162-167): ``access_perc`` of accesses hit the first
    ``hot_max`` keys uniformly, the rest ``[hot_max, n)`` uniformly.
    ``data_perc`` is an absolute key count despite its name."""

    n: int
    hot_max: int
    access_perc: float

    def sample(self, key: torch.Tensor, shape: tuple) -> torch.Tensor:
        k1, k2, k3 = prng.split_plain(key, 3)
        is_hot = prng.bernoulli(k1, self.access_perc, shape)
        hot = prng.randint(k2, shape, 0, self.hot_max)
        cold = prng.randint(k3, shape, self.hot_max, self.n)
        return torch.where(is_hot, hot, cold)

    def kernel_params(self) -> tuple:
        """K4b's sampler arguments, in `Zipfian.kernel_params`' order:
        the zipf constants unused, hot_max > 0 selecting HOT (and starting
        the cold range), access_perc, then the hot and the cold range's
        `randint_consts` (launch constants, so the kernel divides by
        nothing)."""
        f = np.float32
        return (0, f(0), f(0), f(0), f(0), f(0), self.hot_max,
                f(self.access_perc), *randint_consts(0, self.hot_max),
                *randint_consts(self.hot_max, self.n))


MASK64 = (1 << 64) - 1


def magic_mod(d: int) -> int:
    """The remainder magic of a divisor ``d`` in [1, 2^32): floor((2^64 -
    1) / d) + 1 mod 2^64 (0 for d = 1).  ``x % d`` is then the top 32 bits
    of ``((magic * x) mod 2^64) * d`` for every uint32 x (Lemire, Kaser
    and Kurz 2019), which is how K4b takes HOT's remainders
    (``csrc/threefry.cuh`` ``dt_fastmod``)."""
    return (MASK64 // d + 1) & MASK64


def randint_consts(lo: int, hi: int) -> tuple[int, int, int]:
    """K4b's launch constants of one ``randint`` range [lo, hi): its span
    hi - lo (1 for an empty range), the multiplier (2^16 % span)^2 % span
    of `prng.randint` and the span's `magic_mod`."""
    span = hi - lo if hi > lo else 1
    return span, ((65536 % span) ** 2 & 0xFFFFFFFF) % span, magic_mod(span)
