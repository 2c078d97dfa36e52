"""Random typed-data generators (counterpart of
``transmogrifai_tpu.testkit.generators``, a numpy module: the port keeps
its own copy).

Infinite streams of typed feature values with a probability of an empty
value (the reference's testkit ``Random*`` generators); each draws from
its own ``np.random.default_rng(seed)``, so the same seed gives the same
values as the JAX package's.
"""
from __future__ import annotations

import string
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

__all__ = [
    "RandomReal", "RandomIntegral", "RandomBinary", "RandomText",
    "RandomPickList", "RandomList", "RandomSet", "RandomMap", "RandomVector",
]


class _RandomBase:
    """Infinite generator with P(empty) (RandomData trait parity)."""

    def __init__(self, probability_of_empty: float = 0.0, seed: int = 42):
        self.probability_of_empty = probability_of_empty
        self.rng = np.random.default_rng(seed)

    def _one(self) -> Any:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        while True:
            if self.rng.random() < self.probability_of_empty:
                yield None
            else:
                yield self._one()

    def take(self, n: int) -> List[Any]:
        it = iter(self)
        return [next(it) for _ in range(n)]

    def with_probability_of_empty(self, p: float) -> "_RandomBase":
        self.probability_of_empty = p
        return self


class RandomReal(_RandomBase):
    def __init__(self, distribution: str = "normal", loc: float = 0.0,
                 scale: float = 1.0, **kw):
        super().__init__(**kw)
        self.distribution = distribution
        self.loc = loc
        self.scale = scale

    @staticmethod
    def normal(loc=0.0, scale=1.0, **kw):
        return RandomReal("normal", loc, scale, **kw)

    @staticmethod
    def uniform(lo=0.0, hi=1.0, **kw):
        return RandomReal("uniform", lo, hi, **kw)

    @staticmethod
    def poisson(lam=1.0, **kw):
        return RandomReal("poisson", lam, 0.0, **kw)

    def _one(self):
        if self.distribution == "normal":
            return float(self.rng.normal(self.loc, self.scale))
        if self.distribution == "uniform":
            return float(self.rng.uniform(self.loc, self.scale))
        if self.distribution == "poisson":
            return float(self.rng.poisson(self.loc))
        raise ValueError(self.distribution)


class RandomIntegral(_RandomBase):
    def __init__(self, lo: int = 0, hi: int = 100, **kw):
        super().__init__(**kw)
        self.lo, self.hi = lo, hi

    def _one(self):
        return int(self.rng.integers(self.lo, self.hi))


class RandomBinary(_RandomBase):
    def __init__(self, probability_of_true: float = 0.5, **kw):
        super().__init__(**kw)
        self.p = probability_of_true

    def _one(self):
        return bool(self.rng.random() < self.p)


class RandomText(_RandomBase):
    def __init__(self, min_len: int = 3, max_len: int = 12, **kw):
        super().__init__(**kw)
        self.min_len, self.max_len = min_len, max_len

    def _one(self):
        n = int(self.rng.integers(self.min_len, self.max_len + 1))
        letters = self.rng.choice(list(string.ascii_lowercase), n)
        return "".join(letters)


class RandomPickList(_RandomBase):
    def __init__(self, domain: Sequence[str], **kw):
        super().__init__(**kw)
        self.domain = list(domain)

    def _one(self):
        return str(self.rng.choice(self.domain))


class RandomList(_RandomBase):
    def __init__(self, element: _RandomBase, min_len: int = 0,
                 max_len: int = 5, **kw):
        super().__init__(**kw)
        self.element = element
        self.min_len, self.max_len = min_len, max_len

    def _one(self):
        n = int(self.rng.integers(self.min_len, self.max_len + 1))
        return [self.element._one() for _ in range(n)]


class RandomSet(RandomList):
    def _one(self):
        return set(super()._one())


class RandomMap(_RandomBase):
    def __init__(self, value: _RandomBase, keys: Sequence[str], **kw):
        super().__init__(**kw)
        self.value = value
        self.keys = list(keys)

    def _one(self):
        n = int(self.rng.integers(0, len(self.keys) + 1))
        ks = self.rng.choice(self.keys, n, replace=False)
        return {str(k): self.value._one() for k in ks}


class RandomVector(_RandomBase):
    def __init__(self, dim: int, **kw):
        super().__init__(**kw)
        self.dim = dim

    def _one(self):
        return self.rng.normal(size=self.dim).astype(np.float32)
