"""Boolean hypercube iteration and the challenge-source abstraction.

Components #1 and #6 of the reference
(sum-check-protocol/src/lib.rs:34-70 and :13-21).
"""

from __future__ import annotations

import random
from typing import Iterator, List

from ..fields import Felt, FieldConfig


class BooleanHypercube:
    """Iterate the n-dimensional boolean hypercube in counter order.

    Matches the reference bit order exactly: bit 0 (LSB) of the counter is
    variable x_1's value (sum-check-protocol/src/lib.rs:54-68, little-endian
    via bitvec BitSlice). Yields a list of Felts per point.
    """

    def __init__(self, n: int, field: FieldConfig):
        self.n = n
        self.field = field

    def __iter__(self) -> Iterator[List[Felt]]:
        zero, one = self.field.zero(), self.field.one()
        for i in range(1 << self.n):
            yield [one if (i >> j) & 1 else zero for j in range(self.n)]

    def __len__(self) -> int:
        return 1 << self.n


class FeltRng:
    """Abstraction over verifier challenge sources (reference ``RngF``,
    sum-check-protocol/src/lib.rs:13-21). Subclasses implement ``draw``."""

    def draw(self, field: FieldConfig) -> Felt:
        raise NotImplementedError


class SeededRng(FeltRng):
    """Deterministic test RNG — the analogue of ``ark_std::test_rng()``."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def draw(self, field: FieldConfig) -> Felt:
        return field.felt(self._rng.randrange(field.p))


class RandNums(FeltRng):
    """Replay a fixed list of field elements as 'random' draws.

    The mechanism that feeds Fiat-Shamir challenges into the unmodified
    interactive verifier (fiat-shamir/src/lib.rs:102-119).
    """

    def __init__(self, nums: List[Felt]):
        self.nums = list(nums)
        self.current = 0

    def draw(self, field: FieldConfig) -> Felt:
        res = self.nums[self.current]
        self.current += 1
        return res
