"""Batched proving: many independent sumcheck instances per dispatch.

A prover service rarely proves one statement at a time. B independent
instances of the same shape run together: tables carry a leading batch
axis [B, 2^n], and each instance's Fiat-Shamir chain draws its own
challenge. Two paths, as in the JAX package:

- the fused prover (``ops/fs_kernel.fs_prove_device_batch``): every round
  of all B proofs is one round kernel launch plus one FS tail launch, and
  the host reads once at the end;
- the per-round prover (:meth:`BatchedProductPoly.round_batch`), for a
  non-empty DST, a ``degree`` other than the number of factors, and
  wherever the fused prover declines: one round kernel launch per round
  over all B proofs (fold at each proof's challenge, per-block partial
  sums), a block sum and one host read of the [B, k + 1] sums; the
  interpolation and each instance's hash chain with the DST run on the
  host.

Transcripts are byte-identical to proving each instance alone, because
batching changes scheduling, not math.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fiat_shamir.hash_to_field import XmdChain
from ..fiat_shamir.serialize import serialize_c1_and_poly, serialize_unipoly
from ..fiat_shamir.transcript import (
    FiatShamirTranscript,
    SumcheckInteractiveProver,
    generate_transcript,
)
from ..fields import FArray, Felt, FieldConfig
from ..ops.cuda_round import round_partials
from ..ops.fs_kernel import fs_prove_device_batch
from ..ops.round_kernel import single_block_spec
from ..sumcheck import Prover
from ..sumcheck.univariate import UniPoly, interpolate_at_small_points
from .factor_poly import ProductPoly


def _values_at(sums: Sequence[int], degree: int, p: int) -> List[int]:
    """s(0..degree) of a round polynomial of degree k = len(sums) - 1 from
    s(0..k) (canonical ints): the first degree + 1 values, or s(0..k)
    extended by exact Lagrange interpolation mod p. Where p <= k the points
    0..k repeat mod p, and s(t) = s(t mod p)."""
    k = len(sums) - 1
    out = list(sums[: degree + 1])
    for t in range(k + 1, degree + 1):
        if p <= k:
            out.append(sums[t % p])
            continue
        acc = 0
        for i, s in enumerate(sums):
            num, den = 1, 1
            for j in range(k + 1):
                if j != i:
                    num = num * (t - j) % p
                    den = den * (i - j) % p
            acc += s * num * pow(den, -1, p)
        out.append(acc % p)
    return out


class BatchedProductPoly:
    """B same-shape instances of a single-block k-factor product.

    ``degree``: the round polynomials' degree bound (the number of factors
    by default); its values s(0..degree) are what each round serializes."""

    def __init__(self, tables: Sequence[FArray], degree: Optional[int] = None):
        self.tables = tuple(tables)  # each [B, 2^n]
        self.batch = self.tables[0].shape[0]
        self._degree = len(self.tables) if degree is None else degree

    @classmethod
    def stack(cls, instances: Sequence[Sequence[FArray]]) -> "BatchedProductPoly":
        """Stack B per-instance 1-D factor-table lists into batch form."""
        field = instances[0][0].field
        return cls(
            FArray(torch.stack([inst[k].data for inst in instances]), field)
            for k in range(len(instances[0]))
        )

    @property
    def field(self) -> FieldConfig:
        return self.tables[0].field

    def num_vars(self) -> int:
        return self.tables[0].shape[1].bit_length() - 1

    def _sums(self, r: Optional[torch.Tensor]) -> Tuple[Optional[list], FArray]:
        """One round kernel launch over the batch (folding at ``r`` [B]
        words where given): (folded tables or None, s(0..k) [B, k + 1])."""
        folded, partials = round_partials([t.data for t in self.tables], r, field=self.field)
        return folded, FArray(partials, self.field).sum(axis=1)

    def c_1(self) -> List[Felt]:
        """Each instance's sum of the product over the hypercube: s(0) + s(1)
        of round 0."""
        _, s = self._sums(None)
        return (s[:, 0] + s[:, 1]).to_felts()

    def _round(self, r: Optional[torch.Tensor]) -> Tuple[np.ndarray, List[UniPoly], "BatchedProductPoly"]:
        """One round for all B instances at the challenge words ``r`` (None
        for round 0): the sums s(0..k) [B, k + 1] canonical, the round
        polynomials and the folded batch. One launch, one host read."""
        field = self.field
        folded, s = self._sums(r)
        sums = s.to_u64()
        unis = [
            interpolate_at_small_points(
                [Felt(v, field) for v in _values_at([int(x) for x in row], self._degree, field.p)], field
            )
            for row in sums
        ]
        tables = self.tables if folded is None else [FArray(t, field) for t in folded]
        return sums, unis, BatchedProductPoly(tables, self._degree)

    def round_batch(
        self, r_prev: Optional[Sequence[Felt]]
    ) -> Tuple[List[UniPoly], "BatchedProductPoly"]:
        """One round for all B instances; ``r_prev`` is the per-instance
        challenge list (None for round 0). One launch, one host read."""
        r = None
        if r_prev is not None:
            r = FArray.from_felts(list(r_prev), self.field, device=self.tables[0].device).data
        _, unis, nxt = self._round(r)
        return unis, nxt


def generate_transcripts_batch(
    poly: BatchedProductPoly, field: FieldConfig, dst: bytes = b""
):
    """Fiat-Shamir transcripts for all B instances. Fast path: the fused
    device prover over the whole batch, with an instance whose serialized
    coefficients hit a zero (value-dependent message lengths; rare)
    re-proven ALONE on the exact host loop — the rest of the batch keeps the
    device result. Where the fused prover does not apply (a non-empty DST,
    ``degree`` other than the number of factors) the per-round prover runs,
    each instance keeping its own host hash chain. Byte-identical to
    per-instance ``generate_transcript`` runs either way."""
    spec = single_block_spec(len(poly.tables), poly.num_vars())
    if poly._degree == len(poly.tables):
        fused = fs_prove_device_batch(spec, poly.tables, dst)
        if fused is not None:
            out = []
            for i, msgs in enumerate(fused):
                if msgs is None:  # per-instance zero-coefficient fallback
                    inst = ProductPoly(spec, tuple(t[i] for t in poly.tables))
                    out.append(
                        generate_transcript(SumcheckInteractiveProver(Prover(inst)), field, dst)
                    )
                else:
                    out.append(FiatShamirTranscript(msgs))
            return out

    n = poly.num_vars()
    chains = [XmdChain(field, dst) for _ in range(poly.batch)]
    sums, unis, poly = poly._round(None)  # c_1 = s(0) + s(1) from the same launch
    c1s = [Felt((int(row[0]) + int(row[1])) % field.p, field) for row in sums]
    msgs = [[serialize_c1_and_poly(c1, uni)] for c1, uni in zip(c1s, unis)]
    for chain, m in zip(chains, msgs):
        chain.absorb(m[0])
    for _ in range(1, n):
        unis, poly = poly.round_batch([chain.draw(1)[0] for chain in chains])
        for chain, m, uni in zip(chains, msgs, unis):
            m.append(serialize_unipoly(uni))
            chain.absorb(m[-1])
    return [FiatShamirTranscript(m) for m in msgs]
