"""Batched proving: many independent sumcheck instances per dispatch.

A prover service rarely proves one statement at a time. B independent
instances of the same shape run together: tables carry a leading batch
axis [B, 2^n], and every round of all B proofs is one round kernel launch
plus one FS tail launch (``ops/fs_kernel.fs_prove_device_batch``).

Transcripts are byte-identical to proving each instance alone, because
batching changes scheduling, not math.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..fields import FArray, FieldConfig
from ..fiat_shamir.transcript import (
    FiatShamirTranscript,
    SumcheckInteractiveProver,
    generate_transcript,
)
from ..ops.fs_kernel import fs_prove_device_batch
from ..ops.round_kernel import single_block_spec
from ..sumcheck import Prover
from .factor_poly import ProductPoly


class BatchedProductPoly:
    """B same-shape instances of a single-block k-factor product."""

    def __init__(self, tables: Sequence[FArray]):
        self.tables = tuple(tables)  # each [B, 2^n]
        self.batch = self.tables[0].shape[0]

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


def generate_transcripts_batch(
    poly: BatchedProductPoly, field: FieldConfig, dst: bytes = b""
):
    """Fiat-Shamir transcripts for all B instances: the batched device
    prover, with an instance whose serialized coefficients hit a zero
    (value-dependent message lengths; rare) re-proven ALONE on the exact
    host loop — the rest of the batch keeps the device result.
    Byte-identical to per-instance ``generate_transcript`` runs. A
    non-empty DST is not covered by the fused prover, whose result is then
    ``None``; the JAX package proves it on its unfused per-round path, the
    port raises ``NotImplementedError`` (ROADMAP A5)."""
    spec = single_block_spec(len(poly.tables), poly.num_vars())
    fused = fs_prove_device_batch(spec, poly.tables, dst)
    if fused is None:
        raise NotImplementedError(
            "the unfused per-round batched prover (a non-empty DST, "
            "thaler_study_tpu/protocols/batched.py:188-204) is a later slice of the port (ROADMAP A5)"
        )
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
