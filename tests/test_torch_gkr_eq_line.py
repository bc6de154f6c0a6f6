"""The GKR table kernels' plain mirrors against the JAX package, on the CPU.

- ``eq_table_dot`` (the eq table and W~(u) of one pass) over BabyBear at
  k = 0..6 against the JAX ``eq_table_dev`` + ``dot_mod`` and against
  ``runtime.mle_eval`` (Goldilocks: ``tests/test_torch_gkr_fused.py``);
- ``line_restrict_tiled_plain``, the line-restriction kernel's tiles and
  indexing in torch ops, at k = 2..8 with the first tile T in
  {1, 3, k, k + 1} and the default plan against the JAX
  ``line_restrict_coeffs`` (BabyBear), and with T = 3 and the default plan
  against ``line_restrict_coeffs_plain`` (Goldilocks, held against JAX by
  ``tests/test_torch_gkr_fused.py``); ``line_restrict_chal`` (the fused
  path's form) against JAX;
- ``line_plan`` / ``line_launches_of``: tiles that sum to k, fit the
  kernel's shared memory and leave a wave of blocks in the first launch;
  the last tile in the launch before it;
- the bit-reversal index, cached up to 2^22 entries, and the wrappers'
  argument checks.

The JAX side runs eagerly under ``jax.disable_jit()``, each case embedded
at one width (the extra variables at u = c = 0, which leaves the function
unchanged) so that its primitives compile for one set of shapes. Inputs
come from numpy seeds; tolerance: exact (field values). The CUDA kernels
are held against the plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.gkr import device_tables as jdt  # noqa: E402
from thaler_study_tpu_torch import runtime  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.gkr import device_tables as dt  # noqa: E402
from thaler_study_tpu_torch.mle import dense  # noqa: E402
from thaler_study_tpu_torch.ops import mle_kernel  # noqa: E402

JB = jfields.BABYBEAR


def _embed(x: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([x, np.zeros(n - len(x), dtype=np.uint64)])


def _cases(rng, p, k):
    """(W, u, c): random, then every value p - 1."""
    yield tuple(rng.integers(0, p, n, dtype=np.uint64) for n in (1 << k, k, k))
    yield tuple(np.full(n, p - 1, dtype=np.uint64) for n in (1 << k, k, k))


def test_eq_table_dot_babybear_matches_jax():
    rng = np.random.default_rng(71)
    p, K = BABYBEAR.p, 6
    for k in range(0, K + 1):
        for w, u, _ in _cases(rng, p, k):
            jw, ju = jfields.FArray.from_ints(_embed(w, 1 << K), JB), jfields.FArray.from_ints(_embed(u, K), JB)
            with jax.disable_jit():
                jeq = jdt.eq_table_dev(ju, K)
                jwu = jdt.dot_mod(jw, jeq)
            eq_all = np.asarray(jeq.to_u64(), dtype=np.uint64)
            assert not eq_all[1 << k :].any()
            fw, fu = FArray.from_ints(w, BABYBEAR, device="cpu"), FArray.from_ints(u, BABYBEAR, device="cpu")
            eq_u, w_u = dt.eq_table_dot(fu, fw, k)
            assert np.array_equal(eq_u.to_u64(), eq_all[: 1 << k]), k
            want = int(np.asarray(jwu.to_u64()).reshape(-1)[0])
            assert w_u.shape == (1,) and int(w_u.to_u64()[0]) == want == runtime.mle_eval(w, u, p), k


def test_line_restriction_tiles_match_jax():
    rng = np.random.default_rng(72)
    K = 8
    for field in (BABYBEAR, GOLDILOCKS):
        p = field.p
        for k in range(2, K + 1):
            for w, u, c in _cases(rng, p, k):
                fw, fu, fc = (FArray.from_ints(x, field, device="cpu") for x in (w, u, c))
                if field is BABYBEAR:
                    jw, ju, jc = (jfields.FArray.from_ints(_embed(x, n), JB) for x, n in ((w, 1 << K), (u, K), (c, K)))
                    with jax.disable_jit():
                        q_all = np.asarray(jdt.line_restrict_coeffs(jw, ju, jc - ju, K).to_u64(), dtype=np.uint64)
                    assert not q_all[k + 1 :].any()
                    want = q_all[: k + 1]
                    chal = FArray.from_ints(np.concatenate([u, c]), field, device="cpu")
                    assert np.array_equal(dt.line_restrict_chal(fw, chal, k).to_u64(), want), k
                    firsts = (None, 1, 3, k, k + 1)
                else:
                    want = dt.line_restrict_coeffs_plain(fw, fu, fc - fu, k).to_u64()
                    firsts = (None, 3)
                for first in firsts:
                    got = dt.line_restrict_tiled_plain(fw, fu, fc - fu, k, first)
                    assert got.shape == (k + 1,)
                    assert np.array_equal(got.to_u64(), want), (field.name, k, first)


def test_line_plan():
    for word_bytes in (8, 4):
        cap = dt.LINE_SMEM_BYTES // word_bytes
        for k in range(0, 31):
            tiles = dt.line_plan(k, word_bytes)
            assert sum(tiles) == k and all(t >= 1 for t in tiles), (k, tiles)
            d = 0
            for t in tiles:
                assert dt._tile_words(d, t) <= cap or t == 1, (k, tiles)
                d += t
            if 0 < k <= dt.LINE_ONE:
                assert tiles == [k]
            elif k > dt.LINE_ONE:
                assert k - tiles[0] >= dt.LINE_WAVE, (k, tiles)
            launches = dt.line_launches_of(tiles)
            assert [t for pair in launches for t in pair if t] == tiles
            assert len(launches) == max(len(tiles) - 1, 1 if k else 0)
    # the flagship: two tiles in one launch at k = 20 in both fields
    assert dt.line_plan(20, 8) == [13, 7] and dt.line_launches_of([13, 7]) == [(13, 7)]
    assert len(dt.line_launches_of(dt.line_plan(20, 4))) == 1
    assert dt.line_plan(6, 8, first=9) == [6] and dt.line_plan(6, 8, first=1) == [1, 5]


def test_bitrev_index_is_not_cached():
    # the card's bit reversal computes its index in the kernel
    # (ops/mle_kernel.bitrev), so no index is cached; the plain version
    # builds its index per call
    cpu = torch.device("cpu")
    assert not hasattr(dense, "_bitrev_cache") and not hasattr(mle_kernel, "_bitrev_cache")
    for n in (0, 1, 5, 10, 23):
        idx = mle_kernel.bitrev_index(n, cpu)
        assert mle_kernel.bitrev_index(n, cpu) is not idx
        assert np.array_equal(idx.numpy(), dense.bitrev_perm(n))
    table = FArray.from_ints(np.arange(32, dtype=np.uint64), GOLDILOCKS, device="cpu")
    assert np.array_equal(dense.bitrev(table, 5).to_u64(), dense.bitrev_perm(5).astype(np.uint64))


def test_wrappers_check_their_arguments():
    u = FArray.from_ints([1, 2, 3], GOLDILOCKS, device="cpu")
    w = FArray.from_ints(list(range(8)), GOLDILOCKS, device="cpu")
    with pytest.raises(ValueError):
        dt.eq_table_dot(u, FArray.from_ints(list(range(4)), GOLDILOCKS, device="cpu"), 3)
    with pytest.raises(ValueError):
        dt.eq_table_dot(u, FArray.from_ints(list(range(8)), BABYBEAR, device="cpu"), 3)
    with pytest.raises(ValueError):
        dt.line_restrict_chal(w, u, 3)  # chal holds 2k words
    with pytest.raises(ValueError):
        dt.line_restrict_coeffs(w, u, FArray.from_ints([1, 2], GOLDILOCKS, device="cpu"), 3)
    meta = FArray(torch.empty(8, dtype=torch.int64, device="meta"), GOLDILOCKS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        dt.line_restrict_chal(meta, FArray(torch.empty(6, dtype=torch.int64, device="meta"), GOLDILOCKS), 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        dt.eq_table_dot(FArray(torch.empty(3, dtype=torch.int64, device="meta"), GOLDILOCKS), meta, 3)
