"""The tensor-core modular matmul's digit form at its flush boundary, on the
CPU.

``ops.modmatmul``'s tensor-core kernel (``csrc/modmatmul_tc.cu``) sums
digit pairs in s32 and flushes them every K_c of K; its plain digit form
(``modmatmul_digits_plain``, the CPU path of ``modmatmul_tc`` and
``contract_partials_tc``) keeps the same chunks and diagonal sums. Words at
p - 1 with K = K_c + 1 and a tiny M and N take the largest first chunk and
a one-word second one; the results are held against Python ints, exactly.
``test_torch_triangles.py`` holds the digit form against the JAX package;
``chip_smoke.py`` holds the kernel against these plain versions on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import modmatmul  # noqa: E402


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=lambda f: f.name)
def test_digit_form_at_the_flush_boundary(field):
    p, m, n = field.p, 2, 3
    k = modmatmul.FLUSH_K[field.backend] + 1
    a = FArray.from_ints(np.full((2 * m, k), p - 1, dtype=np.uint64), field, device="cpu")
    b = FArray.from_ints(np.full((n, k), p - 1, dtype=np.uint64), field, device="cpu")
    rng = np.random.default_rng(9)
    d_ints = rng.integers(0, min(p, 1 << 62), size=(2 * m, n), dtype=np.uint64)
    d = FArray.from_ints(d_ints, field, device="cpu")
    # the planes: the words' bytes (mont32: of the Montgomery word), little
    # end first, K padded to 16 bytes
    planes = modmatmul.digit_planes(a.data, field)
    assert planes.shape == (modmatmul.DIGITS[field.backend], 2 * m, modmatmul.padded_k(k))
    w = (p - 1) * (field.mont_r if field.backend == "mont32" else 1) % p
    word = [w >> (8 * s) & 0xFF for s in range(planes.shape[0])]
    assert planes[:, :, :k].reshape(planes.shape[0], -1).amin(1).tolist() == word
    assert planes[:, :, :k].reshape(planes.shape[0], -1).amax(1).tolist() == word
    assert not planes[:, :, k:].any()
    # C = A B^T: every entry k (p - 1)^2
    c = modmatmul.modmatmul_tc(a[:m], b)
    assert (c.to_ints() == k * (p - 1) ** 2 % p).all()
    # the contraction at the view t = 2 (A_t = A_lo = A_hi here), per tile
    t = 2
    parts = modmatmul.contract_partials_tc(a.data, b.data, d.data, field, t)
    tm, tn = modmatmul.TC_TILE[field.backend]
    assert parts.shape == ((-(-m // tm)) * (-(-n // tn)),)
    dv = [[(int(d_ints[i, j]) + t * (int(d_ints[m + i, j]) - int(d_ints[i, j]))) % p for j in range(n)]
          for i in range(m)]
    want = sum(dv[i][j] * (k * (p - 1) ** 2) for i in range(m) for j in range(n)) % p
    assert FArray(parts, field).sum(axis=0).item().v == want
