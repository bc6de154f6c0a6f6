"""The port's Goldilocks tensors against the JAX package's field backend.

Inputs are made with numpy from a seed and handed to both packages as the
same (lo, hi) uint32 limbs (``FArray.from_jax_limbs``). Tolerance: exact
equality — modular arithmetic has no rounding. Values >= 2^63 read as
negative in the port's int64 storage, so the boundary set covers them.
Also here: the static check that the port imports neither JAX nor the JAX
package.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 7 here would start this file ahead of the long GKR files and
lengthen the whole run.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax.numpy as jnp  # noqa: E402

from thaler_study_tpu.fields import goldilocks as jgl  # noqa: E402
from thaler_study_tpu_torch.fields import GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.fields import goldilocks as gl  # noqa: E402

P = GOLDILOCKS.p
BOUNDARY = [
    0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
    1 << 63, (1 << 63) - 1, (1 << 63) + 1, (1 << 64) - (1 << 32),
]
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _values(seed: int, size: int = 4096) -> np.ndarray:
    """Random canonical values with every boundary value inside."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=size, dtype=np.uint64)
    b = np.array(BOUNDARY, dtype=np.uint64)
    v[: len(b)] = b
    v[len(b) : 2 * len(b)] = b[::-1]
    return v


def _limbs(v: np.ndarray):
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)


def _jax_u64(lo, hi) -> np.ndarray:
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _pair(seed):
    a, b = _values(seed), _values(seed + 1)
    rng = np.random.default_rng(seed + 2)
    rng.shuffle(b)
    return a, b


def test_binary_ops_match_jax():
    a, b = _pair(7)
    ta = FArray.from_jax_limbs(*_limbs(a), device="cpu")
    tb = FArray.from_jax_limbs(*_limbs(b), device="cpu")
    ja, jb = (tuple(jnp.asarray(x) for x in _limbs(v)) for v in (a, b))
    for name, port_op, jax_op, py in (
        ("add", gl.add, jgl.add, lambda x, y: (x + y) % P),
        ("sub", gl.sub, jgl.sub, lambda x, y: (x - y) % P),
        ("mul", gl.mul, jgl.mul, lambda x, y: x * y % P),
    ):
        got = FArray(port_op(ta.data, tb.data), GOLDILOCKS).to_u64()
        np.testing.assert_array_equal(got, _jax_u64(*jax_op(*ja, *jb)), err_msg=name)
        assert [int(x) for x in got] == [py(int(x), int(y)) for x, y in zip(a, b)], name


def test_fold_matches_jax():
    lo, hi = _pair(11)
    r = _values(13)[::-1].copy()
    t = [FArray.from_jax_limbs(*_limbs(v), device="cpu") for v in (lo, hi, r)]
    got = FArray.fold(*t).to_u64()
    j = [tuple(jnp.asarray(x) for x in _limbs(v)) for v in (lo, hi, r)]
    want = _jax_u64(*jgl.fold(*j[0], *j[1], *j[2]))
    np.testing.assert_array_equal(got, want)


def test_sum_matches_jax():
    for size in (1, 2, 3, 64, 65, 4096):
        v = _values(17)[:size]
        got = FArray.from_jax_limbs(*_limbs(v), device="cpu").sum(axis=0).item().v
        want = _jax_u64(*jgl.sum_mod(*(jnp.asarray(x) for x in _limbs(v)), 0))
        assert got == int(want) == sum(int(x) for x in v) % P, size
    rows = _values(19).reshape(8, 512)
    got = FArray.from_jax_limbs(*_limbs(rows), device="cpu").sum(axis=1).to_u64()
    assert [int(x) for x in got] == [sum(int(x) for x in row) % P for row in rows]


def test_codecs_keep_values_above_2_63():
    vals = BOUNDARY + [P, P + 5, (1 << 64) - 1]  # the last three reduce mod p
    a = FArray.from_ints(vals, GOLDILOCKS, device="cpu")
    assert [int(x) for x in a.to_ints()] == [v % P for v in vals]
    b = FArray.from_ints(np.array(vals, dtype=np.uint64), GOLDILOCKS, device="cpu")
    assert list(b.to_u64()) == [v % P for v in vals]
    lo, hi = _limbs(np.array(BOUNDARY, dtype=np.uint64))
    c = FArray.from_jax_limbs(lo, hi, device="cpu")
    assert [int(x) for x in c.to_ints()] == BOUNDARY
    with pytest.raises(ValueError):
        FArray.from_jax_limbs(np.array([1], np.uint32), np.array([0xFFFFFFFF], np.uint32), device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request succeeds")
    with pytest.raises(RuntimeError):
        FArray.from_ints([1, 2], GOLDILOCKS)  # device defaults to cuda


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "thaler_study_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    banned = {"jax", "jaxlib", "thaler_study_tpu"}
    for path in files:
        for name in _imports(path):
            # exact top-level name: thaler_study_tpu_torch itself is fine
            assert name.split(".")[0] not in banned, f"{path}: imports {name}"
