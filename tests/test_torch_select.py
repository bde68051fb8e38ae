"""The exact rank select (``eig_kl_tpu_torch/ops/select.py``, K7's plain
version) against the JAX package's ``eig_kl_tpu/ops/select.py`` on the
CPU, bit for bit:

* f32 against both forms of the JAX select, the 32-pass bit search
  (``_kth_key_bits``) and the 4-pass radix histogram (``_kth_key_radix``),
  at every rank of every size 1-64, at several ranks of 1,000 and 4,038
  values, and on vectors of +-0, +-inf, NaN of both signs, subnormals and
  heavy ties;
* f64 against ``jnp.sort(v)[k]`` at x64 (the JAX package sorts f64), -0.0
  and +0.0 standing in for each other;
* the key maps, ``upper_median``, and no ``torch.kthvalue`` left in the
  port.

The JAX selects run jitted over batches of ranks and vectors (``vmap``);
the plain version runs on one thread.
"""

import contextlib
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _jax_program(form: str):
    """The JAX package's f32 select, in ``form`` "bits" or "radix", of
    the ranks ``ks[i, j]`` of the vectors ``vs[i]``, jitted."""
    from eig_kl_tpu.ops import select as S

    search = S._kth_key_bits if form == "bits" else S._kth_key_radix
    one = lambda v, k: S._key_to_f32(search(S._f32_keys(v), k))  # noqa: E731
    return jax.jit(jax.vmap(jax.vmap(one, in_axes=(None, 0)), in_axes=(0, 0)))


def _jax_select(form: str, v: np.ndarray, ks) -> np.ndarray:
    ks = np.asarray(ks, np.int32)
    return np.asarray(_jax_program(form)(jnp.asarray(v)[None], jnp.asarray(ks)[None]))[0]


#: The largest f32 key (bits 0x7fffffff, a NaN): appended to a vector it
#: leaves the element of every rank below the vector's length as it was.
_TOP = np.array([0x7FFFFFFF], np.uint32).view(np.float32)[0]


@functools.lru_cache(maxsize=None)
def _small_sizes(form: str) -> np.ndarray:
    """The JAX select at every rank of the vectors of sizes 1-64, in one
    program: each vector padded to 64 values with :data:`_TOP`, ranks past
    its length asking rank 0."""
    vs = np.full((64, 64), _TOP, np.float32)
    ks = np.zeros((64, 64), np.int32)
    for n in range(1, 65):
        vs[n - 1, :n] = _vector(n, 100 + n)
        ks[n - 1, :n] = np.arange(n)
    return np.asarray(_jax_program(form)(jnp.asarray(vs), jnp.asarray(ks)))


def _port_ranks(v: np.ndarray, ks) -> np.ndarray:
    from eig_kl_tpu_torch.ops.select import kth_smallest

    t = torch.as_tensor(v)
    with _one_thread():
        return np.array([kth_smallest(t, int(k)).numpy() for k in ks], dtype=v.dtype)


_SPECIAL32 = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.17e-38, -3e-39, 1.0, -1.0, 2.5, 2.5, 2.5],
    np.float32,
)


def _nan(sign: int, payload: int, dtype) -> np.ndarray:
    if dtype == np.float32:
        bits = np.uint32((sign << 31) | 0x7FC00000 | payload)
        return np.array([bits], np.uint32).view(np.float32)
    bits = np.uint64((sign << 63) | 0x7FF8000000000000 | payload)
    return np.array([bits], np.uint64).view(np.float64)


def _vector(n: int, seed: int, dtype=np.float32, specials: bool = True) -> np.ndarray:
    """Random values with repeats, and for ``specials`` some of +-0, +-inf,
    subnormals and NaN of both signs mixed in (f32)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(dtype)
    v[rng.random(n) < 0.3] = v[0]  # ties
    if specials and n >= 4:
        pool = np.concatenate([_SPECIAL32.astype(dtype), _nan(0, 1, dtype), _nan(1, 2, dtype)])
        at = rng.random(n) < 0.25
        v[at] = rng.choice(pool, int(at.sum()))
    return v


@pytest.mark.parametrize("form", ["bits", "radix"])
@pytest.mark.parametrize("n", range(1, 65))
def test_f32_every_rank_equals_the_jax_select(n, form):
    """The port on the vector of ``n`` values, the JAX select on it padded
    with keys above all of its own (:func:`_small_sizes`)."""
    got = _port_ranks(_vector(n, 100 + n), range(n))
    np.testing.assert_array_equal(_bits(got), _bits(_small_sizes(form)[n - 1, :n]))


@pytest.mark.parametrize("form", ["bits", "radix"])
@pytest.mark.parametrize("n", [1000, 4038])
def test_f32_large_vectors_equal_the_jax_select(n, form):
    v = _vector(n, n)
    ks = [0, 1, n // 3, n // 2, n // 2 + 1, n - 2, n - 1]
    np.testing.assert_array_equal(_bits(_port_ranks(v, ks)), _bits(_jax_select(form, v, ks)))


@pytest.mark.parametrize("form", ["bits", "radix"])
def test_f32_special_values_equal_the_jax_select(form):
    """+-0, +-inf, NaN of both signs (a negative NaN's key lies below -inf's,
    as the JAX keys put it), subnormals, and a vector of one repeated value."""
    v = np.concatenate([_SPECIAL32, _nan(0, 5, np.float32), _nan(1, 7, np.float32), _SPECIAL32[::-1]])
    for vec in (v, np.full(37, -0.0, np.float32), np.full(9, 3.0, np.float32)):
        ks = range(vec.size)
        np.testing.assert_array_equal(_bits(_port_ranks(vec, ks)), _bits(_jax_select(form, vec, ks)))
    from eig_kl_tpu_torch.ops.select import kth_smallest

    assert np.isnan(float(kth_smallest(torch.as_tensor(v), 0)))  # the negative NaN
    assert np.isnan(float(kth_smallest(torch.as_tensor(v), v.size - 1)))


def _same_or_zeros(got: np.ndarray, ref: np.ndarray) -> None:
    """Equal bits, -0.0 and +0.0 standing in for each other, and a NaN for
    a NaN (the sort returns it with another payload)."""
    alike = ((got == 0) & (ref == 0)) | (np.isnan(got) & np.isnan(ref))
    np.testing.assert_array_equal(_bits(got)[~alike], _bits(ref)[~alike])


@pytest.mark.parametrize("n", [1, 2, 3, 7, 31, 64, 1000, 4038])
def test_f64_equals_the_sorted_element(n):
    """f64: the key of rank k is ``jnp.sort(v)[k]`` at x64.  Every NaN here
    has its sign bit clear (a sort puts NaN of either sign last, the keys a
    negative NaN first), and no value is subnormal: XLA's CPU sort compares
    subnormals as zeros (they are held to NumPy's sort instead)."""
    v = _vector(n, 7 * n, np.float64, specials=False)
    if n >= 7:
        v[:5] = [0.0, -0.0, np.inf, -np.inf, _nan(0, 3, np.float64)[0]]
        v = np.random.default_rng(n).permutation(v)
    ks = np.arange(n) if n <= 64 else np.array([0, 1, n // 2, n - 2, n - 1])
    srt = np.asarray(jnp.sort(jnp.asarray(v)))
    got = _port_ranks(v, ks)
    assert got.dtype == np.float64
    _same_or_zeros(got, srt[ks])
    if n >= 7:
        v[-2:] = [5e-324, -2.5e-310]
        _same_or_zeros(_port_ranks(v, ks), np.sort(v)[ks])


def test_key_maps_keep_the_float_order_and_invert():
    from eig_kl_tpu_torch.ops.select import f32_from_key, f32_keys, f64_from_key, f64_keys

    from eig_kl_tpu.ops.select import _f32_keys

    v32 = np.concatenate([_SPECIAL32, _nan(0, 1, np.float32), _nan(1, 1, np.float32),
                          np.random.default_rng(3).standard_normal(500).astype(np.float32)])
    k32 = f32_keys(torch.as_tensor(v32))
    np.testing.assert_array_equal(k32.numpy(), np.asarray(_f32_keys(jnp.asarray(v32))).astype(np.int64))
    np.testing.assert_array_equal(_bits(f32_from_key(k32).numpy()), _bits(v32))
    v64 = np.random.default_rng(4).standard_normal(500) * 10.0 ** np.arange(-250, 250)
    v64 = np.concatenate([v64, [0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324]])
    k64 = f64_keys(torch.as_tensor(v64))
    np.testing.assert_array_equal(_bits(f64_from_key(k64).numpy()), _bits(v64))
    order = np.argsort(k64.numpy(), kind="stable")
    finite = np.sort(v64)
    np.testing.assert_array_equal(v64[order], finite)  # the keys sort as the floats


def test_upper_median_is_the_rank_n_half_element():
    from eig_kl_tpu_torch.ops.select import kth_smallest, upper_median

    for dtype in (torch.float32, torch.float64):
        v = torch.as_tensor(np.random.default_rng(9).standard_normal(1001)).to(dtype)
        med = upper_median(v)
        assert med.dim() == 0 and med.dtype == dtype
        assert float(med) == float(torch.sort(v).values[500])
        assert float(upper_median(v, 998)) == float(torch.sort(v).values[499])
    with pytest.raises(ValueError, match="rank"):
        kth_smallest(torch.ones(3), 3)
    with pytest.raises(TypeError):
        kth_smallest(torch.ones(3, dtype=torch.float16), 1)


def test_the_port_calls_no_kthvalue():
    pkg = pathlib.Path(__file__).resolve().parent.parent / "eig_kl_tpu_torch"
    hits = [str(p) for p in pkg.rglob("*.py") if "kthvalue" in p.read_text()]
    assert hits == []
