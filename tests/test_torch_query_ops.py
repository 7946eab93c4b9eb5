"""The query path's device programs in hyperspace_tpu_torch (on the CPU)
against the JAX package's: the predicate closures of
``ops.filter.compile_predicate`` give bit-equal masks, and the joins of
``ops.join`` give the same (left, right) pairs in the same order.
The inputs are drawn from seeded numpy generators; there is no
tolerance (every value is a copied input or a comparison)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from hyperspace_tpu.ops import filter as jfilter
from hyperspace_tpu.ops import join as jjoin
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.utils.compat import enable_x64
from hyperspace_tpu_torch.ops import filter as tfilter
from hyperspace_tpu_torch.ops import join as tjoin
from hyperspace_tpu_torch.plan import expr as texpr

_P24 = 1 << 24


def _columns():
    """An int64 column around 2**24 (and beyond 2**53) and a float64
    column with -0.0, NaN, inf and values one ulp around 2**24."""
    rng = np.random.default_rng(17)
    n = 4096
    a = np.concatenate([
        rng.integers(-50, 50, n // 4),
        _P24 + rng.integers(-4, 5, n // 4),
        rng.integers(-2**40, 2**40, n // 4),
        (1 << 53) + rng.integers(-3, 4, n // 4),
    ]).astype(np.int64)
    b = rng.standard_normal(n) * 20
    b[:64] = [0.0, -0.0, np.nan, np.inf, -np.inf, 0.5, 2.5, 7.0] * 8
    b[64:128] = _P24 + rng.integers(-2, 3, 64) + rng.choice([0.0, 0.5], 64)
    rng.shuffle(b)
    return {"a": a, "b": b}


# Each case builds one predicate from either package's ``col`` and ``lit``.
_PREDICATES = {
    "eq": lambda col, lit: col("a") == 7,
    "lt": lambda col, lit: col("a") < -3,
    "le": lambda col, lit: col("b") <= 0.5,
    "gt_float_literal_above_2_24": lambda col, lit: col("a") > 16777216.5,
    "ge_int_literal": lambda col, lit: col("a") >= 16777217,
    "eq_float_literal_on_int": lambda col, lit: col("a") == 16777217.0,
    "lt_float_literal_above_2_53": lambda col, lit: col("a") < 9007199254740993.0,
    "literal_on_the_left": lambda col, lit: lit(3) < col("a"),
    "neg_zero": lambda col, lit: col("b") == -0.0,
    "and_or_not": lambda col, lit: ((col("a") > 0) & (col("b") < 1.0))
    | ~(col("a") <= 16777216),
    "int_vs_float_columns": lambda col, lit: col("a") < col("b"),
    "isin_int": lambda col, lit: col("a").isin([-3, 2.5, 16777217, 99]),
    "isin_float": lambda col, lit: col("b").isin([0.5, 7, float("nan"), -0.0]),
    "arith_mul_float": lambda col, lit: col("a") * 1.5 > col("b"),
    "arith_add_sub": lambda col, lit: (col("a") + 3) - col("b") < 7,
    "arith_neg": lambda col, lit: -col("a") * 2 >= -10,
    "arith_above_2_24": lambda col, lit: (col("a") - 16777216) * 0.5 > 0.25,
    "arith_literals": lambda col, lit: col("b") < lit(2) * lit(1.5) + lit(1),
}


def _jax_mask(pred, cols):
    order = sorted(pred.referenced_columns())
    fn, literals = jfilter.compile_predicate(pred, order)
    with enable_x64():
        return np.asarray(fn([jnp.asarray(cols[c]) for c in order], literals))


def _torch_mask(pred, cols):
    order = sorted(pred.referenced_columns())
    fn, literals = tfilter.compile_predicate(pred, order)
    return fn([torch.from_numpy(cols[c]) for c in order], literals).numpy()


@pytest.mark.parametrize("name", sorted(_PREDICATES))
def test_predicate_mask_is_bit_equal_to_jax(name):
    cols = _columns()
    want = _jax_mask(_PREDICATES[name](jexpr.col, jexpr.lit), cols)
    got = _torch_mask(_PREDICATES[name](texpr.col, texpr.lit), cols)
    assert got.dtype == np.bool_ and got.shape == want.shape
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (name, {c: v[bad[:5]] for c, v in cols.items()})


def test_float_literal_against_int64_compares_in_float64():
    """torch's default promotion would compare in float32, where
    16777217 reads as 16777216 and is not above 16777216.5."""
    col = torch.tensor([16777215, 16777216, 16777217, 16777218])
    fn, literals = tfilter.compile_predicate(texpr.col("a") > 16777216.5, ["a"])
    assert fn([col], literals).tolist() == [False, False, True, True]


def test_predicate_cache_hits_when_only_literals_differ():
    fn1, lits1 = tfilter.compile_predicate(texpr.col("a") < 3, ["a"])
    fn2, lits2 = tfilter.compile_predicate(texpr.col("a") < 7, ["a"])
    assert fn1 is fn2 and lits1 == [3] and lits2 == [7]
    col = torch.arange(10)
    assert fn2([col], lits2).sum().item() == 7
    # IN values are part of the structure: another list, another closure.
    fn3, _ = tfilter.compile_predicate(texpr.col("a").isin([1]), ["a"])
    fn4, _ = tfilter.compile_predicate(texpr.col("a").isin([2]), ["a"])
    assert fn3 is not fn4


def test_division_is_not_device_evaluable():
    with pytest.raises(ValueError, match="Division"):
        tfilter.compile_predicate(texpr.col("a") / 2 > 1, ["a"])


def test_build_value_fn_matches_jax():
    cols = _columns()
    jfn, jlits = jfilter.build_value_fn(
        jexpr.col("a") * 1.5 - -jexpr.col("b"), ["a", "b"])
    tfn, tlits = tfilter.build_value_fn(
        texpr.col("a") * 1.5 - -texpr.col("b"), ["a", "b"])
    with enable_x64():
        want = np.asarray(jfn([jnp.asarray(cols["a"]), jnp.asarray(cols["b"])],
                              jlits))
    got = tfn([torch.from_numpy(cols["a"]), torch.from_numpy(cols["b"])],
              tlits).numpy()
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want, equal_nan=True)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------
def _join_cases():
    rng = np.random.default_rng(23)
    nan = float("nan")
    return {
        "empty_left": (np.empty(0, np.int64), rng.integers(0, 9, 50)),
        "empty_right": (rng.integers(0, 9, 50), np.empty(0, np.int64)),
        "no_matches": (rng.integers(0, 50, 200), rng.integers(100, 150, 300)),
        "heavy_duplicates": (rng.integers(0, 5, 300), rng.integers(0, 5, 400)),
        "int32_fitting": (rng.integers(-2**31, 2**31, 500),
                          rng.integers(-2**31, 2**31, 500)),
        "beyond_int32": (rng.integers(2**31, 2**31 + 40, 300) * 3,
                         rng.integers(2**31, 2**31 + 40, 300) * 3),
        "negative": (rng.integers(-30, 0, 300), rng.integers(-30, 5, 200)),
        "int64_extremes": (np.array([-2**63, 2**63 - 1, 0, -1, 2**63 - 1]),
                           np.array([2**63 - 1, -2**63, -1, 7])),
        "float_nan_and_signed_zero": (
            np.array([0.0, -0.0, nan, 1.0, -nan, 2.5, np.inf, -np.inf, nan]),
            np.array([nan, -0.0, 0.0, 1.0, np.inf, -nan, 2.5, 0.0, -np.inf])),
        "float_duplicates": (rng.integers(0, 6, 300) / 2.0,
                             rng.integers(0, 6, 300) / 2.0),
        "int_left_float_right": (rng.integers(0, 10, 200),
                                 rng.integers(0, 20, 200) / 2.0),
    }


def _jax_pairs(fn, lk, rk):
    li, ri = fn(lk, rk)
    return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)


@pytest.mark.parametrize("case", sorted(_join_cases()))
def test_sorted_equi_join_pairs_and_order_equal_jax(case):
    lk, rk = _join_cases()[case]
    want = _jax_pairs(jjoin.sorted_equi_join, lk, rk)
    got = tjoin.sorted_equi_join(lk, rk, device="cpu")
    # Tensors stay on their device, unnarrowed: the same pairs.
    got_t = tjoin.sorted_equi_join(torch.from_numpy(lk), torch.from_numpy(rk))
    for pairs in (got, got_t):
        assert pairs[0].dtype == pairs[1].dtype == np.int64
        assert np.array_equal(pairs[0], want[0])
        assert np.array_equal(pairs[1], want[1])


@pytest.mark.parametrize("case", sorted(_join_cases()))
def test_sorted_equi_join_np_equals_jax(case):
    lk, rk = _join_cases()[case]
    want = _jax_pairs(jjoin.sorted_equi_join_np, lk, rk)
    got = tjoin.sorted_equi_join_np(lk, rk)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_nan_keys_match_nan_keys_on_the_device_path():
    """The JAX device path's total order: NaN == NaN and -0.0 == 0.0."""
    li, ri = tjoin.sorted_equi_join(np.array([float("nan"), -0.0]),
                                    np.array([0.0, -float("nan")]), device="cpu")
    assert sorted(zip(li.tolist(), ri.tolist())) == [(0, 1), (1, 0)]


def _composite_tables():
    rng = np.random.default_rng(29)
    n = 400

    def table():
        k = rng.integers(0, 12, n)
        s = np.array([f"s{v}" for v in rng.integers(0, 6, n)], dtype=object)
        mask = rng.random(n) < 0.05
        return pa.table({
            "k": pa.array(k, type=pa.int64()),
            "s": pa.array(s, mask=mask),
            "f": pa.array(rng.integers(0, 4, n) / 2.0),
        })

    return table(), table()


@pytest.mark.parametrize("on_device", [True, False])
@pytest.mark.parametrize("keys", [("k", "s"), ("s",), ("k", "f")])
def test_hashed_equi_join_equals_jax(on_device, keys):
    left, right = _composite_tables()
    keys = list(keys)
    want = _jax_pairs(
        lambda a, b: jjoin.hashed_equi_join(a, b, keys, keys, device=on_device),
        left, right)
    got = tjoin.hashed_equi_join(left, right, keys, keys,
                                 torch.device("cpu") if on_device else None)
    assert got[0].size > 0
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_hashed_equi_join_refuses_string_against_int():
    left = pa.table({"k": pa.array(["1", "2"])})
    right = pa.table({"k": pa.array([1, 2])})
    with pytest.raises(tjoin.UnsupportedJoinKeys):
        tjoin.hashed_equi_join(left, right, ["k"], ["k"], None)


def test_key_digests_equal_jax():
    left, _ = _composite_tables()
    for null_salt in (1, 2):
        assert np.array_equal(
            tjoin.key_digests(left, ["k", "s", "f"], null_salt),
            jjoin.key_digests(left, ["k", "s", "f"], null_salt))
