"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU each wrapper of ``hyperspace_tpu_torch.ops.kernels`` runs its
plain PyTorch version; the JAX kernels run in Pallas interpret mode, as
tests/test_pallas_kernels.py runs them.  Every value is an integer, so
every comparison is bit-exact.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperspace_tpu.ops.pallas_kernels import bucket_histogram as jax_histogram
from hyperspace_tpu.ops.pallas_kernels import hash_buckets as jax_hash_buckets
from hyperspace_tpu_torch.ops import kernels


def _words(n, cols, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
            for _ in range(cols)]


def _port_hash(words, num_buckets):
    return kernels.hash_buckets([torch.from_numpy(w) for w in words],
                                num_buckets).numpy()


def _jax_hash(words, num_buckets):
    out = jax_hash_buckets(tuple(jnp.asarray(w) for w in words), num_buckets)
    return np.asarray(out).astype(np.int32)  # bucket_ids_pallas's cast


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 32768, 32769, 100_003])
def test_hash_parity(n):
    words = _words(n, cols=2, seed=0)
    np.testing.assert_array_equal(_port_hash(words, 0), _jax_hash(words, 0))


@pytest.mark.parametrize("cols", [1, 2, 3])
@pytest.mark.parametrize("num_buckets", [0, 1, 13, 200, 4096])
def test_bucket_ids_parity(cols, num_buckets):
    words = _words(10_000, cols=cols, seed=1)
    got = _port_hash(words, num_buckets)
    np.testing.assert_array_equal(got, _jax_hash(words, num_buckets))
    if num_buckets:
        assert got.min() >= 0 and got.max() < num_buckets


@pytest.mark.parametrize("n,num_buckets", [
    (1, 1), (100, 7), (4096, 128), (4097, 129), (50_000, 200), (1000, 4096),
    (32769, 13), (100_003, 4096),
])
def test_histogram_parity(n, num_buckets):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, num_buckets, size=n, dtype=np.int32)
    got = kernels.bucket_histogram(torch.from_numpy(ids), num_buckets).numpy()
    want = np.asarray(jax_histogram(jnp.asarray(ids), num_buckets))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and int(got.sum()) == n


def test_histogram_padding_counts_nowhere():
    """-1 padding (and any id outside [0, num_buckets)) counts nowhere."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 40, size=20_000).astype(np.int32)
    got = kernels.bucket_histogram(torch.from_numpy(ids), 32).numpy()
    want = np.asarray(jax_histogram(jnp.asarray(ids), 32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.bincount(ids[(ids >= 0) & (ids < 32)], minlength=32))


def test_histogram_empty_input():
    got = kernels.bucket_histogram(torch.empty(0, dtype=torch.int32), 64)
    want = np.asarray(jax_histogram(jnp.asarray(np.empty(0, np.int32)), 64))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.zeros(64, np.int32))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    words = [torch.from_numpy(w) for w in _words(500, cols=2, seed=4)]
    kernels.hash_buckets(words, 16)
    kernels.bucket_histogram(torch.zeros(10, dtype=torch.int32), 4)
    assert kernels.launch_counts() == {"hash_buckets": 0, "bucket_histogram": 0}


def test_wrappers_refuse_bad_input():
    good = torch.zeros((4, 2), dtype=torch.uint32)
    with pytest.raises(ValueError):
        kernels.hash_buckets([good.to(torch.int32)], 4)     # dtype
    with pytest.raises(ValueError):
        kernels.hash_buckets([torch.zeros((4, 3), dtype=torch.uint32)], 4)
    with pytest.raises(ValueError):
        kernels.hash_buckets([good, torch.zeros((5, 2), dtype=torch.uint32)], 4)
    with pytest.raises(ValueError):
        kernels.hash_buckets([], 4)
    with pytest.raises(ValueError):
        kernels.bucket_histogram(torch.zeros(4, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        kernels.bucket_histogram(torch.zeros((2, 2), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        kernels.bucket_histogram(torch.zeros(4, dtype=torch.int32), 0)


def test_no_fallback_off_the_cpu():
    """A tensor on a device other than the CPU never takes the plain
    version: a non-CUDA device is refused outright."""
    with pytest.raises(ValueError):
        kernels.hash_buckets([torch.zeros((4, 2), dtype=torch.uint32,
                                          device="meta")], 4)
    with pytest.raises(ValueError):
        kernels.bucket_histogram(torch.zeros(4, dtype=torch.int32,
                                             device="meta"), 4)


def _fold_chunks(words, num_buckets):
    """The plain hash run over the CUDA wrapper's launch schedule: one
    call per chunk, each later one carrying the running hash."""
    cols = [torch.from_numpy(w) for w in words]
    h = None
    for start, stop, carry, buckets in kernels.hash_chunks(len(cols),
                                                           num_buckets):
        assert carry == (h is not None)
        h = kernels.hash_buckets_plain(cols[start:stop], buckets, h)
    return h.numpy()


@pytest.mark.parametrize("cols", [kernels.HASH_MAX_COLS + 1, 40])
@pytest.mark.parametrize("num_buckets", [0, 16, 200])
def test_chunked_hash_parity(cols, num_buckets):
    """More key columns than one launch takes: the chunk schedule, folded
    through the plain version, equals the Pallas kernel over all."""
    words = _words(3000, cols=cols, seed=5)
    want = _jax_hash(words, num_buckets)
    np.testing.assert_array_equal(_fold_chunks(words, num_buckets), want)
    np.testing.assert_array_equal(_port_hash(words, num_buckets), want)


@pytest.mark.parametrize("split", [1, 2, 5])
@pytest.mark.parametrize("num_buckets", [0, 13, 4096])
def test_hash_carry_contract(split, num_buckets):
    """Hashing columns [:split] with no buckets, then the rest from that
    running hash, equals hashing all of them at once."""
    words = _words(1001, cols=6, seed=6)
    cols = [torch.from_numpy(w) for w in words]
    h = kernels.hash_buckets_plain(cols[:split], 0)
    got = kernels.hash_buckets_plain(cols[split:], num_buckets, h).numpy()
    np.testing.assert_array_equal(got, _jax_hash(words, num_buckets))


def test_hash_chunk_schedule():
    m = kernels.HASH_MAX_COLS
    assert kernels.hash_chunks(1, 7) == [(0, 1, False, 7)]
    assert kernels.hash_chunks(m, 7) == [(0, m, False, 7)]
    assert kernels.hash_chunks(m + 1, 7) == [(0, m, False, 0),
                                             (m, m + 1, True, 7)]
    assert kernels.hash_chunks(2 * m + 3, 0) == [
        (0, m, False, 0), (m, 2 * m, True, 0), (2 * m, 2 * m + 3, True, 0)]


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("num_buckets", [0, 200])
def test_hash_on_sliced_views(offset, num_buckets):
    """Key columns that start inside a larger tensor (as ``big[1:]`` does
    on the card, 8- but not 16-byte aligned) hash as the JAX kernel."""
    words = _words(4099, cols=2, seed=7)
    views = []
    for w in words:
        big = torch.zeros((w.shape[0] + offset, 2), dtype=torch.uint32)
        big[offset:] = torch.from_numpy(w)
        views.append(big[offset:])
        assert views[-1].is_contiguous() and views[-1].storage_offset() == 2 * offset
    got = kernels.hash_buckets(views, num_buckets).numpy()
    np.testing.assert_array_equal(got, _jax_hash(words, num_buckets))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("num_buckets", [16, 200, 1025])
def test_histogram_on_sliced_views(offset, num_buckets):
    """Ids that start inside a larger tensor (a head of 1-3 ids before a
    16-byte boundary on the card) count as the JAX kernel counts them."""
    rng = np.random.default_rng(8)
    ids = rng.integers(-1, num_buckets, size=10_001).astype(np.int32)
    big = torch.full((ids.shape[0] + offset,), 7, dtype=torch.int32)
    big[offset:] = torch.from_numpy(ids)
    view = big[offset:]
    assert view.is_contiguous() and view.storage_offset() == offset
    got = kernels.bucket_histogram(view, num_buckets).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_histogram(jnp.asarray(ids), num_buckets)))


def _hammer(fn, threads=16, calls=400):
    """``fn`` from ``threads`` threads at once, with the interpreter's
    switch interval cut so a lost update has every chance to show."""
    import sys
    import threading

    start = threading.Barrier(threads)
    errors = []

    def work():
        start.wait(timeout=30)
        try:
            for _ in range(calls):
                fn()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert errors == []
    finally:
        sys.setswitchinterval(interval)
    return threads * calls


def test_launch_counts_lose_nothing_under_concurrent_launches():
    """The spill build launches from several route threads at once."""

    class FakeLib:
        def hs_fake(self, *args):
            return 0

    k = kernels._Kernel("fake.cu", "hs_fake", [])
    k.lib = FakeLib()
    assert k.launches == 0
    assert _hammer(k.launch) == k.launches


def test_one_accumulator_per_stream_under_concurrent_first_calls(
        monkeypatch):
    """Concurrent first histogram calls on one (device, stream) share one
    accumulator: the lookup-or-grow is one step.  (CPU tensors stand in
    for the card's; a CPU build of torch has no capture to ask about.)"""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    device, stream = torch.device("cpu", 0), -12345
    try:
        _hammer(lambda: kernels._accumulator(device, stream, 200))
        held = kernels._ACCUMULATORS[(0, stream)]
        assert len(held) == 1 and held[0].numel() == 1 + 1024
    finally:
        kernels._ACCUMULATORS.pop((0, stream), None)
