"""Hand-written CUDA kernels of the build path, with their plain versions.

Two kernels, the counterparts of the JAX package's two Pallas kernels
(hyperspace_tpu/ops/pallas_kernels.py):

  - ``hash_buckets`` (csrc/hash_buckets.cu): the fused murmur3 row hash,
    or bucket ids when ``num_buckets > 0``.
  - ``bucket_histogram`` (csrc/bucket_histogram.cu): int32 rows per
    bucket; ids outside ``[0, num_buckets)`` count nowhere.

Each wrapper takes the kernel's plain PyTorch version for a tensor that
lies on the CPU and launches the kernel for a CUDA tensor (or raises:
there is no fallback).  Each launch adds one to the kernel's
``launches`` count, so a run can show that its main path went through
the kernel.  The wrappers may be called from several threads at once
(the spill build's route workers): the count and the accumulator lookup
are locked.

Neither wrapper copies to the card or synchronises, so both can be
captured in a CUDA graph.  The hash passes its column pointers by value,
in a kernel parameter of up to ``HASH_MAX_COLS`` pointers; more columns
are hashed in chunks, one launch each, every later launch carrying the
running hash in its output.  The histogram is one launch: each block
adds its counts into an accumulator with global atomics, and the last
block to finish (by an atomic ticket beside the accumulator) moves them
into the output and zeroes the accumulator for the next launch, so the
output needs no zero-fill.  The wrapper zeroes the accumulator once and
keeps one per device and stream, so launches on different streams never
share one; it is made outside graph capture (call the histogram once on
the capture stream before capturing it).

The kernels are compiled for ``sm_90a`` with ``nvcc`` at first use, one
``nvcc`` per source started together, into ``csrc/build/`` (each library
is named by the hash of its source, so an edited source never loads a
stale build), and bound with ``ctypes`` through a plain C interface.

torch on the CPU has no uint32 ``>>`` or ``%``, so the plain hash does
its 32-bit arithmetic in int64 and masks with ``& 0xFFFFFFFF`` after
every multiply (int32 would give an arithmetic ``>>`` and break the
hash); the CUDA kernel uses native ``uint32_t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC / "build"
_NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_SEED = 0x3C074A61


_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint


class KernelError(RuntimeError):
    """A kernel did not build, load or launch.  Never an ``OSError``, so
    no fallback that takes read errors (containment, the degraded rule
    boundary) can mistake the loader's failure for the index's."""


class _Kernel:
    """One CUDA source: the C function it exports, its lazily built
    library, and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.lib = None
        # The spill build launches from several route threads at once, and
        # ``+= 1`` is a read-modify-write that could lose a count.
        self._count_lock = threading.Lock()

    def launch(self, *args) -> None:
        """Call the C launcher on the current stream; raise if the launch
        was refused (a refused launch never runs, and a later synchronise
        would not report it)."""
        if self.lib is None:
            build_kernels()
        err = getattr(self.lib, self.symbol)(*args)
        if err != 0:
            msg = self.lib.hs_error_string(err).decode()
            raise KernelError(f"{self.source}: launch failed ({err}): {msg}")
        with self._count_lock:
            self.launches += 1


# hs_hash_buckets(cols, n_cols, n, num_buckets, carry, out, stream);
# `cols` is a host array of device pointers.
HASH_BUCKETS = _Kernel("hash_buckets.cu", "hs_hash_buckets",
                       [_P, _I, _LL, _U, _I, _P, _P])
# Column pointers one hash launch takes (kMaxCols in hash_buckets.cu).
HASH_MAX_COLS = 32
# hs_bucket_histogram(ids, n, num_buckets, acc, out, stream)
BUCKET_HISTOGRAM = _Kernel("bucket_histogram.cu", "hs_bucket_histogram",
                           [_P, _LL, _I, _P, _P, _P])
KERNELS: Dict[str, _Kernel] = {"hash_buckets": HASH_BUCKETS,
                               "bucket_histogram": BUCKET_HISTOGRAM}
_BUILD_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source not yet built, one ``nvcc`` each, all
    started together, and load the libraries.  Idempotent.  Returns the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    of each source it compiled."""
    try:
        return _build_kernels()
    except OSError as e:
        raise KernelError(f"kernel build or load failed: {e}") from e


def _build_kernels() -> Dict[str, str]:
    logs: Dict[str, str] = {}
    with _BUILD_LOCK:
        todo = [k for k in KERNELS.values() if k.lib is None]
        if not todo:
            return logs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for k in todo:
            src = _CSRC / k.source
            digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
            lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
            proc = tmp = None
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.Popen(
                    [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            jobs.append((k, lib, proc, tmp))
        for k, lib, proc, tmp in jobs:
            if proc is not None:
                out, _ = proc.communicate()
                logs[k.source] = out.decode(errors="replace")
                if proc.returncode != 0:
                    raise KernelError(
                        f"nvcc failed on {k.source}:\n{logs[k.source]}")
                os.replace(tmp, lib)
            dll = ctypes.CDLL(str(lib))
            getattr(dll, k.symbol).argtypes = k.argtypes
            getattr(dll, k.symbol).restype = _I
            dll.hs_error_string.argtypes = [_I]
            dll.hs_error_string.restype = ctypes.c_char_p
            k.lib = dll
    return logs


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# hash_buckets
# ---------------------------------------------------------------------------
def _check_word_cols(word_cols: Sequence[torch.Tensor]) -> None:
    if not word_cols:
        raise ValueError("hash_buckets needs at least one key column")
    n = word_cols[0].shape[0]
    device = word_cols[0].device
    for w in word_cols:
        if w.dtype != torch.uint32 or w.dim() != 2 or w.shape[1] != 2:
            raise ValueError(
                f"key words must be (n, 2) uint32; got {tuple(w.shape)} {w.dtype}")
        if w.shape[0] != n or w.device != device:
            raise ValueError("key word columns differ in length or device")
        if not w.is_contiguous():
            raise ValueError("key word columns must be contiguous")


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` holding uint32 values: ``c`` is
    split into 16-bit halves so no partial product leaves int64's range."""
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (hi + h * (c & 0xFFFF)) & _MASK32


def _fmix32_plain(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def _as_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same 32 bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def hash_buckets_plain(word_cols: Sequence[torch.Tensor],
                       num_buckets: int = 0,
                       h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hash_buckets` (int64-masked words).

    ``h``: the running hash of earlier key columns, as this function
    returns it with ``num_buckets == 0`` ((n,) int32 holding the uint32
    bits); the hash then goes on from it instead of from the seed.  This
    is the kernel's chunk-and-carry contract: hashing columns ``[:m]``
    with 0 buckets, then ``[m:]`` from that ``h``, equals hashing all."""
    if h is None:
        h = torch.full((word_cols[0].shape[0],), _SEED, dtype=torch.int64,
                       device=word_cols[0].device)
    else:
        h = h.to(torch.int64) & _MASK32
    for w in word_cols:
        w = w.to(torch.int64)
        h = _fmix32_plain(_mul32(h, 31) ^ _fmix32_plain(w[:, 0]))
        h = _fmix32_plain(_mul32(h, 31) ^ _fmix32_plain(w[:, 1]))
    if num_buckets:
        h = h % num_buckets
    return _as_int32_bits(h)


def hash_chunks(n_cols: int, num_buckets: int):
    """The launches that hash ``n_cols`` key columns: per launch
    ``(start, stop, carry, buckets)``, the columns ``[start, stop)``,
    whether it goes on from the running hash in the output, and the
    buckets it applies (0 for all but the last)."""
    return [(start, min(start + HASH_MAX_COLS, n_cols), start > 0,
             num_buckets if start + HASH_MAX_COLS >= n_cols else 0)
            for start in range(0, n_cols, HASH_MAX_COLS)]


def hash_buckets(word_cols: Sequence[torch.Tensor],
                 num_buckets: int = 0) -> torch.Tensor:
    """Fused row hash (``num_buckets == 0``) or bucket ids, as (n,) int32
    holding the uint32 bits — ``bucket_ids_pallas``'s cast.

    ``word_cols``: per key column an (n, 2) uint32 tensor of (hi, lo)
    hash words (``io.columnar.to_hash_words``)."""
    word_cols = list(word_cols)
    _check_word_cols(word_cols)
    if not 0 <= num_buckets < 1 << 32:
        raise ValueError(f"num_buckets out of range: {num_buckets}")
    device = word_cols[0].device
    if device.type == "cpu":
        return hash_buckets_plain(word_cols, num_buckets)
    if device.type != "cuda":
        raise ValueError(f"hash_buckets: unsupported device {device}")
    for w in word_cols:
        if w.data_ptr() % 8:
            raise ValueError("key word columns must be 8-byte aligned")
    n = word_cols[0].shape[0]
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        stream = _stream(device)
        for start, stop, carry, buckets in hash_chunks(len(word_cols),
                                                       num_buckets):
            chunk = word_cols[start:stop]
            ptrs = (ctypes.c_void_p * len(chunk))(*[w.data_ptr() for w in chunk])
            HASH_BUCKETS.launch(ptrs, len(chunk), n, buckets, int(carry),
                                out.data_ptr(), stream)
    return out


# ---------------------------------------------------------------------------
# bucket_histogram
# ---------------------------------------------------------------------------
def _check_ids(ids: torch.Tensor, num_buckets: int) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(
            f"bucket ids must be (n,) int32; got {tuple(ids.shape)} {ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("bucket ids must be contiguous")
    if not 1 <= num_buckets < 1 << 31:
        raise ValueError(f"num_buckets out of range: {num_buckets}")


def bucket_histogram_plain(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucket_histogram`."""
    ids = ids[(ids >= 0) & (ids < num_buckets)].to(torch.int64)
    out = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    return out.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))


# Per (device, stream), the histogram's accumulators, newest (widest)
# last: each is [ticket, counts...], zeroed once and left zero by every
# launch.  Launches that share one must not overlap, and launches on one
# stream are ordered, so each stream has its own.  A wider one is added
# when needed and the older ones are kept, since a CUDA graph may hold a
# launch that uses them.  A graph's launches use the accumulator of the
# stream it was captured on: replay it in order with that stream's work.
_ACCUMULATORS: Dict[Tuple[int, int], list] = {}
# Route threads of the spill build call the histogram at once: the
# lookup-or-grow below is a check-then-act.
_ACCUMULATORS_LOCK = threading.Lock()


def _accumulator(device: torch.device, stream: int,
                 num_buckets: int) -> torch.Tensor:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _ACCUMULATORS_LOCK:
        held = _ACCUMULATORS.setdefault((index, stream), [])
        if not held or held[-1].numel() < 1 + num_buckets:
            # Under capture the zero fill would only be recorded, not run.
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "bucket_histogram: call it once on the capture stream, "
                    "with as many buckets, before capturing it in a CUDA graph")
            held.append(torch.zeros(1 + max(num_buckets, 1024),
                                    dtype=torch.int32, device=device))
        return held[-1]


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(num_buckets,) int32 rows per bucket of the (n,) int32 ``ids``;
    ids outside ``[0, num_buckets)`` count nowhere."""
    _check_ids(ids, num_buckets)
    device = ids.device
    if device.type == "cpu":
        return bucket_histogram_plain(ids, num_buckets)
    if device.type != "cuda":
        raise ValueError(f"bucket_histogram: unsupported device {device}")
    out = torch.empty(num_buckets, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = _stream(device)
        acc = _accumulator(device, stream, num_buckets)
        BUCKET_HISTOGRAM.launch(ids.data_ptr(), ids.shape[0], num_buckets,
                                acc.data_ptr(), out.data_ptr(), stream)
    return out
