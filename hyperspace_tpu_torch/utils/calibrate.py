"""Measured device-routing thresholds (counterpart of
hyperspace_tpu/utils/calibrate.py): the attachment is probed once per
device at first use, and a row threshold per op kind is derived from
what was measured:

    device_time(R) ~ latency + R * bytes_per_row / bandwidth
    host_time(R)   ~ R / host_rows_per_s          (measured per op kind)
    threshold      = smallest R where device_time < host_time
                     (capped at NEVER_MIN_ROWS when the per-row transfer
                     alone exceeds the host's per-row cost)

The device's compute rate is not probed: the model assumes the card's
compute is never the bottleneck, so a threshold is the point where the
transfer's latency is paid back.  The model charges a transfer its bytes
only, not the host conversion in front of the copy.  The formulas and
constants are the JAX package's; only the transfer probe is torch's: a
pageable ``.to(device)`` and ``.cpu()``, the copies the executor's
``_device_column`` and its read backs pay.

Explicit conf values always win (``HyperspaceConf.device_min_rows``).
``HS_CALIBRATE=0`` disables the probe, and a device on the CPU keeps the
static constants: on the CPU the "device" kernels are the host's own.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional, Tuple, Union

import torch

# Conservative fallbacks, used when calibration is disabled, the probe
# failed, or the device is the CPU.
STATIC_MIN_ROWS: Dict[str, int] = {
    "filter": 1 << 26,
    "join": 1 << 26,
    "agg": 1 << 26,
    "join_agg": 1 << 26,
    "build": 1 << 22,
}

# "Device never organically wins": finite, so conf arithmetic and JSON
# round trips stay safe, and far above any batch.
NEVER_MIN_ROWS = 1 << 40

# Fallbacks of the thresholds for inputs already resident on the device
# (execution/device_cache.py; only the round trip's latency is left to
# repay).
STATIC_RESIDENT_MIN_ROWS: Dict[str, int] = {
    "filter": 1 << 24,
    "join": 1 << 22,
    "agg": 1 << 22,
    # The fused join+aggregate returns O(groups), not O(rows), so its
    # resident break-even sits well below the plain join's.
    "join_agg": 1 << 20,
    "build": 1 << 22,
}

# Bytes shipped to the device per row, per op kind (the dominant
# transfer):
#   filter: two 8-B columns up, 1-B mask down
#   join:   8-B keys both sides up, two 8-B index vectors down
#   agg:    (n,2)-u32 key words + one f64 value column up, results down
#   build:  (n,2)-u32 hash words + (n,2)-u32 order words up, 2x i32 down
_BYTES_PER_ROW: Dict[str, float] = {
    "filter": 17.0,
    "join": 32.0,
    "agg": 24.0,
    # Keys of both sides plus ~3 referenced value or group columns up;
    # results come back per group.
    "join_agg": 40.0,
    "build": 24.0,
}


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """The measured attachment and the host's rates per op kind."""

    platform: str
    latency_s: float           # host -> device -> host round trip
    h2d_bytes_per_s: float     # host -> device bandwidth
    d2h_bytes_per_s: float     # device -> host bandwidth
    host_rows_per_s: Dict[str, float]  # per op kind

    def _host_rate(self, kind: str) -> float:
        """The host rate of ``kind``; a profile without a ``join_agg``
        rate derives it from join and agg, which its host mirror runs
        one after the other."""
        rate = self.host_rows_per_s.get(kind)
        if rate is None and kind == "join_agg":
            j = self.host_rows_per_s["join"]
            a = self.host_rows_per_s["agg"]
            rate = 1.0 / (1.0 / j + 1.0 / a)
        if rate is None:
            raise KeyError(f"Unknown device op kind: {kind!r}")
        return rate

    def min_rows(self, kind: str) -> int:
        """Break-even row count of ``kind`` under this profile."""
        host_s_per_row = 1.0 / self._host_rate(kind)
        transfer_s_per_row = _BYTES_PER_ROW[kind] / self.h2d_bytes_per_s
        margin = host_s_per_row - transfer_s_per_row
        if margin <= 0:
            # The per-row transfer alone costs more than the host's row.
            return NEVER_MIN_ROWS
        rows = self.latency_s / margin
        # A power of two: thresholds are routing knobs.
        threshold = 1 << max(0, (int(rows) - 1).bit_length())
        return min(threshold, NEVER_MIN_ROWS)

    def resident_min_rows(self, kind: str) -> int:
        """Break-even row count when the inputs are already resident: only
        the round trips are left to repay (the fused join+aggregate syncs
        on the match count and the group count and reads its groups back,
        three trips; the other two-phase programs sync once mid-flight,
        two), assuming the device's compute beats the host mirror at any
        size that clears this."""
        trips = 3.0 if kind == "join_agg" else 2.0
        rows = trips * self.latency_s * self._host_rate(kind)
        threshold = 1 << max(12, (max(1, int(rows)) - 1).bit_length())
        return min(threshold, NEVER_MIN_ROWS)


# One profile per device, probed once: concurrent first queries must not
# each run the probe (timings taken under mutual load would be kept as
# the routing physics).
_PROFILES: Dict[str, DeviceProfile] = {}
_FAILED: set = set()
_PROBE_LOCK = threading.Lock()


def calibration_enabled() -> bool:
    return os.environ.get("HS_CALIBRATE", "1").lower() not in ("0", "false")


def _median_time(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _probe_host_rates(n: int = 1 << 20) -> Dict[str, float]:
    """Host rows per second of each op kind's dominant host-mirror cost:
    an arrow elementwise compare (filter), a numpy argsort (join: the
    mirror is sort + searchsorted), an arrow hash aggregation (agg) and a
    numpy 3-key lexsort (build)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    rng = np.random.default_rng(0)
    ints = rng.integers(0, n, n)
    arr = pa.array(ints)
    tbl = pa.table({"k": ints % 1024, "v": rng.random(n)})

    t_filter = _median_time(lambda: pc.greater(arr, n // 2))
    t_join = _median_time(lambda: np.argsort(ints, kind="stable"))
    t_agg = _median_time(
        lambda: tbl.group_by("k").aggregate([("v", "sum")]))
    u32 = (ints % (1 << 31)).astype(np.uint32)
    t_build = _median_time(lambda: np.lexsort((u32, u32, u32 % 16)))
    return {
        "filter": n / max(t_filter, 1e-9),
        "join": n / max(t_join, 1e-9),
        "agg": n / max(t_agg, 1e-9),
        # The fused pipeline's host mirror does both: join, then hash-agg.
        "join_agg": n / max(t_join + t_agg, 1e-9),
        "build": n / max(t_build, 1e-9),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_transfer(device: torch.device) -> Tuple[str, float, float, float]:
    """(platform, latency_s, h2d_Bps, d2h_Bps) of ``device``: pageable
    copies, the ones the executor's uploads and read backs pay."""
    small = torch.zeros(8, dtype=torch.float32)
    # Warm the dispatch once before timing, so that the CUDA context's
    # creation is not read as latency.
    small.to(device).cpu()
    latency = _median_time(lambda: small.to(device).cpu())

    big = torch.zeros(1 << 16, dtype=torch.float32)  # 256 KiB
    nbytes = big.numel() * big.element_size()

    def h2d() -> None:
        _sync(device)
        big.to(device)
        _sync(device)

    h2d()  # warm
    t_h2d = max(_median_time(h2d) - latency / 2, 1e-9)
    # Each timed read back copies a distinct resident tensor.
    residents = [(big + float(i)).to(device) for i in range(3)]
    _sync(device)
    times = []
    for r in residents:
        t0 = time.perf_counter()
        r.cpu()
        times.append(time.perf_counter() - t0)
    times.sort()
    t_d2h = max(times[len(times) // 2] - latency / 2, 1e-9)
    return device.type, latency, nbytes / t_h2d, nbytes / t_d2h


def _as_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_profile(device: Union[str, torch.device],
                   refresh: bool = False) -> Optional[DeviceProfile]:
    """The measured profile of ``device`` (probed once per process), or
    None when calibration is disabled or the probe failed."""
    if not calibration_enabled():
        return None
    device = _as_device(device)
    key = str(device)
    with _PROBE_LOCK:
        if key in _PROFILES and not refresh:
            return _PROFILES[key]
        if key in _FAILED and not refresh:
            return None
        try:
            from hyperspace_tpu_torch.execution import sync_guard

            # The probe times read-backs on purpose: an allowance window
            # keeps the strict guard from failing it into the constants.
            with sync_guard.allowed():
                platform, latency, h2d, d2h = _probe_transfer(device)
            profile = DeviceProfile(
                platform=platform,
                latency_s=latency,
                h2d_bytes_per_s=h2d,
                d2h_bytes_per_s=d2h,
                host_rows_per_s=_probe_host_rates(),
            )
        except Exception:  # noqa: BLE001 — the routes keep the constants
            _FAILED.add(key)
            _PROFILES.pop(key, None)
            return None
        _FAILED.discard(key)
        _PROFILES[key] = profile
        return profile


def _profile_for_routing(device) -> Optional[DeviceProfile]:
    """The profile that routes work on ``device``: none on the CPU,
    which keeps the constants without probing."""
    if torch.device(device).type == "cpu":
        return None
    return device_profile(device)


def calibrated_min_rows(kind: str, device: Union[str, torch.device]) -> int:
    """The threshold of ``kind`` on ``device``: measured when possible,
    the static constants otherwise (calibration off, a failed probe, or
    the CPU)."""
    if kind not in STATIC_MIN_ROWS:
        raise KeyError(f"Unknown device op kind: {kind!r}")
    profile = _profile_for_routing(device)
    if profile is None or profile.platform == "cpu":
        return STATIC_MIN_ROWS[kind]
    return profile.min_rows(kind)


def calibrated_resident_min_rows(kind: str,
                                 device: Union[str, torch.device]) -> int:
    """The threshold of ``kind`` for resident inputs on ``device`` (the
    static constants in the same three cases)."""
    if kind not in STATIC_RESIDENT_MIN_ROWS:
        raise KeyError(f"Unknown device op kind: {kind!r}")
    profile = _profile_for_routing(device)
    if profile is None or profile.platform == "cpu":
        return STATIC_RESIDENT_MIN_ROWS[kind]
    return profile.resident_min_rows(kind)


def profile_summary(device: Union[str, torch.device]) -> Dict[str, object]:
    """JSON-ready view of ``device``'s profile (probed here even on the
    CPU) and the thresholds in effect."""
    profile = device_profile(device)
    if profile is None:
        return {"calibrated": False,
                "thresholds": dict(STATIC_MIN_ROWS),
                "resident_thresholds": dict(STATIC_RESIDENT_MIN_ROWS)}
    return {
        "calibrated": True,
        "platform": profile.platform,
        "latency_ms": round(profile.latency_s * 1e3, 3),
        "h2d_mb_per_s": round(profile.h2d_bytes_per_s / 1e6, 2),
        "d2h_mb_per_s": round(profile.d2h_bytes_per_s / 1e6, 2),
        "host_mrows_per_s": {k: round(v / 1e6, 2)
                             for k, v in profile.host_rows_per_s.items()},
        "thresholds": {k: calibrated_min_rows(k, device)
                       for k in STATIC_MIN_ROWS},
        "resident_thresholds": {k: calibrated_resident_min_rows(k, device)
                                for k in STATIC_RESIDENT_MIN_ROWS},
    }
