"""The device mesh of one process and its rule-driven sharding layer
(counterpart of hyperspace_tpu/parallel/mesh.py).

The JAX mesh spans the process's local devices; torch has no virtual
devices, so the mesh here is a small value type, :class:`Mesh`: an
ordered tuple of ``torch.device``s, one per logical shard.  A device may
repeat, so eight shards on ``cuda:0`` (or on ``cpu``) form a valid mesh.
One axis name is used throughout: ``"shard"``, the data axis.  Rows are
split over it in order (shard ``d`` holds rows ``[d * L, (d + 1) * L)``
with ``L = ceil(n / size)``; the last shards may be short or empty), and
after routing a bucket is owned by one shard.  ``shard_map``'s body
becomes a plain loop over the shards, each shard's tensors on its own
device; the shards of one device run one after another on its current
stream.

Three layers sit on the bare mesh, as in the JAX package:

  - **the rule table** (:data:`PARTITION_RULES`,
    :func:`match_partition_rules`): array names map to a spec by regex,
    first match wins.  A spec is the marker :data:`SHARD_AXIS` (split
    rows over the mesh) or None (every shard gets the whole array).
  - **shard/gather fns** (:func:`make_shard_and_gather_fns`): per named
    array, a shard fn that places a host array on the mesh (a list of
    per-shard tensors) and a gather fn that brings the shards back to the
    host through one attributed ``sync_guard.pull`` at site
    ``<site>.<name>``, so the read-back stays visible to the sync guard
    and to ``exec.transfer.d2h.bytes``.
  - **the conf gate** (:func:`active_mesh`): ``conf.mesh_enabled`` --
    "auto" (the default) builds the mesh when at least 2 local devices
    are seen, "off" keeps every caller on the single-device path (the
    same bytes and answers), ``mesh_max_devices`` caps the span.  None
    means "no mesh": the sharded paths are never half taken.

:func:`local_devices` is the one place the port counts devices: one
entry per CUDA card for a CUDA session, ``[cpu]`` for a CPU session.
So under "auto" one card never takes a mesh route, as one TPU chip does
not.  Replacing it (a test's monkeypatch) with N copies of the session's
device gives N logical shards, the counterpart of the JAX tests'
``--xla_force_host_platform_device_count=8``.  The 2-axis ``(dcn,
ici)`` mesh and the process group are ``parallel/multihost.py``'s.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SHARD_AXIS = "shard"

# Name pattern -> spec, first match wins.  Row-wise data planes split
# over the data axis; per-shard scalars (counts) are one slot per shard,
# which on a 1-D mesh is the same row split; everything else replicates.
PARTITION_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    (r"^(hash|order|key|row)_words$", SHARD_AXIS),
    (r"^(payload|valid|codes|values|value_cols)$", SHARD_AXIS),
    (r"^(routed|records|recv|mask|perm|boundaries)$", SHARD_AXIS),
    (r"^(counts|overflow|totals|n_groups|n_valid)$", SHARD_AXIS),
    (r".", None),  # replicate by default (literals, thresholds)
)


class Mesh:
    """A 1-D mesh: one ``torch.device`` per logical shard, in order."""

    __slots__ = ("devices",)
    axis_names = (SHARD_AXIS,)

    def __init__(self, devices: Sequence) -> None:
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def shard_bounds(n: int, size: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each shard's rows when ``n`` rows split over
    ``size`` shards: ``ceil(n / size)`` rows each, in order."""
    local = -(-n // size) if size else 0
    return [(min(n, d * local), min(n, (d + 1) * local)) for d in range(size)]


def match_partition_rules(names: Sequence[str],
                          rules: Sequence[Tuple[str, Optional[str]]]
                          = PARTITION_RULES) -> Dict[str, Optional[str]]:
    """The spec of each array name, first matching rule wins.  Every name
    must match a rule (the catch-all replicate rule is last and
    explicit); the table, not the call site, owns the placement."""
    out: Dict[str, Optional[str]] = {}
    for name in names:
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                out[name] = spec
                break
        else:
            raise ValueError(f"No partition rule matches array {name!r}")
    return out


def make_shard_and_gather_fns(mesh: Mesh, specs: Dict[str, Optional[str]],
                              site: str = "mesh"
                              ) -> Tuple[Dict[str, Callable],
                                         Dict[str, Callable]]:
    """(shard_fns, gather_fns) keyed like ``specs``.

    ``shard_fns[name](x)`` places ``x`` (a numpy array or a tensor) on the
    mesh as a list of one tensor per shard, each on its shard's device:
    its rows split in order under :data:`SHARD_AXIS`, the whole array on
    every shard under None.  ``gather_fns[name](shards)`` is the HOST
    GATHER SEAM: the shards concatenated on the first one's device and
    pulled to the host by one attributed ``sync_guard.pull`` at site
    ``<site>.<name>``."""
    from hyperspace_tpu_torch.execution import sync_guard

    def make_shard_fn(spec: Optional[str]):
        def shard_fn(x) -> List[torch.Tensor]:
            t = x if isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.require(x, requirements="CW"))
            if spec is None:
                return [t.to(dev) for dev in mesh.devices]
            return [t[lo:hi].to(dev) for (lo, hi), dev in
                    zip(shard_bounds(t.shape[0], mesh.size), mesh.devices)]

        return shard_fn

    def make_gather_fn(name: str):
        def gather_fn(shards) -> np.ndarray:
            if isinstance(shards, torch.Tensor):
                return sync_guard.pull(shards, f"{site}.{name}")
            first = shards[0].device
            return sync_guard.pull(torch.cat([s.to(first) for s in shards]),
                                   f"{site}.{name}")

        return gather_fn

    shard_fns = {name: make_shard_fn(spec) for name, spec in specs.items()}
    gather_fns = {name: make_gather_fn(name) for name in specs}
    return shard_fns, gather_fns


def local_devices(device=None) -> List[torch.device]:
    """The devices this process can shard over for a session on
    ``device`` (``cuda`` when None): every CUDA card for a CUDA session,
    ``[cpu]`` for a CPU one.  The one place the port counts devices."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def build_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A 1-D mesh over ``devices``, or over the first ``n_devices`` of
    :func:`local_devices` for a session on ``device`` (all by
    default)."""
    if devices is None:
        devices = local_devices(device)
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices)


def mesh_mode(conf) -> str:
    """The validated ``conf.mesh_enabled``: "auto", "on" or "off"."""
    mode = str(getattr(conf, "mesh_enabled", "auto")).lower()
    if mode in ("true", "on"):
        return "on"
    if mode in ("false", "off"):
        return "off"
    if mode != "auto":
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        raise HyperspaceError(
            f"Invalid {mode!r} for hyperspace.parallel.mesh.enabled; "
            f"expected 'auto', 'on', or 'off'")
    return mode


def active_mesh(conf=None, device=None) -> Optional[Mesh]:
    """The engine mesh for a session on ``device`` per ``conf``, or None
    when the sharded paths must not run: mesh off, or fewer than 2
    devices (a 1-shard mesh has nothing to shard, and the single-device
    path is the reference).  ``conf.mesh_max_devices`` (> 0) caps the
    span."""
    mode = mesh_mode(conf) if conf is not None else "auto"
    if mode == "off":
        return None
    devices = list(local_devices(device))
    cap = int(getattr(conf, "mesh_max_devices", 0) or 0) \
        if conf is not None else 0
    if cap > 0:
        devices = devices[:cap]
    if len(devices) < 2:
        return None
    return Mesh(devices)
