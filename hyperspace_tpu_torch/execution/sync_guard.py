"""The strict-mode device→host sync guard (counterpart of
hyperspace_tpu/execution/sync_guard.py; ``conf.device_guard_enabled``,
off by default).

Every read-back of the port goes through two attributed seams, and
strict mode turns that rule into a runtime contract:

  - **the seams**: :func:`pull` (a tensor to a numpy array) and
    :func:`scalar` (one value to a Python number).  Each runs inside an
    allowance window (:func:`allowed`), counts ``guard.sync.attributed``
    while armed, and :func:`pull` feeds ``exec.transfer.d2h.bytes``
    (``timeline.record_transfer``).  Host inputs pass through, and a
    CPU tensor on a CUDA session converts uncounted: it crosses no bus.
    On a CUDA tensor a seam costs what the plain ``.cpu().numpy()`` costs.
  - **the guard**: :func:`arm` (``Dataset.collect`` calls it with the
    session's conf and device) patches, on first arming, the host
    conversion surface of ``torch.Tensor`` process-wide: ``item``,
    ``tolist``, ``__float__``, ``__int__``, ``__bool__``, ``__index__``,
    ``__array__``, ``numpy``, ``cpu``, and ``to`` with a CPU target.
    While armed, such a conversion of a tensor on the armed device type
    outside an allowance window raises :class:`DeviceSyncError` and
    counts ``guard.sync.violations``.

PyTorch has no type that holds only device tensors (the JAX guard
patches the device array type), so the guard tells device from host by
the tensor: on a ``cuda`` session it takes CUDA tensors only, and host
torch work on CPU tensors passes; on a ``cpu`` session every tensor
counts, so the CPU tests catch what the card would.  ``cpu()`` and
``to(cpu)`` of a tensor already on the CPU copy nothing and pass; the
``numpy()`` or ``tolist()`` behind them is what the guard catches there.
Conversions made in C (``torch.equal``, printing) are not interceptable.

The armed flag and the device type are global, so the bucketed join's
route threads and the ``parallel_map`` workers are caught too; the
allowance depth is thread-local.  Disarmed, a patched method costs one
global read before the original.  The state persists until the next
collect's conf says otherwise.  The timeline's ``kernel_end`` event sync
runs in an allowance window.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import DeviceSyncError

_armed = False
_device_type: str | None = None  # the armed session's; None: none yet
_patched = False
_install_lock = threading.Lock()
_local = threading.local()

# The patched surface of ``torch.Tensor``; ``cpu`` and ``to`` are
# checked for a real crossing (see the module docstring).
_SURFACE = ("item", "tolist", "__float__", "__int__", "__bool__",
            "__index__", "__array__", "numpy", "cpu", "to")


def _depth() -> int:
    return getattr(_local, "depth", 0)


@contextlib.contextmanager
def allowed() -> Iterator[None]:
    """An allowance window: conversions inside the block are attributed
    (the seams below and ``timeline.kernel_end`` use it)."""
    _local.depth = _depth() + 1
    try:
        yield
    finally:
        _local.depth = _depth() - 1


def armed() -> bool:
    return _armed


def arm(conf, device=None) -> None:
    """Apply the session's conf to the process-wide guard, for tensors on
    ``device`` (the session's ``torch.device`` or a device string such as
    ``"cuda:0"``; None keeps the last one).  The first arming installs the
    patch; disarming leaves it installed and inert."""
    global _armed, _device_type
    enabled = bool(getattr(conf, "device_guard_enabled", False))
    if device is not None:
        _device_type = torch.device(device).type
    if enabled and not _patched:
        _install()
    _armed = enabled


def pull(x: Any, site: str = "") -> Any:
    """The sanctioned device→host array pull: ``x.cpu().numpy()`` in an
    allowance window, counted in ``exec.transfer.d2h.bytes`` and
    ``guard.sync.attributed``.  A host value passes through
    ``np.asarray``."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    with allowed():
        out = x.detach().cpu().numpy()
    if _on_session_device(x):
        _count_attributed(site)
        from hyperspace_tpu_torch.telemetry import timeline

        timeline.record_transfer("d2h", int(out.nbytes))
    return out


def scalar(x: Any, site: str = "") -> Any:
    """The sanctioned scalar sync point: one value (a match count, a
    group count, a flag) crossing to the host as a Python number.  A
    host value passes through."""
    if not isinstance(x, torch.Tensor):
        return x
    with allowed():
        out = x.item()
    if _on_session_device(x):
        _count_attributed(site)
    return out


def _on_session_device(x: torch.Tensor) -> bool:
    """Whether a seam's tensor is a read-back to count: one on the armed
    session's device type (every tensor before any session armed)."""
    return _device_type is None or x.device.type == _device_type


def _count_attributed(site: str) -> None:
    if not _armed:
        return
    from hyperspace_tpu_torch.telemetry import metrics

    metrics.inc("guard.sync.attributed")


def _violation(kind: str, device) -> DeviceSyncError:
    from hyperspace_tpu_torch.telemetry import metrics

    metrics.inc("guard.sync.violations")
    return DeviceSyncError(
        f"unattributed device→host sync via {kind} of a tensor on "
        f"{device} while conf.device_guard_enabled is on: route the "
        f"read-back through execution/sync_guard.pull()/scalar() (or the "
        f"timeline kernel seams) so exec.transfer.* and exec.kernel.* "
        f"can attribute it")


def _cpu_target(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call's arguments name the CPU."""
    target = kwargs.get("device")
    if target is None:
        for a in args:
            if isinstance(a, (str, torch.device)):
                target = a
                break
            if isinstance(a, torch.Tensor):
                target = a.device
                break
    if target is None:
        return False
    try:
        return torch.device(target).type == "cpu"
    except (RuntimeError, TypeError):
        return False


def _install() -> None:
    """Patch ``torch.Tensor``'s host conversion surface.  Idempotent."""
    global _patched
    with _install_lock:
        if _patched:
            return
        cls = torch.Tensor

        def _wrap(name: str):
            orig = getattr(cls, name, None)
            if orig is None:
                return
            crossing_only = name in ("cpu", "to")

            def guarded(self, *args, **kwargs):
                if _armed and _depth() == 0:
                    dev = self.device
                    if dev.type == _device_type and not (
                            crossing_only and (
                                dev.type == "cpu"
                                or (name == "to"
                                    and not _cpu_target(args, kwargs)))):
                        raise _violation(f"Tensor.{name}()", dev)
                return orig(self, *args, **kwargs)

            guarded.__name__ = name
            guarded.__qualname__ = f"Tensor.{name}"
            guarded.__doc__ = getattr(orig, "__doc__", None)
            setattr(cls, name, guarded)

        for name in _SURFACE:
            _wrap(name)
        _patched = True
