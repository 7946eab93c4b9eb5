"""Reflective class loading for conf fields that name a class
(counterpart of hyperspace_tpu/utils/reflection.py): the event logger
(``conf.event_logger``), the log manager (``conf.log_manager_class``)
and the store (``conf.log_store_class``), one loader so every such field
takes the same path syntax and raises the same way.

A path into the JAX package is refused before anything is imported:
importing it would import ``jax``, and the port runs without it."""

from __future__ import annotations

from typing import Dict, Type


_CACHE: Dict[tuple, type] = {}
_JAX_PACKAGE = "hyperspace_tpu"


def load_class(name: str, base_cls: type,
               exc_cls: Type[Exception] = ValueError) -> type:
    """Load ``name`` (``module.Class`` or ``module:Class``) and require it
    to subclass ``base_cls``.  Failures raise ``exc_cls`` with context.
    Memoized per (name, base)."""
    key = (name, base_cls)
    cls = _CACHE.get(key)
    if cls is not None:
        return cls
    import importlib

    module_name, _, cls_name = name.replace(":", ".").rpartition(".")
    if not module_name:
        raise exc_cls(f"Invalid class path: {name!r}")
    if module_name.split(".")[0] == _JAX_PACKAGE:
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        raise HyperspaceError(
            f"Cannot load class {name!r}: it names the JAX package "
            f"{_JAX_PACKAGE!r}, which this package never imports; name "
            f"the class under 'hyperspace_tpu_torch' instead")
    try:
        cls = getattr(importlib.import_module(module_name), cls_name)
    except (ImportError, AttributeError) as e:
        raise exc_cls(f"Cannot load class {name!r} ({e})") from e
    if not (isinstance(cls, type) and issubclass(cls, base_cls)):
        raise exc_cls(f"{name!r} is not a {base_cls.__name__} subclass")
    _CACHE[key] = cls
    return cls
