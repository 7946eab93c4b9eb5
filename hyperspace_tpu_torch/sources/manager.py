"""Source provider manager (counterpart of
hyperspace_tpu/sources/manager.py).  The port has one provider, the
default file source, made from the session's conf; the manager keeps
the JAX package's entry points so the actions call it the same way."""

from __future__ import annotations

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.sources.default.provider import (
    DefaultFileBasedRelation,
    DefaultFileBasedSource,
)


class FileBasedSourceProviderManager:
    def __init__(self, conf: HyperspaceConf) -> None:
        self._provider = DefaultFileBasedSource(conf)

    def is_supported_relation(self, scan: Scan) -> bool:
        return self._provider.is_supported_relation(scan)

    def get_relation(self, scan: Scan) -> DefaultFileBasedRelation:
        rel = self._provider.get_relation(scan)
        if rel is None:
            raise HyperspaceError(
                f"No source provider supports format "
                f"{scan.relation.file_format!r}")
        return rel
