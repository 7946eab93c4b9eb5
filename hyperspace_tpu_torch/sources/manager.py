"""Source provider manager (counterpart of
hyperspace_tpu/sources/manager.py): dispatches each provider API to
exactly one provider.

The providers are the names in ``conf.source_providers``, each looked up
in ``PROVIDER_REGISTRY`` (``default``, ``delta`` and ``iceberg`` are
built in; ``register_provider`` adds one); a name not registered raises
when the manager is made.  Every call asks each provider and takes the
one answer: none, or more than one, raises ``HyperspaceError``.  A
provider with ``bind_session`` gets the session, which ``closest_index``
needs to read older index log versions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, TypeVar

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import Relation
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
)

T = TypeVar("T")

# Name -> factory of a provider, made from the session's conf.
PROVIDER_REGISTRY: Dict[str, Callable[[HyperspaceConf],
                                      FileBasedSourceProvider]] = {}


def register_provider(name: str,
                      factory: Callable[[HyperspaceConf],
                                        FileBasedSourceProvider]) -> None:
    PROVIDER_REGISTRY[name] = factory


def _builtin_providers() -> None:
    if "default" not in PROVIDER_REGISTRY:
        from hyperspace_tpu_torch.sources.default.provider import (
            DefaultFileBasedSource,
        )

        register_provider("default", DefaultFileBasedSource)
    if "delta" not in PROVIDER_REGISTRY:
        from hyperspace_tpu_torch.sources.delta.provider import DeltaLakeSource

        register_provider("delta", DeltaLakeSource)
    if "iceberg" not in PROVIDER_REGISTRY:
        from hyperspace_tpu_torch.sources.iceberg.provider import IcebergSource

        register_provider("iceberg", IcebergSource)


class FileBasedSourceProviderManager:
    def __init__(self, conf: HyperspaceConf, session=None) -> None:
        _builtin_providers()
        names = [n.strip() for n in conf.source_providers.split(",")
                 if n.strip()]
        unknown = [n for n in names if n not in PROVIDER_REGISTRY]
        if unknown:
            raise HyperspaceError(f"Unknown source providers: {unknown}")
        self._providers: List[FileBasedSourceProvider] = [
            PROVIDER_REGISTRY[n](conf) for n in names]
        if session is not None:
            for p in self._providers:
                if hasattr(p, "bind_session"):
                    p.bind_session(session)

    def _run(self, api: str,
             fn: Callable[[FileBasedSourceProvider], Optional[T]]) -> T:
        answers = [(p, r) for p in self._providers if (r := fn(p)) is not None]
        if not answers:
            raise HyperspaceError(f"No source provider answered {api}")
        if len(answers) > 1:
            names = [p.name for p, _ in answers]
            raise HyperspaceError(
                f"Multiple source providers answered {api}: {names}")
        return answers[0][1]

    def is_supported_relation(self, scan: Scan) -> bool:
        try:
            return self._run("is_supported_relation",
                             lambda p: p.is_supported_relation(scan) or None)
        except HyperspaceError:
            return False

    def get_relation(self, scan: Scan) -> FileBasedRelation:
        return self._run("get_relation", lambda p: p.get_relation(scan))

    def internal_file_format_name(self, relation: Relation) -> str:
        return self._run("internal_file_format_name",
                         lambda p: p.internal_file_format_name(relation))

    def refresh_relation_metadata(self, relation: Relation) -> Relation:
        return self._run("refresh_relation_metadata",
                         lambda p: p.refresh_relation_metadata(relation))

    def enrich_index_properties(self, relation: Relation,
                                properties: Dict[str, str]) -> Dict[str, str]:
        return self._run("enrich_index_properties",
                         lambda p: p.enrich_index_properties(relation,
                                                             properties))
