"""Index-validity fingerprinting (counterpart of
hyperspace_tpu/index/signatures.py): an md5 fold over (size, mtime, path)
of every source file, the hash of the plan's operator-type chain, and
the default provider that combines the two.  Providers are looked up by
name from ``PROVIDERS``."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from hyperspace_tpu_torch.index.log_entry import FileInfo
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.utils.hashing import fold_md5, md5_hex


class SignatureProvider:
    name: str = ""

    def signature(self, plan: LogicalPlan,
                  all_files_of: Callable[[Scan], List[FileInfo]]) -> Optional[str]:
        """None when the plan has no leaf relation."""
        raise NotImplementedError


class FileBasedSignatureProvider(SignatureProvider):
    """md5 fold over (size, mtime, name) of every leaf file.  A root
    path that is a glob pattern is expanded by the listing
    (``io.files.expand_globs``) before the fold, so the signature covers
    the files of the directories that match now."""

    name = "FileBasedSignatureProvider"

    def signature(self, plan, all_files_of):
        leaves = plan.leaf_relations()
        if not leaves:
            return None
        infos: List[FileInfo] = []
        for scan in leaves:
            infos.extend(all_files_of(scan))
        return fold_md5(f"{f.size}{f.mtime}{f.name}" for f in infos)


class PlanSignatureProvider(SignatureProvider):
    """Hash of the operator-type chain."""

    name = "PlanSignatureProvider"

    def signature(self, plan, all_files_of):
        types: List[str] = []

        def walk(node: LogicalPlan) -> None:
            types.append(type(node).__name__)
            for c in node.children:
                walk(c)

        walk(plan)
        return md5_hex("".join(types))


class IndexSignatureProvider(SignatureProvider):
    """Default provider: md5(file_signature + plan_signature)."""

    name = "IndexSignatureProvider"

    def signature(self, plan, all_files_of):
        fs = FileBasedSignatureProvider().signature(plan, all_files_of)
        if fs is None:
            return None
        return md5_hex(fs + PlanSignatureProvider().signature(plan, all_files_of))


PROVIDERS: Dict[str, Callable[[], SignatureProvider]] = {
    FileBasedSignatureProvider.name: FileBasedSignatureProvider,
    PlanSignatureProvider.name: PlanSignatureProvider,
    IndexSignatureProvider.name: IndexSignatureProvider,
}


def get_provider(name: str) -> SignatureProvider:
    try:
        return PROVIDERS[name]()
    except KeyError:
        raise ValueError(f"Unknown signature provider: {name!r}") from None
