"""The engine session (counterpart of hyperspace_tpu/session.py): conf,
the device the data plane runs on, readers and the source provider
manager."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.plan.nodes import Scan, ScanRelation
from hyperspace_tpu_torch.sources.manager import FileBasedSourceProviderManager


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card: ``cuda``, which must be available.  There
    is no silent fall back to the CPU; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hyperspace_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DataReader:
    """``session.read.parquet(path)``."""

    def __init__(self, session: "HyperspaceSession") -> None:
        self._session = session

    def parquet(self, *paths: str, **options: str):
        from hyperspace_tpu_torch.dataset import Dataset

        rel = ScanRelation(root_paths=tuple(paths), file_format="parquet",
                           options=tuple(sorted(options.items())))
        return Dataset(Scan(rel), self._session)


class HyperspaceSession:
    def __init__(self, system_path: Optional[str] = None,
                 device: Union[None, str, torch.device] = None,
                 conf: Optional[HyperspaceConf] = None) -> None:
        self.device = resolve_device(device)
        self.conf = conf if conf is not None else HyperspaceConf()
        if system_path is not None:
            self.conf.system_path = system_path
        # Per-build phase seconds, one dict per CreateAction run.
        self.build_stats_log: List[Dict[str, float]] = []

    @property
    def read(self) -> DataReader:
        return DataReader(self)

    @property
    def source_provider_manager(self) -> FileBasedSourceProviderManager:
        return FileBasedSourceProviderManager()

    @property
    def index_collection_manager(self):
        from hyperspace_tpu_torch.index.manager import IndexCollectionManager

        return IndexCollectionManager(self)
