"""Top-level user API (counterpart of hyperspace_tpu/hyperspace.py):
``create_index`` and ``indexes``."""

from __future__ import annotations

from typing import Any, Dict, List

from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.session import HyperspaceSession


class Hyperspace:
    def __init__(self, session: HyperspaceSession) -> None:
        self.session = session
        self.index_manager = session.index_collection_manager

    def create_index(self, dataset: Dataset, config: IndexConfig) -> None:
        self.index_manager.create(dataset, config)

    def indexes(self) -> List[Dict[str, Any]]:
        """One row per index: the rows of the JAX package's ``indexes()``
        table, as dictionaries (pyarrow stays inside ``io/``)."""
        return self.index_manager.indexes()
