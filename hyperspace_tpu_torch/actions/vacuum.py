"""VacuumAction: hard delete, DELETED -> DOESNOTEXIST, removing every
index data version, newest first, and the index's quarantine records
(counterpart of hyperspace_tpu/actions/vacuum.py)."""

from __future__ import annotations

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.telemetry.events import VacuumActionEvent


class VacuumAction(Action):
    event_class = VacuumActionEvent
    transient_state = States.VACUUMING
    final_state = States.DOESNOTEXIST

    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager) -> None:
        super().__init__(log_manager)
        self.data_manager = data_manager

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.DELETED:
            raise HyperspaceError(
                f"Vacuum is only supported in {States.DELETED} state; index is "
                f"{'missing' if self.previous_log_entry is None else self.previous_log_entry.state}")

    def op(self) -> None:
        for version in reversed(self.data_manager.versions()):
            self.data_manager.delete(version)
        # Each delete dropped its version's records; a record that maps
        # to no version directory goes too.
        if self.data_manager.quarantine is not None:
            self.data_manager.quarantine.clear()

    def log_entry(self) -> IndexLogEntry:
        return self.log_entry_for_begin()
