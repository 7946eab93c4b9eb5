"""RestoreAction: undo a soft delete, DELETED -> ACTIVE (counterpart of
hyperspace_tpu/actions/restore.py)."""

from __future__ import annotations

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.telemetry.events import RestoreActionEvent


class RestoreAction(Action):
    event_class = RestoreActionEvent
    transient_state = States.RESTORING
    final_state = States.ACTIVE

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.DELETED:
            raise HyperspaceError(
                f"Restore is only supported in {States.DELETED} state; index is "
                f"{'missing' if self.previous_log_entry is None else self.previous_log_entry.state}")

    def op(self) -> None:
        pass

    def log_entry(self) -> IndexLogEntry:
        return self.log_entry_for_begin()
