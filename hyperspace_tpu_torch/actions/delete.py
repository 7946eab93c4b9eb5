"""DeleteAction: soft delete, ACTIVE -> DELETED; the index data stays for
restore (counterpart of hyperspace_tpu/actions/delete.py)."""

from __future__ import annotations

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.telemetry.events import DeleteActionEvent


class DeleteAction(Action):
    event_class = DeleteActionEvent
    transient_state = States.DELETING
    final_state = States.DELETED

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.ACTIVE:
            raise HyperspaceError(
                f"Delete is only supported in {States.ACTIVE} state; index is "
                f"{'missing' if self.previous_log_entry is None else self.previous_log_entry.state}")

    def op(self) -> None:
        pass

    def log_entry(self) -> IndexLogEntry:
        return self.log_entry_for_begin()
