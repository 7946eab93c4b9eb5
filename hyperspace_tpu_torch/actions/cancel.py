"""CancelAction: bring an index stuck in a transient state (an action
died mid-flight) back to its last stable state (counterpart of
hyperspace_tpu/actions/cancel.py).

A stuck VACUUMING goes to DOESNOTEXIST.  Cancel writes no transient entry
of its own: begin() does nothing and end() commits at base_id + 1.
"""

from __future__ import annotations

import copy

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import States
from hyperspace_tpu_torch.telemetry.events import CancelActionEvent


class CancelAction(Action):
    event_class = CancelActionEvent
    def validate(self) -> None:
        if self.previous_log_entry is None:
            raise HyperspaceError("Cancel: index does not exist")
        if self.previous_log_entry.state in States.STABLE:
            raise HyperspaceError(
                f"Cancel is not supported in stable state "
                f"{self.previous_log_entry.state}")

    @property
    def final_state(self) -> str:  # type: ignore[override]
        if self.previous_log_entry.state == States.VACUUMING:
            return States.DOESNOTEXIST
        stable = self.log_manager.get_latest_stable_log()
        return stable.state if stable is not None else States.DOESNOTEXIST

    def op(self) -> None:
        pass

    def begin(self) -> None:
        pass

    def end(self) -> None:
        stable = self.log_manager.get_latest_stable_log()
        entry = copy.deepcopy(stable if stable is not None
                              else self.previous_log_entry)
        entry.state = self.final_state
        self.log_manager.delete_latest_stable_log()
        self.log_manager.write_log_or_raise(self.base_id + 1, entry)
        self.log_manager.create_latest_stable_log(self.base_id + 1)
