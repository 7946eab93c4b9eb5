"""The action state machine: begin -> op -> end with optimistic
concurrency (counterpart of hyperspace_tpu/actions/base.py).

  - ``base_id`` is captured from the latest log id when the action is
    made;
  - ``begin()`` writes a transient-state entry at ``base_id + 1``; the
    create-if-absent write is what detects a concurrent writer;
  - ``op()`` does the work;
  - ``end()`` writes the final-state entry at ``base_id + 2`` and moves
    the ``latestStable`` pointer to it.

An action that dies mid-flight leaves the transient entry as the latest
log record; ``cancel()`` rolls it back.  ``run()`` returns "ok" for a
committed run and "noop" when ``validate()`` raised ``NoChangesError``
(nothing is written).  The JAX package's conflict-retry loop is not
ported: a concurrent writer's conflict propagates.
"""

from __future__ import annotations

import copy
from typing import Optional

from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager


class Action:
    # Subclasses set these.
    transient_state: str = ""
    final_state: str = ""

    def __init__(self, log_manager: IndexLogManager) -> None:
        self.log_manager = log_manager
        latest = self.log_manager.get_latest_id()
        self.base_id: int = 0 if latest is None else latest
        self.previous_log_entry: Optional[IndexLogEntry] = \
            self.log_manager.get_latest_log()

    def validate(self) -> None:
        """Raise HyperspaceError (NoChangesError for a benign no-op)
        before any state is written."""

    def log_entry_for_begin(self) -> IndexLogEntry:
        """The entry begin() writes: by default a copy of the previous
        one (actions on an existing index); create builds a fresh one."""
        if self.previous_log_entry is None:
            raise HyperspaceError("No existing index log entry for this action")
        return copy.deepcopy(self.previous_log_entry)

    def op(self) -> None:
        raise NotImplementedError

    def log_entry(self) -> IndexLogEntry:
        """The entry committed by end(), built after op()."""
        raise NotImplementedError

    def begin(self) -> None:
        entry = self.log_entry_for_begin()
        entry.state = self.transient_state
        self.log_manager.write_log_or_raise(self.base_id + 1, entry)

    def end(self) -> None:
        entry = self.log_entry()
        entry.state = self.final_state
        self.log_manager.delete_latest_stable_log()
        self.log_manager.write_log_or_raise(self.base_id + 2, entry)
        self.log_manager.create_latest_stable_log(self.base_id + 2)

    def run(self) -> str:
        try:
            self.validate()
        except NoChangesError:
            return "noop"
        self.begin()
        self.op()
        self.end()
        return "ok"
