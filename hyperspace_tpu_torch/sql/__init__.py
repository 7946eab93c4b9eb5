"""SQL front end (counterpart of hyperspace_tpu/sql): SELECT text lowered
onto the port's Dataset verbs, so the TPC-H and TPC-DS corpora run as
their SQL text.  ``plan/pushdown.py`` makes the canonical
WHERE-above-joins lowering optimize into the same plans as hand-placed
DSL filters."""

from hyperspace_tpu_torch.sql.parser import SqlError, sql

__all__ = ["sql", "SqlError"]
