"""The language-neutral interop surface (counterpart of
hyperspace_tpu/interop/): a query arrives as a JSON spec
(interop/query.py) and becomes a Dataset of the caller's session.  The
socket server and its clients are not part of this package yet."""

from hyperspace_tpu_torch.interop.query import (
    dataset_from_spec,
    expr_from_json,
    mint_trace_id,
    pop_trace_context,
    valid_trace_id,
)

__all__ = ["dataset_from_spec", "expr_from_json", "mint_trace_id",
           "pop_trace_context", "valid_trace_id"]
