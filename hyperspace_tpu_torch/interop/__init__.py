"""The language-neutral interop surface (counterpart of
hyperspace_tpu/interop/): a query arrives as a JSON spec
(interop/query.py) over a socket and its result returns as an Arrow IPC
stream (interop/server.py), readable from any language with an Arrow
library and no Python on the client."""

from hyperspace_tpu_torch.interop.query import (
    dataset_from_spec,
    expr_from_json,
    mint_trace_id,
    pop_trace_context,
    valid_trace_id,
)
from hyperspace_tpu_torch.interop.server import (
    FleetQueryClient,
    QueryClient,
    QueryFailedError,
    QueryServer,
    ServerBusyError,
    parse_wire_error,
    request_query,
)

__all__ = ["dataset_from_spec", "expr_from_json", "mint_trace_id",
           "pop_trace_context", "valid_trace_id", "FleetQueryClient",
           "QueryClient", "QueryFailedError", "QueryServer",
           "ServerBusyError", "parse_wire_error", "request_query"]
