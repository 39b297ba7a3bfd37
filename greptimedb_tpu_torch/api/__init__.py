"""greptime-proto interop plane (api crate twin).

Reference behavior: src/api/ re-exports the generated `greptime_proto`
v1 types (src/api/src/v1.rs); reference SDKs serialize a
`GreptimeRequest` protobuf into an Arrow Flight ticket
(src/client/src/database.rs:209-231) and the server decodes it in
do_get (src/servers/src/grpc/flight.rs:87-96). This package speaks that
wire format with a hand-rolled protowire codec (no protoc runtime), so
clients built against greptime-proto v1 can connect.

Ported from greptimedb_tpu/api/ unchanged: encodings are byte-identical
to the reference's on the same inputs.
"""

from .v1 import (  # noqa: F401
    Column, ColumnDataType, GreptimeRequest, InsertRequest, QueryRequest,
    SemanticType, decode_greptime_request, encode_affected_rows_metadata,
    encode_greptime_request,
)
