"""gRPC service façade for the CLI.

Reference behavior: src/servers/src/grpc/ — tonic `GreptimeService` whose
query results stream over Arrow Flight `do_get` (flight.rs:40-120). In
this build the Flight endpoint *is* the gRPC service (Flight rides gRPC);
`GrpcServer` adapts `FlightFrontendServer` to the uniform CLI server
lifecycle (start/shutdown, addr string).

Ported from greptimedb_tpu/servers/grpc.py unchanged.
"""

from __future__ import annotations

from .flight import FlightFrontendServer


class GrpcServer:
    def __init__(self, instance, user_provider=None,
                 addr: str = "127.0.0.1:4001"):
        host, _, port = addr.partition(":")
        self.host = host or "127.0.0.1"
        self._flight = FlightFrontendServer(
            instance, f"grpc://{self.host}:{int(port or 0)}")
        self.user_provider = user_provider

    @property
    def port(self) -> int:
        return self._flight.port

    def start(self):
        return self._flight.serve_in_background()

    serve_in_background = start

    def shutdown(self) -> None:
        self._flight.shutdown()
