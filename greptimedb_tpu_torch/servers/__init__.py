"""Protocol servers.

Reference behavior: src/servers — HTTP (axum → aiohttp here), MySQL,
Postgres, gRPC/Flight, InfluxDB line protocol, OpenTSDB, Prometheus remote
read/write, with pluggable auth (src/servers/src/auth/) and per-protocol
handler traits implemented by the frontend.

Ported so far: the HTTP server (http.py, prom_api.py) with the ingest
protocols it serves (prometheus.py, influxdb.py, opentsdb.py, the
OpenTSDB telnet listener included), the MySQL and Postgres wire servers
(mysql.py, postgres.py), auth.py, tls.py, the ingest coalescer
(coalesce.py), the query interceptor (interceptor.py), and the
gRPC / Arrow Flight front door (flight.py's `FlightFrontendServer`,
grpc.py's `GrpcServer`). The Flight datanode server, the distributed
router↔worker plane, comes with the distributed frontend and datanode.
"""
