"""Clients of a GreptimeDB server.

Reference behavior: src/client — `Database` sends inserts and ships
queries whose results stream back over Arrow Flight
(database.rs:39,209-260).

Ported from greptimedb_tpu/client/: the user-facing `Database` over a
`FlightFrontendServer` (client/flight.py). The router↔worker surface
(`DatanodeClient`, `LocalDatanodeClient`, `FlightDatanodeClient`) comes
with the distributed frontend and datanode.
"""
