"""The MySQL and Postgres wire servers: the port's `servers/mysql.py` and
`servers/postgres.py` over its standalone frontend against the JAX
package's servers over their own, on the CPU.

Each package runs its `MysqlServer` and `PostgresServer` on port 0 over a
frontend with its own data home (the reference's
`FrontendInstance(DatanodeInstance(...))`, the port's
`build_standalone(DatanodeOptions(..., device="cpu"))`), and the same
list of steps goes to both over real sockets, in order, through minimal
clients shaped like tests/test_mysql.py's `MiniMysqlClient` and
tests/test_postgres.py's `MiniPgClient`: ping, the quick-start flow,
timestamps, NULLs and every column type, error packets, the federated
bootstrap answers, `USE` / COM_INIT_DB, SHOW / DESCRIBE, SHOW
PROCESSLIST and KILL (SQL and COM_PROCESS_KILL), prepared statements,
the Postgres extended protocol (text and binary parameters, Describe of a
portal and of a statement, Close, errors skipped until Sync), a
TSBS-shaped aggregate by host and `date_bin` hour (on the pandas path,
then on the device path with the dispatch floor at 0) and TQL EVAL.

Comparisons: column definitions (names, MySQL type codes and charsets,
Postgres OIDs), command tags, OK packets, error codes, SQLSTATEs and
messages byte-equal; every value byte-equal except aggregate floats,
which must be within the SQL float32 bound of tests/test_torch_sql.py
(|port - ref| <= 1e-5 |ref| + 8 eps32 P, P the sum of |x| over the
table), and TQL values within rtol 1e-5 as tests/test_torch_promql.py
holds them. Each package keeps its own process registry, so SHOW
PROCESSLIST is compared without its per-process columns (Id,
Elapsed_ms, Trace_id), and KILL by what it does, never by an id.

Then several clients at once, auth (a good password, a bad one, an
unknown user, connect-with-db) and one TLS handshake on each server, held
to the reference; and what only the port's process is asked here: `SET
admission_max_inflight = 1` gives errno 1040 over MySQL and SQLSTATE
53300 over Postgres on connections that survive; KILL sent over one wire
ends a streamed scan running over the other (slowed by the
`stream_slice` failpoint) within about one slice.
"""

import hashlib
import math
import socket
import ssl
import struct
import threading
import time

import numpy as np
import pytest

from greptimedb_tpu.common import admission as ref_admission
from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import stream_exec as ref_stream
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.servers.auth import StaticUserProvider as RefUsers
from greptimedb_tpu.servers.mysql import MysqlServer as RefMysqlServer
from greptimedb_tpu.servers.postgres import PostgresServer as RefPgServer
from greptimedb_tpu_torch.common import (admission, background_jobs,
                                         failpoint, process_list)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import stream_exec, tpu_exec
from greptimedb_tpu_torch.servers import mysql, postgres, tls
from greptimedb_tpu_torch.servers.auth import StaticUserProvider
from greptimedb_tpu_torch.servers.mysql import MysqlServer
from greptimedb_tpu_torch.servers.postgres import PostgresServer

EPS32 = 2.0 ** -24
TIMEOUT_S = 20
T0 = 1_451_606_400_000                        # TSBS's 2016-01-01 start
HOSTS, MINUTES = 6, 120                       # 2 h at a 60 s interval


# ---------------------------------------------------------------------------
# the data, from a seed
# ---------------------------------------------------------------------------

def _tsbs_rows():
    """A TSBS cpu-only-shaped table: hostname and region tags, two
    fields, 2 h per host."""
    rng = np.random.default_rng(13)
    user = np.round(rng.uniform(0, 100, (HOSTS, MINUTES)), 3)
    system = np.round(rng.uniform(0, 100, (HOSTS, MINUTES)), 3)
    rows = []
    for h in range(HOSTS):
        for m in range(MINUTES):
            rows.append(f"('host_{h}', 'r{h % 3}', {T0 + m * 60_000}, "
                        f"{float(user[h, m])!r}, {float(system[h, m])!r})")
    return ", ".join(rows), float(max(np.abs(user).sum(),
                                      np.abs(system).sum()))


def _counter_rows():
    """A Prometheus-layout counter per host, one reset on host h1."""
    rng = np.random.default_rng(17)
    rows = []
    for h in range(3):
        ctr = np.cumsum(np.round(rng.uniform(0, 40, 60) * 4) / 4)
        if h == 1:
            ctr[30:] -= ctr[29]
        rows += [f"('h{h}', {i * 10_000}, {float(v)!r})"
                 for i, v in enumerate(ctr)]
    return ", ".join(rows)


TSBS_VALUES, P_ABS = _tsbs_rows()
TSBS_DDL = ("CREATE TABLE cpu (hostname STRING, region STRING, ts TIMESTAMP "
            "TIME INDEX, usage_user DOUBLE, usage_system DOUBLE, PRIMARY "
            "KEY(hostname, region))")
TSBS_AGG = ("SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS hour, "
            "avg(usage_user), max(usage_system), count(*) FROM cpu GROUP BY "
            "hostname, hour ORDER BY hostname, hour")
TQL = "TQL EVAL (0, 590, '30s') sum by (host) (rate(ctr[1m]))"
TYPES_DDL = ("CREATE TABLE typed (ts TIMESTAMP TIME INDEX, v DOUBLE, "
             "s STRING, b BOOLEAN, n BIGINT, i INT, f FLOAT, u INT UNSIGNED)")
TYPES_INSERT = ("INSERT INTO typed VALUES (1672531200000, 1.5, 'x', true, "
                "-7, 3, 0.25, 4000000000), (1672531201500, NULL, NULL, "
                "false, NULL, NULL, NULL, NULL), (1672531202000, -0.125, "
                "'it''s', NULL, 9007199254740993, -2147483648, 1e-3, 0)")


# ---------------------------------------------------------------------------
# minimal clients
# ---------------------------------------------------------------------------

class MyClient:
    """Just enough of the MySQL client protocol: HandshakeResponse41
    (optionally after an SSLRequest), COM_* commands, text and binary
    result sets. Results are ("ok", affected, status), ("err", errno,
    sqlstate, message) or ("rows", column-definition packets, rows)."""

    def __init__(self, port, user="greptime", password="", database=None,
                 tls_context=None):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=TIMEOUT_S)
        self.io = mysql.PacketIO(self.sock)
        self.login = self._login(user, password, database, tls_context)

    def _login(self, user, password, database, tls_context):
        greeting = self.io.read_packet()
        assert greeting[0] == 10
        end = greeting.index(b"\x00", 1)
        self.server_version = greeting[1:end].decode()
        pos = end + 1 + 4
        nonce = greeting[pos:pos + 8]
        caps_lo = struct.unpack_from("<H", greeting, pos + 9)[0]
        caps_hi = struct.unpack_from("<H", greeting, pos + 14)[0]
        self.server_caps = caps_lo | caps_hi << 16
        pos += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        nonce += greeting[pos:pos + 12]
        self.nonce = nonce
        caps = (mysql.CLIENT_PROTOCOL_41 | mysql.CLIENT_SECURE_CONNECTION
                | mysql.CLIENT_PLUGIN_AUTH)
        if database:
            caps |= mysql.CLIENT_CONNECT_WITH_DB
        if tls_context is not None:
            caps |= mysql.CLIENT_SSL
            self.io.write_packet(struct.pack("<IIB", caps, 1 << 24, 45)
                                 + b"\x00" * 23)
            self.sock = tls_context.wrap_socket(self.sock)
            self.io.sock = self.sock
        auth = mysql.native_password_scramble(password, nonce)
        body = (struct.pack("<IIB", caps, 1 << 24, 45) + b"\x00" * 23
                + user.encode() + b"\x00" + bytes([len(auth)]) + auth)
        if database:
            body += database.encode() + b"\x00"
        body += b"mysql_native_password\x00"
        self.io.write_packet(body)
        return self._simple(self.io.read_packet())

    @staticmethod
    def _simple(p):
        if p[0] == 0xFF:
            return ("err", struct.unpack_from("<H", p, 1)[0],
                    p[4:9].decode(), p[9:].decode(errors="replace"))
        if p[0] == 0x00:
            affected, pos = mysql.read_lenenc_int(p, 1)
            _, pos = mysql.read_lenenc_int(p, pos)
            return ("ok", affected, struct.unpack_from("<H", p, pos)[0])
        if p[0] == 0xFE and len(p) < 9:
            return ("eof", struct.unpack_from("<H", p, 3)[0])
        return None

    def command(self, cmd, payload=b""):
        self.io.reset_seq()
        self.io.write_packet(bytes([cmd]) + payload)

    def ping(self):
        self.command(mysql.COM_PING)
        return self._simple(self.io.read_packet())

    def init_db(self, db):
        self.command(mysql.COM_INIT_DB, db.encode())
        return self._simple(self.io.read_packet())

    def kill(self, pid):
        self.command(mysql.COM_PROCESS_KILL, struct.pack("<I", pid))
        return self._simple(self.io.read_packet())

    def raw(self, cmd, payload=b""):
        self.command(cmd, payload)
        return self._simple(self.io.read_packet())

    def query(self, sql):
        self.command(mysql.COM_QUERY, sql.encode())
        return self._result(binary=False)

    def _result(self, binary):
        head = self.io.read_packet()
        simple = self._simple(head)
        if simple is not None:
            return simple
        ncols, _ = mysql.read_lenenc_int(head, 0)
        coldefs = [self.io.read_packet() for _ in range(ncols)]
        assert self._simple(self.io.read_packet())[0] == "eof"
        rows = []
        while True:
            p = self.io.read_packet()
            if p[0] == 0xFE and len(p) < 9:
                break
            rows.append(self._binary_row(p, ncols) if binary
                        else self._text_row(p, ncols))
        return ("rows", coldefs, rows)

    @staticmethod
    def _text_row(p, ncols):
        row, pos = [], 0
        for _ in range(ncols):
            if p[pos] == 0xFB:
                row.append(None)
                pos += 1
            else:
                v, pos = mysql.read_lenenc_str(p, pos)
                row.append(v)
        return row

    @staticmethod
    def _binary_row(p, ncols):
        assert p[0] == 0x00
        nbytes = (ncols + 9) // 8
        bitmap = p[1:1 + nbytes]
        pos, row = 1 + nbytes, []
        for i in range(ncols):
            if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                row.append(None)
            else:
                v, pos = mysql.read_lenenc_str(p, pos)
                row.append(v)
        return row

    def prepare(self, sql):
        """(statement id, the prepare-OK packet without its id, the
        parameter definitions)."""
        self.command(mysql.COM_STMT_PREPARE, sql.encode())
        p = self.io.read_packet()
        if p[0] == 0xFF:
            return None, self._simple(p), []
        stmt_id = struct.unpack_from("<I", p, 1)[0]
        nparams = struct.unpack_from("<H", p, 7)[0]
        params = [self.io.read_packet() for _ in range(nparams)]
        if nparams:
            assert self._simple(self.io.read_packet())[0] == "eof"
        return stmt_id, p[:1] + p[5:], params

    def execute(self, stmt_id, params=()):
        body = struct.pack("<IBI", stmt_id, 0, 1)
        if params:
            n = len(params)
            bitmap = bytearray((n + 7) // 8)
            types, values = b"", b""
            for i, v in enumerate(params):
                if v is None:
                    bitmap[i // 8] |= 1 << (i % 8)
                    types += struct.pack("<H", mysql.T_NULL)
                elif isinstance(v, bool):
                    types += struct.pack("<H", mysql.T_TINY)
                    values += struct.pack("<b", int(v))
                elif isinstance(v, int):
                    types += struct.pack("<H", mysql.T_LONGLONG)
                    values += struct.pack("<q", v)
                elif isinstance(v, float):
                    types += struct.pack("<H", mysql.T_DOUBLE)
                    values += struct.pack("<d", v)
                else:
                    types += struct.pack("<H", mysql.T_VAR_STRING)
                    values += mysql.lenenc_str(str(v).encode())
            body += bytes(bitmap) + b"\x01" + types + values
        self.command(mysql.COM_STMT_EXECUTE, body)
        return self._result(binary=True)

    def close(self):
        try:
            self.command(mysql.COM_QUIT)
            self.sock.close()
        except OSError:
            pass


class PgClient:
    """Just enough of the Postgres v3 client protocol. Each exchange
    returns the messages up to ReadyForQuery as (tag, payload) pairs."""

    def __init__(self, port, user="greptime", password=None,
                 database="public", tls_context=None):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=TIMEOUT_S)
        if tls_context is not None:
            self.sock.sendall(struct.pack("!II", 8, postgres.SSL_REQUEST))
            self.ssl_answer = self.sock.recv(1)
            if self.ssl_answer == b"S":
                self.sock = tls_context.wrap_socket(self.sock)
        self.startup = self._startup(user, password, database)

    def send(self, tag, body=b""):
        self.sock.sendall(tag + struct.pack("!I", len(body) + 4) + body)

    def _read_n(self, n):
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("eof")
            out += chunk
        return out

    def read(self):
        head = self._read_n(5)
        length = struct.unpack_from("!I", head, 1)[0]
        return chr(head[0]), self._read_n(length - 4)

    def _startup(self, user, password, database):
        """The startup messages, BackendKeyData's process id masked; or
        ("E", payload) when the server refused."""
        body = struct.pack("!I", postgres.PROTOCOL_V3)
        body += b"user\x00" + user.encode() + b"\x00"
        if database:
            body += b"database\x00" + database.encode() + b"\x00"
        body += b"\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        got = []
        while True:
            tag, payload = self.read()
            if tag == "R":
                code = struct.unpack_from("!I", payload, 0)[0]
                got.append((tag, struct.pack("!I", code)))
                if code == 3:
                    self.send(b"p", (password or "").encode() + b"\x00")
                elif code == 5:
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        ((password or "") + user).encode()).hexdigest()
                    self.send(b"p", ("md5" + hashlib.md5(
                        inner.encode() + salt).hexdigest()).encode()
                        + b"\x00")
                continue
            if tag == "K":
                payload = b"<pid>" + payload[4:]
            got.append((tag, payload))
            if tag in "EZ":
                return got

    def until_ready(self):
        got = []
        while True:
            tag, payload = self.read()
            got.append((tag, payload))
            if tag == "Z":
                return got

    def query(self, sql):
        self.send(b"Q", sql.encode() + b"\x00")
        return self.until_ready()

    def parse(self, sql, name=b"", oids=()):
        self.send(b"P", name + b"\x00" + sql.encode() + b"\x00"
                  + struct.pack("!H", len(oids))
                  + b"".join(struct.pack("!I", o) for o in oids))

    def bind(self, params=(), stmt=b"", fmt=0):
        body = b"\x00" + stmt + b"\x00"
        body += struct.pack("!HH", 1, fmt) if fmt else struct.pack("!H", 0)
        body += struct.pack("!H", len(params))
        for p in params:
            if p is None:
                body += struct.pack("!i", -1)
            else:
                raw = p if isinstance(p, bytes) else str(p).encode()
                body += struct.pack("!i", len(raw)) + raw
        self.send(b"B", body + struct.pack("!H", 0))

    def extended(self, sql, params=(), oids=(), fmt=0, describe=True):
        self.parse(sql, oids=oids)
        self.bind(params, fmt=fmt)
        if describe:
            self.send(b"D", b"P\x00")
        self.send(b"E", b"\x00" + struct.pack("!I", 0))
        self.send(b"S")
        return self.until_ready()

    def close(self):
        try:
            self.send(b"X")
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the steps, sent to both packages in order
# ---------------------------------------------------------------------------

EXACT, SQL, PROM, PROCESSES = "exact", "sql", "prom", "processes"


def _my_query(sql):
    return lambda s: s.my.query(sql)


def _pg_query(sql):
    return lambda s: s.pg.query(sql)


def _my_prepared(sql, *param_sets):
    def run(s):
        stmt_id, ok, params = s.my.prepare(sql)
        out = [ok, params]
        for ps in param_sets:
            out.append(s.my.execute(stmt_id, ps))
        return out
    return run


def _pg_describe_portal(s):
    c = s.pg
    c.parse("SELECT host, cpu FROM monitor ORDER BY host")
    c.bind()
    c.send(b"D", b"P\x00")
    c.send(b"S")
    first = c.until_ready()
    c.bind()
    c.send(b"D", b"P\x00")
    c.send(b"E", b"\x00" + struct.pack("!I", 0))
    c.send(b"S")
    return first + c.until_ready()


def _pg_describe_statement(s):
    c = s.pg
    c.parse("SELECT cpu, host FROM monitor WHERE host = $1", name=b"s1")
    c.send(b"D", b"Ss1\x00")
    c.parse("INSERT INTO monitor VALUES ($1, $2, $3, $4)", name=b"s2")
    c.send(b"D", b"Ss2\x00")
    c.parse("TQL EVAL (0, 10, '5s') ctr", name=b"s3")
    c.send(b"D", b"Ss3\x00")
    c.send(b"D", b"Snope\x00")
    c.send(b"S")
    return c.until_ready()


def _pg_cache_across_sync(s):
    """A result Describe computed is not reused after a Sync: the
    Execute of the next cycle sees a write made in between."""
    c = s.pg
    c.query("CREATE TABLE stale (ts TIMESTAMP TIME INDEX, v DOUBLE)")
    c.query("INSERT INTO stale VALUES (1, 1.0)")
    c.parse("SELECT v FROM stale ORDER BY ts")
    c.bind()
    c.send(b"D", b"P\x00")
    c.send(b"S")
    first = c.until_ready()
    c.query("INSERT INTO stale VALUES (2, 2.0)")
    c.send(b"E", b"\x00" + struct.pack("!I", 0))
    c.send(b"S")
    return first + c.until_ready()


def _pg_bind_unknown(s):
    s.pg.send(b"B", b"\x00nope\x00" + struct.pack("!HHH", 0, 0, 0))
    s.pg.send(b"S")
    return s.pg.until_ready()


def _pg_pipeline_error(s):
    c = s.pg
    c.parse("SELECT host FROM monitor ORDER BY host")
    c.bind()
    c.send(b"E", b"\x00" + struct.pack("!I", 0))
    c.send(b"S")
    first = c.until_ready()
    c.send(b"B", b"\x00gone\x00" + struct.pack("!HHH", 0, 0, 0))
    c.send(b"E", b"\x00" + struct.pack("!I", 0))
    c.send(b"D", b"P\x00")
    c.send(b"S")
    return first + c.until_ready() + c.query("SELECT 1")


def _pg_close(s):
    c = s.pg
    c.parse("SELECT 1", name=b"c1")
    c.send(b"C", b"Sc1\x00")
    c.bind(stmt=b"c1")
    c.send(b"S")
    return c.until_ready()


def _pg_unknown_message(s):
    s.pg.send(b"F", b"\x00\x00\x00\x00")
    return s.pg.until_ready()


def _pg_binary(s):
    c = s.pg
    out = c.extended(
        "INSERT INTO binp VALUES ($1, $2, $3, $4, $5, $6)",
        [b"h1", struct.pack("!q", (1672531200123456 - 946684800000000)),
         struct.pack("!d", 2.75), struct.pack("!q", -12), b"\x01",
         struct.pack("!f", 0.5)],
        oids=[25, 1114, 701, 20, 16, 700], fmt=1)
    out += c.extended(
        "INSERT INTO binp VALUES ($1, $2, $3, $4, $5, $6)",
        [b"h2", struct.pack("!q", 0), struct.pack("!d", -1.0),
         struct.pack("!h", 7), b"\x00", None],
        oids=[25, 1184, 701, 21, 16, 700], fmt=1)
    out += c.extended("SELECT count(*) FROM binp WHERE n = $1",
                      [struct.pack("!i", -12)], oids=[23], fmt=1)
    out += c.extended("SELECT host FROM binp WHERE host = $1", [b"h2"],
                      oids=[], fmt=1)
    return out + c.query("SELECT * FROM binp ORDER BY host")


def _multi_clients(s):
    """Two more connections on each wire: one creates, the other inserts,
    the first reads; MySQL and Postgres see each other's rows."""
    a, b = MyClient(s.mysql.port), MyClient(s.mysql.port)
    c, d = PgClient(s.pg_srv.port), PgClient(s.pg_srv.port)
    try:
        out = [a.query("CREATE TABLE multi (ts TIMESTAMP TIME INDEX, "
                       "v DOUBLE)"),
               b.query("INSERT INTO multi VALUES (1, 2.0)")]
        out += c.query("INSERT INTO multi VALUES (2, 3.5)")
        out.append(a.query("SELECT count(*) AS n, sum(v) FROM multi"))
        out += d.query("SELECT * FROM multi ORDER BY ts")
        return out
    finally:
        for cl in (a, b, c, d):
            cl.close()


STEPS = [
    ("my ping", lambda s: s.my.ping(), EXACT),
    ("my create", _my_query(
        "CREATE TABLE monitor (host STRING, ts TIMESTAMP TIME INDEX, "
        "cpu DOUBLE, memory DOUBLE, PRIMARY KEY(host))"), EXACT),
    ("my insert", _my_query(
        "INSERT INTO monitor VALUES ('host1', 1000, 66.6, 1024), ('host2', "
        "2000, 77.7, 2048), ('host1', 3000, 99.9, 4096)"), EXACT),
    ("my quickstart aggregate", _my_query(
        "SELECT host, avg(cpu) AS c, sum(memory), count(*) FROM monitor "
        "GROUP BY host ORDER BY host"), SQL),
    ("my select star", _my_query("SELECT * FROM monitor ORDER BY ts"),
     EXACT),
    ("my types ddl", _my_query(TYPES_DDL), EXACT),
    ("my types insert", _my_query(TYPES_INSERT), EXACT),
    ("my types select", _my_query("SELECT * FROM typed ORDER BY ts"),
     EXACT),
    ("my expressions", _my_query(
        "SELECT ts, v * 2 AS w, s IS NULL AS missing, n + 1 FROM typed "
        "ORDER BY ts"), EXACT),
    ("my not found", _my_query("SELECT * FROM nope_nothing"), EXACT),
    ("my parse error", _my_query("SELEC 1"), EXACT),
    ("my duplicate table", _my_query(
        "CREATE TABLE monitor (ts TIMESTAMP TIME INDEX, v DOUBLE)"), EXACT),
    ("my version comment", _my_query("SELECT @@version_comment"), EXACT),
    ("my version", _my_query("SELECT @@version"), EXACT),
    ("my version()", _my_query("SELECT version()"), EXACT),
    ("my unknown variable", _my_query("SELECT @@no_such_var"), EXACT),
    ("my set names", _my_query("SET NAMES utf8mb4"), EXACT),
    ("my set autocommit", _my_query("SET autocommit=1"), EXACT),
    ("my begin", _my_query("BEGIN"), EXACT),
    ("my commit", _my_query("COMMIT"), EXACT),
    ("my show variables", _my_query("SHOW VARIABLES LIKE 'sql_mode'"),
     EXACT),
    ("my show collation", _my_query("SHOW COLLATION"), EXACT),
    ("my database()", _my_query("SELECT database()"), EXACT),
    ("my create database", _my_query("CREATE DATABASE IF NOT EXISTS otherdb"),
     EXACT),
    ("my use", _my_query("USE otherdb"), EXACT),
    ("my database() after use", _my_query("SELECT database()"), EXACT),
    ("my show tables in otherdb", _my_query("SHOW TABLES"), EXACT),
    ("my init_db", lambda s: s.my.init_db("public"), EXACT),
    ("my database() after init_db", _my_query("SELECT database()"), EXACT),
    ("my init_db unknown", lambda s: [s.my.init_db("no_such_db"),
                                      s.my.query("SELECT database()")],
     EXACT),
    ("my use public", _my_query("USE public"), EXACT),
    ("my show tables", _my_query("SHOW TABLES"), EXACT),
    ("my show databases", _my_query("SHOW DATABASES"), EXACT),
    ("my describe", _my_query("DESCRIBE TABLE monitor"), EXACT),
    ("my show create table", _my_query("SHOW CREATE TABLE monitor"), EXACT),
    ("my processlist", _my_query("SHOW PROCESSLIST"), PROCESSES),
    ("my kill unknown", _my_query("KILL 424242"), EXACT),
    ("my com_process_kill unknown", lambda s: [s.my.kill(424242),
                                               s.my.ping()], EXACT),
    ("my field list", lambda s: s.my.raw(mysql.COM_FIELD_LIST,
                                         b"monitor\x00"), EXACT),
    ("my unknown command", lambda s: [s.my.raw(0x1F), s.my.ping()], EXACT),
    ("my prepared insert", _my_prepared(
        "INSERT INTO monitor (host, ts, cpu, memory) VALUES (?, ?, ?, ?)",
        ("h3", 4000, 3.25, 512), ("h4", 5000, None, 256),
        ("it's", 6000, 0.5, None)), EXACT),
    ("my prepared select", _my_prepared(
        "SELECT host, cpu, ts FROM monitor WHERE host = ? AND ts >= ? "
        "ORDER BY ts", ("h3", 0), ("it's", 5500), ("host1", 2000)), EXACT),
    ("my prepared no params", _my_prepared(
        "SELECT count(*) FROM monitor", ()), EXACT),
    ("my prepared aggregate", _my_prepared(
        "SELECT host, avg(cpu) FROM monitor WHERE ts > ? GROUP BY host "
        "ORDER BY host", (1500,)), SQL),
    ("my prepared error", _my_prepared("SELECT * FROM nowhere WHERE a = ?",
                                       (1,)), EXACT),
    ("my execute unknown statement",
     lambda s: s.my.execute(9999), EXACT),
    ("my tsbs ddl", _my_query(TSBS_DDL), EXACT),
    ("my tsbs insert", _my_query("INSERT INTO cpu VALUES " + TSBS_VALUES),
     EXACT),
    ("my tsbs aggregate", _my_query(TSBS_AGG), SQL),
    ("pg ready", lambda s: s.pg.startup, EXACT),
    ("pg tsbs aggregate", _pg_query(TSBS_AGG), SQL),
    ("pg device floor", _pg_query("SET tpu_dispatch_min_rows = 0"), EXACT),
    ("pg tsbs aggregate on the device path", _pg_query(TSBS_AGG), SQL),
    ("pg device floor again", _pg_query("SET tpu_dispatch_min_rows = 0"),
     EXACT),
    ("my tsbs aggregate on the device path", _my_query(TSBS_AGG), SQL),
    ("pg host floor", _pg_query("SET tpu_dispatch_min_rows = 131072"),
     EXACT),
    ("pg counter ddl", _pg_query(
        "CREATE TABLE ctr (host STRING, ts TIMESTAMP TIME INDEX, "
        "greptime_value DOUBLE, PRIMARY KEY(host))"), EXACT),
    ("pg counter insert", _pg_query(
        "INSERT INTO ctr VALUES " + _counter_rows()), EXACT),
    ("pg tql", _pg_query(TQL), PROM),
    ("my tql", _my_query(TQL), PROM),
    ("pg quickstart", _pg_query(
        "SELECT host, avg(cpu) AS c FROM monitor WHERE ts < 4000 GROUP BY "
        "host ORDER BY host"), SQL),
    ("pg select star", _pg_query("SELECT * FROM monitor ORDER BY ts"),
     EXACT),
    ("pg types", _pg_query("SELECT * FROM typed ORDER BY ts"), EXACT),
    ("pg expressions", _pg_query(
        "SELECT ts, v * 2 AS w, s IS NULL AS missing, n + 1 FROM typed "
        "ORDER BY ts"), EXACT),
    ("pg create tag", _pg_query(
        "CREATE TABLE t (ts TIMESTAMP TIME INDEX, v DOUBLE)"), EXACT),
    ("pg insert tag", _pg_query("INSERT INTO t VALUES (1, 1.0), (2, 2.0)"),
     EXACT),
    ("pg delete tag", _pg_query("DELETE FROM t WHERE ts = 1"), EXACT),
    ("pg error then recover", lambda s: s.pg.query(
        "SELECT * FROM missing_table") + s.pg.query("SELECT count(*) "
                                                      "FROM t"), EXACT),
    ("pg parse error", _pg_query("SELEC 1"), EXACT),
    ("pg empty query", _pg_query(""), EXACT),
    ("pg multi statement", _pg_query(
        "INSERT INTO t VALUES (3, 3.0); SELECT v FROM t ORDER BY ts"),
     EXACT),
    ("pg show tables", _pg_query("SHOW TABLES"), EXACT),
    ("pg describe table", _pg_query("DESCRIBE TABLE typed"), EXACT),
    ("pg set", _pg_query("SET time_zone = 'UTC'"), EXACT),
    ("pg processlist", _pg_query("SHOW PROCESSLIST"), PROCESSES),
    ("pg kill unknown", _pg_query("KILL 424242"), EXACT),
    ("pg extended insert", lambda s: s.pg.extended(
        "INSERT INTO monitor (host, ts, cpu) VALUES ($1, $2, $3)",
        ("h9", 9000, 2.5)), EXACT),
    ("pg extended select", lambda s: s.pg.extended(
        "SELECT cpu, ts FROM monitor WHERE host = $1", ("h9",)), EXACT),
    ("pg extended null and quote", lambda s: s.pg.extended(
        "INSERT INTO monitor (host, ts, cpu) VALUES ($1, $2, $3)",
        ("o'neil", 9500, None)) + s.pg.extended(
        "SELECT host, cpu FROM monitor WHERE host = $1", ("o'neil",)),
     EXACT),
    ("pg extended without describe", lambda s: s.pg.extended(
        "SELECT host FROM monitor WHERE ts > $1 ORDER BY host", ("5000",),
        describe=False), EXACT),
    ("pg extended error", lambda s: s.pg.extended(
        "SELECT * FROM nowhere WHERE v = $1", ("1",)), EXACT),
    ("pg describe portal", _pg_describe_portal, EXACT),
    ("pg describe statement", _pg_describe_statement, EXACT),
    ("pg describe cache across sync", _pg_cache_across_sync, EXACT),
    ("pg binary ddl", _pg_query(
        "CREATE TABLE binp (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
        "n BIGINT, ok BOOLEAN, f FLOAT, PRIMARY KEY(host))"), EXACT),
    ("pg binary parameters", _pg_binary, EXACT),
    ("pg bind unknown statement", _pg_bind_unknown, EXACT),
    ("pg error skips until sync", _pg_pipeline_error, EXACT),
    ("pg close statement", _pg_close, EXACT),
    ("pg unknown message", _pg_unknown_message, EXACT),
    ("several clients", _multi_clients, EXACT),
    ("my after everything", _my_query(
        "SELECT host, count(*) FROM monitor GROUP BY host ORDER BY host"),
     EXACT),
]


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

class Side:
    """One package's frontend, MySQL server, Postgres server and one
    connection to each."""

    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(data_home=str(home),
                                                       device="cpu"))
            self.mysql, self.pg_srv = MysqlServer(self.fe), \
                PostgresServer(self.fe)
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home))))
            self.fe.start()
            self.mysql, self.pg_srv = RefMysqlServer(self.fe), \
                RefPgServer(self.fe)
        self.servers = [self.mysql, self.pg_srv]
        for srv in self.servers:
            srv.start()
        self.my = MyClient(self.mysql.port)
        self.pg = PgClient(self.pg_srv.port)

    def serve(self, kind, **kw):
        """Another server of `kind` ("mysql" / "postgres") over this
        side's frontend, shut down with the side."""
        if kind == "mysql":
            cls = MysqlServer if self.port else RefMysqlServer
        else:
            cls = PostgresServer if self.port else RefPgServer
        srv = cls(self.fe, **kw)
        srv.start()
        self.servers.append(srv)
        return srv

    def close(self):
        try:
            self.my.close()
            self.pg.close()
            for srv in self.servers:
                srv.shutdown()
        finally:
            self.fe.shutdown()


def _knobs():
    """The module state SET changes in both packages: the dispatch floors,
    the admission gates, the streaming knobs."""
    return [(ex, "TPU_DISPATCH_MIN_ROWS", ex.TPU_DISPATCH_MIN_ROWS)
            for ex in (ref_exec, tpu_exec)] + \
        [(ex, "_observed_min_dt", list(ex._observed_min_dt))
         for ex in (ref_exec, tpu_exec)] + \
        [(g, a, getattr(g, a)) for g in (ref_admission.GATE, admission.GATE)
         for a in ("max_inflight", "max_queued_bytes", "retry_after_s")] + \
        [(st, a, list(getattr(st, a))) for st in (ref_stream, stream_exec)
         for a in ("_STREAM_THRESHOLD_ROWS", "_SLICE_ROWS")]


def _restore(saved):
    for obj, attr, value in saved:
        if isinstance(value, list):
            getattr(obj, attr)[:] = value
        else:
            setattr(obj, attr, value)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    saved = _knobs()
    out = {}
    try:
        out["ref"] = Side(False, tmp_path_factory.mktemp("ref"))
        out["port"] = Side(True, tmp_path_factory.mktemp("port"))
        yield out
    finally:
        for s in out.values():
            s.close()
        _restore(saved)


@pytest.fixture(scope="module")
def exchange(sides):
    """Every step run on the reference's side, then on the port's:
    label -> {"ref": answer, "port": answer}."""
    saved = _knobs()
    out = {}
    try:
        for label, run, _ in STEPS:
            out[label] = {k: run(s) for k, s in sides.items()}
    finally:
        _restore(saved)
    return out


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _sql_bound(g, w):
    if math.isnan(w):
        return math.isnan(g)
    return abs(g - w) <= 1e-5 * abs(w) + 8 * EPS32 * P_ABS


def _prom_bound(g, w):
    if math.isnan(w) or math.isinf(w):
        return g == w or (math.isnan(g) and math.isnan(w))
    return math.isclose(g, w, rel_tol=1e-5, abs_tol=0.0)


def _float_columns(answer):
    """The columns a result declares as floats: MySQL DOUBLE / FLOAT
    column definitions, Postgres float8 in a RowDescription."""
    if isinstance(answer, tuple) and answer and answer[0] == "rows":
        return {i for i, cd in enumerate(answer[1])
                if cd[-6] in (mysql.T_DOUBLE, mysql.T_FLOAT)}
    return None


def _pg_float_columns(payload):
    n = struct.unpack_from("!H", payload, 0)[0]
    pos, out = 2, set()
    for i in range(n):
        pos = payload.index(b"\x00", pos) + 1
        if struct.unpack_from("!I", payload, pos + 6)[0] == \
                postgres.OID_FLOAT8:
            out.add(i)
        pos += 18
    return out


def _pg_row(payload):
    n = struct.unpack_from("!H", payload, 0)[0]
    pos, row = 2, []
    for _ in range(n):
        ln = struct.unpack_from("!i", payload, pos)[0]
        pos += 4
        if ln == -1:
            row.append(None)
        else:
            row.append(payload[pos:pos + ln])
            pos += ln
    return row


def _cells(got, want, floats, num, where):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        if i in floats and g is not None and w is not None and g != w:
            assert num(float(g), float(w)), f"{where}[{i}]: {g} != {w}"
        else:
            assert g == w, f"{where}[{i}]: {g!r} != {w!r}"


def _same(got, want, num, where):
    """Equal answers; with `num`, float cells of declared float columns
    within it."""
    if isinstance(want, list) and want and isinstance(want[0], tuple) and \
            len(want[0]) == 2 and isinstance(want[0][0], str):
        # Postgres messages
        assert [t for t, _ in got] == [t for t, _ in want], where
        floats = set()
        for i, ((gt, gp), (_, wp)) in enumerate(zip(got, want)):
            if gt == "T":
                floats = _pg_float_columns(wp)
            if gt == "D" and num is not None:
                _cells(_pg_row(gp), _pg_row(wp), floats, num, f"{where}#{i}")
            else:
                assert gp == wp, f"{where}#{i} {gt}: {gp!r} != {wp!r}"
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, num, f"{where}[{i}]")
        return
    floats = _float_columns(want)
    if floats is not None and num is not None:
        assert got[:2] == want[:2] and len(got[2]) == len(want[2]), where
        for i, (g, w) in enumerate(zip(got[2], want[2])):
            _cells(g, w, floats, num, f"{where} row {i}")
        return
    assert got == want, f"{where}: {got!r} != {want!r}"


def _processes(answer, sql):
    """SHOW PROCESSLIST's column definitions and the statement's own row
    with the per-process columns (Id, Elapsed_ms, Trace_id) dropped."""
    if isinstance(answer, tuple):                       # MySQL
        _, coldefs, rows = answer
        own = [r for r in rows if r[-1] == sql.encode()]
        return coldefs, [[r[1], r[2], r[3], r[4], r[6], r[7], r[9]]
                         for r in own]
    tags = [t for t, _ in answer]
    desc = answer[tags.index("T")][1]
    own = [_pg_row(p) for t, p in answer if t == "D" and
           _pg_row(p)[-1] == sql.encode()]
    return desc, [[r[1], r[2], r[3], r[4], r[6], r[7], r[9]] for r in own]


@pytest.mark.parametrize("label", [s[0] for s in STEPS])
def test_port_answers_as_the_reference(exchange, label):
    kind = {s[0]: s[2] for s in STEPS}[label]
    got, want = exchange[label]["port"], exchange[label]["ref"]
    if kind == PROCESSES:
        got, want = (_processes(a, "SHOW PROCESSLIST") for a in (got, want))
        assert got == want and len(want[1]) == 1, (got, want)
        return
    _same(got, want, {SQL: _sql_bound, PROM: _prom_bound}.get(kind), label)


def test_exchange_reached_every_path(exchange):
    """The steps did what they are there for: rows came back, errors came
    back as errors with the reference's codes, the device-path aggregate
    ran on the port's kernel path, KILL of an unknown id is ER 1094 /
    SQLSTATE XX000 on a connection that stays open."""
    def port(label):
        return exchange[label]["port"]

    assert port("my ping")[0] == "ok"
    assert port("my quickstart aggregate")[0] == "rows"
    names = [_coldef_name(cd) for cd in port("my quickstart aggregate")[1]]
    assert names[:2] == [b"host", b"c"]
    assert port("my not found")[:2] == ("err", 1105)
    assert port("my version")[2] == [[mysql.SERVER_VERSION.encode()]]
    assert port("my database() after use")[2] == [[b"otherdb"]]
    assert port("my com_process_kill unknown")[0][:2] == ("err", 1094)
    assert b"no such running" in port("my kill unknown")[3].encode()
    assert port("my unknown command")[0][:2] == ("err", 1047)
    assert port("my execute unknown statement")[:2] == ("err", 1243)
    assert len(port("my tsbs aggregate")[2]) == HOSTS * 2
    rows = port("my types select")[2]
    assert rows[0][:4] == [b"2023-01-01 00:00:00.000", b"1.5", b"x", b"1"]
    assert rows[1][1:3] == [None, None]
    pg_rows = [_pg_row(p) for t, p in port("pg types") if t == "D"]
    assert pg_rows[0][:4] == [b"2023-01-01 00:00:00.000000", b"1.5", b"x",
                              b"t"]
    tags = [p for t, p in port("pg delete tag") if t == "C"]
    assert tags == [b"DELETE 1\x00"]
    assert [t for t, _ in port("pg error skips until sync")].count("E") == 1
    assert any(t == "D" for t, _ in port("pg tql"))
    assert any(b"26000" in p for t, p in port("pg bind unknown statement")
               if t == "E")


def _coldef_name(cd):
    pos = 0
    for _ in range(4):                   # catalog, schema, table, org_table
        _, pos = mysql.read_lenenc_str(cd, pos)
    return mysql.read_lenenc_str(cd, pos)[0]


# ---------------------------------------------------------------------------
# auth, connect-with-db and TLS on both packages
# ---------------------------------------------------------------------------

def _users(side):
    cls = StaticUserProvider if side.port else RefUsers
    return cls({"greptime": "hunter2"})


def _login_outcomes(sides, kind):
    """Logins against an auth server of `kind` on each side."""
    out = {}
    for key, side in sides.items():
        srv = side.serve(kind, user_provider=_users(side))
        got = []
        for user, pwd, db in (("greptime", "hunter2", None),
                              ("greptime", "wrong", None),
                              ("nobody", "x", None),
                              ("greptime", "hunter2", "public")):
            if kind == "mysql":
                c = MyClient(srv.port, user, pwd, database=db)
                got.append(c.login)
                if c.login[0] == "ok":
                    got.append(c.query("SELECT database()"))
            else:
                c = PgClient(srv.port, user, pwd, database=db or "public")
                got.append([(t, p) for t, p in c.startup])
                if c.startup[-1][0] == "Z":
                    got.append(c.query("SELECT database()"))
            c.close()
        out[key] = got
    return out


@pytest.mark.parametrize("kind", ["mysql", "postgres"])
def test_auth_matches_the_reference(sides, kind):
    out = _login_outcomes(sides, kind)
    _same(out["port"], out["ref"], None, kind)
    if kind == "mysql":
        good, _, bad, unknown, with_db, _ = out["port"]
        assert good[0] == "ok" and with_db[0] == "ok"
        assert bad[:3] == ("err", 1045, "28000") and "Access denied" in bad[3]
        assert unknown[:2] == ("err", 1045)
    else:
        good, _, bad, unknown, with_db, _ = out["port"]
        assert good[-1][0] == "Z" and with_db[-1][0] == "Z"
        for refused in (bad, unknown):
            assert refused[-1][0] == "E" and b"C28P01\x00" in refused[-1][1]


@pytest.fixture(scope="module")
def tls_contexts(tmp_path_factory):
    pytest.importorskip("cryptography")
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    tls.make_self_signed(cert, key)
    server = tls.TlsOption.from_config({"mode": "require", "cert_path": cert,
                                        "key_path": key}).setup()
    client = ssl.create_default_context()
    client.check_hostname = False
    client.verify_mode = ssl.CERT_NONE
    return server, client


@pytest.mark.parametrize("kind", ["mysql", "postgres"])
def test_tls_handshake_matches_the_reference(sides, tls_contexts, kind):
    server_ctx, client_ctx = tls_contexts
    out = {}
    for key, side in sides.items():
        srv = side.serve(kind, ssl_context=server_ctx)
        if kind == "mysql":
            c = MyClient(srv.port, tls_context=client_ctx)
            assert c.server_caps & mysql.CLIENT_SSL
            out[key] = [c.login, c.query("SELECT 1 AS one"),
                        c.sock.version() is not None]
        else:
            c = PgClient(srv.port, tls_context=client_ctx)
            assert c.ssl_answer == b"S"
            out[key] = c.startup + c.query("SELECT 1 AS one") + \
                [("tls", str(c.sock.version() is not None).encode())]
        c.close()
    _same(out["port"], out["ref"], None, kind)


# ---------------------------------------------------------------------------
# what only the port's process is asked
# ---------------------------------------------------------------------------

def test_admission_rejects_over_both_wires(sides):
    """`SET admission_max_inflight = 1` (through Postgres: MySQL answers
    every SET with the federated OK) and one statement held in flight:
    MySQL answers errno 1040, Postgres SQLSTATE 53300, and both
    connections then answer again."""
    side = sides["port"]
    saved = _knobs()
    try:
        assert [t for t, _ in side.pg.query(
            "SET admission_max_inflight = 1")] == ["C", "Z"]
        assert admission.GATE.max_inflight == 1
        with process_list.track("SELECT held", protocol="mysql"):
            err = side.my.query("SELECT 1")
            pg = side.pg.query("SELECT 1")
        assert err[:2] == ("err", 1040), err
        assert "admission_max_inflight=1" in err[3]
        (e,) = [p for t, p in pg if t == "E"]
        assert b"C53300\x00" in e
        assert side.my.query("SELECT 1")[2] == [[b"1"]]
        assert [t for t, _ in side.pg.query("SELECT 1")] == \
            ["T", "D", "C", "Z"]
    finally:
        _restore(saved)


def _streamed_table(side):
    """Ten time-disjoint bulk loads (20 000 rows) in table `slow` of the
    port's frontend, as tests/test_torch_stream.py's KILL test loads
    them."""
    fe = side.fe
    fe.do_query("CREATE TABLE slow (host STRING, ts TIMESTAMP TIME INDEX, "
                "cpu DOUBLE, mem DOUBLE, PRIMARY KEY(host))")
    table = fe.catalog.table("greptime", "public", "slow")
    per = 2000
    for chunk in range(10):
        table.bulk_load({
            "host": np.repeat(np.array([f"h{i}" for i in range(20)]),
                              per // 20).astype(object),
            "ts": np.arange(per, dtype=np.int64) * 1000 + chunk * per * 1000,
            "cpu": np.random.default_rng(chunk).random(per),
            "mem": np.ones(per)})
    return table


def _job_history():
    """The port's completed background jobs (the process-wide rings that
    information_schema.background_jobs serves)."""
    with background_jobs._lock:
        return ({k: list(v) for k, v in background_jobs._completed.items()},
                background_jobs._next_id[0])


def _restore_job_history(saved):
    completed, next_id = saved
    with background_jobs._lock:
        background_jobs._completed.clear()
        background_jobs._completed.update(completed)
        background_jobs._next_id[0] = next_id


SLOW_QUERY = ("SELECT host, count(*), sum(cpu), avg(cpu) FROM slow GROUP BY "
              "host ORDER BY host")


@pytest.mark.parametrize("victim", ["mysql", "postgres"])
def test_kill_over_the_other_wire_ends_a_streamed_scan(sides, victim,
                                                       monkeypatch):
    """A streamed scan slowed to 150 ms per slice boundary runs over one
    wire; the other wire finds it in SHOW PROCESSLIST and kills it (SQL
    KILL over Postgres, COM_PROCESS_KILL over MySQL). The victim gets the
    cancellation error within about one slice, and its connection answers
    the next statement."""
    side = sides["port"]
    # the port-only table's flushes and compactions leave the process's
    # job history as the test found it (other tests compare the
    # background_jobs view between the packages)
    jobs = _job_history()
    if side.fe.catalog.table("greptime", "public", "slow") is None:
        _streamed_table(side)
    saved = _knobs()
    monkeypatch.setattr(stream_exec, "_STREAM_THRESHOLD_ROWS", [0])
    monkeypatch.setattr(stream_exec, "_SLICE_ROWS", [1000])
    tpu_exec.TPU_DISPATCH_MIN_ROWS = 0
    tpu_exec._observed_min_dt[0] = None
    victim_c = MyClient(side.mysql.port) if victim == "mysql" else \
        PgClient(side.pg_srv.port)
    killer = side.pg if victim == "mysql" else side.my
    outcome, done = [], []

    def run():
        outcome.append(victim_c.query(SLOW_QUERY))
        done.append(time.perf_counter())

    try:
        with failpoint.cfg("stream_slice", "delay(150)"):
            t = threading.Thread(target=run)
            t.start()
            pid = None
            deadline = time.perf_counter() + 10
            while pid is None and time.perf_counter() < deadline:
                time.sleep(0.05)
                pid = next((r["id"] for r in process_list.REGISTRY.rows()
                            if r["query"] == SLOW_QUERY), None)
            assert pid is not None, "the scan never showed up"
            time.sleep(0.4)                        # a few slices in
            listed = killer.query("SHOW PROCESSLIST")
            t0 = time.perf_counter()
            killed = killer.query(f"KILL {pid}") if victim == "mysql" \
                else killer.kill(pid)
            t.join(timeout=30)
            elapsed = done[0] - t0
        if victim == "mysql":
            infos = [_pg_row(p)[-1] for tag, p in listed if tag == "D"]
            assert SLOW_QUERY.encode() in infos
            assert [tag for tag, _ in killed] == ["C", "Z"]
            err = outcome[0]
            assert err[:2] == ("err", 1105), err
            assert f"query {pid} was killed" in err[3]
            assert victim_c.query("SELECT 1")[2] == [[b"1"]]
        else:
            assert any(r[-1] == SLOW_QUERY.encode() for r in listed[2])
            assert killed[0] == "ok", killed
            (e,) = [p for tag, p in outcome[0] if tag == "E"]
            assert f"query {pid} was killed".encode() in e
            assert [tag for tag, _ in victim_c.query("SELECT 1")] == \
                ["T", "D", "C", "Z"]
        assert elapsed < 2.0, f"{elapsed:.2f}s after KILL"
        assert side.fe.catalog.table("greptime", "public", "slow")
    finally:
        victim_c.close()
        _restore(saved)
        side.fe.datanode.storage.scheduler.wait_idle(timeout=60)
        _restore_job_history(jobs)
