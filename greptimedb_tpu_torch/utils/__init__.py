"""Shared host-side utilities."""

from __future__ import annotations

import os
import tempfile


def env_int(name: str, default: int) -> int:
    """Integer env knob; malformed values fall back to the default."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """Float env knob; malformed values fall back to the default."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_flag(name: str, default: bool) -> bool:
    """Boolean env knob: unset → default; '0'/'false'/'off'/'no'/''
    (any case) → False; anything else → True. THE parser for on/off
    env twins — per-module copies drift on the accepted false-strings.
    Lives in this leaf module so storage/ can import it without pulling
    the runtime→scheduler→storage import cycle."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "off", "no", "")


def atomic_write(path: str, data: "bytes | str", *, fsync: bool = True,
                 tmp_prefix: str = ".tmp-") -> None:
    """Write `data` (bytes or str) to `path` atomically: temp file in the
    same directory, optional fsync, rename. A crash at any point leaves
    either the old file or the complete new one — never a torn mix — and
    the temp file is unlinked on failure. One implementation shared by
    every state-doc writer (object store, meta kv, raft persistence) so
    a durability fix lands everywhere at once."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=tmp_prefix)
    try:
        mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
        with os.fdopen(fd, mode) as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_publish(tmp_path: str, path: str, *, fsync: bool = True) -> None:
    """Publish an ALREADY-WRITTEN temp file to its final name atomically:
    the streaming/subprocess twin of :func:`atomic_write`, for bytes
    produced by someone else (a compiler, a spooled upload stream).
    Optionally fsyncs the temp file, renames it into place, and unlinks
    the temp on failure — same guarantees, same single implementation
    (greptlint GL03 allows renames only here)."""
    try:
        if fsync:
            with open(tmp_path, "rb+") as f:
                os.fsync(f.fileno())
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
