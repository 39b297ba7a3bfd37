"""Compressed file access for external tables and COPY TO/FROM.

Reference behavior: src/common/datasource/src/file_format/mod.rs +
compression.rs — the datasource layer decompresses CSV/JSON transparently
(gzip/zstd, inferred from the file extension or given explicitly) and
compresses on export. Parquet is excluded: its compression is internal
to the format. Implemented over pyarrow's codec streams so the CSV
reader consumes the decompressed bytes in C, not through Python shims.

Copied from greptimedb_tpu/common/datasource.py. Host code only: COPY
(frontend/statement.py) and the file-table engine (file_table/) import
it; the PromQL and SQL scan paths do not.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ..errors import UnsupportedError

_EXT_CODECS = {
    ".gz": "gzip",
    ".gzip": "gzip",
    ".zst": "zstd",
    ".zstd": "zstd",
}

_KNOWN = {"gzip", "zstd"}


def file_codec(path: str, explicit: Optional[str] = None) -> Optional[str]:
    """Resolve the compression codec: explicit option first (``none``
    disables inference), else the file extension."""
    if explicit is not None:
        name = str(explicit).lower()
        if name in ("none", ""):
            return None
        if name == "gz":
            name = "gzip"
        if name not in _KNOWN:
            raise UnsupportedError(
                f"compression {explicit!r} (supported: gzip, zstd)")
        return name
    for ext, codec in _EXT_CODECS.items():
        if path.lower().endswith(ext):
            return codec
    return None


def open_compressed_in(path: str, codec: Optional[str]) -> "pa.NativeFile":
    """Readable stream over a possibly-compressed local file."""
    raw = pa.OSFile(path, "rb")
    if codec is None:
        return raw
    return pa.CompressedInputStream(raw, codec)


def open_compressed_out(path: str, codec: Optional[str]) -> "pa.NativeFile":
    """Writable stream producing a possibly-compressed local file."""
    raw = pa.OSFile(path, "wb")
    if codec is None:
        return raw
    return pa.CompressedOutputStream(raw, codec)
