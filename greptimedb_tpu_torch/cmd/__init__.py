"""Process entry: the `greptime` CLI.

Reference behavior: src/cmd/src/bin/greptime.rs — subcommands
standalone|datanode|frontend|metasrv with layered TOML + flag options.
"""

from .main import main

__all__ = ["main"]
