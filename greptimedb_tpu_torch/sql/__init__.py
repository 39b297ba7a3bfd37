"""SQL front end: tokenizer, AST, and recursive-descent parser.

Reference behavior: src/sql — a wrapper over sqlparser-rs adding GreptimeDB
statements and clauses (`src/sql/src/statements/statement.rs:34-64`): CREATE
TABLE with TIME INDEX / PRIMARY KEY / PARTITION BY RANGE COLUMNS / ENGINE
(`src/sql/src/parsers/create_parser.rs:144-260`), the `TQL EVAL(start, end,
step) <promql>` extension (`src/sql/src/parsers/tql_parser.rs:31-70`), COPY
(`src/sql/src/parsers/copy_parser.rs`), SHOW/DESCRIBE, ALTER, DELETE, and
INSERT. Implemented here as a hand-rolled lexer + recursive-descent parser
(no sqlparser dependency exists for Python at parity)."""

from .ast import *  # noqa: F401,F403
from .parser import ParserError, parse_sql, parse_statements
from . import ast

__all__ = ["parse_sql", "parse_statements", "ParserError"] + ast.__all__
