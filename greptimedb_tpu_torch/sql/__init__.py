"""SQL AST (statement node types, including `Tql`).

Only the AST is ported so far; the SQL tokenizer and parser, and the TQL
entry point that takes a `Tql` statement, come with later slices."""

from . import ast

__all__ = ["ast"]
