"""SQL query interceptor hooks.

Reference behavior: src/servers/src/interceptor.rs:26 —
`SqlQueryInterceptor` plugin with pre/post hooks around parse and
execute; every protocol frontend consults the plugin chain so operators
can rewrite, audit, or reject queries without touching the engine.
"""

from __future__ import annotations

from typing import List, Sequence

from ..query.output import Output
from ..session import QueryContext


class SqlQueryInterceptor:
    """Override any subset of hooks; raise to reject the query."""

    def pre_parsing(self, sql: str, ctx: QueryContext) -> str:
        """May rewrite the raw SQL before parsing."""
        return sql

    def post_parsing(self, statements: List, ctx: QueryContext) -> List:
        """May rewrite the parsed statement list."""
        return statements

    def pre_execute(self, statement, ctx: QueryContext) -> None:
        """Called before executing each statement."""

    def post_execute(self, output: Output, ctx: QueryContext) -> Output:
        """May replace each statement's output."""
        return output


class InterceptorChain(SqlQueryInterceptor):
    def __init__(self, interceptors: Sequence[SqlQueryInterceptor] = ()):
        self.interceptors = list(interceptors)

    def append(self, interceptor: SqlQueryInterceptor) -> None:
        self.interceptors.append(interceptor)

    def pre_parsing(self, sql, ctx):
        for i in self.interceptors:
            sql = i.pre_parsing(sql, ctx)
        return sql

    def post_parsing(self, statements, ctx):
        for i in self.interceptors:
            statements = i.post_parsing(statements, ctx)
        return statements

    def pre_execute(self, statement, ctx):
        for i in self.interceptors:
            i.pre_execute(statement, ctx)

    def post_execute(self, output, ctx):
        for i in self.interceptors:
            output = i.post_execute(output, ctx)
        return output
