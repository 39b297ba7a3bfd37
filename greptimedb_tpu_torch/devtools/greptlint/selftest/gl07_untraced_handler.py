"""Seeded GL07 violation: a Flight handler that never touches
remote_context/traceparent, dropping the caller's trace on the wire."""


class RogueFlightServer:
    def do_get(self, context, ticket):
        return self._scan(ticket)

    def _scan(self, ticket):
        return []
