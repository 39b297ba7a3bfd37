"""Seeded GL10 violation: a Flight handler reaches (two calls deep) a
`raise` of an exception class outside the errors.* taxonomy — the wire
would carry status UNKNOWN/500 instead of a real code. The handler
touches remote_context so GL07 stays quiet: this fixture seeds exactly
one finding."""


class NotWireMapped(Exception):
    """Deliberately NOT a GreptimeError subclass."""


class FixtureFlightServer:
    def do_get(self, context, ticket):
        with remote_context(None):  # noqa: F821 — parsed, never run
            return _load(ticket)


def _load(ticket):
    return _decode(ticket)


def _decode(ticket):
    raise NotWireMapped("untyped error escaping the RPC boundary")
