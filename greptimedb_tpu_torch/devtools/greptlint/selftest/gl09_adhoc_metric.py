"""Seeded GL09 violation: an ad-hoc prometheus metric object. It lives
outside the common/telemetry helpers, so the self-monitoring scraper,
/metrics and information_schema.runtime_metrics all miss or mis-handle
it (no shared registry walk, no suppress_metrics recursion guard, no
name-collision sanitizer)."""

from prometheus_client import Counter

_MY_COUNTER = Counter("my_private_requests_total", "bespoke counter")


def record_request():
    _MY_COUNTER.inc()
