"""Seeded GL08 violation: module declares a lock for its shared state
but one path mutates the module-level dict without holding it."""

import threading

_lock = threading.Lock()
_registry = {}


def register_safe(name, value):
    with _lock:
        _registry[name] = value


def register_racy(name, value):
    _registry[name] = value
