"""Plugins: a typed any-map shared across components.

Reference behavior: src/common/base/src/lib.rs — `Plugins` is an anymap
that layers (frontend, servers) consult for optional extensions (user
provider, query interceptors, meters). Lookup is by type.
"""

from __future__ import annotations

import threading
from typing import Optional, Type, TypeVar

T = TypeVar("T")


class Plugins:
    def __init__(self):
        self._by_type = {}
        self._lock = threading.Lock()

    def insert(self, value: object) -> None:
        with self._lock:
            self._by_type[type(value)] = value

    def get(self, cls: Type[T]) -> Optional[T]:
        with self._lock:
            v = self._by_type.get(cls)
            if v is not None:
                return v
            # subclass-aware lookup: a request for the base type finds a
            # registered specialization
            for t, inst in self._by_type.items():
                if issubclass(t, cls):
                    return inst
        return None

    def __contains__(self, cls: type) -> bool:
        return self.get(cls) is not None
