"""tracked_state(): shared-structure access recording for greptsan.

``tracked_state(obj, name)`` wraps a dict/list/set/OrderedDict in a
subclass whose accesses flow through :func:`detector.record_access`.
When the detector is off it returns ``obj`` unchanged — the
TrackedLock/failpoint zero-overhead factory pattern.

Granularity (what counts as "the same variable"):

- dict item get/set/del race per *key* — two threads updating different
  keys are GIL-atomic and independent by design in this codebase;
- operations that change or observe the *key set* (inserting a new key,
  deleting, clear, len, iteration, keys/values/items, containment)
  share one ``<shape>`` variable — an unsynchronized key-set change
  concurrent with iteration is exactly the "dict changed size during
  iteration" crash, so shape-write vs shape-read is a reported race;
- lists and sets are one variable each (their idiomatic uses here —
  scheduler queues, worker lists, mailbox lists — are whole-structure).

The proxies subclass the builtins, so isinstance checks, json encoding
and repr all behave; only the access-recording methods are overridden.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Any, Iterator, Tuple

from . import detector

__all__ = ["tracked_state", "TrackedDict", "TrackedOrderedDict",
           "TrackedList", "TrackedSet", "SHAPE"]

#: sentinel variable key for key-set shape accesses
SHAPE = "<shape>"

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


class _TrackedBase:
    """Mixin holding the (name, id) identity + record shorthands."""

    _san_name: str
    _san_id: int

    def _san_init(self, name: str) -> None:
        # object.__setattr__: subclasses of dict/list/set have no
        # __slots__ conflict, but keep the write explicit and cheap
        self._san_name = name
        self._san_id = _next_id()

    def _rec(self, key: object, write: bool) -> None:
        detector.record_access(self._san_name, self._san_id, key, write,
                               skip=3)


class TrackedDict(_TrackedBase, dict):
    def __init__(self, name: str, *args: Any, **kwargs: Any):
        dict.__init__(self, *args, **kwargs)
        self._san_init(name)

    # -- per-key accesses --------------------------------------------
    def __getitem__(self, key: object) -> Any:
        self._rec(key, False)
        return dict.__getitem__(self, key)

    def get(self, key: object, default: Any = None) -> Any:
        self._rec(key, False)
        return dict.get(self, key, default)

    def __setitem__(self, key: object, value: Any) -> None:
        if not dict.__contains__(self, key):
            self._rec(SHAPE, True)
        self._rec(key, True)
        dict.__setitem__(self, key, value)

    def setdefault(self, key: object, default: Any = None) -> Any:
        if not dict.__contains__(self, key):
            self._rec(SHAPE, True)
            self._rec(key, True)
        else:
            self._rec(key, False)
        return dict.setdefault(self, key, default)

    def __delitem__(self, key: object) -> None:
        self._rec(SHAPE, True)
        self._rec(key, True)
        dict.__delitem__(self, key)

    def pop(self, key: object, *default: Any) -> Any:
        if dict.__contains__(self, key):
            self._rec(SHAPE, True)
        self._rec(key, True)
        return dict.pop(self, key, *default)

    def popitem(self) -> Tuple[Any, Any]:
        self._rec(SHAPE, True)
        return dict.popitem(self)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._rec(SHAPE, True)
        dict.update(self, *args, **kwargs)

    def clear(self) -> None:
        self._rec(SHAPE, True)
        dict.clear(self)

    # -- shape observations ------------------------------------------
    def __contains__(self, key: object) -> bool:
        self._rec(SHAPE, False)
        return dict.__contains__(self, key)

    def __iter__(self) -> Iterator:
        self._rec(SHAPE, False)
        return dict.__iter__(self)

    def __len__(self) -> int:
        self._rec(SHAPE, False)
        return dict.__len__(self)

    def keys(self):  # type: ignore[no-untyped-def]
        self._rec(SHAPE, False)
        return dict.keys(self)

    def values(self):  # type: ignore[no-untyped-def]
        self._rec(SHAPE, False)
        return dict.values(self)

    def items(self):  # type: ignore[no-untyped-def]
        self._rec(SHAPE, False)
        return dict.items(self)

    def copy(self) -> dict:
        self._rec(SHAPE, False)
        return dict(self)


class TrackedOrderedDict(_TrackedBase, OrderedDict):
    """OrderedDict twin (the LRU caches): move_to_end is a write to the
    *order*, which iteration observes — modeled as a shape write."""

    def __init__(self, name: str, *args: Any, **kwargs: Any):
        OrderedDict.__init__(self, *args, **kwargs)
        self._san_init(name)

    def __getitem__(self, key: object) -> Any:
        self._rec(key, False)
        return OrderedDict.__getitem__(self, key)

    def get(self, key: object, default: Any = None) -> Any:
        self._rec(key, False)
        return OrderedDict.get(self, key, default)

    def __setitem__(self, key: object, value: Any) -> None:
        if not dict.__contains__(self, key):
            self._rec(SHAPE, True)
        self._rec(key, True)
        OrderedDict.__setitem__(self, key, value)

    def setdefault(self, key: object, default: Any = None) -> Any:
        if not dict.__contains__(self, key):
            self._rec(SHAPE, True)
            self._rec(key, True)
        else:
            self._rec(key, False)
        return OrderedDict.setdefault(self, key, default)

    def __delitem__(self, key: object) -> None:
        self._rec(SHAPE, True)
        self._rec(key, True)
        OrderedDict.__delitem__(self, key)

    def pop(self, key: object, *default: Any) -> Any:
        if dict.__contains__(self, key):
            self._rec(SHAPE, True)
        self._rec(key, True)
        return OrderedDict.pop(self, key, *default)

    def popitem(self, last: bool = True) -> Tuple[Any, Any]:
        self._rec(SHAPE, True)
        return OrderedDict.popitem(self, last)

    def move_to_end(self, key: object, last: bool = True) -> None:
        self._rec(SHAPE, True)
        OrderedDict.move_to_end(self, key, last)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._rec(SHAPE, True)
        OrderedDict.update(self, *args, **kwargs)

    def clear(self) -> None:
        self._rec(SHAPE, True)
        OrderedDict.clear(self)

    def __contains__(self, key: object) -> bool:
        self._rec(SHAPE, False)
        return dict.__contains__(self, key)

    def __iter__(self) -> Iterator:
        self._rec(SHAPE, False)
        return OrderedDict.__iter__(self)

    def __len__(self) -> int:
        self._rec(SHAPE, False)
        return dict.__len__(self)

    def keys(self):  # type: ignore[no-untyped-def]
        self._rec(SHAPE, False)
        return OrderedDict.keys(self)

    def values(self):  # type: ignore[no-untyped-def]
        self._rec(SHAPE, False)
        return OrderedDict.values(self)

    def items(self):  # type: ignore[no-untyped-def]
        self._rec(SHAPE, False)
        return OrderedDict.items(self)

    def copy(self) -> OrderedDict:
        # OrderedDict.copy() builds self.__class__(self) — whose first
        # positional here is the tracker NAME, so the inherited copy
        # would TypeError only under the detector. Return a plain
        # OrderedDict (the TrackedDict.copy contract).
        self._rec(SHAPE, False)
        out: OrderedDict = OrderedDict()
        for k in OrderedDict.keys(self):
            out[k] = OrderedDict.__getitem__(self, k)
        return out


class TrackedList(_TrackedBase, list):
    def __init__(self, name: str, *args: Any):
        list.__init__(self, *args)
        self._san_init(name)

    def _read(self) -> None:
        self._rec(SHAPE, False)

    def _write(self) -> None:
        self._rec(SHAPE, True)

    def __getitem__(self, i: Any) -> Any:
        self._read()
        return list.__getitem__(self, i)

    def __setitem__(self, i: Any, v: Any) -> None:
        self._write()
        list.__setitem__(self, i, v)

    def __delitem__(self, i: Any) -> None:
        self._write()
        list.__delitem__(self, i)

    def __iter__(self) -> Iterator:
        self._read()
        return list.__iter__(self)

    def __len__(self) -> int:
        self._read()
        return list.__len__(self)

    def __contains__(self, v: object) -> bool:
        self._read()
        return list.__contains__(self, v)

    def append(self, v: Any) -> None:
        self._write()
        list.append(self, v)

    def extend(self, it: Any) -> None:
        self._write()
        list.extend(self, it)

    def insert(self, i: int, v: Any) -> None:
        self._write()
        list.insert(self, i, v)

    def pop(self, i: int = -1) -> Any:
        self._write()
        return list.pop(self, i)

    def remove(self, v: Any) -> None:
        self._write()
        list.remove(self, v)

    def clear(self) -> None:
        self._write()
        list.clear(self)

    def sort(self, **kw: Any) -> None:
        self._write()
        list.sort(self, **kw)


class TrackedSet(_TrackedBase, set):
    def __init__(self, name: str, *args: Any):
        set.__init__(self, *args)
        self._san_init(name)

    def _read(self) -> None:
        self._rec(SHAPE, False)

    def _write(self) -> None:
        self._rec(SHAPE, True)

    def __contains__(self, v: object) -> bool:
        self._read()
        return set.__contains__(self, v)

    def __iter__(self) -> Iterator:
        self._read()
        return set.__iter__(self)

    def __len__(self) -> int:
        self._read()
        return set.__len__(self)

    def add(self, v: Any) -> None:
        self._write()
        set.add(self, v)

    def discard(self, v: Any) -> None:
        self._write()
        set.discard(self, v)

    def remove(self, v: Any) -> None:
        self._write()
        set.remove(self, v)

    def clear(self) -> None:
        self._write()
        set.clear(self)

    def update(self, *others: Any) -> None:
        self._write()
        set.update(self, *others)


def tracked_state(obj: Any, name: str) -> Any:
    """Wrap a shared structure for race detection; identity when off.

    ``name`` is the report label ("storage.engine.regions") — one name
    per structure *class*, like TrackedLock names. Apply at creation:

        self._regions = tracked_state({}, "storage.engine.regions")

    Supported: dict, OrderedDict, list, set. Anything else returns
    unchanged (with a one-time warning under the detector) so a caller
    never breaks when a structure changes type."""
    if not detector.enabled():
        return obj
    if isinstance(obj, OrderedDict):
        out: Any = TrackedOrderedDict(name)
        OrderedDict.update(out, obj)
        return out
    if isinstance(obj, dict):
        out = TrackedDict(name)
        dict.update(out, obj)
        return out
    if isinstance(obj, list):
        out = TrackedList(name)
        list.extend(out, obj)
        return out
    if isinstance(obj, set):
        out = TrackedSet(name)
        set.update(out, obj)
        return out
    import logging
    logging.getLogger(__name__).warning(
        "tracked_state(%s): unsupported type %s — not tracked",
        name, type(obj).__name__)
    return obj
