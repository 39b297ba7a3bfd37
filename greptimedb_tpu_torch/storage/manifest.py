"""Region manifest: durable metadata action log with checkpoints.

Reference behavior: src/storage/src/manifest/ — every metadata mutation
(schema change, SST edit, removal) is an action appended to a versioned log
on object storage; a checkpoint summarizing state is written every
`checkpoint_margin` actions and old deltas are GC'd. Recovery = load last
checkpoint + replay later deltas.

Files under `{region}/manifest/`:
    {version:020d}.json            — one action list per version
    {version:020d}.checkpoint.json — full-state checkpoint at that version
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..common import failpoint as _fp
from ..common.locks import TrackedLock
from .object_store import ObjectStore

_fp.register("manifest_commit")
_fp.register("manifest_checkpoint")

_DELTA_RE = re.compile(r"^(\d{20})\.json$")
_CKPT_RE = re.compile(r"^(\d{20})\.checkpoint\.json$")


class RegionManifest:
    def __init__(self, store: ObjectStore, manifest_dir: str,
                 checkpoint_margin: int = 10):
        self.store = store
        self.dir = manifest_dir.rstrip("/")
        self.checkpoint_margin = checkpoint_margin
        self._lock = TrackedLock("storage.manifest")
        self._version = -1           # last written version
        self._actions_since_ckpt = 0

    # ---- writing ----
    def save(self, actions: List[dict]) -> int:
        """Append an action list; returns the new manifest version."""
        with self._lock:
            _fp.fail_point("manifest_commit")
            self._version += 1
            v = self._version
            key = f"{self.dir}/{v:020d}.json"
            self.store.write(key, json.dumps(
                {"version": v, "actions": actions}).encode())
            self._actions_since_ckpt += 1
            return v

    def save_checkpoint(self, state: dict) -> None:
        with self._lock:
            _fp.fail_point("manifest_checkpoint")
            v = self._version
            if v < 0:
                return
            key = f"{self.dir}/{v:020d}.checkpoint.json"
            self.store.write(key, json.dumps(
                {"version": v, "state": state}).encode())
            self._actions_since_ckpt = 0

    def should_checkpoint(self) -> bool:
        return self._actions_since_ckpt >= self.checkpoint_margin

    def gc(self) -> None:
        """Delete deltas and older checkpoints covered by the newest
        checkpoint."""
        files = self._files()
        ckpts = sorted(v for v, _, is_c in files if is_c)
        if not ckpts:
            return
        latest = ckpts[-1]
        for v, name, is_c in files:
            if (is_c and v < latest) or (not is_c and v <= latest):
                self.store.delete(f"{self.dir}/{name}")

    # ---- recovery ----
    def load(self) -> Tuple[Optional[dict], List[dict]]:
        """Returns (checkpoint_state | None, actions newer than it, in order).
        Also positions the writer version past the last entry."""
        files = self._files()
        ckpt_versions = sorted(v for v, _, is_c in files if is_c)
        state = None
        start_after = -1
        if ckpt_versions:
            latest = ckpt_versions[-1]
            raw = json.loads(self.store.read(
                f"{self.dir}/{latest:020d}.checkpoint.json"))
            state = raw["state"]
            start_after = latest
        actions: List[dict] = []
        max_v = start_after
        for v, name, is_c in sorted(files):
            if is_c or v <= start_after:
                continue
            raw = json.loads(self.store.read(f"{self.dir}/{name}"))
            actions.extend(raw["actions"])
            max_v = max(max_v, v)
        with self._lock:
            self._version = max_v
            self._actions_since_ckpt = max_v - start_after
        return state, actions

    def _files(self) -> List[Tuple[int, str, bool]]:
        out = []
        for key in self.store.list(self.dir):
            name = key.rsplit("/", 1)[-1]
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)), name, True))
                continue
            m = _DELTA_RE.match(name)
            if m:
                out.append((int(m.group(1)), name, False))
        return out
