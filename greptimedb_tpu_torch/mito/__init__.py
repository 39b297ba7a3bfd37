"""Mito: the default table engine, mapping tables onto storage regions.

Reference behavior: src/mito — `MitoEngine` creates one storage region per
table partition (src/mito/src/engine.rs:84-260), persists a table manifest
next to the data (src/mito/src/manifest.rs), and `MitoTable` implements the
Table trait by fanning scans over regions
(src/mito/src/table.rs:140-213).
"""

from .engine import MitoEngine, MitoTable

__all__ = ["MitoEngine", "MitoTable"]
