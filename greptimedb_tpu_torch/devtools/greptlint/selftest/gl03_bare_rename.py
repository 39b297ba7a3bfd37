"""Seeded GL03 violation: write-then-rename bypassing utils.atomic_write
(no fsync, no crash-safe temp cleanup)."""

import os


def save_snapshot(path, data):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)
