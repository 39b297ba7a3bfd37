"""What the query path reads from storage: the series dictionary and a
region scan's `ScanData`. Regions themselves (memtable, SSTs, WAL,
manifest) come with the storage slice."""

from .scan import ScanData  # noqa: F401
from .series import SeriesDict  # noqa: F401
