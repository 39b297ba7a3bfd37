"""Query engine: SQL planning, the GPU aggregate fast path and the pandas
fallback executor."""

from .output import Output
from .engine import QueryEngine
