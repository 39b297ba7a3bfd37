"""Native PromQL engine on PyTorch.

Reference behavior: src/promql — a PromQL planner compiling to DataFusion
plans with custom streaming nodes (SeriesNormalize / SeriesDivide /
Instant- and RangeManipulate) and per-window UDFs
(src/promql/src/planner.rs, extension_plan/, functions/). Here the same
stages run as torch ops on the engine's device (ops/window.py): series
become a dense [series, time] matrix in device memory; instant selection
and every range function are (series × step) device passes; label
grouping, vector matching, and JSON shaping stay on the host.
"""

from .parser import parse_promql, PromqlParseError
from .engine import PromqlEngine

__all__ = ["parse_promql", "PromqlParseError", "PromqlEngine"]
