"""Spans of the program's layers, seen by torch.profiler.

While a profiler records, ``span(name)`` is a ``record_function`` range, on
the same clock as the device trace; otherwise it is one shared null
context, so an untraced run pays a C-level query a span. The profiler is
the only switch.
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """True while a torch profiler is recording."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    return torch.profiler.record_function(name) if enabled() else _NULL
