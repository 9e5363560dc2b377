"""Spans of the program's layers, recorded while a torch profiler records.

`span(name)` is a context manager: a profiler range named `name` while
`torch.profiler.profile()` (or the autograd profiler) is recording on this
process, else one shared no-op. So tracing is on exactly while a profiler
records. On the host of an H100 machine a span costs 0.56 us with no
profiler recording (the check and the no-op) and 1.13 us while one
records.

The range is the profiler's fast function range: it sits on the
profiler's clock beside the CUDA runtime calls and the device operations
they launch (correlated by launch), and, unlike `record_function`, it
leaves no copy of itself on the device's timeline, which would count as
device work. Span names are fixed strings or an operator's class name,
never a label with parameters in it:

    ballista.sql, .sql.parse, .sql.plan      SessionContext.sql
    ballista.collect, ballista.route         SessionContext.collect
    ballista.attempt, .plan.physical,        each pass of converge
      .plan.bind, ballista.verdict
    ballista.exec.<OperatorClass>            Run._evaluate
    ballista.kernel.masked_slot_sums         masked_slot_sums_rows
    ballista.join.unique_keys                SessionContext.join_unique_
                                               keys: a large table's join
                                               columns
    ballista.join.key_remap                  HashJoinExec: a union-
                                               dictionary lookup table built
    ballista.join.probe                      HashJoinExec.evaluate: probe_
                                               unique, merge_full_unique or
                                               expand_join
"""

from __future__ import annotations

import contextlib

import torch

_recording = torch.autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

EXEC = "ballista.exec."


def span(name: str):
    """A profiler range named `name` while a profiler records, else a no-op."""
    return _range(name) if _recording() else _OFF


def exec_span(node):
    """The span of one operator's evaluation, named by its class; the name
    is built only while a profiler records."""
    return _range(EXEC + type(node).__name__) if _recording() else _OFF
