"""Named spans at the port's layer boundaries, recorded only while a
``torch.profiler`` session runs.

``span(name, qid=None)`` is a context manager.  With no profiler running
it returns one shared no-op context: nothing is entered and nothing is
allocated.  Under a profiler it opens a named range on the calling thread,
a host event on the same clock as the device activity of the trace, so a
trace's idle gaps can be named by the span over them.  A span given a
request's ``qid`` carries it as the keyword argument ``qid`` (visible in
``FunctionEvent.kwinputs`` and in the Chrome trace's ``args`` when the
profiler records shapes); the spans opened inside it belong to that
request by nesting.

There is no switch: spans are on exactly while someone profiles.  A
profiler records the spans of the thread that started it; the planner
thread's need ``_ExperimentalConfig(profile_all_threads=True)``
(docs/serving_torch.md).

Names are static, ``odyssey.<layer>.<step>``: ``odyssey.serve.plan_batch``,
``odyssey.serve.execute_batch``, ``odyssey.serve.execute`` (one request),
``odyssey.exec.star``, ``odyssey.exec.join``, ``odyssey.exec.readback``,
``odyssey.exec.rows``.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
# the profiler's named range with keyword values: ``record_function``'s
# ``args`` string reaches no event, and its ranges add device-side
# annotations that a trace reader must then tell from device work
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str, qid: "int | None" = None):
    """A named range over the ``with`` body while a profiler runs (module
    docstring); otherwise a shared no-op context."""
    # the module flag, not ``torch.autograd._profiler_enabled()``: that one
    # is thread-local and reads False on every thread but the profiler's
    if not _profiler._is_profiler_enabled:
        return _OFF
    if qid is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], {"qid": qid})
