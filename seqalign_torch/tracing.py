"""The program's own spans and counters, on the host clock, kept in memory.

Off by default: only ``with recording() as rec:`` turns them on, for that
block.  Off, ``span()`` makes one check of a module global and returns a
shared no-op context manager, and ``count()`` and ``annotate()`` make the
same check and return: none reads a clock, allocates, or touches torch or
the device.

On, a span records its name, its own id, its parent's id (the innermost
span open on the same thread), a request id, and its start and end from
``time.perf_counter_ns``.  A span opened with no parent on its thread is a
request's root (``api.align`` and ``batch.search`` on the program's
paths): it opens a new request id, which every span under it carries.
``rec`` holds the finished spans (``rec.spans``, in the order they ended)
and the counters by name (``rec.counters``); nothing is written anywhere
else.

The spans and counters of the pair path:

* ``api.align``: a request (the root); attribute ``route``: ``direct``,
  ``checkpoint`` or ``other``, as ``models/base.py`` picks it;
* ``direct.align``: the direct route, ``ops/direct.direct_align``;
* ``checkpoint.fill``: the checkpoint engine's phase 1, and in it
  ``checkpoint.strip``, one strip's pattern upload and K1 launch;
* ``checkpoint.traceback``: its phase 2, and in it ``checkpoint.tile``,
  one path tile (``Tiles.walk``), counted in ``checkpoint.tiles``;
* ``native.emit``: the host's replay of the moves (linear or affine);
* ``host_waits``: the reads of a device tensor to the host on these paths.

The spans and counters of the database search (``parallel/search.py``):

* ``batch.search``: a request (the root); attribute ``buckets``: its K3
  launches, one a run of groups one kernel fills;
* ``search.dispatch``: the query's upload and the K3 launches;
* ``search.tail``: the sequences above the tail threshold, K1's (a
  ``checkpoint.fill`` each);
* ``search.collect``: the scores to the host;
* ``search.buckets`` (K3 launches), ``search.cells`` (the query's length
  times the database's residues), ``search.cells_padded`` (the cells the
  kernels are given: K3's groups at their widths by the query's rows to
  a stripe, K1's strips by their steps), ``search.cells16`` (the query's
  length times the residues of the groups filled in int16 cells: its
  share of ``search.cells`` is the int16 gate's), ``search.tail_pairs``,
  and ``host_waits`` at each read-back.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from time import perf_counter_ns as _clock

# The recording in progress, or None (tracing off).
_rec = None
_NOOP = contextlib.nullcontext()


class Span:
    """One span; a context manager that times itself into its recording."""

    __slots__ = ("name", "id", "parent", "request", "start", "end", "attrs",
                 "_rec")

    def __init__(self, rec: "Recording", name: str):
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        self.parent = self.request = None
        self.start = self.end = 0
        self.attrs: dict = {}

    def __enter__(self):
        stack = self._rec._stack()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.request = next(self._rec._requests)
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        stack = self._rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._rec.spans.append(self)
        return False


class Recording:
    """What one ``recording()`` block holds: ``spans`` (finished, in the
    order they ended) and ``counters`` (name -> total)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        local = self._local
        if not hasattr(local, "stack"):
            local.stack = []
        return local.stack

    def _count(self, name: str, n: int):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn spans and counters on for the block; yields the ``Recording``
    that holds them.  Recordings do not nest."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already in progress")
    rec = Recording()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None


def span(name: str):
    """A span named ``name`` around the ``with`` block, while recording."""
    rec = _rec
    if rec is None:
        return _NOOP
    return Span(rec, name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``, while recording."""
    rec = _rec
    if rec is None:
        return
    rec._count(name, n)


def annotate(key: str, value):
    """Set the attribute ``key`` of the innermost span open on this
    thread, while recording."""
    rec = _rec
    if rec is None:
        return
    stack = rec._stack()
    if stack:
        stack[-1].attrs[key] = value
