"""Asynchronous host-side output writing.

The reference writes every snapshot/restart synchronously on rank 0 — the
whole MPI job stalls while Exporter streams records to disk (reference:
exportResults/writeRestart, model/finiteelement.cpp:14111-14325, 9503-9696).
Here the split is different: the device→host transfer is cheap
(DMA, done on the caller thread so array contents are frozen at submit
time), while serialization/compression/disk IO ride a single ordered
worker thread — the step loop never waits on the filesystem.

One process-wide writer keeps writes ordered across all output kinds
(snapshots, restarts) so a restart never lands before the snapshot that
precedes it. The queue is bounded: if the disk cannot keep up, submission
degrades gracefully to (partial) backpressure instead of unbounded memory
growth. Worker errors are re-raised on the caller thread at the next
``submit``/``flush`` so disk-full/permission failures are not silently
swallowed.

Enabled by ``output.async_io`` (off by default — synchronous writes remain
bitwise-identical to the reference behaviour in timing-sensitive tests).
"""

from __future__ import annotations

import atexit
import queue
import threading
from typing import Callable, Optional


class AsyncWriter:
    """Single ordered worker thread executing submitted write callables."""

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                fn, args, kwargs = item
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # surfaced at next submit/flush
                    self._err = e
            finally:
                self._q.task_done()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="nextsim-io", daemon=True
                )
                self._thread.start()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("asynchronous output write failed") from err

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)``; blocks only when the queue of
        pending writes is full (disk slower than the model)."""
        self._raise_pending()
        self._ensure_thread()
        self._q.put((fn, args, kwargs))

    def flush(self) -> None:
        """Wait for every pending write to hit the filesystem; re-raise any
        worker failure. Call before reading back a file written through the
        writer, and at finalise."""
        if self._thread is not None:
            self._q.join()
        self._raise_pending()


_writer: Optional[AsyncWriter] = None
_writer_lock = threading.Lock()


def get_writer() -> AsyncWriter:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = AsyncWriter()
        return _writer


def flush() -> None:
    """Flush the process-wide writer if one exists (cheap no-op otherwise)."""
    if _writer is not None:
        _writer.flush()


# the worker is a daemon thread: without this, queued writes submitted by a
# user script that never reaches Simulator.finalise would die with the
# interpreter (atexit runs before daemon threads are killed)
atexit.register(flush)
