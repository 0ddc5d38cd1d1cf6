"""A local world of rank processes that runs functions on every rank.

:class:`LocalWorld` starts ``n`` Python processes on this host
(``python -m incubator_mxnet_tpu_torch.parallel.world``), which join one
``torch.distributed`` world through a ``FileStore`` in ``store_dir``, and
keeps them: :meth:`LocalWorld.run` pickles a function (by reference: its
module must import on the rank's ``sys.path``, which is the parent's) and
its arguments to every rank, runs it there as ``fn(rank, *args)``, and
returns the results in rank order; :meth:`LocalWorld.start` sends such a
call and returns at once, :meth:`LocalWorld.wait` collects the oldest
call started (the world's own join is the first, so the constructor
returns while the ranks start). Every call has its own timeout, counted
from its start; a rank that fails or does not answer in time stops the
whole world (its processes are killed) and the wait raises, so a hang
costs one timeout, not a test suite's clock. :meth:`close` (or the
``with`` block's end) stops the world.

Each rank runs ``threads`` torch threads, sees ``LOCAL_RANK`` /
``RANK`` / ``WORLD_SIZE`` set, and joins with ``backend`` (gloo or NCCL;
the caller's choice) on ``device``. Tasks and results travel as
length-prefixed pickles over the rank's stdin and a pipe of its own,
which a reader thread a rank drains into a queue (so a rank never blocks
on its results while the parent sends the next call); the rank's prints
go to its stderr, which the world keeps in ``store_dir/rank<r>.log``.
"""
from __future__ import annotations

import os
import pickle
import queue
import struct
import subprocess
import sys
import threading
import time
import traceback
from typing import Optional

__all__ = ["LocalWorld", "WorldError"]


class WorldError(RuntimeError):
    """A rank failed, died or did not answer in time."""


def _send(f, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(fd: int, n: int) -> bytes:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = os.readv(fd, [view[got:]])
        if not k:
            raise EOFError
        got += k
    return bytes(buf)


def _reader(fd: int, q: "queue.Queue") -> None:
    """Every result a rank writes, into ``q``; None when the pipe ends."""
    try:
        while True:
            (n,) = struct.unpack("<Q", _read_exact(fd, 8))
            q.put(pickle.loads(_read_exact(fd, n)))
    except (EOFError, OSError):
        q.put(None)


class LocalWorld:
    """``n`` rank processes in one ``torch.distributed`` world (see the
    module's note)."""

    def __init__(self, n: int, store_dir: str, backend: str = "gloo",
                 device: str = "cpu", threads: int = 1,
                 timeout: float = 120.0, env: Optional[dict] = None):
        self.n = n
        self.store_dir = str(store_dir)
        os.makedirs(self.store_dir, exist_ok=True)
        store = os.path.join(self.store_dir, "store")
        if os.path.exists(store):
            os.remove(store)
        self._procs, self._logs, self._res = [], [], []
        self._queues, self._readers = [], []
        path = os.pathsep.join(p for p in sys.path if p)
        for r in range(n):
            rfd, wfd = os.pipe()
            log = open(os.path.join(self.store_dir, f"rank{r}.log"), "wb")
            e = dict(os.environ)
            e.update(env or {})
            e.update(PYTHONPATH=path, LOCAL_RANK=str(r), RANK=str(r),
                     WORLD_SIZE=str(n), OMP_NUM_THREADS=str(threads),
                     _MXT_WORLD_FD=str(wfd))
            p = subprocess.Popen(
                [sys.executable, "-m", "incubator_mxnet_tpu_torch.parallel."
                 "world", store, backend, device, str(threads)],
                stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
                env=e, pass_fds=(wfd,))
            os.close(wfd)
            self._procs.append(p)
            self._logs.append(log)
            self._res.append(rfd)
            q = queue.Queue()
            t = threading.Thread(target=_reader, args=(rfd, q), daemon=True,
                                 name=f"world-rank{r}")
            t.start()
            self._queues.append(q)
            self._readers.append(t)
        self._pending = []
        self.start(_joined, timeout=timeout)

    @property
    def closed(self) -> bool:
        return not self._procs

    def start(self, fn, *args, timeout: float = 120.0) -> None:
        """Send ``fn(rank, *args)`` to every rank; :meth:`wait` collects
        it (calls are collected in the order they were started)."""
        if not self._procs:
            raise WorldError("the world is closed")
        for r, p in enumerate(self._procs):
            try:
                _send(p.stdin, (fn, args))
            except OSError:
                self._kill()
                raise WorldError(f"rank {r} is gone ({self._tail(r)})") \
                    from None
        self._pending.append((fn, time.monotonic() + timeout, timeout))

    def run(self, fn, *args, timeout: float = 120.0):
        """``fn(rank, *args)`` on every rank; the results in rank order
        (calls started before it are collected first)."""
        self.start(fn, *args, timeout=timeout)
        while len(self._pending) > 1:
            self._collect()
        return self._collect()

    def wait(self):
        """The results, in rank order, of the oldest call started (the
        world's join, if still pending, is collected first)."""
        if self._pending and self._pending[0][0] is _joined \
                and len(self._pending) > 1:
            self._collect()
        return self._collect()

    def _collect(self):
        if not self._pending:
            raise WorldError("no call to wait for")
        fn, deadline, timeout = self._pending.pop(0)
        name = fn.__name__
        out = []
        for r, q in enumerate(self._queues):
            try:
                got = q.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                self._kill()
                raise WorldError(f"rank {r} did not answer {name} within "
                                 f"{timeout:.0f} s; world stopped "
                                 f"({self._tail(r)})") from None
            if got is None:
                self._kill()
                raise WorldError(f"rank {r} died in {name} "
                                 f"({self._tail(r)})")
            ok, val = got
            if not ok:
                self._kill()
                raise WorldError(f"rank {r} failed in {name}:\n{val}")
            out.append(val)
        return out

    def _tail(self, r: int) -> str:
        try:
            with open(os.path.join(self.store_dir, f"rank{r}.log"),
                      "rb") as f:
                return f.read()[-2000:].decode(errors="replace")
        except OSError:
            return "no log"

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()
        self._cleanup()

    def _cleanup(self) -> None:
        """After every rank has exited: their pipes end, the readers
        stop."""
        self._pending = []
        for t in self._readers:
            t.join(timeout=10)
        for fd in self._res:
            os.close(fd)
        for f in self._logs:
            f.close()
        for p in self._procs:
            if p.stdin:
                p.stdin.close()
        self._procs, self._logs, self._res = [], [], []
        self._queues, self._readers = [], []

    def close(self, timeout: float = 30.0) -> None:
        """Stop every rank: ask, wait up to ``timeout``, then kill."""
        if not self._procs:
            return
        for p in self._procs:
            try:
                _send(p.stdin, None)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + timeout
        for p in self._procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._cleanup()

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _joined(rank):
    import torch.distributed as dist
    return dist.get_rank() == rank and dist.get_world_size()


def _rank_main(store: str, backend: str, device: str, threads: int) -> int:
    out = os.fdopen(int(os.environ["_MXT_WORLD_FD"]), "wb")
    inp = sys.stdin.buffer
    sys.stdout = sys.stderr
    import torch
    torch.set_num_threads(threads)
    from .mesh import init_world
    rank = int(os.environ["RANK"])
    init_world(backend, rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
               store_path=store, device=device)
    while True:
        try:
            (n,) = struct.unpack("<Q", inp.read(8))
        except struct.error:
            break
        task = pickle.loads(inp.read(n))
        if task is None:
            break
        fn, args = task
        try:
            res = (True, fn(rank, *args))
        except BaseException:
            res = (False, traceback.format_exc())
        _send(out, res)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], sys.argv[2], sys.argv[3],
                        int(sys.argv[4])))
