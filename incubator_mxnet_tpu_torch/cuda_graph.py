"""CUDA graphs of the port's compiled steps.

The reference compiles its serving steps, its training step
(``parallel/dp.py`` ``make_train_step``) and a hybridized forward
(``gluon/block.py``) with ``jax.jit``. The port captures each as a CUDA
graph over static buffers, once a key, and replays it. Three rules hold
for every such step:

* the body is warmed on the capture stream before its capture, so what the
  wrappers make once a stream (``ops.cuda.common.ticket_buffer``) is that
  stream's and lies outside the graph's pool;
* a replay runs no kernel wrapper, so the launch counts the wrappers make
  while the body is captured (which launches nothing) go to the capture's
  own record (``ops.cuda.common.recording_launches``), and every replay
  adds that record to the shared counts
  (``ops.cuda.common.add_launch_counts``);
* a capture that fails raises, and frees what it held
  (:func:`capture`); no step falls back to its eager body.

A graph that draws random numbers registers the generators it draws from
(``CUDAGraph.register_generator_state``): each replay then advances them,
and a re-seed after the capture reaches the replays.

A body that syncs with the host (``.item()``, ``.tolist()``, a tensor made
from Python values with ``torch.tensor(..., device=cuda)``) runs in the
eager first call and fails in the capture: what the port captures builds
its constants on the device (``torch.full``, ``fill_``).
"""
from __future__ import annotations

import threading

import torch

from .ops.cuda import common as _kcommon

__all__ = ["CapturedStep", "capture", "capture_stream", "first_call",
           "run_on"]

_STREAMS = {}
_CAPTURE_LOCK = threading.Lock()


class CapturedStep:
    """``body()`` returns the step's outputs. Once captured
    (:meth:`capture`), a call replays the CUDA graph and returns the static
    outputs; before, or never captured (the CPU, an eager yardstick), a
    call runs the body."""

    def __init__(self, body):
        self.body = body
        self.graph, self.out, self.counts = None, None, {}

    def capture(self, graph, capturing, generators=()) -> None:
        """Run the body inside ``capturing`` (``torch.cuda.graph`` on
        ``graph``) and keep the graph and its output; ``generators`` are
        registered with the graph first."""
        for g in generators:
            graph.register_generator_state(g)
        with _kcommon.recording_launches(
                getattr(capturing, "capture_stream", None)) as counts:
            with capturing:
                self.out = self.body()
        self.counts = counts
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            return self.body()
        self.graph.replay()
        _kcommon.add_launch_counts(self.counts)
        return self.out


def capture(step: CapturedStep, stream, pool=None, generators=()) -> None:
    """Capture ``step`` as a CUDA graph on ``stream`` (a private memory
    pool unless ``pool`` is given); raises if the capture fails.

    A failed capture leaves its pool registered with the caching
    allocator as a capture under way, which keeps ``empty_cache()`` from
    freeing any segment for the rest of the process, and the graph's
    destructor drops no reference to it: so on failure the pool's
    allocation is ended and its reference released here, and the
    allocator frees its memory at the next ``empty_cache()``."""
    graph = torch.cuda.CUDAGraph()
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
    with _CAPTURE_LOCK:     # one capture under way at a time
        try:
            step.capture(graph, torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"), generators)
        except BaseException:
            _abandon_pool(stream.device, pool)
            raise


def _abandon_pool(device, pool) -> None:
    """End a failed capture's allocation to ``pool`` (if the capture's
    end did not) and drop the capture's reference to it."""
    index = torch.device(device).index
    for release in (torch._C._cuda_endAllocateToPool,
                    torch._C._cuda_releasePool):
        try:
            release(index, pool)
        except RuntimeError:
            pass            # the capture ended (or never began) it


def capture_stream(device):
    """The one stream the port's steps on ``device`` are warmed and
    captured on. cuBLAS keeps a workspace for each (thread, stream) pair it
    runs on for the life of the process, and one carved from a cached
    segment pins the whole segment: so the workspaces of the capture
    stream (the calling thread's and the autograd engine's) are made once,
    here, from an emptied cache. The first use on a device therefore
    empties the caching allocator's cache (``torch.cuda.empty_cache``) and
    runs a 16 x 16 matmul and its backward in float32 and bf16 on the new
    stream."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _STREAMS.get(index)
    if stream is None:
        stream = torch.cuda.Stream(index)
        torch.cuda.empty_cache()
        with torch.cuda.stream(stream), torch.enable_grad():
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones((16, 16), dtype=dtype, device=device,
                               requires_grad=True)
                torch.autograd.grad((a @ a).sum(), a)
        stream.synchronize()
        _STREAMS[index] = stream
    return stream


def first_call(step: CapturedStep, device, generators=(), what="step",
               pool=None):
    """The first call of a key on the card: ``step``'s body eagerly on the
    capture stream (a real call, whose output is returned), then its
    capture, which executes nothing, into ``pool`` (a private one unless
    given). A capture that fails raises, naming ``what``; the caller keeps
    no entry for it."""
    stream = capture_stream(device)
    out = run_on(stream, step)
    try:
        capture(step, stream, pool, generators)
    except Exception as err:
        raise RuntimeError(
            f"{what}: the CUDA graph capture failed ({err}); a body that "
            "syncs with the host cannot be captured (cuda_graph)") from err
    torch.cuda.synchronize(device)
    return out


def run_on(stream, fn):
    """``fn()`` on ``stream``, ordered after the current stream's work and
    before its later work."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out
