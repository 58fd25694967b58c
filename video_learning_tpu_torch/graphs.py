"""CUDA graphs: the port's counterpart of ``jax.jit`` at static shapes.

The JAX package compiles every device program once at static shapes and
then replays it, one dispatch per step.  Here a program is captured once
as a CUDA graph and replayed:

* ``Program`` captures a function of tensors that live outside the
  graph (static input buffers, parameters, optimizer state) into a graph
  on a side stream, in a memory pool that may be shared with other
  programs, with ``capture_error_mode="thread_local"``: another thread
  that copies to the card or synchronizes while a capture runs (the feed
  prefetcher, an HTTP handler) does not break it.  A capture that fails
  raises ``GraphCaptureError``, naming the call (file, line and code,
  outside torch) where the first error came from; nothing runs eagerly
  in its place.
* ``ProgramCache`` holds one ``Program`` per (caller's key, input
  shapes and dtypes) for a function of a dict of input tensors: the
  first ``warmups`` calls at a key run the function eagerly on the
  capture stream (real calls, whose results are returned), the last of
  them then captures it on static input buffers (one set per input
  signature, shared by its programs); later calls copy their inputs
  into those buffers and replay.  A lock makes one call at a time: the
  static buffers are shared.

Launch counts.  Each kernel wrapper (registered here with
``register_wrapper``) counts where it launches its kernel: one that runs
now adds one to ``fn.launches``; one that a capture on the current stream
records instead adds one to ``fn.captured``, since it runs only when the
graph is replayed.  A capture reads the ``captured`` counts to record
what one replay launches (``Program.launches``).  A replay runs no
Python and adds to no count: what replays run is counted from the
profiler's kernel records (``chip_smoke.py``).

What a caller must not do after a capture: rebind a tensor the program
reads or writes (parameters, moments, counts, the static buffers), since
the graph keeps reading the captured memory; change a value that was a
Python number at capture time; or replay one program while another
thread reads its outputs.

Imports only torch and the standard library.
"""

import logging
import os
import threading
import time
import traceback

import torch

_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_WRAPPERS = []
_LOGGER = "vlt"         # utils' logger (utils is not imported here)


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed.  torch may leave the card's default
    generator unusable after it (its next draw raises), so a process
    should stop rather than go on."""


def register_wrapper(fn):
    """Register a kernel wrapper that counts its kernel's launches in
    ``fn.launches`` and the launches a capture records in
    ``fn.captured``, so that a capture can tell what it recorded.
    Returns ``fn``."""
    fn.launches = 0
    fn.captured = 0
    _WRAPPERS.append(fn)
    return fn


def _captured_counts():
    return {fn: fn.captured for fn in _WRAPPERS}


def _first_cause(exc):
    """The earliest exception of a chain (the error that broke a capture,
    not the one that ending the broken capture raised after it)."""
    seen = set()
    while id(exc) not in seen:
        seen.add(id(exc))
        nxt = exc.__cause__ or exc.__context__
        if nxt is None:
            break
        exc = nxt
    return exc


def _call_site(exc):
    """'file:line in function: code' of the innermost frame of ``exc``'s
    traceback outside torch and this module (the op's caller), or
    None."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not os.path.abspath(f.filename).startswith(_TORCH + os.sep)
              and os.path.abspath(f.filename) != os.path.abspath(__file__)]
    if not frames:
        return None
    f = frames[-1]
    return "%s:%d in %s: %s" % (os.path.basename(f.filename), f.lineno,
                                f.name, (f.line or "").strip())


class Program:
    """One captured CUDA graph.

    ``name`` says what it is in errors and logs; ``pool`` is a memory
    pool handle (``torch.cuda.graph_pool_handle()``) to share, or None for
    a pool of its own; ``generators`` are CUDA ``torch.Generator``s the
    captured function draws from: each replay reads their seed and offset
    as they stand then (so a generator re-seeded before a replay gives the
    replay the draws an eager call would make after the same seeding) and
    advances their offset by what the graph draws.  ``stream`` is the
    side stream to capture on (a new one by default)."""

    def __init__(self, name, pool=None, generators=(), stream=None):
        self.name = name
        self.pool = pool
        self.generators = list(generators)
        self.stream = stream
        self.graph = None
        self.outputs = None
        self.launches = {}
        self.replays = 0
        self.capture_s = None
        self.pool_bytes = None

    def capture(self, fn, *args, **kwargs):
        """Capture ``fn(*args, **kwargs)``; returns its outputs, tensors
        the graph writes at every replay (not computed yet).  Records
        ``capture_s`` and ``pool_bytes``, what the allocator reserved
        during the capture (the pool's growth: all of it for a pool of its
        own)."""
        t0 = time.monotonic()
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _captured_counts()
        self.stream.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(*args, **kwargs)
        except Exception as exc:
            first = _first_cause(exc)
            where = _call_site(first) or _call_site(exc)
            raise GraphCaptureError(
                "CUDA graph capture of %s failed%s: %s: %s"
                % (self.name, " at " + where if where else "",
                   type(first).__name__, str(first).strip().split("\n")[0])
            ) from exc
        torch.cuda.current_stream().wait_stream(self.stream)
        after = _captured_counts()
        self.launches = {w: after[w] - n for w, n in before.items()
                         if after[w] != n}
        self.graph = graph
        self.outputs = outputs
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.monotonic() - t0
        return outputs

    def replay(self):
        """Launch the graph on the current stream."""
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def launch_counts(self):
        """{wrapper name: its kernels that one replay launches}, as the
        capture recorded them."""
        return {fn.__name__: n for fn, n in self.launches.items()}


def on_stream(stream, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run on ``stream`` after the work already
    queued on the current stream; the current stream then waits for it.
    The eager warmup of a capture runs this way, on the capture's own
    stream, so that the libraries' per-stream state (cuBLAS workspaces)
    exists before the capture."""
    current = torch.cuda.current_stream()
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn(*args, **kwargs)
    current.wait_stream(stream)
    return out


def signature(tensors):
    """The static shape of a dict of tensors: ((key, shape, dtype), ...)
    in key order."""
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(tensors.items()))


def storage_key(tree):
    """What a program that reads the tensors of ``tree`` (nested dicts and
    lists) bakes in: each tensor's address, shape and dtype, and every
    other leaf's value."""
    if isinstance(tree, dict):
        return tuple((k, storage_key(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return tuple(storage_key(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(), tuple(tree.shape), tree.dtype)
    return repr(tree)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(o) for o in out)
    return out


class ProgramCache:
    """``fn(inputs)`` over a dict of CUDA input tensors, one captured
    program per (``key``, input signature), all in one memory pool and on
    one capture stream.

    ``run(key, fn, inputs, warmups=1, keep=None)``: the first ``warmups``
    calls at a key run ``fn`` eagerly on the capture stream and return
    their results (real calls, not redone), and the last of them then
    captures ``fn`` on the static input buffers of the inputs' signature;
    later calls copy the inputs into those buffers and replay.  A replay
    returns copies of the outputs, or with ``clone=False`` (given to the
    cache) the captured outputs themselves, valid until the next replay.
    ``generators`` are CUDA generators that every program draws from
    (``Program``).  ``keep`` is held as long as the program (e.g. the
    parameter tree whose memory the graph reads, so that its addresses
    are not reused while the key names them).  ``fn`` must read nothing
    that changes between calls but the inputs and the tensors it updates
    in place."""

    def __init__(self, name, generators=(), clone=True):
        self.name = name
        self.generators = list(generators)
        self.clone = clone
        self._programs = {}
        self._warmups = {}
        self._static = {}
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._programs)

    def programs(self):
        """{(key, signature): (program, keep)}."""
        return dict(self._programs)

    def static_inputs(self, sig):
        """{name: buffer}: the static inputs that the programs of input
        signature ``sig`` read."""
        return self._static[sig]

    def run(self, key, fn, inputs, warmups=1, keep=None):
        sig = signature(inputs)
        full = (key, sig)
        current = torch.cuda.current_stream()
        with self._lock:
            entry = self._programs.get(full)
            if entry is None:
                return self._warmup(full, fn, inputs, warmups, keep)
            static = self._static[sig]
            for k, v in inputs.items():
                v.record_stream(current)
                static[k].copy_(v)
            out = entry[0].replay()
            return _clone(out) if self.clone else out

    def _warmup(self, full, fn, inputs, warmups, keep):
        """One eager call on the capture stream; the capture after the
        last of ``warmups``."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        for v in inputs.values():
            v.record_stream(self._stream)
        out = on_stream(self._stream, fn, dict(inputs))
        _record(out, torch.cuda.current_stream())
        self._warmups[full] = self._warmups.get(full, 0) + 1
        if self._warmups[full] < warmups:
            return out
        static = self._static.get(full[1])
        if static is None:
            static = self._static[full[1]] = {k: torch.empty_like(v)
                                              for k, v in inputs.items()}
        program = Program("%s %s at %s" % (self.name, full[0], full[1]),
                          pool=self._pool, generators=self.generators,
                          stream=self._stream)
        program.capture(fn, dict(static))
        logging.getLogger(_LOGGER).info(
            "Captured %s in %.2f s (pool +%.2f GB); a replay launches %s"
            % (program.name, program.capture_s, program.pool_bytes / 1e9,
               program.launch_counts()))
        self._programs[full] = (program, keep)
        return out


def _record(out, stream):
    if isinstance(out, torch.Tensor):
        out.record_stream(stream)
    elif isinstance(out, (list, tuple)):
        for o in out:
            _record(o, stream)
