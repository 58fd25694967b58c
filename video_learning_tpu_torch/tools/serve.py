"""HTTP serving over a ``ServingModule`` with request coalescing.

Counterpart of ``video_learning_tpu/tools/serve.py``:

  python -m video_learning_tpu_torch.tools.serve model.zip --port 8000 \
      [--device cuda] [--classes map.txt] [--window-ms 3] [--no-batch] \
      [--request-timeout-s 30]
  python -m video_learning_tpu_torch.tools.serve model.zip --selftest \
      [--selftest-items 1,8,32] [--selftest-duration-s 8] \
      [--selftest-concurrency 8]

The serving module runs static batches (its buckets, up to
``batch_items`` items; a call runs at the smallest bucket that holds it,
zero-padded).  Traffic is mostly single items, so a micro-batcher
coalesces concurrent requests that arrive within a short window into one
device call up to the largest bucket, then splits the output rows back
per request.  The server warms every bucket before it answers.  The HTTP
layer uses the standard library and numpy only.

Endpoints:

  GET  /healthz   -> 200 "ok" once the warm-up call has finished
  GET  /meta      -> the module's meta (+ server settings)
  GET  /metrics   -> Prometheus text: request counts by status, items
                     served, request latency sum, device calls by
                     bucket, coalesced batches
  POST /predict   -> run the forward
      JSON body: {"inputs": {name: nested-list, ...}} or
                 {"inputs": [nested-list, ...]} (positional), optional
                 "topk": N -> per-item {"class", "prob"} lists
                 (softmax over the logits; --classes names them).
                 A captioner's module answers its (items, T) word ids
                 and "captions", one string per item (never "topk").
      NPZ body (content-type application/x-npz or octet-stream): numpy
                 .npz keyed by input name (or arr_0, arr_1, ...);
                 respond JSON, or .npz with ?format=npz.

Each request carries 1..batch_items items: leading dims must be whole
multiples of the per-item row counts in ``meta['inputs']``.

``--selftest`` runs the loopback load test instead of serving: the
server in-process on an ephemeral port, closed-loop client threads
posting npz bodies of each request size, and one JSON line per size with
the sustained requests/s, items/s and p50 / p99 latency.

A mesh artifact (``export_serving --mesh``) is served by as many ranks
as its mesh holds, each of which loads it:

  python -m torch.distributed.run --nproc-per-node 4 \
      -m video_learning_tpu_torch.tools.serve mesh.zip \
      [--device cuda:0 --backend gloo] [--selftest ...]

The module on a mesh is a collective that every rank calls with the
whole batch.  Rank 0 binds the server and runs the batcher; every device
call it makes goes through ``MeshDispatch``, which broadcasts the call
to the other ranks first, and those ranks follow (``MeshDispatch.follow``)
until rank 0 broadcasts the stop at its shutdown (a SIGTERM drain
included).  A world of one joins nothing and serves as above.
"""

import argparse
import http.client
import io
import json
import queue
import signal
import threading
import time

import numpy as np

from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.tools.combine_logits import load_class_map
from video_learning_tpu_torch.utils import (FrameworkError,
                                            ensure_console_logging, error,
                                            info, warning)


class Stats:
    """Thread-safe serving counters, exposed at /metrics in Prometheus
    text exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = {}          # status code -> count
        self.items = 0              # items served (2xx only)
        self.request_seconds = 0.0  # summed request wall time
        self.device_calls = {}      # bucket (batch items) -> count
        self.coalesced = 0          # device calls serving >1 request

    def request(self, status, seconds, items=0):
        with self._lock:
            self.requests[status] = self.requests.get(status, 0) + 1
            self.request_seconds += seconds
            if 200 <= status < 300:
                self.items += items

    def device_call(self, bucket, requests_in_batch):
        with self._lock:
            self.device_calls[bucket] = \
                self.device_calls.get(bucket, 0) + 1
            if requests_in_batch > 1:
                self.coalesced += 1

    def render(self):
        with self._lock:
            lines = [
                "# TYPE vlx_requests_total counter",
                *("vlx_requests_total{status=\"%d\"} %d" % (s, c)
                  for s, c in sorted(self.requests.items())),
                "# TYPE vlx_items_total counter",
                "vlx_items_total %d" % self.items,
                "# TYPE vlx_request_seconds_total counter",
                "vlx_request_seconds_total %.6f" % self.request_seconds,
                "# TYPE vlx_device_calls_total counter",
                *("vlx_device_calls_total{bucket=\"%d\"} %d" % (b, c)
                  for b, c in sorted(self.device_calls.items())),
                "# TYPE vlx_coalesced_batches_total counter",
                "vlx_coalesced_batches_total %d" % self.coalesced,
            ]
        return ("\n".join(lines) + "\n").encode("utf-8")


class _Pending:
    __slots__ = ("arrays", "items", "event", "result", "err", "abandoned")

    def __init__(self, arrays, items):
        self.arrays = arrays
        self.items = items
        self.event = threading.Event()
        self.result = None
        self.err = None
        self.abandoned = False     # waiter gave up (request timeout)


_STOP = object()


class Batcher:
    """Coalesce concurrent requests into single device calls.

    All module calls happen on the one worker thread.  ``window_s``
    bounds how long the first request of a batch waits for company.
    ``close()`` stops the worker."""

    def __init__(self, module, window_s=0.003, coalesce=True, stats=None,
                 request_timeout_s=None):
        self.module = module
        self.stats = stats or Stats()
        self.window_s = float(window_s)
        self.request_timeout_s = (float(request_timeout_s)
                                  if request_timeout_s else None)
        self.capacity = int(module.meta["batch_items"])
        ins = module.meta["inputs"]
        self.per_item = []
        for spec in ins:
            rows = int(spec["shape"][0])
            if rows % self.capacity:
                coalesce = False
                break
            self.per_item.append(rows // self.capacity)
        out = module.warmup()
        self.out_shape = out.shape
        if out.shape[0] % self.capacity:
            coalesce = False
        self.out_per_item = (out.shape[0] // self.capacity
                             if not out.shape[0] % self.capacity else None)
        self.coalesce = bool(coalesce)
        self._q = queue.Queue()
        self._lock = threading.Lock()   # no-coalesce path
        self._thread = None
        if self.coalesce:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="vlt-batcher")
            self._thread.start()

    def close(self, timeout=30.0):
        if self._thread is not None:
            self._q.put(_STOP)
            self._thread.join(timeout)
            self._thread = None

    # ---- request side
    def items_of(self, arrays):
        """Validate leading dims; return the request's item count."""
        ins = self.module.meta["inputs"]
        if len(arrays) != len(ins):
            raise ValueError("expected %d inputs %s; got %d"
                             % (len(ins), [i["name"] for i in ins],
                                len(arrays)))
        if not self.coalesce:
            return None
        k = None
        for a, per, spec in zip(arrays, self.per_item, ins):
            if a.shape[1:] != tuple(spec["shape"][1:]):
                raise ValueError(
                    "input %s expects trailing shape %s; got %s"
                    % (spec["name"], tuple(spec["shape"][1:]), a.shape))
            if a.shape[0] % per:
                raise ValueError(
                    "input %s rows (%d) must be a multiple of the "
                    "per-item row count %d" % (spec["name"], a.shape[0], per))
            ak = a.shape[0] // per
            if k is None:
                k = ak
            elif ak != k:
                raise ValueError("inconsistent item count across inputs "
                                 "(%d vs %d)" % (ak, k))
        if not 1 <= k <= self.capacity:
            raise ValueError("request carries %d items; the module serves "
                             "1..%d per call" % (k, self.capacity))
        return k

    def run(self, arrays):
        """Run one request's arrays; returns its output rows."""
        k = self.items_of(arrays)
        if not self.coalesce:
            if not self._lock.acquire(
                    timeout=self.request_timeout_s or -1):
                raise TimeoutError(
                    "request timed out after %.1fs waiting for the "
                    "device" % self.request_timeout_s)
            try:
                out = self.module(*arrays)
                self.stats.device_call(
                    self.module.last_bucket or self.capacity, 1)
                return out
            finally:
                self._lock.release()
        p = _Pending(arrays, k)
        self._q.put(p)
        if not p.event.wait(timeout=self.request_timeout_s):
            p.abandoned = True
            raise TimeoutError(
                "request timed out after %.1fs waiting for the device"
                % self.request_timeout_s)
        if p.err is not None:
            raise p.err
        return p.result

    # ---- worker side
    def _worker(self):
        while True:
            first = self._q.get()
            if first is _STOP:
                return
            if first.abandoned:
                continue
            batch = [first]
            total = first.items
            t_end = time.monotonic() + self.window_s
            stop = False
            while total < self.capacity:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                if nxt.abandoned:
                    continue
                if total + nxt.items > self.capacity:
                    self._q.put(nxt)    # would overflow: next batch
                    break
                batch.append(nxt)
                total += nxt.items
            try:
                if len(batch) == 1:
                    batch[0].result = self.module(*batch[0].arrays)
                else:
                    joined = [np.concatenate([p.arrays[i] for p in batch])
                              for i in range(len(batch[0].arrays))]
                    out = self.module(*joined)
                    row = 0
                    for p in batch:
                        take = p.items * self.out_per_item
                        p.result = out[row:row + take]
                        row += take
                self.stats.device_call(
                    self.module.last_bucket or self.capacity, len(batch))
            except Exception as e:  # noqa: BLE001 - surfaced to waiters
                for p in batch:
                    p.err = e
            for p in batch:
                p.event.set()
            if stop:
                return


# the ops of the header rank 0 broadcasts before each device call on a mesh
_OP_STOP, _OP_CALL, _OP_IDLE = 0, 1, 2
_HEADER_INTS = 32
# seconds without a call after which rank 0 sends an idle op: well inside
# the group's timeout (torch's default, 30 minutes), which a follower's
# wait for the next call would otherwise reach on an idle server
KEEPALIVE_S = 60.0
# the artifact's input dtypes, by their code in the header
_DTYPES = ("uint8", "int32", "float32")


class MeshDispatch:
    """The device calls of a ``ServingModule`` on a mesh, where every rank
    calls the module with the whole batch (``serving.py``).

    On rank 0 the dispatch stands in for the module (its other attributes
    are the module's): each call, under one lock, broadcasts a header (the
    op, then each input's dtype and shape at request size) and the arrays
    over the world group, then calls the module, which pads to the
    bucket, runs its rows and gathers.  The other ranks run ``follow``:
    they take each header and its arrays, call the module with them and
    drop the output, until the stop op that ``stop`` sends.  After
    ``KEEPALIVE_S`` without a call rank 0 sends an idle op, so that no
    follower waits longer than the group's timeout.  A collective that
    fails breaks the dispatch: every later call raises at once, and no
    request is served on rank 0 alone."""

    def __init__(self, module):
        self.module = module
        self._lock = threading.Lock()
        self._failed = None
        self._stopped = threading.Event()
        self._last = time.monotonic()
        self._keepalive = None

    def __getattr__(self, name):
        return getattr(self.module, name)

    def _send(self, header, arrays=()):
        """Broadcast ``header`` and ``arrays`` (under the lock); a failure
        breaks the dispatch."""
        if self._failed is not None:
            raise RuntimeError("the mesh's ranks are out of step after a "
                               "failed collective: %s" % self._failed)
        try:
            mesh_mod.broadcast_ints(header, _HEADER_INTS)
            for a in arrays:
                mesh_mod.broadcast_array(a, a.shape, a.dtype)
        except Exception as e:
            self._failed = e
            raise
        self._last = time.monotonic()

    def __call__(self, *arrays):
        arrays = [np.ascontiguousarray(a) for a in arrays]
        header = [_OP_CALL, len(arrays)]
        for a in arrays:
            if a.dtype.name not in _DTYPES:
                raise ValueError("input dtype %s is none of %s"
                                 % (a.dtype, _DTYPES))
            header += [_DTYPES.index(a.dtype.name), a.ndim, *a.shape]
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("the mesh dispatch has stopped")
            self._send(header, arrays)
            try:
                return self.module(*arrays)
            except FrameworkError:
                raise           # refused on every rank, before a collective
            except Exception as e:
                self._failed = e
                raise

    def warmup(self):
        """The module's warm-up, each call dispatched to every rank; then
        the keepalive starts."""
        out = self.module.warmup(call=self)
        if self._keepalive is None:
            self._keepalive = threading.Thread(
                target=self._keep_alive, daemon=True, name="vlt-keepalive")
            self._keepalive.start()
        return out

    def _keep_alive(self):
        while not self._stopped.wait(KEEPALIVE_S / 4):
            with self._lock:
                if self._stopped.is_set() or self._failed is not None:
                    return
                if time.monotonic() - self._last >= KEEPALIVE_S:
                    try:
                        self._send([_OP_IDLE])
                    except Exception:   # noqa: BLE001 - the next call says
                        return

    def stop(self):
        """Rank 0: broadcast the stop op (once; not over a broken
        group)."""
        with self._lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            if self._failed is None:
                self._send([_OP_STOP])
        info("Mesh dispatch stopped; the other ranks return")

    def follow(self):
        """A rank other than 0: run every call rank 0 dispatches, until
        its stop op; returns the number of calls.  A SIGTERM
        (``torch.distributed.run`` forwards it to every rank) is left to
        rank 0's drain, whose stop ends this loop."""
        prev = None
        try:
            prev = signal.signal(signal.SIGTERM, lambda *a: info(
                "SIGTERM: waiting for rank 0's stop"))
        except ValueError:
            pass                        # not the main thread
        calls = 0
        try:
            while True:
                h = mesh_mod.broadcast_ints(None, _HEADER_INTS)
                if h[0] == _OP_STOP:
                    break
                if h[0] == _OP_IDLE:
                    continue
                arrays, i = [], 2
                for _ in range(h[1]):
                    dtype, ndim = _DTYPES[h[i]], h[i + 1]
                    shape = h[i + 2:i + 2 + ndim]
                    arrays.append(mesh_mod.broadcast_array(None, shape,
                                                           dtype))
                    i += 2 + ndim
                calls += 1
                try:
                    self.module(*arrays)
                except FrameworkError as e:
                    warning("Follower: the module refused a call, as rank "
                            "0's did: %s" % e)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
        info("Follower: rank 0 stopped after %d calls" % calls)
        return calls


def _on_mesh(module):
    """The module's mesh when it spans more than one rank, else None."""
    mesh = getattr(module, "mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


def _softmax(x):
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _parse_npz(body):
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return dict(z)


def make_handler(batcher, idx2name=None):
    from http.server import BaseHTTPRequestHandler

    module = batcher.module
    ins = module.meta["inputs"]
    server_meta = dict(module.meta)
    server_meta["server"] = {
        "coalesce": batcher.coalesce,
        "window_s": batcher.window_s,
        "capacity_items": batcher.capacity,
        "buckets": module.meta.get("buckets", [batcher.capacity]),
        "output_shape": list(map(int, batcher.out_shape)),
    }

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # idle keep-alive connections close after this, so a drain cannot
        # hang on a client that holds its connection open
        timeout = 5

        def log_message(self, fmt, *args):
            info("serve: %s" % (fmt % args))

        def _send(self, code, payload, ctype="application/json"):
            if isinstance(payload, (dict, list)):
                payload = json.dumps(payload).encode("utf-8")
            if self.command == "POST":
                # counted before the answer leaves, so that a client which
                # reads /metrics next finds its own request there
                batcher.stats.request(code, time.monotonic() - self._t0,
                                      self._predict_items)
                self._counted = True
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _fail(self, code, msg):
            self._send(code, {"error": str(msg)})

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif path == "/meta":
                self._send(200, server_meta)
            elif path == "/metrics":
                self._send(200, batcher.stats.render(),
                           "text/plain; version=0.0.4")
            else:
                self._fail(404, "unknown path %s" % path)

        def do_POST(self):
            self._t0 = time.monotonic()
            self._counted = False
            self._predict_items = 0
            try:
                self._predict()
            finally:
                if not self._counted:       # failed before answering
                    batcher.stats.request(500, time.monotonic() - self._t0)

        def _predict(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                return self._fail(404, "unknown path %s" % path)
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").lower()
                topk = 0
                if "json" in ctype:
                    doc = json.loads(body.decode("utf-8"))
                    given = doc.get("inputs")
                    topk = int(doc.get("topk", 0))
                    if isinstance(given, dict):
                        arrays = [np.asarray(given[s["name"]],
                                             dtype=s["dtype"]) for s in ins]
                    else:
                        arrays = [np.asarray(v, dtype=s["dtype"])
                                  for v, s in zip(given or [], ins)]
                        if len(arrays) != len(ins):
                            raise ValueError(
                                "JSON 'inputs' needs %d entries" % len(ins))
                else:
                    named = _parse_npz(body)
                    if all(s["name"] in named for s in ins):
                        arrays = [np.asarray(named[s["name"]],
                                             dtype=s["dtype"]) for s in ins]
                    else:
                        arrays = [np.asarray(named["arr_%d" % i],
                                             dtype=s["dtype"])
                                  for i, s in enumerate(ins)]
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                return self._fail(400, e)
            try:
                out = batcher.run(arrays)
            except ValueError as e:
                return self._fail(400, e)
            except TimeoutError as e:   # wedged device -> retryable 503
                return self._fail(503, e)
            except Exception as e:  # noqa: BLE001 - device faults -> 500
                return self._fail(500, e)
            if len(batcher.per_item) == len(ins):
                self._predict_items = \
                    arrays[0].shape[0] // batcher.per_item[0]
            if "format=npz" in query:
                buf = io.BytesIO()
                np.savez(buf, outputs=out)
                return self._send(200, buf.getvalue(), "application/x-npz")
            doc = {"outputs": np.asarray(out).tolist()}
            kind = module.meta["output"].get("kind", "logits")
            if kind == "token_ids":
                # a captioner: the rows as caption strings
                doc["captions"] = module.captions_from_ids(out)
            if topk and kind == "logits":
                probs = _softmax(out)
                k = min(topk, probs.shape[-1])
                order = np.argsort(-probs, axis=-1)[:, :k]
                doc["topk"] = [
                    [{"class": (idx2name.get(int(c), int(c))
                                if idx2name else int(c)),
                      "prob": float(p[c])}
                     for c in row]
                    for row, p in zip(order, probs)]
            return self._send(200, doc)

    return Handler


def serve(module, port=8000, host="127.0.0.1", classes=None, window_ms=3.0,
          coalesce=True, started=None, request_timeout_s=None,
          device="cuda"):
    """Blocking server loop over a ServingModule (or an artifact path,
    loaded onto ``device``).  ``started`` (optional threading.Event) is set
    once listening, with ``.addr``, ``.httpd`` and ``.batcher`` attached;
    ``started.httpd.shutdown()`` then stops the loop, and the batcher's
    worker is closed on the way out.  A module on a mesh of more than
    one rank is served by every rank: rank 0 serves through a
    ``MeshDispatch`` and broadcasts the stop when it leaves; the others
    follow and return None then.

    SIGTERM drains gracefully when serving from the main thread: the
    accept loop stops and in-flight requests finish."""
    if isinstance(module, str):
        from video_learning_tpu_torch.serving import load
        module = load(module, device=device)
    info("Serving module (inputs=%s, batch_items=%s, buckets=%s, "
         "quantize=%s, mesh=%s); warming up..."
         % ([i["name"] for i in module.meta["inputs"]],
            module.meta["batch_items"], module.meta.get("buckets"),
            module.meta.get("quantize"), module.meta.get("mesh")))
    mesh = _on_mesh(module)
    if mesh is None:
        return _serve(module, port, host, classes, window_ms, coalesce,
                      started, request_timeout_s)
    dispatch = MeshDispatch(module)
    if mesh.rank != 0:
        dispatch.follow()
        return None
    try:
        return _serve(dispatch, port, host, classes, window_ms, coalesce,
                      started, request_timeout_s)
    finally:
        dispatch.stop()


def _serve(module, port, host, classes, window_ms, coalesce, started,
           request_timeout_s):
    from http.server import ThreadingHTTPServer

    class _Server(ThreadingHTTPServer):
        daemon_threads = False      # wait for in-flight requests
        block_on_close = True

    idx2name = load_class_map(classes)[1] if classes else None
    batcher = Batcher(module, window_s=window_ms / 1000.0, coalesce=coalesce,
                      request_timeout_s=request_timeout_s)
    httpd = _Server((host, port), make_handler(batcher, idx2name))
    prev_term = None
    try:
        prev_term = signal.signal(
            signal.SIGTERM,
            lambda signum, frame: threading.Thread(
                target=httpd.shutdown, daemon=True).start())
    except ValueError:
        pass                        # not the main thread
    info("Serving on http://%s:%d (coalesce=%s, window=%.1fms, "
         "capacity=%d items)" % (httpd.server_address[0],
                                 httpd.server_address[1], batcher.coalesce,
                                 window_ms, batcher.capacity))
    if started is not None:
        started.addr = httpd.server_address
        started.httpd = httpd
        started.batcher = batcher
        started.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()    # blocks until in-flight requests finish
        batcher.close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        info("Server drained and closed.")
    return httpd


def selftest(module, item_counts=(1, 8, 32), duration_s=8.0, concurrency=8,
             window_ms=3.0, classes=None, device="cuda"):
    """Loopback load test: start the server in-process on an ephemeral
    port over ``module`` (a ServingModule or an artifact path, loaded onto
    ``device``), drive it with ``concurrency`` closed-loop client threads
    posting npz bodies of each request size for ``duration_s`` seconds,
    and report the sustained requests/s, items/s, p50 and p99 latency
    per size (one JSON line each, and the list of rows returned; the
    ranks of a mesh other than 0 follow and return []).  What
    it measures beyond a device call: request parsing, the coalescing
    window, response encoding and the sockets.  Item counts beyond the
    module's capacity are clamped (a request cannot exceed one batch)."""
    if isinstance(module, str):
        from video_learning_tpu_torch.serving import load
        module = load(module, device=device)
    mesh = _on_mesh(module)
    if mesh is not None and mesh.rank != 0:
        serve(module)           # follows rank 0's server until its stop
        return []
    capacity = int(module.meta["batch_items"])
    per = [int(s["shape"][0]) // capacity for s in module.meta["inputs"]]

    def body_for(n):
        rng = np.random.RandomState(n)
        arrays = {s["name"]: rng.randint(
            0, 200, (p * n,) + tuple(s["shape"][1:])).astype(s["dtype"])
            for p, s in zip(per, module.meta["inputs"])}
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    started = threading.Event()
    server_thread = threading.Thread(
        target=serve, args=(module,),
        kwargs=dict(port=0, classes=classes, window_ms=window_ms,
                    started=started), daemon=True)
    server_thread.start()
    if not started.wait(timeout=300):
        error("selftest server did not start")
    host, port = started.addr
    headers = {"Content-Type": "application/x-npz"}
    results = []
    try:
        for n in item_counts:
            n = min(int(n), capacity)
            body = body_for(n)
            lat, errs = [], [0]
            lock = threading.Lock()

            def client():
                conn = http.client.HTTPConnection(host, port, timeout=120)
                mine = []
                while time.monotonic() < stop_at:
                    t0 = time.monotonic()
                    try:
                        conn.request("POST", "/predict", body=body,
                                     headers=headers)
                        r = conn.getresponse()
                        r.read()
                        ok = r.status == 200
                    except (OSError, http.client.HTTPException):
                        ok = False
                        conn.close()
                        conn = http.client.HTTPConnection(host, port,
                                                          timeout=120)
                    if ok:
                        mine.append(time.monotonic() - t0)
                    else:
                        with lock:
                            errs[0] += 1
                conn.close()
                with lock:
                    lat.extend(mine)

            # one request first: the size's first call outside the window
            warm = http.client.HTTPConnection(host, port, timeout=300)
            try:
                warm.request("POST", "/predict", body=body, headers=headers)
                resp = warm.getresponse()
                resp.read()
            finally:
                warm.close()
            if resp.status != 200:
                error("selftest warm-up request answered %d" % resp.status)
            stop_at = time.monotonic() + duration_s
            threads = [threading.Thread(target=client)
                       for _ in range(concurrency)]
            t_start = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.monotonic() - t_start
            lat.sort()
            row = {
                "items_per_request": n,
                "concurrency": concurrency,
                "duration_s": elapsed,
                "requests": len(lat),
                "errors": errs[0],
                "rps": len(lat) / elapsed,
                "items_per_sec": len(lat) * n / elapsed,
                "p50_ms": 1e3 * lat[len(lat) // 2] if lat else None,
                "p99_ms": 1e3 * lat[int(len(lat) * 0.99)] if lat else None,
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        started.httpd.shutdown()
        server_thread.join(timeout=60)
    if server_thread.is_alive():
        error("selftest server did not stop")
    return results


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser(
        description="Serve a saved ServingModule artifact over HTTP with "
                    "request coalescing.")
    parser.add_argument("artifact", help="path to the artifact (.zip)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on "
                             "the CPU; cuda:0 puts every rank on card 0)")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="process-group backend of a mesh artifact's "
                             "ranks (default nccl on cuda, gloo on the "
                             "cpu; gloo lets ranks share a card)")
    parser.add_argument("--classes", help="'classname index' map file "
                                          "for named top-k responses")
    parser.add_argument("--request-timeout-s", type=float, default=None,
                        help="deadline for a queued request; a wedged "
                             "device answers 503 instead of hanging")
    parser.add_argument("--window-ms", type=float, default=3.0,
                        help="micro-batch coalescing window")
    parser.add_argument("--no-batch", action="store_true",
                        help="disable coalescing (serialize requests)")
    parser.add_argument("--selftest", action="store_true",
                        help="loopback load test instead of serving: "
                             "prints one JSON line per request size "
                             "with sustained RPS and p50/p99 latency")
    parser.add_argument("--selftest-items", default="1,8,32",
                        help="comma list of items per request")
    parser.add_argument("--selftest-duration-s", type=float, default=8.0)
    parser.add_argument("--selftest-concurrency", type=int, default=8)
    args = parser.parse_args(argv)
    device = mesh_mod.init_distributed(args.device, args.backend)
    if args.selftest:
        selftest(args.artifact,
                 item_counts=[int(x) for x in
                              args.selftest_items.split(",") if x],
                 duration_s=args.selftest_duration_s,
                 concurrency=args.selftest_concurrency,
                 window_ms=args.window_ms, classes=args.classes,
                 device=device)
        return
    serve(args.artifact, port=args.port, host=args.host,
          classes=args.classes, window_ms=args.window_ms,
          coalesce=not args.no_batch,
          request_timeout_s=args.request_timeout_s, device=device)


if __name__ == "__main__":
    main()
