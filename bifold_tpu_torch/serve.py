"""Deployment serving daemon: ``python -m bifold_tpu_torch.serve``.

Counterpart of bifold_tpu/serve.py: load a JAX trainer checkpoint (read
without JAX) or one of the port's serving artifacts once, warm up, then
answer observations over HTTP for a robot control loop.

    python -m bifold_tpu_torch.serve --run-dir outputs/vr_folding/default
    python -m bifold_tpu_torch.serve --checkpoint best.ckpt --config config.yaml \\
        --quantize int8 --max-batch 8
    python -m bifold_tpu_torch.serve --artifact exported/serve.pt --port 8787

Protocol (stdlib + numpy, no web framework), the JAX daemon's:

- ``GET /healthz``: JSON liveness with the fields, threshold and quantize.
- ``GET /metrics``: request, observation and error counters, latency
  percentiles over a sliding window, and the batcher's counters.
- ``POST /predict``: the body is one ``.npz``: ``rgb`` uint8 (H, W, 3),
  ``depth`` (H, W), ``mask`` (H, W), ``instruction`` (a string array),
  optionally context frames ``ctx_rgb`` (T, H, W, 3) / ``ctx_depth`` /
  ``ctx_mask`` and ``ctx_count``. A leading batch dim on every array (one
  instruction per row) serves a pool. The response is an ``.npz`` with one
  (B, 2) float32 array per action field; ``?raw=1`` adds the raw model
  outputs as ``raw_<name>``; ``?pad=N`` pads the pool to N rows. A body
  that does not parse is a 400, a failed prediction a 500.

Device work is serialized under one lock, as the JAX daemon's is. With
``--max-batch`` > 1, concurrent single observations of one layout coalesce
into one padded ``predict_batch``.

``--mesh dp=2,tp=2`` (parsed as JAX's daemon parses it) serves a model
sharded over a ``torch.distributed`` group, one process per device, every
process started by a launcher::

    python -m torch.distributed.run --nproc_per_node 2 -m bifold_tpu_torch.serve \
        --run-dir outputs/vr_folding/default --mesh tp=2

Every rank builds the same ``ServingModel(mesh=)``. Rank 0 runs the HTTP
server (``/healthz``, ``/metrics``, the dynamic batcher) and, before each
call to the model (a request, a batcher's pool, a warm-up), broadcasts the
call with its decoded observations to the other ranks, which make the same
call (:class:`MeshLeader`, :func:`follow`); rank 0 answers. An idle leader
broadcasts a no-op now and then, so that the other ranks' wait never
reaches the group's timeout. SIGINT or SIGTERM stops rank 0, which sends a
stop message; every rank then leaves the group and exits 0 (the other
ranks ignore those signals: the stop message ends them). JAX's daemon is
one process over its local devices; the HTTP contract is the same. The
group's backend is NCCL for CUDA and gloo for the CPU; a caller that has
joined a group of its own before ``main`` keeps it. An artifact keeps its
refusal of a mesh, and int8 under fsdp keeps its own.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["build_server", "make_httpd", "RemotePolicy", "MeshLeader", "follow",
           "parse_mesh", "main"]


def build_server(run_dir=None, checkpoint=None, config=None, artifact=None,
                 which: str = "best", depth_wire: str = "float16",
                 quantize=None, threshold=None, mesh=None, device="cuda"):
    """A ServingModel or ExportedServingModel from the CLI's inputs, on
    ``device``. ``run_dir``: a training output dir, its ``config.yaml`` and
    ``checkpoints/{which}.ckpt`` (best falls back to last). ``checkpoint``
    and ``config`` (a YAML path or a dict) name them explicitly.
    ``artifact``: a serving artifact of the port. ``mesh`` (a ``mesh``
    config node or a ``parallel.Mesh``): shard the server over the default
    ``torch.distributed`` group, every rank building it and calling it
    alike (``ServingModel(mesh=)``); an artifact has no sharded form."""
    from bifold_tpu_torch.serving import ServingModel

    if artifact is not None:
        if mesh is not None:
            raise NotImplementedError("a serving artifact is served on one device; "
                                      "serve a checkpoint under a mesh")
        return ServingModel.load_exported(artifact, device=device)
    if run_dir is not None:
        run_dir = Path(run_dir)
        config = config or run_dir / "config.yaml"
        ckpts = run_dir / "checkpoints"
        checkpoint = checkpoint or (
            ckpts / f"{which}.ckpt" if (ckpts / f"{which}.ckpt").exists()
            else ckpts / "last.ckpt")
    if checkpoint is None or config is None:
        raise ValueError("need --artifact, --run-dir, or both --checkpoint "
                         "and --config")
    if not isinstance(config, dict):
        from bifold_tpu_torch.config import load_yaml
        config = load_yaml(config)
    return ServingModel.from_checkpoint(
        str(checkpoint), config, threshold=threshold,
        depth_wire_dtype=depth_wire, quantize=quantize, mesh=mesh, device=device)


def _parse_observations(body: bytes):
    """One npz payload -> list of predict() kwarg dicts (one for an
    unbatched observation)."""
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if "instruction" not in arrays \
            or ("rgb" not in arrays and "depth" not in arrays):
        raise ValueError("payload must contain instruction and at least one "
                         "of rgb / depth")
    instr = np.atleast_1d(arrays["instruction"].astype(str))
    # rgb is (H, W, 3) per observation and (B, H, W, 3) batched; depth is
    # (H, W) / (B, H, W)
    if "rgb" in arrays:
        batched = arrays["rgb"].ndim == 4
        n = arrays["rgb"].shape[0] if batched else 1
    else:
        batched = arrays["depth"].ndim == 3
        n = arrays["depth"].shape[0] if batched else 1
    if len(instr) != n:
        raise ValueError(f"{n} observation row(s) but {len(instr)} "
                         "instruction(s)")

    def row(name, i):
        a = arrays.get(name)
        if a is None:
            return None
        return a[i] if batched else a

    obs = []
    for i in range(n):
        context = None
        ctx_rgb = row("ctx_rgb", i)
        if ctx_rgb is not None:
            ctx_depth, ctx_mask = row("ctx_depth", i), row("ctx_mask", i)
            context = [dict(rgb=ctx_rgb[t],
                            depth=None if ctx_depth is None else ctx_depth[t],
                            mask=None if ctx_mask is None else ctx_mask[t])
                       for t in range(ctx_rgb.shape[0])]
            cc = row("ctx_count", i)
            if cc is not None:
                # ragged pools: the real frame count of each observation
                # rides the wire; the tail frames are client-side padding
                context = context[:int(cc)]
        obs.append(dict(rgb=row("rgb", i), depth=row("depth", i),
                        mask=row("mask", i), instruction=str(instr[i]),
                        context=context))
    return obs


def _npz_bytes(tree: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **tree)
    return buf.getvalue()


class _DynamicBatcher:
    """Coalesce concurrent single-observation requests into one padded
    ``predict_batch``: the first request opens a window of ``window_ms``,
    and up to ``max_batch`` requests of its layout that arrive inside it
    share one upload and one forward at the pool shape (pad_to=max_batch)."""

    def __init__(self, server, lock, max_batch: int = 8,
                 window_ms: float = 2.0):
        self.server, self.lock = server, lock
        self.max_batch = int(max_batch)
        self.window = float(window_ms) / 1e3
        self._cv = threading.Condition()
        self._queue: List[dict] = []
        self._stop = False
        self.requests = 0   # single requests accepted
        self.batches = 0    # device dispatches issued
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @staticmethod
    def _compat_key(obs: dict):
        """Only observations with identical array layouts share a padded
        dispatch, the context frames' layouts included: one client's other
        camera resolution, missing modality or context resolution must never
        fail another client's request."""
        def arrays(d):
            return tuple(sorted(
                (k, np.asarray(v).shape, str(np.asarray(v).dtype))
                for k, v in d.items() if isinstance(v, np.ndarray)))

        ctx = tuple(arrays(f) for f in (obs.get("context") or []))
        return arrays(obs) + (("ctx",) + ctx,)

    def submit(self, obs: dict, want_raw: bool):
        pend = {"obs": obs, "raw": want_raw, "key": self._compat_key(obs),
                "event": threading.Event(), "result": None, "error": None}
        with self._cv:
            if self._stop:
                # the worker is gone: a queued request would wait forever
                raise RuntimeError("batcher is shut down")
            self._queue.append(pend)
            self.requests += 1
            self._cv.notify()
        pend["event"].wait()
        if pend["error"] is not None:
            raise pend["error"]
        return pend["result"]

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5)

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
            time.sleep(self.window)  # let concurrent requests pile in
            with self._cv:
                if not self._queue:
                    continue
                # up to max_batch requests of the FIRST request's layout;
                # the others stay queued for the next window
                key = self._queue[0]["key"]
                group = [p for p in self._queue
                         if p["key"] == key][:self.max_batch]
                taken = set(map(id, group))
                self._queue = [p for p in self._queue if id(p) not in taken]
            want_raw = any(p["raw"] for p in group)
            try:
                with self.lock:
                    result = self.server.predict_batch(
                        [p["obs"] for p in group], pad_to=self.max_batch,
                        return_raw_output=want_raw)
                self.batches += 1
                action, raw = result if want_raw else (result, None)
                for i, p in enumerate(group):
                    row_raw = None
                    if p["raw"]:
                        row_raw = {k: np.asarray(v)[i:i + 1]
                                   for k, v in raw.items()}
                    p["result"] = (action, i, row_raw)
                    p["event"].set()
            except Exception as e:  # the group's requests each get a 500
                for p in group:
                    p["error"] = e
                    p["event"].set()


def make_httpd(server, host: str = "127.0.0.1", port: int = 0,
               max_batch: Optional[int] = None, batch_window_ms: float = 2.0):
    """A ThreadingHTTPServer over a serving model (port 0: an ephemeral
    port, ``httpd.server_address[1]``). ``max_batch`` > 1 turns on dynamic
    batching (``httpd.batcher`` has its counters); above an artifact's
    pinned batch it raises here, not as a 500 on every request."""
    from bifold_tpu_torch.serving import ExportedServingModel

    lock = threading.Lock()
    exported = isinstance(server, ExportedServingModel)
    fields = tuple(server.fields if exported else server._action_fields())
    if (exported and max_batch and int(max_batch) > 1
            and int(max_batch) > server.batch):
        raise ValueError(
            f"--max-batch {max_batch} exceeds the artifact's pinned batch "
            f"{server.batch}; re-export with batch={max_batch} or lower "
            "--max-batch")
    batcher = (_DynamicBatcher(server, lock, max_batch, batch_window_ms)
               if max_batch and int(max_batch) > 1 else None)
    metrics_lock = threading.Lock()
    metrics = {"requests": 0, "observations": 0, "errors_400": 0,
               "errors_500": 0}
    latencies_ms: List[float] = []

    def record(n_obs: int, t0: float, status: int):
        with metrics_lock:
            metrics["requests"] += 1
            metrics["observations"] += n_obs
            if status == 400:
                metrics["errors_400"] += 1
            elif status == 500:
                metrics["errors_500"] += 1
            else:
                latencies_ms.append((time.perf_counter() - t0) * 1e3)
                del latencies_ms[:-512]   # sliding window

    info = {"status": "ok", "fields": list(fields),
            "max_batch": int(max_batch) if batcher else None,
            "threshold": float(server.threshold), "quantize": server.quantize,
            "exported": exported}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/x-npz"):
            """Sent after the metrics were recorded: a client that hung up
            must not count its served request as a fault."""
            try:
                self._send(code, body, ctype)
            except OSError:
                pass  # the client went away; the prediction succeeded

        def do_GET(self):
            route = self.path.split("?")[0]
            if route == "/healthz":
                self._send_json(200, info)
            elif route == "/metrics":
                with metrics_lock:
                    snap = dict(metrics)
                    lat = sorted(latencies_ms)
                if lat:
                    snap["latency_p50_ms"] = lat[len(lat) // 2]
                    snap["latency_p95_ms"] = lat[min(len(lat) - 1,
                                                     int(len(lat) * 0.95))]
                if batcher is not None:
                    snap["batcher_requests"] = batcher.requests
                    snap["batcher_dispatches"] = batcher.batches
                self._send_json(200, snap)
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                self._send_json(404, {"error": f"no route {path}"})
                return
            want_raw = "raw=1" in query.split("&")
            t0 = time.perf_counter()
            try:
                pad_to = None
                for part in query.split("&"):
                    if part.startswith("pad="):
                        pad_to = int(part[4:])   # a malformed pad is a 400
                length = int(self.headers.get("Content-Length", "0"))
                obs = _parse_observations(self.rfile.read(length))
            except Exception as e:  # the client's fault
                record(0, t0, 400)
                self._reply(400, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")
                return
            try:
                # a client that manages its own pool shape (?pad=) bypasses
                # the batcher
                if batcher is not None and len(obs) == 1 and pad_to is None:
                    action, i, row_raw = batcher.submit(obs[0], want_raw)
                    out = {f: np.asarray(getattr(action, f), np.float32)[i:i + 1]
                           for f in fields}
                    if want_raw:
                        out.update({f"raw_{k}": v for k, v in row_raw.items()})
                else:
                    with lock:
                        result = server.predict_batch(
                            obs, pad_to=pad_to, return_raw_output=want_raw)
                    action, raw = result if want_raw else (result, None)
                    out = {f: np.asarray(getattr(action, f), np.float32)
                           for f in fields}
                    if want_raw:
                        out.update({f"raw_{k}": np.asarray(v)
                                    for k, v in raw.items()})
                body = _npz_bytes(out)
                record(len(obs), t0, 200)
                self._reply(200, body)
            except Exception as e:  # a prediction fault: the server's
                record(len(obs), t0, 500)
                self._reply(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.batcher = batcher
    _close = httpd.server_close

    def server_close():
        if batcher is not None:
            batcher.close()
        _close()

    httpd.server_close = server_close
    return httpd


class RemotePolicy:
    """Closed-loop policy callable backed by a remote serving daemon: the
    sim or robot host packs raw observations into one npz POST and gets
    pixel actions back. Drop-in for the evaluators' policy interface
    (``wants_raw``, a single dict or a lockstep pool, ``pad_to`` forwarded);
    returns ``(Action, None)`` like ``ServingPolicy``."""

    wants_raw = True

    def __init__(self, url: str, timeout: float = 600.0):
        from urllib.parse import urlparse
        u = urlparse(url if "//" in url else f"http://{url}")
        self.host, self.port = u.hostname, u.port or 80
        self.timeout = timeout
        # one keep-alive connection, serialized; it re-opens once on a
        # socket error, so a daemon restart mid-rollout is a retry
        self._conn = None
        self._lock = threading.Lock()
        status, data = self._request("GET", "/healthz")
        if status != 200:
            raise ConnectionError(f"serving daemon unhealthy: {status}")
        self.info = json.loads(data)
        self.fields = tuple(self.info["fields"])

    def _request(self, method: str, path: str, body=None):
        import http.client
        with self._lock:
            for attempt in (0, 1):
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout)
                try:
                    self._conn.request(method, path, body=body)
                    r = self._conn.getresponse()
                    return r.status, r.read()
                except (OSError, http.client.HTTPException):
                    try:
                        self._conn.close()
                    finally:
                        self._conn = None
                    if attempt:
                        raise

    @staticmethod
    def _pack(observations: List[dict]) -> bytes:
        arrays: Dict[str, np.ndarray] = {}
        for name in ("rgb", "depth", "mask"):
            vals = [o.get(name) for o in observations]
            if vals[0] is not None:
                arrays[name] = np.stack([np.asarray(v) for v in vals])
        # ragged context pools: pad every observation to the longest
        # context and send the real frame counts (ctx_count)
        ctxs = [list(o.get("context") or []) for o in observations]
        t_max = max(len(c) for c in ctxs)
        if t_max:
            template = next(f for c in ctxs for f in c)
            for name in ("rgb", "depth", "mask"):
                if template.get(name) is None:
                    continue
                pad = np.ones_like(np.asarray(template[name]))
                arrays[f"ctx_{name}"] = np.stack(
                    [np.stack([np.asarray(f[name])
                               if f.get(name) is not None else pad
                               for f in c]
                              + [pad] * (t_max - len(c))) for c in ctxs])
            arrays["ctx_count"] = np.asarray([len(c) for c in ctxs], np.int32)
        arrays["instruction"] = np.asarray(
            [str(o.get("instruction", "")) for o in observations])
        return _npz_bytes(arrays)

    def __call__(self, obs, pad_to: Optional[int] = None):
        from bifold_tpu_torch.env.action import Action
        observations = list(obs) if isinstance(obs, (list, tuple)) else [obs]
        path = "/predict" + (f"?pad={int(pad_to)}" if pad_to else "")
        status, data = self._request("POST", path, body=self._pack(observations))
        if status != 200:
            raise RuntimeError(f"remote predict failed ({status}): "
                               f"{data[:300]!r}")
        out = dict(np.load(io.BytesIO(data)))
        return Action(**{f: out[f] for f in self.fields}), None


def parse_mesh(text: str) -> Dict[str, int]:
    """``"dp=2,tp=4"`` -> ``{"dp": 2, "tp": 4}``; ValueError otherwise."""
    return {k.strip(): int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def _broadcast(message):
    """``message`` (rank 0's) on every rank of the default group."""
    from bifold_tpu_torch.parallel.collectives import broadcast_object

    return broadcast_object(message, src=0)


# an idle leader broadcasts a no-op this often (seconds), well inside the
# group's timeout that the other ranks' wait for the next call runs under
HEARTBEAT_S = 60.0


class MeshLeader:
    """Rank 0's handle on a server sharded over the default group: each
    call to the model is broadcast to the other ranks (which run
    :func:`follow`) before rank 0 makes it; anything else reads through to
    the server. An idle leader broadcasts a no-op every
    :data:`HEARTBEAT_S`."""

    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._closed = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, daemon=True)
        self._beat.start()

    def __getattr__(self, name):
        return getattr(self.server, name)

    def _call(self, method: str, *args, **kwargs):
        with self._lock:
            _broadcast((method, args, kwargs))
            self._last = time.monotonic()
            return getattr(self.server, method)(*args, **kwargs)

    def predict_batch(self, *args, **kwargs):
        return self._call("predict_batch", *args, **kwargs)

    def warmup(self, *args, **kwargs):
        return self._call("warmup", *args, **kwargs)

    def _heartbeat(self):
        while not self._closed.wait(HEARTBEAT_S / 4):
            with self._lock:
                if self._closed.is_set():
                    return
                if time.monotonic() - self._last >= HEARTBEAT_S:
                    _broadcast(("ping", (), {}))
                    self._last = time.monotonic()

    def stop(self) -> None:
        """Tell the other ranks to leave (once)."""
        with self._lock:
            if not self._closed.is_set():
                self._closed.set()
                _broadcast(("stop", (), {}))


def follow(server) -> int:
    """A rank other than 0: make every call rank 0 broadcasts, until the
    stop message. A call that raises here raises on rank 0 too (the same
    inputs), which answers it with an error; this rank waits for the next."""
    calls = 0
    while True:
        method, args, kwargs = _broadcast(None)
        if method == "stop":
            return calls
        if method == "ping":
            continue
        calls += 1
        try:
            getattr(server, method)(*args, **kwargs)
        except Exception as e:  # rank 0 reports it to its client
            print(f"[serve] rank {_rank()}: {method} failed: {type(e).__name__}: {e}",
                  flush=True)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bifold_tpu_torch.serve",
        description="HTTP serving daemon over bifold_tpu_torch.serving")
    p.add_argument("--run-dir", help="training output dir "
                   "(config.yaml + checkpoints/)")
    p.add_argument("--checkpoint", help="explicit .ckpt path (a checkpoint "
                   "of the JAX trainer)")
    p.add_argument("--config", help="explicit config.yaml path")
    p.add_argument("--artifact", help="a serving artifact of the port "
                   "(ServingModel.export)")
    p.add_argument("--which", default="best", choices=("best", "last"))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--depth-wire", default="float16",
                   choices=("float32", "float16"))
    p.add_argument("--quantize", default=None, choices=(None, "int8"))
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu only "
                        "when asked)")
    p.add_argument("--mesh", default=None, metavar="dp=2,tp=4",
                   help="shard serving over the ranks of a launcher's group "
                        "(one process per device): comma-separated mesh axes; "
                        "rank 0 serves HTTP and broadcasts each call. "
                        "Incompatible with --artifact")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--warmup", type=int, default=None, metavar="SIZE",
                   help="one request at SIZE x SIZE before listening")
    p.add_argument("--max-batch", type=int, default=None,
                   help=">1: dynamic batching; concurrent single requests "
                        "coalesce into one padded forward")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="how long the first queued request waits for "
                        "company before dispatching")
    a = p.parse_args(argv)

    mesh = None
    if a.mesh:
        try:
            mesh = parse_mesh(a.mesh)
        except ValueError:
            p.error(f"--mesh wants comma-separated axis=size pairs, got {a.mesh!r}")
        if a.artifact is not None:
            p.error("--artifact is served on one device; --mesh requires "
                    "--run-dir or --checkpoint")
        return _serve_mesh(a, mesh)
    server = build_server(run_dir=a.run_dir, checkpoint=a.checkpoint,
                          config=a.config, artifact=a.artifact, which=a.which,
                          depth_wire=a.depth_wire, quantize=a.quantize,
                          threshold=a.threshold, device=a.device)
    return _serve_http(a, server)


def _serve_mesh(a, mesh) -> int:
    """``main`` under ``--mesh``: join the launcher's group, build the
    sharded server on every rank, serve on rank 0, follow elsewhere."""
    import signal

    import torch.distributed as dist

    from bifold_tpu_torch import parallel

    device = None if a.device == "cuda" else a.device
    if not parallel.distributed_init(device=device):
        raise ValueError(
            "--mesh serves over a launcher's group, one process per device: "
            "python -m torch.distributed.run --nproc_per_node N -m "
            "bifold_tpu_torch.serve ... --mesh ...; no launcher environment "
            "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) here")
    if dist.get_rank() != 0:
        # the stop message ends a follower, not a launcher's signal
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    server = build_server(run_dir=a.run_dir, checkpoint=a.checkpoint,
                          config=a.config, which=a.which, depth_wire=a.depth_wire,
                          quantize=a.quantize, threshold=a.threshold, mesh=mesh,
                          device=a.device)
    try:
        if dist.get_rank() != 0:
            calls = follow(server)
            print(f"[serve] rank {dist.get_rank()}: stopped after {calls} calls",
                  flush=True)
            return 0
        leader = MeshLeader(server)

        def _term(signum, frame):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _term)
        try:
            return _serve_http(a, leader)
        finally:
            leader.stop()
    finally:
        dist.destroy_process_group()


def _serve_http(a, server) -> int:
    """Warm up, then answer HTTP until interrupted."""
    if a.warmup:
        # the batcher dispatches at pad_to=max_batch: warm that pool too
        pools = [None] + ([a.max_batch] if a.max_batch
                          and a.max_batch > 1 else [])
        for pool in pools:
            print(f"[serve] warming up at {a.warmup}x{a.warmup}"
                  f"{f' pool={pool}' if pool else ''} ...", flush=True)
            server.warmup(a.warmup, pool=pool)
    httpd = make_httpd(server, a.host, a.port, max_batch=a.max_batch,
                       batch_window_ms=a.batch_window_ms)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} "
          "(POST /predict, GET /healthz, GET /metrics)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
