"""Generation server of the port: ``python -m mixermdm_tpu_torch serve``.

Counterpart of ``mixermdm_tpu/cli/serve.py``.  The full MixerMDM system is
built once on the card (the kernels built, the int8 weight caches filled by
a warm-up dispatch at start-up), and every request runs the sampling chain
at a fixed (batch, window) shape.

HTTP API (stdlib ``http.server``, HTTP/1.1 keep-alive).  One batcher thread
drives the card and batches continuously: requests that queue while the card
is busy (or within ``--linger-ms`` of each other) coalesce into one dispatch
of up to ``--batch-size`` rows.  Requests with a seed run alone and are
bit-reproducible; requests without one coalesce.  ``--max-queue-rows``
bounds the queue (429 with ``Retry-After`` beyond it) and ``--deadline-s``
sheds requests that waited too long.

    GET  /healthz   -> {"status": "ok", "warm": true, ...}
    POST /generate  -> body {"text_interaction": str,
                             "text_individual1": str,
                             "text_individual2": str,
                             "num_samples": int (<= --batch-size),
                             "seed": int (optional),
                             "format": "npy_base64" | "json"}
                    <- {"shape": [n, T, 524], "dtype": "float32",
                        "motion_npy_b64": ...} (or "motion": nested lists)

    Instead of the three text fields a request may carry ``"prompts":
    [{"text_interaction": ..., "text_individual1": ...,
    "text_individual2": ...}, ...]`` (up to --batch-size entries): row i of
    the response is prompt i's sample.

A dispatch is padded to the served batch with its last prompt, and the pad
rows are dropped from the response.  It samples under
``torch.inference_mode()`` in the batcher thread with
``torch.Generator(device).manual_seed(seed)``; an unseeded dispatch's seed
is the running dispatch count.  A failed dispatch answers 500 to every
request in it; nothing is retried on the CPU or on the plain versions.

Weights come from the released checkpoint files (``--checkpoint``,
``--ckpt-individual``, ``--ckpt-interaction``, as in ``infer-mixermdm``).
Usage on the card::

    python -m mixermdm_tpu_torch serve --checkpoint MixerMDM.ckpt \\
        --ckpt-individual individual.ckpt --ckpt-interaction interaction.ckpt \\
        [--batch-size 10] [--window 299] [--sampler dpmpp --sample-steps 25]

:func:`make_server` builds the server without starting it, for callers that
run it in-process (``--port 0`` takes a free port).

Data parallelism (the JAX server's, over its devices): on several ranks
(one per visible card, or the world ``torchrun`` describes) rank 0 runs the
HTTP server and the batcher, the served batch is rounded up to a multiple
of the rank count, and each dispatch broadcasts its prompts and seed to
every rank; each samples its rows (the noise of the whole batch drawn from
the seed, as one rank draws it) and the rows are gathered.  While idle,
rank 0 sends a keep-alive every :data:`KEEPALIVE_S` seconds (a rank waits
at most the process groups' timeout for a message); a stop message ends
the other ranks.  ``--no-data-parallel`` serves from one rank.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import threading
import time

TEXT_KEYS = ("text_interaction", "text_individual1", "text_individual2")
KEEPALIVE_S = 30.0


class Overloaded(Exception):
    """Request shed under overload (HTTP 429).  ``retry_after_s`` is the
    server's estimate of when capacity frees up: queued rows / batch
    capacity x the mean dispatch time."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = max(1.0, retry_after_s)


class _Batcher:
    """Continuous batching over one sampling function of fixed batch
    ``capacity``, driven by one thread (JAX ``cli/serve.py:_Batcher``).

    Requests without a seed coalesce (the dispatch's seed is the running
    dispatch count); a request with a seed runs alone, so its output is
    reproducible whatever the traffic.  FIFO order is kept: coalescing only
    merges a contiguous run of unseeded jobs.  ``linger_s`` holds an idle
    batch open for stragglers; ``max_queue_rows`` sheds a request at
    admission once that many rows wait (0: unbounded); ``deadline_s`` sheds
    jobs that waited longer at dispatch time (0: never).
    """

    def __init__(self, generate_rows, capacity: int, linger_s: float = 0.0,
                 max_queue_rows: int = 0, deadline_s: float = 0.0):
        self._generate = generate_rows  # (rows, seed) -> array (len(rows), T, F)
        self.capacity = capacity
        self.linger_s = linger_s
        self.max_queue_rows = max_queue_rows
        self.deadline_s = deadline_s
        self.shed = 0          # requests rejected (full queue or deadline)
        self.dispatch_ema_s = 0.0
        self.batches = 0
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-batcher")
        self._thread.start()

    def _retry_after(self, queued_rows: int) -> float:
        per_dispatch = self.dispatch_ema_s or 2.0
        return (queued_rows / max(1, self.capacity)) * per_dispatch

    def submit(self, rows: list, seed):
        """Block until this request's rows are sampled; returns (motion,
        used_seed).  ``seed=None`` opts into coalescing.  Raises
        :class:`Overloaded` when the queue bound or the deadline sheds it."""
        job = {"rows": rows, "seed": seed, "done": threading.Event(), "result": None,
               "used_seed": None, "error": None, "t_enq": time.monotonic()}
        with self._cv:
            if self.max_queue_rows:
                queued = sum(len(j["rows"]) for j in self._queue)
                if queued + len(rows) > self.max_queue_rows:
                    self.shed += 1
                    raise Overloaded(f"queue full ({queued}/{self.max_queue_rows} rows)",
                                     self._retry_after(queued))
            self._queue.append(job)
            self._cv.notify_all()
        job["done"].wait()
        if job["error"] is not None:
            raise job["error"]
        return job["result"], job["used_seed"]

    def stop(self, timeout: float = 30.0) -> None:
        """End the batcher thread once the queue is empty."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _shed_expired(self) -> None:
        """Drop queued jobs past their deadline (lock held)."""
        if not self.deadline_s:
            return
        now = time.monotonic()
        live = []
        for j in self._queue:
            if now - j["t_enq"] > self.deadline_s:
                self.shed += 1
                j["error"] = Overloaded(f"deadline exceeded ({self.deadline_s:.0f}s in queue)",
                                        self._retry_after(len(self._queue)))
                j["done"].set()
            else:
                live.append(j)
        self._queue[:] = live

    def _take_batch(self) -> list[dict]:
        """Pop the next dispatch: the head job and, if it is unseeded, the
        contiguous unseeded jobs after it that fit."""
        jobs = [self._queue.pop(0)]
        if jobs[0]["seed"] is None:
            n = len(jobs[0]["rows"])
            while (self._queue and self._queue[0]["seed"] is None
                   and n + len(self._queue[0]["rows"]) <= self.capacity):
                j = self._queue.pop(0)
                n += len(j["rows"])
                jobs.append(j)
        return jobs

    def _loop(self):
        while True:
            with self._cv:
                while True:
                    self._shed_expired()
                    if self._queue or self._stopped:
                        break
                    self._cv.wait()
                if not self._queue:
                    return
                if self.linger_s > 0 and self._queue[0]["seed"] is None:
                    deadline = time.monotonic() + self.linger_s
                    while (time.monotonic() < deadline
                           and sum(len(j["rows"]) for j in self._queue
                                   if j["seed"] is None) < self.capacity):
                        self._cv.wait(timeout=deadline - time.monotonic())
                    self._shed_expired()
                    if not self._queue:
                        continue
                jobs = self._take_batch()
            self.batches += 1
            t_dispatch = time.monotonic()
            seed = jobs[0]["seed"]
            used = self.batches if seed is None else int(seed)
            rows = [r for j in jobs for r in j["rows"]]
            try:
                motion = self._generate(rows, used)
                off = 0
                for j in jobs:
                    j["result"] = motion[off:off + len(j["rows"])]
                    j["used_seed"] = used
                    off += len(j["rows"])
            except Exception as e:  # every waiter gets the error; keep serving
                for j in jobs:
                    j["error"] = e
            finally:
                dt = time.monotonic() - t_dispatch
                self.dispatch_ema_s = (dt if self.dispatch_ema_s == 0.0
                                       else 0.8 * self.dispatch_ema_s + 0.2 * dt)
                for j in jobs:
                    j["done"].set()


def build_parser() -> argparse.ArgumentParser:
    from .infer_mixermdm import add_weight_args

    parser = argparse.ArgumentParser(prog="mixermdm_tpu_torch serve",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787, help="0 takes a free port")
    parser.add_argument("--batch-size", type=int, default=10,
                        help="served batch (every dispatch is padded to it)")
    parser.add_argument("--window", type=int, default=299)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights that no checkpoint file fills")
    parser.add_argument("--tiny", action="store_true", help="tiny config (smoke runs, tests)")
    parser.add_argument("--linger-ms", type=float, default=0.0,
                        help="hold an idle batch open this long for more requests to "
                             "coalesce; 0 dispatches at once")
    parser.add_argument("--max-queue-rows", type=int, default=None,
                        help="shed /generate with 429 + Retry-After once this many rows "
                             "are queued (default 8x the served batch; 0 = unbounded)")
    parser.add_argument("--deadline-s", type=float, default=60.0,
                        help="shed queued requests older than this at dispatch time "
                             "(429; 0 = no deadline)")
    parser.add_argument("--no-data-parallel", action="store_true",
                        help="serve from one rank even where several cards are visible "
                             "(default: every dispatch's rows split over all ranks)")
    add_weight_args(parser)
    return parser


class _Ranks:
    """Rank 0's side of data-parallel serving: every dispatch and every
    keep-alive goes to the other ranks as one broadcast, under one lock (the
    batcher thread and the keep-alive thread take turns)."""

    def __init__(self, mesh, dispatch):
        from ..parallel import comm

        self.group, self.dispatch, self.comm = mesh.group("data"), dispatch, comm
        self.lock = threading.Lock()
        self.last = time.monotonic()
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._keepalive, daemon=True)
        self.thread.start()

    def run(self, batch: dict, seed: int):
        with self.lock:
            self.comm.broadcast_object(("dispatch", batch, seed), 0, self.group)
            self.last = time.monotonic()
            return self.dispatch(batch, seed)

    def _keepalive(self):
        while not self.stopped.wait(1.0):
            with self.lock:
                if time.monotonic() - self.last >= KEEPALIVE_S:
                    self.comm.broadcast_object(("alive",), 0, self.group)
                    self.last = time.monotonic()

    def stop(self):
        self.stopped.set()
        self.thread.join()
        with self.lock:
            self.comm.broadcast_object(("stop",), 0, self.group)


def serve_rank(state) -> int:
    """A rank other than 0: sample the rows of every dispatch rank 0
    broadcasts, until its stop message.  Returns the dispatches served."""
    from ..parallel import comm

    n = 0
    while True:
        msg = comm.broadcast_object(None, 0, state["mesh"].group("data"))
        if msg[0] == "stop":
            return n
        if msg[0] == "dispatch":
            state["dispatch"](msg[1], msg[2])
            n += 1


def make_server(argv=None):
    """Build the system and the server from command-line ``argv``, run the
    warm-up dispatch, and return ``(server, batcher, state)`` without
    serving: ``server.serve_forever()`` serves (``server.server_address``
    has the port), ``server.shutdown()`` and ``batcher.stop()`` end it.
    ``state`` holds the system, the served shape and the request count."""
    import numpy as np
    import torch

    from .infer_mixermdm import system_from_args

    from ..parallel import initialize_distributed, make_mesh, rank_device, world_rank, \
        world_size

    args = build_parser().parse_args(argv)
    if args.tiny:
        args.batch_size = min(args.batch_size, 2)
        args.window = min(args.window, 16)
    initialize_distributed(args.device)
    args.device = str(rank_device(args.device))
    system = system_from_args(args)
    B, window = args.batch_size, args.window
    mesh = None
    if world_size() > 1 and not args.no_data_parallel:
        mesh = make_mesh()
        if B % mesh.size:
            B = -(-B // mesh.size) * mesh.size
            print(f"batch-size rounded up to {B} ({mesh.size} ranks)", flush=True)
        print(f"data-parallel serving over {mesh.size} ranks", flush=True)
    state = {"warm": False, "requests": 0, "system": system, "batch_size": B,
             "window": window, "mesh": mesh}
    count_lock = threading.Lock()  # handler threads count the requests they answer

    def dispatch(batch: dict, seed: int):
        """The whole batch's samples (every rank of the mesh calls it)."""
        with torch.inference_mode():
            cond = system.generate_cond(batch)
            gen = torch.Generator(device=system.device).manual_seed(int(seed))
            return system.sample(cond, window, generator=gen, mesh=mesh)

    state["dispatch"] = dispatch
    if mesh is not None and world_rank() != 0:
        return None, None, state  # serve_rank(state) follows rank 0's dispatches
    ranks = _Ranks(mesh, dispatch) if mesh is not None else None
    state["ranks"] = ranks

    def generate(rows: list, seed: int):
        """One dispatch: row i of the output answers ``rows[i]``; the pad
        rows (the last prompt again) keep the shape fixed and are dropped."""
        padded = rows + [rows[-1]] * (B - len(rows))
        batch = {k: [p[k] for p in padded] for k in TEXT_KEYS}
        out = ranks.run(batch, seed) if ranks is not None else dispatch(batch, seed)
        return out[:len(rows)].float().cpu().numpy()

    max_queue = 8 * B if args.max_queue_rows is None else max(0, args.max_queue_rows)
    batcher = _Batcher(generate, B, linger_s=args.linger_ms / 1e3, max_queue_rows=max_queue,
                       deadline_s=args.deadline_s)
    t0 = time.time()
    print(f"warming up (B={B}, T={window}) ...", flush=True)
    batcher.submit([{k: "warmup" for k in TEXT_KEYS}], 0)
    print(f"warm in {time.time() - t0:.1f}s", flush=True)
    state["warm"] = True

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: clients reuse one connection across requests
        # (every response carries Content-Length, which persistence needs).
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # no access log
            pass

        def _send(self, code: int, payload: dict, headers: dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "warm": state["warm"], "batch_size": B,
                                 "window": window, "requests": state["requests"],
                                 "batches": batcher.batches, "shed": batcher.shed})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if "prompts" in req:
                    prompts = [{k: str(p[k]) for k in TEXT_KEYS} for p in req["prompts"]]
                    if not 1 <= len(prompts) <= B:
                        return self._send(400, {"error": f"prompts must have 1..{B} entries"})
                    n = len(prompts)
                else:
                    prompts = [{k: str(req[k]) for k in TEXT_KEYS}]
                    n = int(req.get("num_samples", 1))
                seed = req.get("seed")
                seed = None if seed is None else int(seed)
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                return self._send(400, {"error": f"bad request: {e!r}"})
            if not 1 <= n <= B:
                return self._send(400, {"error": f"num_samples must be in [1, {B}]"})
            # One row per sample: a single prompt n times, or one per prompt.
            rows = [prompts[min(i, len(prompts) - 1)] for i in range(n)]
            t0 = time.time()
            try:
                motion, used_seed = batcher.submit(rows, seed)
            except Overloaded as e:  # backpressure: shed, say when to retry
                retry = max(1, int(round(e.retry_after_s)))
                return self._send(429, {"error": f"overloaded: {e}", "retry_after_s": retry},
                                  headers={"Retry-After": str(retry)})
            except Exception as e:  # a failed dispatch: 500, keep serving
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})
            with count_lock:
                state["requests"] += 1
            resp = {"shape": list(motion.shape), "dtype": "float32", "seed": used_seed,
                    "latency_s": round(time.time() - t0, 4)}
            if req.get("format", "npy_base64") == "json":
                resp["motion"] = motion.tolist()
            else:
                buf = io.BytesIO()
                np.save(buf, motion)
                resp["motion_npy_b64"] = base64.b64encode(buf.getvalue()).decode()
            self._send(200, resp)

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    return server, batcher, state


def stop(server, batcher, state) -> None:
    """End a server from :func:`make_server`: its socket, its batcher and
    (data-parallel) the other ranks."""
    server.server_close()
    batcher.stop()
    if state.get("ranks") is not None:
        state["ranks"].stop()


def main(argv=None):
    from ..parallel import on_ranks

    args = build_parser().parse_args(argv)
    return on_ranks(_serve, argv if argv is not None else sys.argv[1:],
                    spread=not args.no_data_parallel, device=args.device)


def _serve(argv) -> int:
    server, batcher, state = make_server(argv)
    if server is None:
        from ..parallel import world_rank

        print(f"rank {world_rank()}: {serve_rank(state)} dispatches served", flush=True)
        return 0
    host, port = server.server_address[:2]
    print(f"serving MixerMDM on http://{host}:{port} "
          f"(B={state['batch_size']}, T={state['window']})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop(server, batcher, state)
    return 0


if __name__ == "__main__":
    main()
