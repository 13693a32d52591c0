"""The port's generation server (``mixermdm_tpu_torch serve``), on the CPU.

The continuous batcher is held to the JAX package's on the same fake
sampler: each behaviour runs against both ``mixermdm_tpu.cli.serve`` and
``mixermdm_tpu_torch.cli.serve`` (neither imports JAX at module level).  The
port's HTTP server then runs in-process on a free port with the miniature
system (``--tiny --device cpu``): health, both response formats, a prompt
list, reproducible seeded requests equal to a direct ``sample`` of the
padded batch, and 400 for malformed requests.
"""

import base64
import importlib
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

SERVE_MODULES = ["mixermdm_tpu.cli.serve", "mixermdm_tpu_torch.cli.serve"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _row(i):
    return {"text_interaction": str(i), "text_individual1": "x", "text_individual2": "x"}


def _fake_batcher(mod, capacity=4, **kw):
    """A batcher over a fake sampler whose row i encodes its prompt id; the
    sampler blocks while ``gate`` is clear."""
    calls, gate = [], threading.Event()
    gate.set()

    def generate(rows, seed):
        gate.wait()
        calls.append((len(rows), seed))
        return np.array([[float(r["text_interaction"])] for r in rows])

    return importlib.import_module(mod)._Batcher(generate, capacity, **kw), calls, gate


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_seeded_requests_run_solo_and_reproducibly(mod):
    b, calls, _ = _fake_batcher(mod)
    out1, s1 = b.submit([_row(1)], 42)
    out2, s2 = b.submit([_row(2)], 42)
    assert s1 == s2 == 42
    assert calls == [(1, 42), (1, 42)]
    assert out1[0, 0] == 1.0 and out2[0, 0] == 2.0


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_unseeded_queued_requests_coalesce_in_fifo_order(mod):
    """While the sampler holds job 0, three unseeded jobs queue and then go
    out as one dispatch, each answered with its own row."""
    b, calls, gate = _fake_batcher(mod, capacity=4)
    gate.clear()
    results = {}

    def req(i):
        results[i] = b.submit([_row(i)], None)

    threads = [threading.Thread(target=req, args=(0,))]
    threads[0].start()
    time.sleep(0.2)
    for i in (1, 2, 3):
        threads.append(threading.Thread(target=req, args=(i,)))
        threads[-1].start()
    time.sleep(0.2)
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert [c[0] for c in calls] == [1, 3]
    assert b.batches == 2
    for i in range(4):
        assert results[i][0][0, 0] == float(i)


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_linger_holds_an_idle_batch_for_stragglers(mod):
    """With linger_s an unseeded job at an idle batcher waits: two
    stragglers within the window go out in its dispatch, and a batch that
    fills goes out without waiting the window out."""
    b, calls, _ = _fake_batcher(mod, capacity=4, linger_s=0.8)
    results = {}

    def req(batcher, i):
        results[i] = batcher.submit([_row(i)], None)

    threads = [threading.Thread(target=req, args=(b, i)) for i in range(3)]
    t0 = time.monotonic()
    threads[0].start()
    time.sleep(0.2)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert time.monotonic() - t0 >= 0.8
    assert calls == [(3, 1)] and b.batches == 1
    for i in range(3):
        assert results[i][0][0, 0] == float(i)

    full, calls, _ = _fake_batcher(mod, capacity=2, linger_s=30.0)
    threads = [threading.Thread(target=req, args=(full, i)) for i in range(2)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert time.monotonic() - t0 < 10.0
    assert calls == [(2, 1)] and full.batches == 1


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_queue_bound_sheds_with_retry_after(mod):
    """Once max_queue_rows rows wait, submit raises Overloaded (the 429
    path) at once, with a Retry-After estimate of at least 1 s."""
    m = importlib.import_module(mod)
    b, _, gate = _fake_batcher(mod, capacity=1, max_queue_rows=2)
    gate.clear()
    threads = [threading.Thread(target=b.submit, args=([_row(i)], 7 + i)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # one job in the sampler, two queued: the bound
    with pytest.raises(m.Overloaded, match="queue full") as ei:
        b.submit([_row(9)], None)
    assert ei.value.retry_after_s >= 1.0 and b.shed == 1
    gate.set()
    for t in threads:
        t.join(timeout=30)


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_deadline_sheds_stale_jobs_at_dispatch(mod):
    m = importlib.import_module(mod)
    b, _, gate = _fake_batcher(mod, capacity=1, deadline_s=0.2)
    gate.clear()
    out = {}

    def req(i, seed):
        try:
            out[i] = b.submit([_row(i)], seed)
        except m.Overloaded as e:
            out[i] = e

    t0 = threading.Thread(target=req, args=(0, 1))
    t0.start()
    time.sleep(0.3)   # job 0 in the sampler
    t1 = threading.Thread(target=req, args=(1, 2))
    t1.start()
    time.sleep(0.5)   # job 1 ages past the deadline in the queue
    gate.set()
    t0.join(timeout=30)
    t1.join(timeout=30)
    assert not isinstance(out[0], m.Overloaded) and isinstance(out[1], m.Overloaded)
    assert b.shed == 1
    assert b.submit([_row(5)], 3)[0].shape == (1, 1)  # still serving


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_sampler_error_reaches_every_waiter(mod):
    b = importlib.import_module(mod)._Batcher(
        lambda rows, seed: (_ for _ in ()).throw(RuntimeError("boom")), 4)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit([_row(1)], None)
    b._generate = lambda rows, seed: np.zeros((len(rows), 1))
    assert b.submit([_row(1)], None)[0].shape == (1, 1)


# ---------------------------------------------------------------- the server

@pytest.fixture(scope="module")
def server():
    from mixermdm_tpu_torch.cli.serve import make_server

    srv, batcher, state = make_server(["--tiny", "--device", "cpu", "--port", "0"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", batcher, state
    srv.shutdown()
    srv.server_close()
    batcher.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + "/generate", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


PROMPT = {"text_interaction": "two people shake hands",
          "text_individual1": "a person reaches out", "text_individual2": "a person reaches out"}


def test_healthz_after_warmup(server):
    url, batcher, state = server
    code, health = _get(url + "/healthz")
    assert code == 200 and health["status"] == "ok" and health["warm"] is True
    assert (health["batch_size"], health["window"]) == (2, 16) and batcher.batches >= 1


def test_generate_npy_base64_and_json(server):
    url, _, _ = server
    code, resp = _post(url, {**PROMPT, "num_samples": 2})
    assert code == 200 and resp["shape"] == [2, 16, 524] and resp["dtype"] == "float32"
    motion = np.load(io.BytesIO(base64.b64decode(resp["motion_npy_b64"])))
    assert motion.shape == (2, 16, 524) and np.isfinite(motion).all()
    prompts = [PROMPT, {**PROMPT, "text_interaction": "one person pushes the other"}]
    code, resp = _post(url, {"prompts": prompts, "format": "json", "seed": 1})
    assert code == 200 and np.asarray(resp["motion"], np.float32).shape == (2, 16, 524)


def test_seeded_request_is_reproducible_and_equals_sample(server):
    """The same seeded request twice gives the same bytes, which are the
    rows of system.sample on the padded batch with that seed."""
    url, _, state = server
    body = {**PROMPT, "num_samples": 1, "seed": 123}
    (c1, r1), (c2, r2) = _post(url, body), _post(url, body)
    assert c1 == c2 == 200 and r1["seed"] == 123
    assert r1["motion_npy_b64"] == r2["motion_npy_b64"]
    system = state["system"]
    batch = {k: [PROMPT[k]] * state["batch_size"] for k in PROMPT}
    with torch.inference_mode():
        want = system.sample(system.generate_cond(batch), state["window"],
                             generator=torch.Generator().manual_seed(123))[:1].numpy()
    got = np.load(io.BytesIO(base64.b64decode(r1["motion_npy_b64"])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("body", [b"{not json", {"text_interaction": "only one text"},
                                  {**PROMPT, "num_samples": 3}, {**PROMPT, "num_samples": 0},
                                  {"prompts": []}, {**PROMPT, "seed": "abc"}])
def test_malformed_requests_get_400(server, body):
    url, _, _ = server
    code, resp = _post(url, body)
    assert code == 400 and "error" in resp
