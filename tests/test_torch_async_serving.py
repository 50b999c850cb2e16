"""The port's always-on loop (``AsyncEngine``) and HTTP/SSE front-end
(``HttpFrontend``, ``serve_http``) against the JAX package's.

Each test runs one scenario of the async/HTTP part of
``tests/test_async_serving.py`` twice, over the JAX front-ends with a JAX
engine and over the port's with a torch engine, on the same weights
(``bridge.params_from_jax``) at ``reduce_for_smoke(olmo-1b)``, and requires
equal observations: stream events and SSE frames without their timing
fields, tokens, finish reasons, HTTP status lines and error bodies, and the
engine's abort and block counts.  Then the reference test's own assertions
run on the port's observations.  Both sides use fp32 pools and an
``eos_token`` outside the vocab.

Two behaviours are the port's own: every step runs on one stepping thread
of the ``AsyncEngine`` (``step_threads``), and a graceful shutdown drains
the engine before it waits for open connections, so a request or a
``/healthz`` probe on a connection opened before the drain gets 503 while
an in-flight stream still runs to its end.
"""

import asyncio
import json
import os
import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as J
import repro_torch.serving as T
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving.http import serve_http as jax_serve_http
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.serving.http import serve_http as torch_serve_http

torch.set_num_threads(2)

EOS = 1 << 30  # outside the vocab: every request runs to its length
PROMPT = [5, 9, 12, 7]


@pytest.fixture(scope="module")
def sides():
    jcfg = jax_reduce(jax_get_config("olmo-1b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = reduce_for_smoke(get_config("olmo-1b"))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return {
        "jax": SimpleNamespace(mod=J, cfg=jcfg, params=jparams, serve_http=jax_serve_http,
                               engine_kw=dict(cache_dtype=jnp.float32)),
        "torch": SimpleNamespace(mod=T, cfg=tcfg, params=tparams, serve_http=torch_serve_http,
                                 engine_kw=dict(cache_dtype=torch.float32, device="cpu")),
    }


def ample_engine(S, **kw):
    """Enough slots and blocks that nothing ever waits."""
    return S.mod.InferenceEngine(S.cfg, S.params, max_batch=8, max_seq=64, cache_kind="paged", block_size=4,
                                 eos_token=EOS, **S.engine_kw, **kw)


def both(sides, scenario):
    obs = {name: scenario(S) for name, S in sides.items()}
    assert obs["torch"] == obs["jax"]
    return obs["torch"]


def drained(S, prompts, max_new):
    ref = ample_engine(S)
    reqs = [ref.submit(p, max_new_tokens=max_new) for p in prompts]
    ref.run_until_drained()
    return [list(r.generated) for r in reqs]


def event(ev) -> tuple:
    """A stream event without its timing field."""
    return (ev.kind, ev.req_id, tuple(ev.tokens), ev.index, ev.reason, ev.n_tokens, ev.ttft_s is not None,
            ev.preemptions)


# ---- async engine ---------------------------------------------------------


def test_async_stream_matches_drained_tokens(sides):
    threads = {}

    def scenario(S):
        async def go():
            async with S.mod.AsyncEngine(ample_engine(S)) as aeng:
                events = [ev async for ev in aeng.submit_stream(PROMPT, max_new_tokens=8)]
                threads[S.mod] = getattr(aeng, "step_threads", None)
                return events

        return [event(e) for e in asyncio.run(go())]

    events = both(sides, scenario)
    token_events = [e for e in events if e[0] == "token"]
    assert len(token_events) >= 2, "tokens must stream incrementally, not in one batch"
    assert [t for e in token_events for t in e[2]] == drained(sides["torch"], [PROMPT], 8)[0]
    kind, _, _, _, reason, n_tokens, has_ttft, _ = events[-1]
    assert kind == "finish" and reason == "length" and n_tokens == 8 and has_ttft
    (name,) = threads[T]  # every step on the one stepping thread
    assert name.startswith("engine-step")


def test_async_concurrent_streams(sides):
    prompts = [[5, 9, 12], [7, 3], [20, 21, 22, 23]]

    def scenario(S):
        async def go():
            async with S.mod.AsyncEngine(ample_engine(S)) as aeng:
                return await asyncio.gather(*(aeng.generate(p, max_new_tokens=5) for p in prompts))

        return [(event(final), toks) for final, toks in asyncio.run(go())]

    outs = both(sides, scenario)
    assert [toks for _, toks in outs] == drained(sides["torch"], prompts, 5)


def test_async_submit_validation_raises_in_caller(sides):
    def scenario(S):
        async def go():
            async with S.mod.AsyncEngine(ample_engine(S)) as aeng:
                with pytest.raises(ValueError) as err:
                    async for _ in aeng.submit_stream([1, 2], max_new_tokens=-1):
                        pass  # pragma: no cover
                return str(err.value)

        return asyncio.run(go())

    assert "max_new_tokens" in both(sides, scenario)


# ---- HTTP/SSE front-end ---------------------------------------------------


async def _http_roundtrip(port: int, payload: dict) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n" + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    return raw.decode()


async def _http_get(port: int, path: str) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    return raw.decode()


def _parse_sse(raw: str) -> list[tuple[str, dict]]:
    head, _, stream = raw.partition("\r\n\r\n")
    assert "200" in head.split("\r\n")[0], head
    frames = []
    for block in stream.strip().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in block.split("\n") if ": " in ln)
        frames.append((lines["event"], json.loads(lines["data"])))
    return frames


def frames_without_timing(raw: str) -> list:
    return [(kind, {k: v for k, v in data.items() if k != "ttft_s"}) for kind, data in _parse_sse(raw)]


def status_and_body(raw: str) -> tuple:
    head, _, body = raw.partition("\r\n\r\n")
    return head.split("\r\n")[0], json.loads(body)


def test_http_sse_roundtrip(sides):
    def scenario(S):
        async def go():
            front = S.mod.HttpFrontend(S.mod.AsyncEngine(ample_engine(S)), port=0)
            await front.start()
            try:
                raw = await _http_roundtrip(front.port, {"prompt": PROMPT, "max_new_tokens": 6})
                metrics = await _http_get(front.port, "/metrics")
                bad = await _http_roundtrip(front.port, {"prompt": PROMPT, "max_new_tokens": -1})
                return raw, metrics, bad
            finally:
                await front.stop()

        raw, metrics, bad = asyncio.run(go())
        return dict(frames=frames_without_timing(raw), metrics="engine_tokens_out_total" in metrics,
                    bad=status_and_body(bad))

    o = both(sides, scenario)
    kinds = [k for k, _ in o["frames"]]
    assert kinds[-1] == "done" and all(k == "token" for k in kinds[:-1])
    streamed = [t for k, d in o["frames"] if k == "token" for t in d["tokens"]]
    assert streamed == drained(sides["torch"], [PROMPT], 6)[0]
    assert o["frames"][-1][1]["reason"] == "length"
    assert o["metrics"] and "400" in o["bad"][0]


MALFORMED = {
    "bad_length": b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: nope\r\n\r\n",
    "huge_body": b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 999999999\r\n\r\n",
    "not_json": b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 4\r\n\r\nabcd",
    "not_object": b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 7\r\n\r\n[1,2,3]",
    "bad_prompt": b'POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 21\r\n\r\n{"prompt": "strings"}',
}


def test_http_rejects_malformed_framing(sides):
    def scenario(S):
        async def go():
            front = S.mod.HttpFrontend(S.mod.AsyncEngine(ample_engine(S)), port=0)
            await front.start()
            results = {}
            try:
                for name, req in MALFORMED.items():
                    reader, writer = await asyncio.open_connection("127.0.0.1", front.port)
                    writer.write(req)
                    await writer.drain()
                    results[name] = status_and_body((await reader.read()).decode())
                    writer.close()
                    await writer.wait_closed()
                results["healthz"] = status_and_body(await _http_get(front.port, "/healthz"))
            finally:
                await front.stop()
            return results

        return asyncio.run(go())

    results = both(sides, scenario)
    for name in MALFORMED:
        assert "400" in results[name][0] and "error" in results[name][1], (name, results[name])
    assert "200" in results["healthz"][0]


def test_http_client_disconnect_aborts_request(sides):
    def scenario(S):
        eng = ample_engine(S)

        async def go():
            aeng = S.mod.AsyncEngine(eng)
            front = S.mod.HttpFrontend(aeng, port=0)
            await front.start()
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", front.port)
                body = json.dumps({"prompt": PROMPT, "max_new_tokens": 48}).encode()
                writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                             + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
                await writer.drain()
                await reader.readuntil(b"event: token")  # first token is out
                writer.close()  # client vanishes mid-stream
                await writer.wait_closed()
                await aeng.drain()
            finally:
                await front.stop()

        asyncio.run(go())
        s = eng.stats()
        (req,) = eng.done
        return dict(aborted=s["requests_aborted"], active=s["requests_active"], prefilling=s["requests_prefilling"],
                    reason=req.finish_reason, free=(eng.allocator.num_free, eng.allocator.capacity))

    o = both(sides, scenario)
    assert o["aborted"] == 1, "disconnected client's request must abort"
    assert o["reason"] == "cancelled" and o["active"] == 0 and o["prefilling"] == 0
    assert o["free"][0] == o["free"][1]


def test_healthz_reports_draining_and_replicas(sides):
    def scenario(S):
        async def go():
            aeng = S.mod.AsyncEngine(ample_engine(S))
            front = S.mod.HttpFrontend(aeng, port=0)
            await front.start()
            try:
                ready = await _http_get(front.port, "/healthz")
                aeng._draining = True  # what shutdown() flips first
                draining = await _http_get(front.port, "/healthz")
            finally:
                await front.stop()
            return status_and_body(ready), status_and_body(draining)

        return asyncio.run(go())

    ready, draining = both(sides, scenario)
    assert "200" in ready[0] and ready[1]["ok"] is True
    assert "503" in draining[0] and draining[1] == {"ok": False, "draining": True}


def test_submission_during_drain_gets_503(sides):
    def scenario(S):
        async def go():
            aeng = S.mod.AsyncEngine(ample_engine(S))
            front = S.mod.HttpFrontend(aeng, port=0)
            await front.start()
            try:
                aeng._draining = True
                return await _http_roundtrip(front.port, {"prompt": [5, 9], "max_new_tokens": 2})
            finally:
                await front.stop()

        return status_and_body(asyncio.run(go()))

    status, body = both(sides, scenario)
    assert "503" in status and "draining" in body["error"]


def test_serve_http_sigterm_drains_and_flushes(sides, tmp_path):
    """serve_http installs a SIGTERM handler; the signal drains gracefully
    and the metrics and trace files flush before it returns."""

    def scenario(S):
        out = tmp_path / S.mod.__name__
        out.mkdir()
        eng = ample_engine(S)

        async def go():
            ready = asyncio.Queue()

            async def client():
                front = await ready.get()
                raw = await _http_roundtrip(front.port, {"prompt": PROMPT, "max_new_tokens": 6})
                os.kill(os.getpid(), signal.SIGTERM)
                return raw

            server = S.serve_http(eng, port=0, metrics_json=str(out / "metrics.json"),
                                  trace_out=str(out / "trace.json"), drain_timeout_s=30.0,
                                  on_ready=ready.put_nowait)
            _, raw = await asyncio.wait_for(asyncio.gather(server, client()), timeout=60)
            return raw

        frames = frames_without_timing(asyncio.run(go()))
        snap = json.loads((out / "metrics.json").read_text())
        trace = json.loads((out / "trace.json").read_text())
        return dict(frames=frames, tokens_out=snap["counters"]["engine_tokens_out_total"]["value"],
                    finish=any(e.get("name") == "finish" for e in trace["traceEvents"]))

    o = both(sides, scenario)
    assert o["frames"][-1][0] == "done" and o["frames"][-1][1]["reason"] == "length"
    assert o["tokens_out"] >= 6 and o["finish"]


# ---- the port's own --------------------------------------------------------


def test_graceful_drain_answers_open_connections_with_503(sides):
    """A shutdown that lands while a stream runs: the stream still ends in
    ``done`` with all its tokens, and a connection opened before the drain
    gets 503 for ``/healthz`` and for a new request; the drain beats its
    timeout and the stepping thread is gone afterwards."""
    S = sides["torch"]
    eng = ample_engine(S)

    async def go():
        aeng = T.AsyncEngine(eng)
        front = T.HttpFrontend(aeng, port=0)
        await front.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", front.port)
        body = json.dumps({"prompt": PROMPT, "max_new_tokens": 24}).encode()
        writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n" + f"Content-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        await writer.drain()
        await reader.readuntil(b"event: token")  # the request is in flight
        probes = [await asyncio.open_connection("127.0.0.1", front.port) for _ in range(2)]
        shutdown = asyncio.create_task(front.shutdown(30.0))
        while not aeng.draining:
            await asyncio.sleep(0)
        late = json.dumps({"prompt": [5, 9], "max_new_tokens": 2}).encode()
        answers = []
        for (r, w), req in zip(probes, (b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n",
                                        b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                                        + f"Content-Length: {len(late)}\r\n\r\n".encode() + late)):
            w.write(req)
            await w.drain()
            answers.append(status_and_body((await r.read()).decode()))
            w.close()
            await w.wait_closed()
        rest = (await reader.read()).decode()
        writer.close()
        await writer.wait_closed()
        return answers, rest, await asyncio.wait_for(shutdown, 60), aeng

    answers, rest, drained_in_time, aeng = asyncio.run(go())
    assert [a[0].split(" ")[1] for a in answers] == ["503", "503"]
    assert answers[0][1] == {"ok": False, "draining": True} and "draining" in answers[1][1]["error"]
    frames = [json.loads(b.split("data: ", 1)[1]) for b in rest.strip().split("\n\n") if "data: " in b]
    assert frames[-1]["reason"] == "length" and frames[-1]["n_tokens"] == 24
    assert drained_in_time and aeng._executor is None
    assert eng.stats()["requests_done"] == 1 and eng.allocator.num_free == eng.allocator.capacity
