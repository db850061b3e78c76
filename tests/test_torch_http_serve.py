"""The port's HTTP front end (``infer/http_serve.py``) on the CPU, mirroring
``tests/test_http_serve.py``: routes, wav payloads, coalescing, the
coalescing window and error paths, on 127.0.0.1 port 0 with the tiny
serving model of ``tests/test_torch_serve.py``.  A coalesced request's
audio equals its audio alone within 1 LSB."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

from tests.test_torch_serve import make_synth, mk_speakers
from wavthruvec_pytorch_tpu_torch.infer.http_serve import (
    SynthesisService,
    make_handler,
    serve_http,
    wav_bytes,
)


def _pcm(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 16000 and w.getnchannels() == 1 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def test_wav_bytes_roundtrip():
    sig = np.sin(np.linspace(0, 20, 1600)).astype(np.float32) * 0.5
    pcm = _pcm(wav_bytes(sig, 16000))
    assert pcm.shape == (1600,)
    np.testing.assert_allclose(pcm / 32767.0, sig, atol=1e-4)
    ints = (sig * 32767).astype(np.int16)
    np.testing.assert_array_equal(_pcm(wav_bytes(ints, 16000)), ints)


@pytest.fixture(scope="module")
def http_server(tmp_path_factory):
    """The tiny model behind a server on an ephemeral port, for the module."""
    from http.server import ThreadingHTTPServer

    tmp_path = tmp_path_factory.mktemp("http")
    synth = make_synth()
    store = mk_speakers(tmp_path, synth)
    service = SynthesisService(synth, store, alpha=4.0, max_frames=32, max_batch=4)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", service, synth
    server.shutdown()
    server.server_close()
    service.close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(base, payload):
    req = urllib.request.Request(f"{base}/synthesize", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=600)


def test_http_health_and_speakers(http_server):
    base, _, _ = http_server
    with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["speakers"] == 2
    with urllib.request.urlopen(f"{base}/speakers", timeout=60) as r:
        assert json.loads(r.read()) == ["SSB0000", "SSB0001"]


def test_http_synthesize_returns_wav(http_server):
    base, _, synth = http_server
    with _post(base, {"text": "abc def", "speaker": "SSB0001"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        seconds = float(r.headers["X-Audio-Seconds"])
        body = r.read()
    pcm = _pcm(body)
    assert seconds > 0 and pcm.shape[0] > 0
    # whole latent frames x the upsampling
    assert pcm.shape[0] % synth.v2w_cfg.total_upsample == 0


def test_http_errors(http_server):
    base, _, _ = http_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, {"speaker": "SSB0000"})  # no text
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, {"text": "abc", "speaker": "NOSUCH"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/nope", timeout=60)
    assert e.value.code == 404


def test_http_concurrent_requests_coalesce(http_server):
    """Parallel clients are served from coalesced batched calls, every
    response a wav, each equal to the same request served alone."""
    base, service, synth = http_server
    texts = ["abc def", "gfe abc", "abc", "fed cba"]
    alone = []
    for i, text in enumerate(texts):
        with _post(base, {"text": text, "speaker": f"SSB{i % 2:04d}"}) as r:
            assert r.headers["X-Batched"] == "1"
            alone.append(_pcm(r.read()))

    calls = []
    orig = synth.text_to_latents
    gate = threading.Event()

    def counting(texts, *args, **kwargs):
        calls.append(len(texts))
        if len(calls) == 1:
            gate.wait(60)  # a first request holds the worker while the clients queue
        return orig(texts, *args, **kwargs)

    synth.text_to_latents = counting
    try:
        blocker = service.submit("SSB0000", "abc")
        deadline = time.perf_counter() + 60
        while not calls and time.perf_counter() < deadline:
            time.sleep(0.01)
        results = [None] * 4

        def client(i):
            with _post(base, {"text": texts[i], "speaker": f"SSB{i % 2:04d}"}) as r:
                results[i] = (int(r.headers["X-Batched"]), r.read())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        while service._q.qsize() < 4 and time.perf_counter() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        assert blocker.done.wait(600) and blocker.error is None
    finally:
        gate.set()
        synth.text_to_latents = orig
    # the four queued requests form one batch (the blocker's was the first)
    assert calls == [1, 4] and [r[0] for r in results] == [4] * 4
    for (_, body), want in zip(results, alone):
        got = _pcm(body)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_service_coalescing_window(tmp_path):
    """With ``coalesce_wait_ms``, a request arriving soon after the first is
    folded into the same batched call."""
    synth = make_synth()
    service = SynthesisService(synth, mk_speakers(tmp_path, synth), alpha=4.0, max_frames=32,
                               max_batch=4, coalesce_wait_ms=2000.0)
    try:
        service.submit("SSB0000", "abc").done.wait(600)
        r1 = service.submit("SSB0000", "abc def")
        time.sleep(0.2)  # well inside the 2 s window
        r2 = service.submit("SSB0001", "gfe")
        assert r1.done.wait(600) and r2.done.wait(600)
        assert r1.error is None and r2.error is None
        assert (r1.batched, r2.batched) == (2, 2)
    finally:
        service.close()


def test_serve_http_runs_and_shuts_down(tmp_path):
    """``serve_http`` binds, warms up, serves and returns its count when
    shut down from ``ready_cb``'s thread."""
    synth = make_synth()
    store = mk_speakers(tmp_path, synth)
    box = {}

    def ready(server, service):
        box["base"] = f"http://127.0.0.1:{server.server_address[1]}"
        box["server"] = server
        box["ready"].set()

    box["ready"] = threading.Event()
    t = threading.Thread(target=lambda: box.update(n=serve_http(
        synth, store, port=0, alpha=4.0, max_frames=32, max_batch=2, do_warmup=True,
        ready_cb=ready)), daemon=True)
    t.start()
    assert box["ready"].wait(600)
    with _post(box["base"], {"text": "abc"}) as r:
        assert r.status == 200 and _pcm(r.read()).shape[0] > 0
    box["server"].shutdown()
    t.join(timeout=60)
    assert not t.is_alive() and box["n"] == 1
