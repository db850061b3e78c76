"""HTTP synthesis server on the serving internals, standard library only
(JAX package: infer/http_serve.py).

A ``ThreadingHTTPServer`` front end whose handlers enqueue requests, and one
worker thread that coalesces up to ``max_batch`` queued requests into one
batched synthesis call, padded to the same power-of-two batch buckets as the
stdin loop (``serve.py``), so ``warmup`` covers every shape served.

Endpoints:

* ``GET  /health``      -> {"status": "ok", "speakers": N, "served": M}
* ``GET  /speakers``    -> JSON list of speaker ids
* ``POST /synthesize``  -> body {"text": "...", "speaker": "id"?}; response
  ``audio/wav`` bytes (16-bit PCM), headers ``X-Latency-Ms``
  (client-perceived, queue wait included), ``X-Batched`` (the coalesced
  batch's size) and ``X-Audio-Seconds``.

One worker synthesizes, so the card sees one stream of work while HTTP I/O
overlaps in the handler threads.  The worker double-buffers: it dispatches
batch i+1 before it finalizes batch i, so batch i's host copies and delivery
overlap batch i+1's device work.  The Text2Vec and Generator forwards enter
inference mode themselves, so the worker thread needs no grad-mode setting
of its own.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from wavthruvec_pytorch_tpu_torch.infer.serve import (
    _NONFINITE_MSG,
    SpeakerStore,
    _batch_buckets,
    _dispatch_batch,
    warmup,
)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """A float waveform in [-1, 1] (or int16 PCM from the batched serving
    path) -> the bytes of a 16-bit PCM WAV file."""
    if wav.dtype == np.int16:
        pcm16 = wav.astype("<i2", copy=False)
    else:
        pcm16 = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


class _Pending:
    __slots__ = ("speaker", "text", "done", "wav", "n_samples", "batched", "error")

    def __init__(self, speaker: str, text: str):
        self.speaker = speaker
        self.text = text
        self.done = threading.Event()
        self.wav = None
        self.n_samples = 0
        self.batched = 0
        self.error: Optional[str] = None


class SynthesisService:
    """The queue and the coalescing worker that all handler threads share."""

    def __init__(self, synth, store: SpeakerStore, default_speaker=None,
                 alpha: float = 1.0, max_frames: Optional[int] = None,
                 max_batch: int = 8, coalesce_wait_ms: float = 0.0):
        self.synth = synth
        self.store = store
        self.alpha = alpha
        self.max_frames = max_frames
        self.max_batch = max(1, max_batch)
        # after the first queued request, wait up to this long for more
        # before dispatching (serve._LineSource.take)
        self.coalesce_wait_s = max(0.0, coalesce_wait_ms) / 1e3
        self.buckets = _batch_buckets(self.max_batch)
        self.default_speaker = default_speaker or (store.speakers() or [None])[0]
        self.served = 0
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def warmup(self):
        return warmup(self.synth, max_frames=self.max_frames, alpha=self.alpha,
                      max_batch=self.max_batch)

    def submit(self, speaker: Optional[str], text: str) -> _Pending:
        req = _Pending(speaker or self.default_speaker, text)
        self._q.put(req)
        return req

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=5)

    def _take_batch(self, block: bool = True):
        """``block=False`` drains without waiting for a first request: used
        while a dispatched batch waits to be finalized, so its delivery is
        never held up by an empty queue."""
        if block:
            reqs = [self._q.get()]
            while reqs[0] is None:
                if self._stop.is_set():
                    return []
                reqs = [self._q.get()]
        else:
            try:
                first = self._q.get_nowait()
            except queue.Empty:
                return []
            if first is None:
                return []
            reqs = [first]
        deadline = (time.perf_counter() + self.coalesce_wait_s
                    if self.coalesce_wait_s > 0 else None)
        while len(reqs) < self.max_batch:
            try:
                if deadline is None:
                    r = self._q.get_nowait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is not None:
                reqs.append(r)
        return reqs

    def _deliver(self, reqs, finalize):
        try:
            wavs, n_samples, finite_ok = finalize()
            for i, r in enumerate(reqs):
                # an overflowed eval-mode BN must surface as an error, never
                # as NaN PCM in an audio/wav response
                if not finite_ok[i]:
                    r.error = _NONFINITE_MSG
                    continue
                r.wav = np.asarray(wavs[i])
                r.n_samples = int(n_samples[i])
                r.batched = len(reqs)
        except Exception as e:  # per request, and keep serving
            for r in reqs:
                r.error = f"{type(e).__name__}: {e}"
        finally:
            self.served += len(reqs)
            for r in reqs:
                r.done.set()

    def _run(self):
        # dispatch batch i+1 before finalizing batch i; with an empty queue
        # the pending batch is finalized at once (the take does not block)
        prev = None  # (reqs, finalize) awaiting delivery
        while not self._stop.is_set():
            reqs = self._take_batch(block=prev is None)
            cur = None
            if reqs:
                bucket = next(b for b in self.buckets if b >= len(reqs))
                try:
                    fin = _dispatch_batch(self.synth, self.store,
                                          [(r.speaker, r.text) for r in reqs],
                                          self.alpha, self.max_frames, pad_to=bucket)
                    cur = (reqs, fin)
                except Exception as e:  # dispatch failed: error out now
                    for r in reqs:
                        r.error = f"{type(e).__name__}: {e}"
                    self.served += len(reqs)
                    for r in reqs:
                        r.done.set()
            if prev is not None:
                self._deliver(*prev)
            prev = cur
        if prev is not None:  # drain on shutdown
            self._deliver(*prev)


def make_handler(service: SynthesisService, timeout_s: float = 600.0):
    sr = service.synth.v2w_cfg.sampling_rate

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "speakers": len(service.store.speakers()),
                                 "served": service.served})
            elif self.path == "/speakers":
                self._json(200, service.store.speakers())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/synthesize":
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
            except (KeyError, ValueError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            speaker = req.get("speaker")
            if speaker is not None and speaker not in service.store.speakers():
                return self._json(400, {"error": f"unknown speaker {speaker!r}"})
            t0 = time.perf_counter()
            pending = service.submit(speaker, text)
            if not pending.done.wait(timeout_s):
                return self._json(504, {"error": "synthesis timed out"})
            if pending.error is not None:
                return self._json(500, {"error": pending.error})
            dt_ms = (time.perf_counter() - t0) * 1e3
            body = wav_bytes(pending.wav[: pending.n_samples], sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-Ms", f"{dt_ms:.1f}")
            self.send_header("X-Batched", str(pending.batched))
            self.send_header("X-Audio-Seconds", f"{pending.n_samples / sr:.2f}")
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve_http(synth, store: SpeakerStore, host: str = "127.0.0.1", port: int = 8571,
               default_speaker=None, alpha: float = 1.0, max_frames: Optional[int] = None,
               max_batch: int = 8, do_warmup: bool = False, ready_cb=None,
               coalesce_wait_ms: float = 0.0) -> int:
    """Run the HTTP server until interrupted or shut down; returns the
    number of requests served.  ``ready_cb(server, service)`` runs after the
    bind and the optional warm-up (a caller learns the port there, and may
    call ``server.shutdown()`` from another thread)."""
    service = SynthesisService(synth, store, default_speaker=default_speaker, alpha=alpha,
                               max_frames=max_frames, max_batch=max_batch,
                               coalesce_wait_ms=coalesce_wait_ms)
    if do_warmup:
        service.warmup()
    server = ThreadingHTTPServer((host, port), make_handler(service))
    if ready_cb is not None:
        ready_cb(server, service)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return service.served
