"""Long-running synthesis server loop (JAX package: infer/serve.py).

It reads one request per line and writes one result line per request, a
minimal protocol that a process supervisor or a socket wrapper can drive:

    <text>                          -> synthesize with the default speaker
    <speaker_id>|<text>             -> synthesize with that speaker

Speakers come from ``spk_emb_dir`` (``{spk}.npy`` or ``.pth`` vocoder
embeddings) and a reference-clip directory for the Text2Vec conditioning;
the Text2Vec speaker embedding is computed once per speaker and cached
(``Synthesizer.speaker_embedding``), so steady-state requests never rerun
ECAPA.  Wavs land in ``out_dir`` with the response line ``OK <path>
<seconds>``; errors respond ``ERR <message>``.

* **Request coalescing** (``max_batch > 1``): the requests already queued
  when the server becomes free are synthesized as one batched call (mixed
  speakers and text lengths: per-item embeddings are stacked and padding is
  masked).  A request arriving alone still runs at once.  Responses keep
  request order.  Batches are padded to power-of-two batch buckets (the
  padded rows repeat the last request and are dropped), so ``warmup`` can
  run every shape the loop will see.
* **PCM over stdout** (``pcm=True``): raw int16 little-endian PCM on the
  binary output stream, framed by text control lines; with ``stream_chunk``
  each utterance goes out in chunks while later ones compute
  (``StreamingVocoder``):

      PCMSTART <sr>\\n
      PCMCHUNK <n_bytes>\\n<bytes>...
      PCMEND <n_samples> latency=<ms> ttfa=<ms>\\n

  (``latency`` and ``ttfa`` are client-perceived: from the coalesced
  batch's arrival to the item's last and first audio bytes.)

On the card a batch is dispatched without waiting for it: the inputs go up
by non-blocking copies, and the int16 PCM, the [2, B] meta (frame counts,
finite flags) and the waveform's finite flags come back by non-blocking
copies into pinned host memory, ordered by one CUDA event.  ``finalize``
waits on that event, so a server can dispatch the next batch first
(``http_serve.SynthesisService``).
"""

from __future__ import annotations

import functools
import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.data.vocoder_data import load_spk_emb


class _LineSource:
    """Blocking first read, non-blocking drain, over any line stream.

    A daemon reader thread decouples the loop from the stream, so coalescing
    works on pipes, sockets and StringIO alike (no select())."""

    def __init__(self, stream):
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        t = threading.Thread(target=self._read, args=(stream,), daemon=True)
        t.start()

    def _read(self, stream):
        for line in stream:
            self._q.put(line)
        self._q.put(None)  # EOF sentinel

    def take(self, max_n: int, wait_s: float = 0.0) -> List[str]:
        """Block for one line, then drain whatever is already queued (up to
        ``max_n`` in all).  Returns [] at EOF.

        ``wait_s`` > 0 is the coalescing window: after the first line, keep
        waiting up to that deadline for more, trading up to ``wait_s`` of
        added first-request latency for larger batches.  The window closes
        early when ``max_n`` lines are in hand."""
        first = self._q.get()
        if first is None:
            self._q.put(None)
            return []
        lines = [first]
        deadline = time.perf_counter() + wait_s if wait_s > 0 else None
        while len(lines) < max_n:
            try:
                if deadline is None:
                    nxt = self._q.get_nowait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)
                break
            lines.append(nxt)
        return lines


class SpeakerStore:
    """Per-speaker conditioning, loaded on first use: the vocoder speaker
    embedding and the cached Text2Vec embedding."""

    def __init__(self, synth, spk_emb_dir: str, ref_feat_dir: Optional[str]):
        self.synth = synth
        self.spk_emb_dir = spk_emb_dir
        self.ref_feat_dir = ref_feat_dir
        self._voc: Dict[str, np.ndarray] = {}
        self._t2v: Dict[str, Optional[np.ndarray]] = {}

    def speakers(self) -> List[str]:
        return sorted(os.path.splitext(f)[0] for f in os.listdir(self.spk_emb_dir)
                      if f.endswith((".npy", ".pth")))

    def vocoder_emb(self, spk: str) -> np.ndarray:
        if spk not in self._voc:
            for ext in (".npy", ".pth"):
                p = os.path.join(self.spk_emb_dir, spk + ext)
                if os.path.exists(p):
                    self._voc[spk] = load_spk_emb(p)
                    break
            else:
                raise KeyError(f"no speaker embedding for {spk!r}")
        return self._voc[spk]

    def t2v_emb(self, spk: str) -> Optional[np.ndarray]:
        """The Text2Vec ECAPA embedding of the speaker's reference clip (the
        first .npy under ref_feat_dir/{spk}/), cached; None without one."""
        if self.ref_feat_dir is None:
            return None
        if spk not in self._t2v:
            d = os.path.join(self.ref_feat_dir, spk)
            clips = sorted(f for f in os.listdir(d) if f.endswith(".npy")) if os.path.isdir(d) else []
            if not clips:
                # cached too: steady-state requests must not rescan the disk
                self._t2v[spk] = None
            else:
                ref = np.load(os.path.join(d, clips[0])).squeeze()[None]
                self._t2v[spk] = self.synth.speaker_embedding(ref.astype(np.float32))
        return self._t2v[spk]

    def t2v_emb_or_fallback(self, spk: str) -> np.ndarray:
        """``t2v_emb``, or for a speaker without a reference clip the
        embedding of a zero clip, computed once."""
        emb = self.t2v_emb(spk)
        if emb is not None:
            return emb
        if "\0fallback" not in self._t2v:
            zeros = np.zeros((1, 1, self.synth.t2v_cfg.n_feat_dim), np.float32)
            self._t2v["\0fallback"] = self.synth.speaker_embedding(zeros)
        return self._t2v["\0fallback"]


def _batch_buckets(max_batch: int) -> List[int]:
    """Powers of two up to ``max_batch`` (and ``max_batch`` itself): the batch
    sizes coalesced requests are padded to."""
    bs, b = [], 1
    while b < max_batch:
        bs.append(b)
        b *= 2
    bs.append(max_batch)
    return sorted(set(bs))


def warmup(synth, max_frames: Optional[int] = None, alpha: float = 1.0,
           max_batch: int = 1):
    """Run the serving path once at every (batch bucket, text bucket) shape
    the serve loop can produce, so that the kernels are built and loaded,
    the allocator has grown and cuDNN has chosen its algorithms before the
    first real request.  Returns the shapes run."""
    cfg = synth.t2v_cfg
    mf = max_frames or cfg.frame_buckets[-1]
    done = []
    for B in _batch_buckets(max_batch):
        emb = np.zeros((B, cfg.n_speaker_dim), np.float32)
        spk = np.zeros((B, synth.v2w_cfg.spk_dim), np.float32)
        for nb in cfg.text_buckets:
            # one dummy text padded to this bucket: exactly the serving
            # path's shapes (keep_device, int16 PCM on the device)
            texts = [" " * max(1, nb - 2)] * B
            out = synth.text_to_latents(texts, None, alpha=alpha, max_frames=mf,
                                        t2v_spk_emb=emb, keep_device=True)
            pcm_dev, ok = synth.latents_to_wav(
                out["feat_postnet_output"], spk, noise=_serve_noise(synth, B),
                with_finite=True, keep_device=True, pcm16=True)
            out["meta"].cpu()
            pcm_dev[:, :_wav_fetch_len(1, pcm_dev.shape[1])].cpu()
            done.append((B, nb))
    return done


@functools.lru_cache(maxsize=16)
def _serve_noise_rows(noise_dim: int, B: int, device: torch.device) -> torch.Tensor:
    """The serving noise, cached per (dim, batch, device): one row drawn from
    a CPU ``torch.Generator`` seeded 0, tiled B times and moved.  The CPU
    draw makes card and CPU serve the same noise.  It is not the JAX
    package's row (``jax.random.normal(PRNGKey(0))``): pass ``noise`` to
    ``latents_to_wav`` to reproduce that."""
    row = torch.randn((1, noise_dim), generator=torch.Generator(device="cpu").manual_seed(0))
    return row.expand(B, noise_dim).contiguous().to(device)


def _serve_noise(synth, B: int) -> torch.Tensor:
    """Per-item vocoder noise for serving: every item gets the same row, so a
    request's audio does not depend on its place in a coalesced batch."""
    return _serve_noise_rows(synth.v2w_cfg.noise_dim, B, synth.device)


def _wav_fetch_len(max_samples: int, full_len: int) -> int:
    """The smallest power of two (at least 8192 samples, 0.5 s) covering the
    batch's longest utterance, capped at the padded length: the columns of
    PCM a batch returns."""
    k = 8192
    while k < max_samples and k < full_len:
        k <<= 1
    return min(k, full_len)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: on the card a non-blocking copy into pinned
    memory (valid once the stream passes it), on the CPU ``t`` itself."""
    if t.device.type != "cuda":
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t, non_blocking=True)


def _dispatch_batch(synth, store, reqs, alpha, max_frames, pad_to=None):
    """Dispatch one batched synthesis over parsed (spk, text) requests and
    return a ``finalize()`` closure that waits for it and returns ([B, K]
    int16 PCM, K >= every emitted length, [B] sample counts, [B] finite-ok
    bools).  ``pad_to`` pads the batch (repeating the last request) to a
    batch bucket; padded rows are dropped from the result.

    The latents never leave the device; the waveform is quantized to int16
    PCM there (the wire format).  The finite flags check the full padded
    latent and waveform rows, not just the emitted samples: an overflowed
    eval-mode BatchNorm turns the durations NaN too, so ``total_frames`` can
    collapse to 0 and a check of the emitted samples alone would pass on an
    empty slice."""
    n = len(reqs)
    if pad_to is not None and pad_to > n:
        reqs = list(reqs) + [reqs[-1]] * (pad_to - n)
    texts = [t for _, t in reqs]
    t2v_embs = np.concatenate([store.t2v_emb_or_fallback(s) for s, _ in reqs], axis=0)
    voc_embs = np.stack([store.vocoder_emb(s) for s, _ in reqs], axis=0)
    out = synth.text_to_latents(texts, None, alpha=alpha, max_frames=max_frames,
                                t2v_spk_emb=t2v_embs, keep_device=True)
    pcm_dev, wav_ok = synth.latents_to_wav(
        out["feat_postnet_output"], voc_embs, noise=_serve_noise(synth, len(reqs)),
        with_finite=True, keep_device=True, pcm16=True)
    meta_h, ok_h, pcm_h = (_to_host(t) for t in (out["meta"], wav_ok, pcm_dev))
    done = None
    if pcm_dev.device.type == "cuda":
        done = torch.cuda.Event()
        done.record()

    def finalize():
        if done is not None:
            done.synchronize()
        meta = meta_h.numpy()
        total = np.clip(meta[0][:n], 0, None).astype(np.int64)
        n_samples = total * synth.v2w_cfg.total_upsample
        finite_ok = meta[1][:n].astype(bool) & ok_h.numpy()[:n]
        k = _wav_fetch_len(int(n_samples.max(initial=0)), pcm_h.shape[1])
        return pcm_h[:n, :k].numpy(), np.minimum(n_samples, k), finite_ok

    return finalize


def _synthesize_batch(synth, store, reqs, alpha, max_frames, pad_to=None):
    """Dispatch and finalize in one call (``serve_loop``'s path); see
    ``_dispatch_batch``."""
    return _dispatch_batch(synth, store, reqs, alpha, max_frames, pad_to=pad_to)()


def _to_pcm16(wav: np.ndarray) -> np.ndarray:
    """float [-1, 1] or already-quantized int16 -> int16 little-endian PCM.
    The batched path quantizes on the device; the streaming path's chunks
    are float."""
    if wav.dtype == np.int16:
        return wav.astype("<i2", copy=False)
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")


_NONFINITE_MSG = (
    "non-finite audio (eval-mode BN overflow: recalibrate the checkpoint's BN "
    "running stats with the JAX package's cli recalibrate-bn / infer/recalibrate.py)"
)


def serve_loop(synth, store: SpeakerStore, out_dir: str, default_speaker: Optional[str] = None,
               alpha: float = 1.0, max_frames: Optional[int] = None, stdin=None, stdout=None,
               do_warmup: bool = False, max_batch: int = 1, pcm: bool = False,
               stream_chunk: Optional[int] = None, coalesce_wait_ms: float = 0.0) -> int:
    """Serve requests from ``stdin`` until EOF or a ``QUIT`` line; returns the
    number of utterances served."""
    from wavthruvec_pytorch_tpu_torch.infer.synthesize import write_wav

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    # PCM mode interleaves binary audio with text control lines on one
    # binary stream; wav-file mode keeps plain text lines
    binout = getattr(stdout, "buffer", stdout) if pcm else None

    def say(line: str):
        if pcm:
            binout.write((line + "\n").encode())
            binout.flush()
        else:
            print(line, file=stdout, flush=True)

    if do_warmup:
        buckets = warmup(synth, max_frames=max_frames, alpha=alpha, max_batch=max(1, max_batch))
        say(f"WARM {buckets}")
    batch_buckets = _batch_buckets(max(1, max_batch))
    if not pcm:
        os.makedirs(out_dir, exist_ok=True)
    default_speaker = default_speaker or (store.speakers() or [None])[0]
    sv = None
    if pcm and stream_chunk:
        from wavthruvec_pytorch_tpu_torch.infer.streaming import StreamingVocoder

        sv = StreamingVocoder(synth.gen, synth.v2w_cfg, chunk_frames=int(stream_chunk))

    def respond(wav: np.ndarray, n_samp: int, n: int, dt_ms: float, b: int,
                finite_ok: bool = True):
        # a long-trained checkpoint's eval-mode BN can overflow on an outlier
        # input: a clean error, not NaN PCM or a NaN wav file
        if not finite_ok:
            say(f"ERR {_NONFINITE_MSG}")
            return
        sr = synth.v2w_cfg.sampling_rate
        if pcm:
            pcm16 = _to_pcm16(wav[:n_samp]).tobytes()
            binout.write(f"PCM {n_samp} {sr} latency={dt_ms:.1f}ms batched={b}\n".encode())
            binout.write(pcm16)
            binout.write(b"PCMEND\n")
            binout.flush()
        else:
            path = os.path.join(out_dir, f"utt_{n:06d}.wav")
            write_wav(path, wav[:n_samp], sample_rate=sr)
            say(f"OK {path} {n_samp / sr:.2f}s latency={dt_ms:.1f}ms batched={b}")

    def respond_stream(latents, spk_emb, total_frames, dt0, b: int):
        """Emit one utterance as PCM chunks (the time-to-first-audio path).

        It streams over the full padded latent buffer and trims to the true
        length, as the batched path vocodes the padded buffer and trims:
        zero-padded latents are not a sequence edge (``streaming.py``).
        ``total_frames`` is the uncapped duration sum while the buffer holds
        ``max_frames``, so the length is clipped as the batched path clips.
        Timings are client-perceived, from the batch's arrival: ``ttfa`` to
        this utterance's first audio bytes, ``latency`` to its last."""
        sr = synth.v2w_cfg.sampling_rate
        up = synth.v2w_cfg.total_upsample
        target = min(int(total_frames), latents.shape[0]) * up
        binout.write(f"PCMSTART {sr} batched={b}\n".encode())
        binout.flush()
        n_samp = 0
        ttfa_ms = None
        for chunk in sv.stream(latents[None], spk_emb[None], _serve_noise(synth, 1)):
            data = np.clip(chunk[0][: max(0, target - n_samp)], -1, 1)
            if not np.isfinite(data).all():
                # a Generator-side overflow mid-stream: close the frame with
                # an abort, not NaN PCM (np.clip keeps NaN)
                binout.write(f"PCMABORT {_NONFINITE_MSG}\n".encode())
                binout.flush()
                return
            if data.shape[0]:
                if ttfa_ms is None:
                    ttfa_ms = (time.perf_counter() - dt0) * 1e3
                pcm16 = (data * 32767.0).astype("<i2").tobytes()
                binout.write(f"PCMCHUNK {len(pcm16)}\n".encode())
                binout.write(pcm16)
                binout.flush()
                n_samp += data.shape[0]
            if n_samp >= target:
                break
        dt_ms = (time.perf_counter() - dt0) * 1e3
        assert n_samp == target
        binout.write(f"PCMEND {n_samp} latency={dt_ms:.1f}ms ttfa={ttfa_ms:.1f}ms\n".encode())
        binout.flush()

    src = _LineSource(stdin)
    n = 0
    while True:
        lines = src.take(max(1, max_batch), wait_s=coalesce_wait_ms / 1e3)
        if not lines:
            break
        saw_quit = False
        reqs = []  # (index in responses, spk, text) of the valid requests
        responses: List[Optional[str]] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if line == "QUIT":
                saw_quit = True
                break
            spk, text = line.split("|", 1) if "|" in line else (default_speaker, line)
            if spk is None:
                responses.append("ERR no speaker available")
                continue
            try:
                store.vocoder_emb(spk)  # validate the speaker before batching
            except Exception as e:
                responses.append(f"ERR {e}")
                continue
            reqs.append((len(responses), spk, text))
            responses.append(None)

        if reqs:
            t0 = time.perf_counter()
            bucket = next(b for b in batch_buckets if b >= len(reqs))
            try:
                if sv is not None:
                    # streaming: latents batched, audio chunked per item
                    padded = list(reqs) + [reqs[-1]] * (bucket - len(reqs))
                    out = synth.text_to_latents(
                        [t for _, _, t in padded], None, alpha=alpha, max_frames=max_frames,
                        t2v_spk_emb=np.concatenate(
                            [store.t2v_emb_or_fallback(s) for _, s, _ in padded], axis=0),
                        keep_device=True)
                    lat = out["feat_postnet_output"]
                    total, finite = torch.stack([
                        out["meta"][0], torch.isfinite(lat).flatten(1).all(dim=1).to(torch.int32),
                    ]).cpu().numpy()
                    for j, (slot, spk, _) in enumerate(reqs):
                        if not finite[j]:
                            responses[slot] = f"ERR {_NONFINITE_MSG}"
                            continue
                        respond_stream(lat[j], store.vocoder_emb(spk), total[j], t0, len(reqs))
                        responses[slot] = ""  # already written
                        n += 1
                else:
                    wavs, n_samples, finite_ok = _synthesize_batch(
                        synth, store, [(s, t) for _, s, t in reqs], alpha, max_frames,
                        pad_to=bucket)
                    dt_ms = (time.perf_counter() - t0) * 1e3
                    for j, (slot, _, _) in enumerate(reqs):
                        respond(wavs[j], int(n_samples[j]), n, dt_ms, len(reqs),
                                finite_ok=bool(finite_ok[j]))
                        responses[slot] = ""
                        n += 1
            except Exception as e:  # keep serving
                for slot, _, _ in reqs:
                    if responses[slot] is None:
                        responses[slot] = f"ERR {e}"

        for r in responses:
            if r:  # ERR lines (successes already wrote their output)
                say(r)
        if saw_quit:
            break
    return n
