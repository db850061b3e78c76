"""The port's stdin serving loop (``infer/serve.py``) on the CPU, mirroring
``tests/test_serve.py``: the protocol, the speaker store, coalescing, PCM
mode, PCM streaming, the clip of an over-long stream, the line source's
coalescing window and the finite guards; then one request through the
port's ``serve_loop`` against the JAX package's ``serve_loop``, the same
weights and the port's serving noise injected into the JAX loop.

Tolerances: a coalesced request's PCM against the same request alone and
the streamed PCM against the batched PCM, at most 1 LSB (one float rounding
near a quantization step flips it); the PCM mode against the wav files,
exact (the same int16 from the same call).  Against JAX: the sample counts
exact, the PCM within the waveform tolerance of
``tests/test_torch_synthesize.py`` (2e-3) in LSB, plus 1.
"""

import io
import os
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.test_serve import _parse_pcm
from tests.test_torch_synthesize import SYMBOLS, T2V, V2W, models  # noqa: F401  (fixture)
from wavthruvec_pytorch_tpu.infer import serve as jserve
from wavthruvec_pytorch_tpu.infer.synthesize import Synthesizer as JSynthesizer
from wavthruvec_pytorch_tpu.text import TextFrontend as JTextFrontend
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.infer.serve import (
    SpeakerStore,
    _batch_buckets,
    _LineSource,
    _serve_noise,
    _wav_fetch_len,
    serve_loop,
    warmup,
)
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer, init_import_models
from wavthruvec_pytorch_tpu_torch.text import TextFrontend

SYMS = "PE abcdefg"
# the JAX tests' tiny serving model (tests/test_serve.py _make_synth)
T2V_TINY = dict(n_feat_dim=24, spk_channel=24, n_speaker_dim=16, vocab_size=len(SYMS),
                max_seq_len=64, encoder_dim=24, encoder_n_layer=2,
                encoder_conv1d_filter_size=48, decoder_dim=24, decoder_n_layer=2,
                decoder_conv1d_filter_size=48, duration_predictor_filter_size=16,
                text_buckets=(16,), frame_buckets=(32,))
V2W_TINY = dict(n_feat_dim=24, num_wv_feat=24, spk_dim=16, noise_dim=16,
                upsample_initial_channel=32, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 2)))
DP_BIAS = 1.0  # the random model then speaks a few frames per token at alpha 4


def make_synth() -> Synthesizer:
    t2v_cfg, v2w_cfg = Text2VecConfig(**T2V_TINY), Vec2WavConfig(**V2W_TINY)
    t2v_state, gen_state = init_import_models(t2v_cfg, v2w_cfg)
    t2v_state["length_regulator.duration_predictor.linear_layer.linear_layer.bias"] += DP_BIAS
    return Synthesizer(t2v_cfg, v2w_cfg, t2v_state, gen_state, TextFrontend(SYMS),
                       device="cpu")


def mk_speakers(tmp_path, synth, n=2, spk_dim=16, n_feat=24):
    rng = np.random.default_rng(1)
    spk_dir, ref_dir = tmp_path / "spk_emb", tmp_path / "refs"
    spk_dir.mkdir()
    for i in range(n):
        spk = f"SSB{i:04d}"
        np.save(spk_dir / f"{spk}.npy", rng.standard_normal(spk_dim).astype(np.float32))
        (ref_dir / spk).mkdir(parents=True)
        np.save(ref_dir / spk / "clip.npy",
                rng.standard_normal((1, 20, n_feat)).astype(np.float32))
    return SpeakerStore(synth, str(spk_dir), str(ref_dir))


@pytest.fixture(scope="module")
def synth():
    return make_synth()


def _run(synth, store, text, out_dir, **kw):
    stdin = io.StringIO(text)
    stdout = io.BytesIO() if kw.get("pcm") else io.StringIO()
    n = serve_loop(synth, store, str(out_dir), alpha=4.0, max_frames=32, stdin=stdin,
                   stdout=stdout, **kw)
    return n, stdout.getvalue()


def _lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_serve_loop_end_to_end(tmp_path, synth):
    store = mk_speakers(tmp_path, synth)
    assert store.speakers() == ["SSB0000", "SSB0001"]
    n, out = _run(synth, store,
                  "abc def\n"            # default speaker
                  "SSB0001|gfe abc\n"    # explicit speaker
                  "NOSUCH|oops\n"        # unknown speaker -> ERR, the loop goes on
                  "abc\n"
                  "QUIT\n"
                  "after quit\n",        # never read
                  tmp_path / "out", do_warmup=True)
    lines = out.strip().splitlines()
    assert n == 3
    assert lines[0].startswith("WARM")
    assert [line.split()[0] for line in lines[1:]] == ["OK", "OK", "ERR", "OK"]
    assert sorted(os.listdir(tmp_path / "out")) == [f"utt_{i:06d}.wav" for i in range(3)]
    # the Text2Vec speaker embedding is cached per speaker used
    assert set(store._t2v) == {"SSB0000", "SSB0001"}
    sr, wav = wavfile.read(tmp_path / "out" / "utt_000000.wav")
    assert sr == 16000 and wav.dtype == np.int16 and wav.shape[0] > 0
    assert wav.shape[0] % synth.v2w_cfg.total_upsample == 0


def test_serve_coalescing_batches_queued_requests(tmp_path, synth, monkeypatch):
    """Queued requests are synthesized as one batched call, padded to the
    next batch bucket; responses keep request order; a request's audio in
    the batch equals its audio alone."""
    store = mk_speakers(tmp_path, synth)
    calls = []
    orig = synth.text_to_latents

    def counting(texts, *args, **kwargs):
        calls.append(len(texts))
        return orig(texts, *args, **kwargs)

    monkeypatch.setattr(synth, "text_to_latents", counting)
    # the window (closed early by the EOF) lets the reader thread queue every line first
    n, out = _run(synth, store, "SSB0000|abc def\nSSB0001|gfe abc\nSSB0000|abc\nQUIT\n",
                  tmp_path / "out", max_batch=8, coalesce_wait_ms=2000.0)
    assert n == 3 and calls == [4]
    lines = out.strip().splitlines()
    assert [line.split()[0] for line in lines] == ["OK"] * 3
    assert all("batched=3" in line for line in lines)
    monkeypatch.undo()
    for i, req in enumerate(["SSB0000|abc def", "SSB0001|gfe abc", "SSB0000|abc"]):
        _run(synth, store, f"{req}\nQUIT\n", tmp_path / f"alone{i}", max_batch=1)
        _, a = wavfile.read(tmp_path / "out" / f"utt_{i:06d}.wav")
        _, b = wavfile.read(tmp_path / f"alone{i}" / "utt_000000.wav")
        assert a.shape == b.shape and _lsb(a, b) <= 1, (i, _lsb(a, b))


def test_serve_pcm_mode(tmp_path, synth):
    """``pcm=True`` writes int16 PCM blocks equal to the wav-file output."""
    store = mk_speakers(tmp_path, synth)
    n, raw = _run(synth, store, "SSB0000|abc def\nSSB0001|gfe\nQUIT\n", tmp_path / "out",
                  pcm=True)
    assert n == 2
    blocks = [(h, d) for h, d in _parse_pcm(raw) if d is not None]
    assert len(blocks) == 2 and all(h.startswith("PCM ") for h, _ in blocks)
    _run(synth, store, "SSB0000|abc def\nQUIT\n", tmp_path / "wav")
    _, wav = wavfile.read(tmp_path / "wav" / "utt_000000.wav")
    assert wav.dtype == np.int16
    np.testing.assert_array_equal(blocks[0][1], wav)


def test_serve_pcm_streaming_chunks(tmp_path, synth):
    """``stream_chunk`` frames the audio into PCMCHUNKs that concatenate to
    the utterance, within 1 LSB of the batched PCM."""
    store = mk_speakers(tmp_path, synth)
    n, raw = _run(synth, store, "SSB0000|abc def\nQUIT\n", tmp_path / "out", pcm=True,
                  stream_chunk=8)
    assert n == 1 and raw.count(b"PCMCHUNK ") >= 2
    header, data = [(h, d) for h, d in _parse_pcm(raw) if d is not None][0]
    assert header.startswith("PCMEND ") and "ttfa=" in header
    _, raw2 = _run(synth, store, "SSB0000|abc def\nQUIT\n", tmp_path / "out2", pcm=True)
    _, full = [(h, d) for h, d in _parse_pcm(raw2) if d is not None][0]
    assert data.shape == full.shape and _lsb(data, full) <= 1


def test_serve_stream_clips_overlong_utterance(tmp_path, synth):
    """A text whose duration sum exceeds max_frames streams the capped
    audio: total_frames is uncapped while the latent buffer holds
    max_frames."""
    store = mk_speakers(tmp_path, synth)
    out = synth.text_to_latents(["abc def abcde"], None, alpha=64.0, max_frames=32,
                                t2v_spk_emb=store.t2v_emb_or_fallback("SSB0000"))
    assert out["total_frames"][0] > 32  # the case under test
    stdout = io.BytesIO()
    n = serve_loop(synth, store, str(tmp_path / "out"), alpha=64.0, max_frames=32,
                   stdin=io.StringIO("SSB0000|abc def abcde\nQUIT\n"), stdout=stdout, pcm=True,
                   stream_chunk=8)
    raw = stdout.getvalue()
    assert n == 1 and b"ERR" not in raw and b"PCMABORT" not in raw
    _, data = [(h, d) for h, d in _parse_pcm(raw) if d is not None][0]
    assert data.shape[0] == 32 * synth.v2w_cfg.total_upsample


def test_line_source_coalescing_window():
    """``take(wait_s=...)`` keeps the window open for lines that arrive soon
    after the first, and closes early at max_n."""

    def trickle():
        yield "a\n"
        time.sleep(0.05)
        yield "b\n"
        time.sleep(0.05)
        yield "c\n"
        time.sleep(1.0)
        yield "d\n"

    src = _LineSource(trickle())
    assert src.take(8, wait_s=0.5) == ["a\n", "b\n", "c\n"]
    assert src.take(8, wait_s=0.0) == ["d\n"]
    assert src.take(8) == []  # EOF
    src2 = _LineSource(iter(["x\n", "y\n"]))
    time.sleep(0.05)
    t0 = time.perf_counter()
    assert src2.take(2, wait_s=2.0) == ["x\n", "y\n"]
    assert time.perf_counter() - t0 < 1.0


def test_buckets_warmup_and_fetch_len(synth):
    assert _batch_buckets(1) == [1] and _batch_buckets(8) == [1, 2, 4, 8]
    assert _batch_buckets(6) == [1, 2, 4, 6]
    assert warmup(synth, max_frames=32, alpha=4.0, max_batch=4) == [(1, 16), (2, 16), (4, 16)]
    assert _wav_fetch_len(1, 10_000) == 8192
    assert _wav_fetch_len(8193, 100_000) == 16384
    assert _wav_fetch_len(50_000, 20_000) == 20_000


def test_serve_noise_is_one_seeded_row(synth):
    """Every item gets the same row, drawn from a CPU torch.Generator seeded
    0, whatever the batch size."""
    row = torch.randn((1, 16), generator=torch.Generator().manual_seed(0))
    for B in (1, 3, 8):
        noise = _serve_noise(synth, B)
        assert noise.shape == (B, 16) and noise.device.type == "cpu"
        torch.testing.assert_close(noise, row.expand(B, 16), rtol=0, atol=0)


def test_serve_finite_guards(tmp_path):
    """A Generator that writes NaN gives ``ERR non-finite audio``, in the
    batched path and (as ``PCMABORT``) in the streamed one; the loop goes
    on serving."""
    synth = make_synth()
    store = mk_speakers(tmp_path, synth)
    with torch.no_grad():
        synth.gen.conv_post.bias.fill_(float("nan"))
    n, out = _run(synth, store, "SSB0000|abc\nSSB0001|gfe\nQUIT\n", tmp_path / "out")
    lines = out.strip().splitlines()
    assert n == 2 and [line.split()[0] for line in lines] == ["ERR", "ERR"]
    assert all("non-finite audio" in line for line in lines)
    n, raw = _run(synth, store, "SSB0000|abc\nQUIT\n", tmp_path / "out", pcm=True,
                  stream_chunk=8)
    assert b"PCMABORT non-finite audio" in raw
    # non-finite latents are caught before the vocoder
    with torch.no_grad():
        synth.t2v.last_linear.linear_layer.bias.fill_(float("nan"))
    n, raw = _run(synth, store, "SSB0000|abc\nQUIT\n", tmp_path / "out", pcm=True,
                  stream_chunk=8)
    assert raw.decode().startswith("ERR non-finite audio") and b"PCMSTART" not in raw


def test_serve_loop_matches_jax(tmp_path, models, monkeypatch):
    """One request through the port's serve_loop and the JAX package's, on
    the same weights (``tests/test_torch_synthesize.py``'s model, whose JAX
    BiGRU takes the port's numerics), the port's serving noise injected into
    the JAX loop."""
    jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars, t2v_sd, gen_sd = models
    port = Synthesizer(Text2VecConfig(**T2V), Vec2WavConfig(**V2W), t2v_sd, gen_sd,
                       TextFrontend(SYMBOLS), device="cpu")
    jsyn = JSynthesizer(jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars, JTextFrontend(SYMBOLS))
    store = mk_speakers(tmp_path, port, n=1, spk_dim=8, n_feat=128)
    jstore = jserve.SpeakerStore(jsyn, store.spk_emb_dir, store.ref_feat_dir)
    monkeypatch.setattr(jserve, "_serve_noise",
                        lambda s, B: _serve_noise(port, B).numpy())
    text = "SSB0000|hij klmnopq rst\nQUIT\n"
    outs = {}
    for name, (loop, syn, st) in {"port": (serve_loop, port, store),
                                  "jax": (jserve.serve_loop, jsyn, jstore)}.items():
        stdout = io.BytesIO()
        n = loop(syn, st, str(tmp_path / name), alpha=1.3, max_frames=96, pcm=True,
                 stdin=io.StringIO(text), stdout=stdout)
        assert n == 1
        (header, pcm), = [(h, d) for h, d in _parse_pcm(stdout.getvalue()) if d is not None]
        outs[name] = (int(header.split()[1]), pcm)
    (n_port, pcm_port), (n_jax, pcm_jax) = outs["port"], outs["jax"]
    assert n_port == n_jax > 0
    diff = _lsb(pcm_port, pcm_jax)
    print(f"serve_loop port vs JAX: {n_port} samples, max {diff} LSB")
    assert diff <= int(2e-3 * 32767) + 1
