"""Closed-loop text-to-speech serving: client threads call the program's
``SynthesisService.submit`` (``infer/http_serve.py``, without its HTTP
front end), each waiting for its answer before it sends its next request.

Set-up makes the seeded weights, the speakers (a vocoder embedding and a
reference clip each; the program computes each clip's Text2Vec embedding
once, as its speaker store caches it), starts the service and runs its own
``warmup`` over every batch and text bucket.  The measured window counts
every request submitted and answered inside it; the traced window stops
the clients, lets the device drain, profiles a few seconds of load and
drains again.  Afterwards the answers of a seeded sample of the requests
(and of the longest text) are judged by the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from reference import text2vec as ref_t2v
from reference import vocoder as ref_voc
from reference.ops import Ops, precision_flags
from wtvbench import common, compare, roofline, traffic, weights
from wtvbench import trace as tr

class Store:
    """The speakers as the service asks for them: a Text2Vec embedding
    [1, n_speaker_dim] and a vocoder embedding [spk_dim] each."""

    def __init__(self, names, t2v: np.ndarray, voc: np.ndarray):
        self.names = list(names)
        self.t2v = {n: t2v[i:i + 1] for i, n in enumerate(self.names)}
        self.voc = {n: voc[i] for i, n in enumerate(self.names)}

    def speakers(self):
        return self.names

    def vocoder_emb(self, spk):
        return self.voc[spk]

    def t2v_emb_or_fallback(self, spk):
        return self.t2v[spk]


class Load:
    """``clients`` threads in a closed loop over the request list."""

    def __init__(self, service, requests, names, clients: int, keep: set, sample_rate: int):
        self.service, self.requests, self.names = service, requests, names
        self.clients, self.keep, self.sr = clients, keep, sample_rate
        self.next = 0
        self.lock = threading.Lock()
        self.records: List[dict] = []

    def _client(self, stop: threading.Event):
        while not stop.is_set():
            with self.lock:
                req = self.requests[self.next % len(self.requests)]
                self.next += 1
            t0 = time.perf_counter()
            p = self.service.submit(self.names[req.speaker], req.text)
            p.done.wait()
            t1 = time.perf_counter()
            rec = {"index": req.index, "t0": t0, "t1": t1, "n_samples": int(p.n_samples),
                   "batched": int(p.batched), "error": p.error}
            if req.index in self.keep and p.error is None:
                rec["pcm"] = np.array(p.wav[:p.n_samples])
            with self.lock:
                self.records.append(rec)

    def run_for(self, seconds: float):
        """Run the clients for ``seconds``, then let each finish its request.
        Returns (the window's start, its end, its records)."""
        stop = threading.Event()
        self.records = []
        threads = [threading.Thread(target=self._client, args=(stop,), daemon=True)
                   for _ in range(self.clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t_end = time.perf_counter()
        stop.set()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise RuntimeError("a client never got its answer")
        return t0, t_end, self.records


def _plant(fault: str, synth) -> None:
    """Tests only: break the timed path underneath the harness."""
    if fault == "answer_altered":
        wav = synth.latents_to_wav

        def altered(*a, **k):
            pcm, ok = wav(*a, **k)
            pcm[:, :8] = 1000  # each answer's first samples overwritten where they are made
            return pcm, ok
        synth.latents_to_wav = altered
    elif fault is not None:
        raise ValueError(f"serving has no fault {fault!r}")


def peak_flops(config: dict) -> float:
    """Serving runs both stages in f32 whatever the training precision: the
    chip's f32-accurate peak (3xTF32 on the tensor cores)."""
    return roofline.PEAK_F32_TC


def run(a: common.RunArgs) -> dict:
    mix, conf, dev = a.cell.traffic, a.cell.config, a.device
    tcfg, vcfg = conf["text2vec"], conf["vec2wav"]
    t2v_state = weights.make_state(ref_t2v.param_shapes(tcfg), a.seed, dev,
                                   frozen=ref_t2v.frozen_tables(tcfg),
                                   frames_per_char=mix["frames_per_char"],
                                   duration_spread=mix["duration_spread"])
    gen_state = weights.make_state(ref_voc.generator_shapes(vcfg), a.seed + 1, dev)
    common.set_output_gain(gen_state, vcfg, mix["wav_std"], False, dev)
    spk = traffic.speaker_data(mix, tcfg["n_feat_dim"], vcfg["spk_dim"], a.seed, dev)
    requests = traffic.serve_requests(mix, tcfg["vocab_size"], a.seed)
    calibrate(t2v_state, tcfg, mix, requests, spk, dev)
    common.reset_peak(dev)  # the peak is the program's, not the calibration's
    keep = traffic.serve_checked(mix, requests, a.seed)

    from wavthruvec_pytorch_tpu_torch.infer.http_serve import SynthesisService
    from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer
    from wavthruvec_pytorch_tpu_torch.text import TextFrontend

    T2V, V2W = common.program_configs(conf)
    synth = Synthesizer(T2V, V2W, t2v_state, gen_state,
                        TextFrontend(traffic.symbols(tcfg["vocab_size"])), device=dev)
    names = [f"spk{i:03d}" for i in range(mix["speakers"])]
    store = Store(names, synth.speaker_embedding(spk["clips"]), spk["vocoder"].cpu().numpy())
    calls: List[tuple] = []  # (batch, text bucket) of each Text2Vec call
    # each text's padded length: the duration predictor's last token sees
    # the padding, so the reference pads a request as its batch was padded
    padded: Dict[str, int] = {}
    t2l = synth.text_to_latents

    def text_to_latents(texts, *args, **kw):
        out = t2l(texts, *args, **kw)
        n = _text_len(texts, T2V)
        calls.append((len(texts), n))
        for t in texts:
            padded[t] = n
        return out

    spans = tr.Spans(dev)
    synth.text_to_latents = spans.wrap("text_to_latents", text_to_latents)
    _plant(a.fault, synth)
    synth.latents_to_wav = spans.wrap("latents_to_wav", synth.latents_to_wav)
    service = SynthesisService(synth, store, max_frames=mix["max_frames"],
                               max_batch=mix["max_batch"],
                               coalesce_wait_ms=mix["coalesce_wait_ms"])
    try:
        service.warmup()
        common.sync(dev)
        load = Load(service, requests, names, mix["clients"], keep, V2W.sampling_rate)
        setup_s = common.since(a.t_start)
        out: Dict[str, object] = {}
        if a.trace:
            calls.clear()
            with tr.Window(dev, spans) as w:
                t0, t_end, records = load.run_for(mix["trace_seconds"])
            out["view"] = _view(tr.reduce(w), calls, records, conf, mix)
        else:
            t0, t_end, records = load.run_for(a.seconds)
        peak = common.peak_bytes(dev)
    finally:
        service.close()
    del synth, service
    common.free(dev)

    in_window = [r for r in records if r["t0"] <= t_end]
    answered = [r for r in in_window if r["t1"] <= t_end]
    failed = sum(r["error"] is not None for r in in_window)
    audio_s = sum(r["n_samples"] for r in answered if r["error"] is None) / V2W.sampling_rate
    lat = [(r["t1"] - r["t0"]) * 1e3 if r["error"] is None else np.inf for r in answered]
    if a.trace:
        # a closed loop that keeps the card busy: the tail is a per-layer reading
        out["view"]["counters"]["latency_p95_ms"] = (float(np.percentile(lat, 95)) if lat
                                                     else np.inf)
    out.update({
        "attempted": len(in_window), "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"setup_s": setup_s, "serve_audio_s_per_s": audio_s / (t_end - t0)},
        "readings": check(records, t_end, requests, padded, t2v_state, gen_state, spk, conf,
                          mix, a.seed, dev),
    })
    return out


def calibrate(t2v_state, tcfg, mix, requests, spk, dev) -> None:
    """Set the seeded weights' mean duration (``common.set_duration_bias``)
    over the first ``probe_texts`` requests, each with its own speaker's
    reference embedding: more than a window serves, so every seed asks for
    about the same audio."""
    probe = requests[:mix["probe_texts"]]
    with precision_flags("f32"):
        emb = ref_t2v.speaker_embedding(t2v_state, spk["clips"], tcfg, Ops())
    sp = torch.tensor([r.speaker for r in probe], device=dev)
    common.set_duration_bias(t2v_state, tcfg, [r.text for r in probe], emb[sp],
                             mix["frames_per_char"], dev)


def _text_len(texts, cfg) -> int:
    """The text bucket the program pads this batch to."""
    n = max(len(t) for t in texts) + 2
    return next((b for b in cfg.text_buckets if b >= n), cfg.text_buckets[-1])


def _view(red: dict, calls, records, conf, mix) -> dict:
    from wtvbench import flops

    tcfg, vcfg = conf["text2vec"], conf["vec2wav"]
    per_item = {N: flops.serve_item(tcfg, vcfg, N, mix["max_frames"]) for N in {n for _, n in calls}}
    done = [r for r in records if r["error"] is None]
    red["counters"] = {
        "batches": len(calls),
        "requests": len(done),
        "batch_sizes": [b for b, _ in calls],
        "batch_fill": (len(done) / sum(1.0 / r["batched"] for r in done)) if done else None,
        "flops": sum(b * per_item[n] for b, n in calls),
    }
    red["shapes"] = {"max_frames": mix["max_frames"]}
    return red


def check(records, t_end, requests, padded, t2v_state, gen_state, spk, conf, mix, seed, dev
          ) -> Dict[str, float]:
    """The readings of a seeded sample of the answered requests that kept
    their answers, the longest text among them included."""
    by_index = {r.index: r for r in requests}
    kept = [r for r in records if "pcm" in r and r["t1"] <= t_end]
    if not kept:
        return {"dur_gap_frames": np.inf, "pcm_gap_lsb": np.inf, "checked": 0}
    longest = max(kept, key=lambda r: (len(by_index[r["index"]].text), -r["index"]))
    rest = [r for r in kept if r is not longest]
    rng = np.random.default_rng(seed + 4)
    n = min(len(rest), mix["checks"] - 1)
    sample = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]
    answers = [(by_index[r["index"]], r["n_samples"], r["pcm"], padded[by_index[r["index"]].text])
               for r in sample]
    return judge(answers, t2v_state, gen_state, spk, conf, mix, dev)


def reference_answers(reqs, N, t2v_state, gen_state, spk, conf, mix, dev, mode,
                      durations=None):
    """The reference's token ids, outputs (``ref_t2v.infer``) and waveforms
    of requests ``reqs`` padded to ``N`` tokens, in precision ``mode``;
    ``durations`` replaces the reference's own rounding."""
    tcfg, vcfg = conf["text2vec"], conf["vec2wav"]
    ops = Ops(mode)
    ids = [traffic.token_ids(r.text) for r in reqs]
    ids_t = torch.zeros((len(reqs), N), dtype=torch.long, device=dev)
    for j, i in enumerate(ids):
        ids_t[j, :len(i)] = torch.tensor(i)
    sp = torch.tensor([r.speaker for r in reqs], device=dev)
    noise = serve_noise(vcfg["noise_dim"]).to(dev).expand(len(reqs), -1)
    with torch.no_grad(), precision_flags(mode):
        emb = ref_t2v.speaker_embedding(t2v_state, spk["clips"][sp], tcfg, ops)
        out = ref_t2v.infer(t2v_state, ids_t, emb, mix["max_frames"], tcfg, ops, durations)
        wav = ref_voc.generator(gen_state, out["latents"], spk["vocoder"][sp], noise, vcfg,
                                False, ops, {})
    return ids_t, out, wav


def serve_noise(noise_dim: int) -> torch.Tensor:
    """The serving noise row: the program's recipe, one draw from a CPU
    generator seeded 0, the same for every request."""
    return torch.randn((1, noise_dim), generator=torch.Generator(device="cpu").manual_seed(0))


def judge(answers, t2v_state, gen_state, spk, conf, mix, dev) -> Dict[str, float]:
    """``answers``: (request, n_samples, int16 PCM, padded text length) of
    each checked answer, judged against the reference in f32.  ``worst``
    names the requests behind each reading, for the run's log."""
    up = int(np.prod(conf["vec2wav"]["upsample_rates"]))
    cap = mix["max_frames"]
    rows = []
    by_pad: Dict[int, list] = {}
    for a in answers:
        by_pad.setdefault(a[3], []).append(a)
    blocks = [(n, group[s:s + mix["check_block"]]) for n, group in sorted(by_pad.items())
              for s in range(0, len(group), mix["check_block"])]
    for N, part in blocks:
        reqs = [r for r, _, _, _ in part]
        ids, out, wav = reference_answers(reqs, N, t2v_state, gen_state, spk, conf, mix, dev,
                                          "f32")
        durs, gaps = out["durations"].clone(), []
        for j, (_, n_samples, _, _) in enumerate(part):
            d, gap = compare.reconcile_durations(out["dp"][j], out["durations"][j], ids[j] != 0,
                                                 n_samples // up, cap)
            gaps.append(gap)
            durs[j] = d
        if any(0 < g < np.inf for g in gaps):
            _, out, wav = reference_answers(reqs, N, t2v_state, gen_state, spk, conf, mix, dev,
                                            "f32", durs)
        for j, (r, n_samples, p, _) in enumerate(part):
            frames = min(int(out["durations"][j].sum()), cap)
            pcm = np.inf if frames * up != n_samples else compare.pcm_gap(p, wav[j, :n_samples])
            rows.append((gaps[j], pcm, f"request {r.index}: {len(r.text)} characters padded to "
                         f"{N} tokens, {n_samples // up} frames"))
    worst = {"dur_gap_frames": [[d, g] for g, _, d in sorted(rows, key=lambda x: -x[0])[:3]],
             "pcm_gap_lsb": [[d, p] for _, p, d in sorted(rows, key=lambda x: -x[1])[:3]]}
    return {"dur_gap_frames": max(g for g, _, _ in rows), "pcm_gap_lsb": max(p for _, p, _ in rows),
            "checked": len(rows), "worst": worst}
