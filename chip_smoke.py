#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``wavthruvec_pytorch_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

It fails (exit code 1) when PyTorch sees no CUDA device, and every phase
below is fatal: nothing is caught.

1. Card and build: prints ``nvidia-smi``'s name and power limit, builds the
   CUDA kernels under ``wavthruvec_pytorch_tpu_torch/csrc/`` with ``nvcc``
   (one process per source, all at once) and prints the build seconds and
   ``ptxas``'s register report.
2. Models: the full-size configs ``data/demo/text2vec.json`` (1024-d
   latents, 448-d FFT stacks, ECAPA C = 1024, CBHG H = 1024) and
   ``data/demo/vec2wav.json`` (512-channel Generator, x320) with seeded random
   weights.  Two weights are set so that the random model behaves like a
   trained one at the edges: the duration predictor's output bias speaks
   about ``FRAMES_PER_CHAR`` latent frames per character, and ``conv_post``'s
   gain is set so that, on a probe input, the waveform before the tanh has
   a standard deviation of ``WAV_STD``: inside tanh's linear range, as
   speech is, rather than saturated or nearly constant.
3. Serving: four requests through the port's ``Synthesizer`` (a warm-up pass
   first), with the demo speaker's reference clip and speaker embedding:
   B = 1 at 512 frames, B = 1 at 3000 frames (the largest frame bucket), and
   B = 2 mixed lengths at 1024 frames, once as float and once as pcm16.
   Each request runs ``REPEATS`` times; prints its median time (CUDA
   events; the host clock agrees, since a request ends in a host copy) and
   realtime factor.  Then one
   call of the port's ``entry()`` (its own seeded models, 256 frames).
4. Launch counters, set to 0 just before phase 3: every Generator forward
   launches the fused ResBlock2 kernel 30 times, every Text2Vec forward the
   BiGRU kernel once.
5. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (the 512-frame request's for the fused unit; B in {1, 2},
   T in {512, 3000} for the BiGRU), with the times of the kernel, the plain
   version and one PyTorch library call that computes the same function.
6. The full-size path on the card against the same path on the CPU (the
   kernels' plain versions) on a small request.
7. Where the time of the 512-frame request goes, by stage (CUDA events
   from forward hooks) and by kernel (``torch.profiler``).

Every float32 product and convolution in this run is full float32: TF32 is
off for matmuls and cuDNN.  The second-to-last line is a JSON object with
one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from wavthruvec_pytorch_tpu_torch.config import (
    Text2VecConfig,
    Vec2WavConfig,
    load_config,
    repo_path,
)
from wavthruvec_pytorch_tpu_torch.entry import entry
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import LRELU_SLOPE, Generator
from wavthruvec_pytorch_tpu_torch.ops import kernel_build
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import (
    conv_residual_plain,
    fused_conv_residual,
)
from wavthruvec_pytorch_tpu_torch.ops.gru import gru_fwd, gru_fwd_plain
from wavthruvec_pytorch_tpu_torch.text import TextFrontend

SEED = 0
FRAMES_PER_CHAR = 8.0  # ~0.16 s of speech per character at 50 latent frames/s
WAV_STD = 0.3
REPEATS = 3  # timed runs of each request; its median is reported
SAMPLE_RATE = 16000

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, bf16
# tensor cores, HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# tolerances of the kernel-vs-plain checks on the card
FUSED_ATOL = 1e-4  # f32 both sides, k*C-term sums in another order
GRU_ATOL = 1e-3    # same bf16 rounding both sides; a 1-ulp bf16 flip of h
                   # from a different f32 sum order propagates through T steps
# the full path on the card against the CPU on a small request
LATENT_ATOL = 1e-3
WAV_ATOL = 2e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    """Least time for the work: the larger of bytes over HBM bandwidth and
    operations over the peak rate; returns (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    t0 = time.perf_counter()
    kernel_build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(kernel_build.KERNELS)}")
    for name in kernel_build.KERNELS:
        for line in kernel_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def make_synthesizer(dev):
    t2v_cfg = load_config(Text2VecConfig, repo_path("data", "demo", "text2vec.json"))
    v2w_cfg = load_config(Vec2WavConfig, repo_path("data", "demo", "vec2wav.json"))
    torch.manual_seed(SEED)
    t2v = Text2Vec(t2v_cfg, device=dev)
    gen = Generator(v2w_cfg, device=dev)
    t2v.length_regulator.duration_predictor.linear_layer.linear_layer.bias.add_(FRAMES_PER_CHAR)
    frontend = TextFrontend.from_vocab_file(repo_path(t2v_cfg.vocab_path))
    check(frontend.vocab_size == t2v_cfg.vocab_size, "vocab size differs from the config")
    syn = Synthesizer(t2v_cfg, v2w_cfg, t2v.state_dict(), gen.state_dict(), frontend, device=dev)

    # conv_post's output without its bias, on random latents with the demo
    # speaker and the noise a B = 1 request draws (the random Generator's
    # scale depends on the noise far more than on the latents)
    latents = torch.randn((1, 64, v2w_cfg.n_feat_dim),
                          generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    seen = {}
    hook = syn.gen.conv_post.register_forward_hook(
        lambda mod, args, out: seen.update(std=(out - mod.bias).std().item()))
    syn.gen(latents, torch.as_tensor(demo_speaker(), device=dev), syn._noise(1, SEED))
    hook.remove()
    check(seen["std"] > 0, "the random Generator's output does not depend on its input")
    syn.gen.conv_post.weight_g.mul_(WAV_STD / seen["std"])
    print(f"conv_post gain scaled by {WAV_STD / seen['std']:.3g} (probe std {seen['std']:.3g})")
    n_params = sum(p.numel() for m in (syn.t2v, syn.gen) for p in m.parameters())
    print(f"models: Text2Vec + Generator at full size, {n_params / 1e6:.1f} M parameters")
    return syn


def demo_inputs(syn):
    rng = np.random.default_rng(SEED)
    chars = list(syn.frontend.symbols[3:])  # past the "PE " pad/eos/space symbols

    def text(n):
        return "".join(rng.choice(chars, size=n))

    ref = np.load(repo_path("data", "demo", "w2v_feat", "train", "SSB0000", "u0.npy"))
    return text, ref.astype(np.float32), demo_speaker()


def demo_speaker() -> np.ndarray:
    """The demo speaker's embedding, [1, spk_dim] float32."""
    return np.load(repo_path("data", "demo", "spk_emb", "SSB0000.npy"))[None].astype(np.float32)


def serve(syn):
    text, ref, spk = demo_inputs(syn)
    t2 = [text(60), text(25)]
    requests = [
        ("b1_f512", [text(40)], 512, False),
        ("b1_f3000", [text(120)], 3000, False),
        ("b2_f1024", t2, 1024, False),
        ("b2_f1024_pcm16", t2, 1024, True),
    ]

    def run(texts, max_frames, pcm16):
        B = len(texts)
        return syn.synthesize(texts, np.repeat(ref, B, 0), np.repeat(spk, B, 0),
                              max_frames=max_frames, seed=SEED, pcm16=pcm16)

    for _, texts, max_frames, pcm16 in requests:  # warm-up: allocator, cuDNN, kernel loads
        run(texts, max_frames, pcm16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_conv_residual.launches = 0
    gru_fwd.launches = gru_fwd.step_launches = 0
    wavs = {}
    for name, texts, max_frames, pcm16 in requests:
        times = []
        for _ in range(REPEATS):
            f0, g0 = fused_conv_residual.launches, gru_fwd.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            wav, n_samples = run(texts, max_frames, pcm16)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            check(fused_conv_residual.launches - f0 == 30,
                  f"{name}: {fused_conv_residual.launches - f0} fused ResBlock2 launches, not 30")
            check(gru_fwd.launches - g0 == 1,
                  f"{name}: {gru_fwd.launches - g0} BiGRU launches, not 1")
        ms = float(np.median(times))
        B = len(texts)
        frames = n_samples // syn.v2w_cfg.total_upsample
        check(wav.shape == (B, max_frames * syn.v2w_cfg.total_upsample),
              f"{name}: wav shape {wav.shape}")
        check(wav.dtype == (np.int16 if pcm16 else np.float32), f"{name}: dtype {wav.dtype}")
        if not pcm16:
            check(bool(np.isfinite(wav).all()), f"{name}: non-finite audio")
        check(bool((frames > 0).all() and (frames <= max_frames).all()),
              f"{name}: total_frames {frames} outside (0, {max_frames}]")
        wavs[name] = wav
        audio_s = float(n_samples.sum()) / SAMPLE_RATE
        print(f"request {name}: B={B} max_frames={max_frames} total_frames={frames.tolist()} "
              f"median {ms:.2f} ms of {REPEATS} (min {min(times):.2f}, max {max(times):.2f}), "
              f"{audio_s:.2f} s of speech, realtime factor {audio_s / (ms / 1e3):.1f}, "
              f"wav std {wav.std() / (32767.0 if pcm16 else 1.0):.3f}")
    print(f"serving peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # pcm16 is the float waveform clipped, scaled and truncated toward zero
    want = (np.clip(wavs["b2_f1024"], -1.0, 1.0) * 32767.0).astype(np.int16)
    diff = np.abs(wavs["b2_f1024_pcm16"].astype(np.int32) - want.astype(np.int32)).max()
    check(diff <= 1, f"pcm16 differs from the float waveform by {diff} steps")

    # the port's entry(): its own seeded full-size models (the default
    # configs) and inputs, text -> latents -> wav at B = 1 over 256 frames
    f0, g0 = fused_conv_residual.launches, gru_fwd.launches
    fn, args = entry()
    wav, total = fn(*args)
    torch.cuda.synchronize()
    check(tuple(wav.shape) == (1, 256 * 320) and bool(torch.isfinite(wav).all()),
          f"entry(): wav {tuple(wav.shape)}")
    check(fused_conv_residual.launches - f0 == 30 and gru_fwd.launches - g0 == 1,
          "entry(): launch counts")
    print(f"entry(): wav {tuple(wav.shape)}, total_frames {total.tolist()}")

    launches = dict(fused_resblock=fused_conv_residual.launches, gru_fwd=gru_fwd.launches,
                    gru_fwd_steps=gru_fwd.step_launches)
    n_forwards = REPEATS * len(requests) + 1
    check(launches["fused_resblock"] == 30 * n_forwards, f"launch counts {launches}")
    check(launches["gru_fwd"] == n_forwards, f"launch counts {launches}")
    print(f"launches on the main path: {launches}")
    return launches


def fused_unit_cases(syn, frames: int):
    """(stage, C, T, k, d, conv) of every ResBlock2 unit of one Generator
    forward over ``frames`` latent frames at B = 1."""
    cfg = syn.v2w_cfg
    T = frames
    cases = []
    for i, u in enumerate(cfg.upsample_rates):
        T *= u
        C = cfg.upsample_initial_channel // 2 ** (i + 1)
        for j in range(len(cfg.resblock_kernel_sizes)):
            block = syn.gen.resblocks[i * len(cfg.resblock_kernel_sizes) + j]
            for conv, d in zip(block.convs, block.dilations):
                cases.append((i, C, T, conv.weight_v.shape[-1], d, conv))
    return cases


def check_fused(syn, frames: int = 512):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, err=0.0)
    print(f"fused ResBlock2 unit, kernel vs plain (atol {FUSED_ATOL}), B=1, {frames} frames:")
    for stage, C, T, k, d, conv in fused_unit_cases(syn, frames):
        w_t = conv.weight()  # [C_out, C_in, k]
        w = w_t.permute(2, 1, 0).contiguous()
        b = conv.bias
        x = torch.randn((1, T, C), generator=g, device="cuda")
        got = fused_conv_residual(x, w, b, dilation=d, neg_slope=LRELU_SLOPE)
        want = conv_residual_plain(x, w, b, dilation=d, neg_slope=LRELU_SLOPE)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= FUSED_ATOL, f"fused unit C={C} T={T} k={k} d={d}: max |err| {err:.3g}")
        pad = (k * d - d) // 2
        xa = F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2).contiguous()
        reps = 10
        ms = cuda_ms(lambda: fused_conv_residual(x, w, b, dilation=d, neg_slope=LRELU_SLOPE), reps)
        plain = cuda_ms(lambda: conv_residual_plain(x, w, b, dilation=d, neg_slope=LRELU_SLOPE),
                        reps)
        lib = cuda_ms(lambda: F.conv1d(xa, w_t, b, padding=pad, dilation=d), reps)
        n_ops = 2.0 * k * C * C * T
        n_bytes = 4.0 * (2 * T * C + k * C * C + C)
        bms, by = bound_ms(n_bytes, n_ops, PEAK_F32)
        print(f"  stage {stage} C={C:3d} T={T:6d} k={k:2d} d={d}: err {err:.2e}  kernel {ms:.3f} ms"
              f"  plain {plain:.3f} ms  conv1d {lib:.3f} ms  bound {bms:.3f} ms ({by})"
              f"  {n_ops / ms / 1e9:.1f} TFLOP/s")
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += n_bytes
        tot["ops"] += n_ops
        tot["err"] = max(tot["err"], err)
    bms, by = bound_ms(tot["bytes"], tot["ops"], PEAK_F32)
    print(f"  30 units: kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"conv1d {tot['library_ms']:.3f} ms, bound {bms:.3f} ms ({by}), "
          f"{tot['ops'] / 1e9:.1f} GFLOP")
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms,
                bound_by=by, library_ms=tot["library_ms"])


def check_gru(syn):
    bigru = syn.t2v.postnet.gru
    H = bigru.hidden_size
    lib_gru = torch.nn.GRU(H, H, batch_first=True, bidirectional=True, device="cuda")
    lib_gru.load_state_dict(bigru.state_dict(), strict=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    first = None
    print(f"BiGRU recurrence, kernel vs plain (atol {GRU_ATOL}), D=2, H={H}:")
    for B, T in ((1, 512), (2, 512), (1, 3000), (2, 3000)):
        x = torch.randn((B, T, H), generator=g, device="cuda")
        gi, w_hh, b_hh = bigru.recurrence_inputs(x)
        got = gru_fwd(gi, w_hh, b_hh)
        want = gru_fwd_plain(gi, w_hh, b_hh)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= GRU_ATOL, f"BiGRU B={B} T={T}: max |err| {err:.3g}")
        ms = cuda_ms(lambda: gru_fwd(gi, w_hh, b_hh), 3)
        plain = cuda_ms(lambda: gru_fwd_plain(gi, w_hh, b_hh), 1, warmup=0)
        lib = cuda_ms(lambda: lib_gru(x), 3)
        D, H3 = gi.shape[0], gi.shape[-1]
        n_bytes = 4.0 * gi.numel() + 2.0 * w_hh.numel() + 4.0 * b_hh.numel() + 4.0 * D * B * T * H
        n_ops = 2.0 * D * B * T * H * H3
        bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16)
        print(f"  B={B} T={T:4d}: err {err:.2e}  kernel {ms:.3f} ms ({1e3 * ms / T:.2f} us/step)"
              f"  plain {plain:.3f} ms  cuDNN nn.GRU {lib:.3f} ms  bound {bms:.4f} ms ({by})")
        if first is None:  # the 512-frame request's shape goes into the summary line
            first = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=lib)
        first["max_abs_err"] = max(first["max_abs_err"], err)
    return first


def check_against_cpu(syn):
    """The full-size path on the card against the same weights on the CPU,
    where both kernels take their plain versions."""
    cpu = Synthesizer(syn.t2v_cfg, syn.v2w_cfg,
                      {k: v.cpu() for k, v in syn.t2v.state_dict().items()},
                      {k: v.cpu() for k, v in syn.gen.state_dict().items()},
                      syn.frontend, device="cpu")
    text, ref, spk = demo_inputs(syn)
    texts = [text(4)]
    kw = dict(max_frames=64, noise=syn._noise(1, SEED).cpu().numpy())  # the card's draw, on both
    lat_gpu = syn.text_to_latents(texts, ref, max_frames=64)
    lat_cpu = cpu.text_to_latents(texts, ref, max_frames=64)
    check(np.array_equal(lat_gpu["total_frames"], lat_cpu["total_frames"]),
          f"total_frames {lat_gpu['total_frames']} on the card, {lat_cpu['total_frames']} on the CPU")
    lat_err = float(np.abs(lat_gpu["feat_postnet_output"] - lat_cpu["feat_postnet_output"]).max())
    check(lat_err <= LATENT_ATOL, f"latents differ from the CPU by {lat_err:.3g}")
    wav_gpu, n_gpu = syn.synthesize(texts, ref, spk, **kw)
    wav_cpu, n_cpu = cpu.synthesize(texts, ref, spk, **kw)
    wav_err = float(np.abs(wav_gpu - wav_cpu).max())
    check(np.array_equal(n_gpu, n_cpu) and wav_err <= WAV_ATOL,
          f"waveform differs from the CPU by {wav_err:.3g}")
    print(f"card vs CPU, full size, 64 frames: total_frames {lat_gpu['total_frames'].tolist()}, "
          f"latents max |err| {lat_err:.2e} (atol {LATENT_ATOL}), "
          f"wav max |err| {wav_err:.2e} (atol {WAV_ATOL}), wav max |y| {np.abs(wav_gpu).max():.3f}, "
          f"std {wav_gpu.std():.3f}")


def profile_request(syn, max_frames: int = 512) -> None:
    """Where the time of one B = 1 request goes.  After a warm-up the request
    runs plain (``REPEATS`` times; the median is the reference),
    with forward hooks that record CUDA events around each stage (the hooks'
    own host work stretches that run), and under ``torch.profiler`` for the
    kernels' device time and launch count."""
    text, ref, spk = demo_inputs(syn)
    texts = [text(40)]
    t2v, gen = syn.t2v, syn.gen
    stages = {
        "ECAPA speaker encoder": [t2v.encoder.speaker_encoder],
        "encoder FFT blocks": list(t2v.encoder.layer_stack),
        "duration predictor": [t2v.length_regulator.duration_predictor],
        "decoder FFT blocks": list(t2v.decoder.layer_stack),
        "CBHG postnet (all)": [t2v.postnet],
        "CBHG BiGRU (input projection + recurrence)": [t2v.postnet.gru],
        "Generator conv_pre + conv_post": [gen.conv_pre, gen.conv_post],
        "Generator upsampling + CBN": list(gen.ups) + list(gen.cbns),
        "Generator ResBlock2 (fused units)": list(gen.resblocks),
    }
    def request():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out, _ = syn._latents(texts, ref, 1.0, max_frames, None)
        ev[1].record()
        syn._wav(out["feat_postnet_output"], spk, None, SEED, False)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    request()  # warm-up
    runs = sorted((request() for _ in range(REPEATS)), key=sum)
    t2v_ms, gen_ms = runs[len(runs) // 2]
    total = t2v_ms + gen_ms
    print(f"profile, B=1, {max_frames} frames: Text2Vec {t2v_ms:.3f} ms, Generator {gen_ms:.3f} ms "
          f"(CUDA events, no instrumentation, the median of {REPEATS} runs)")

    marks, hooks = [], []
    for label, mods in stages.items():
        for m in mods:
            def pre(mod, args, label=label):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((label, ev, None))

            def post(mod, args, out, label=label):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                i = max(i for i, (lb, _, e) in enumerate(marks) if lb == label and e is None)
                marks[i] = (label, marks[i][1], ev)
            hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    hooked = sum(request())
    for h in hooks:
        h.remove()
    print(f"  stages, with hooks ({hooked:.3f} ms in all):")
    for label in stages:
        ms = sum(a.elapsed_time(b) for lb, a, b in marks if lb == label)
        print(f"    {label}: {ms:.3f} ms ({100 * ms / hooked:.1f}%)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        request()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    print(f"  torch.profiler: {n_launch} kernel launches of {len(kernels)} kernels, device busy "
          f"{busy_ms:.3f} ms = {100 * busy_ms / total:.1f}% of the uninstrumented {total:.3f} ms "
          f"request (the rest is idle, waiting on the host)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:5d}  {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_kernels()

    with torch.inference_mode():
        syn = make_synthesizer(dev)
        launches = serve(syn)
        fused = check_fused(syn)
        gru = check_gru(syn)
        check_against_cpu(syn)
        profile_request(syn)

    kernels = [
        dict(name="fused_resblock", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/fused_resblock.cu",
             replaces="wavthruvec_pytorch_tpu/ops/fused_resblock.py:29",
             launches=launches["fused_resblock"], **fused),
        dict(name="gru_fwd", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/gru_fwd.cu",
             replaces="wavthruvec_pytorch_tpu/ops/gru_pallas.py:41",
             launches=launches["gru_fwd"], **gru),
    ]
    for kern in kernels:
        check(all(math.isfinite(kern[key]) for key in ("ms", "plain_ms", "bound_ms")),
              f"{kern['name']}: non-finite time")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
