#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``wavthruvec_pytorch_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

It fails (exit code 1) when PyTorch sees no CUDA device, and every phase
below is fatal: nothing is caught.

1. Card and build: prints ``nvidia-smi``'s name and power limit, builds the
   CUDA kernels under ``wavthruvec_pytorch_tpu_torch/csrc/`` with ``nvcc``
   (one process per source, all at once) and prints the build seconds and
   ``ptxas``'s register report and warnings.
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
   realtime factor.  The demo config's ``gru_impl`` is "scan" (JAX's
   default), so its BiGRU runs the f32 kernel; a "pallas" copy of the config
   (the same weights) serves each request once more through the bf16 kernel
   (JAX's gate admits B <= 28 at H = 1024), and the distance between the two
   waveforms is printed.  Then one call of the port's ``entry()`` (its own
   seeded models, 256 frames, the f32 BiGRU).
4. Launch counters, set to 0 just before phase 3: every Generator forward
   launches the fused ResBlock2 kernel 30 times, every Text2Vec forward the
   BiGRU kernel of its numerics once, in one device launch (its persistent
   route), and the step launches that saves are printed.
5. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the times of the kernel, the plain version and one
   PyTorch library call that computes the same function, and ``ptxas``'s
   report of both kernels (neither may spill).  The fused unit (3xTF32 on
   the tensor cores) at each of the 512-frame request's 30 units, with its
   bound at the CUDA cores' f32 rate and at 3xTF32's, and at
   ``FUSED_EDGES`` (a width that is no multiple of 4, kernel sizes built
   with k at run time, B = 2).  The BiGRU's two kernels, bf16 (gru_impl
   "pallas") and f32 ("scan"), at (B, T) in ``GRU_SHAPES``: serving,
   training and the long bucket, on the persistent route and, timed in
   turns in the same run, on the one-launch-a-step route, with the serial
   floor (T steps of the persistent grid running its barriers and nothing
   else) beside the byte and operation bounds, the plain version's time
   and cuDNN's f32 ``nn.GRU`` (TF32 off); and the f32 kernel at
   ``GRU_GATE_SHAPE`` (B = 32), where JAX's gate sends "pallas" to f32 too.
6. The full-size path on the card against the same path on the CPU (the
   kernels' plain versions) on a small request.
7. Where the time of the 512-frame request goes, by stage (CUDA events
   from forward hooks) and by kernel (``torch.profiler``).

Then the Text2Vec training slice, on the same full-size Text2Vec config:

8. Training: a ``Text2VecTrainer`` with seeded random weights takes
   ``WARMUP_STEPS`` then ``TIMED_STEPS`` LAMB steps on one synthetic batch
   (B = 16, text bucket 64, frame bucket 1024: mixed lengths, seeded
   1024-d features, beta-binomial priors from the port's ``data/prior.py``,
   dropout 0.1).  Prints the median step (CUDA events), frames trained per
   second, peak device memory and the losses; every loss must be finite and
   the total loss must fall over the repeated batch.  Counters, set to 0
   just before the timed steps: one MAS launch, one BiGRU forward launch
   and one BiGRU backward kernel launch per step (each one device launch:
   both take their persistent route; every read of the counters checks the
   backward's).  Then ``text2vec_loop.main`` trains 3 steps on the demo
   corpus (``data/demo/text2vec.json``; its run directory under a temporary
   one).
9. The MAS kernel against its plain version, variable lengths, exact
   zeros in the valid region, the hard maps equal in every cell: at
   (B, T, N) = (16, 1024, 64) (the training step's), (16, 3000, 128),
   (4, 300, 300) and (16, 3072, 768) (the long bucket's), timed, with the
   bytes bound and the serial floor (the longest item's rows times one
   row's dependent step, from ``mas_row_chain``); and at the edges: N = 1,
   N = 1024 at (16, 3072), T = 1, a batch with out_len 0, in_len 0 and
   in_len > out_len items, and the "sharp" input, whose best path runs
   through exact zeros and leaves the map.
10. The BiGRU backward: ``ptxas``'s report of its kernel (the persistent
    one may not spill); the kernel's reverse loop against its plain version
    (``gru_bwd_loop_plain``, max |err| / max |plain| of dgi and dgh within
    ``GRU_BWD_LOOP_RTOL``) on both routes at (B, T) in ``GRU_BWD_SHAPES``
    ((2, 512) and the three training shapes, inputs from the BiGRU's own f32
    forward), with the loop's time on the persistent route and on the
    one-launch-a-step route in turns, its serial floor (the persistent grid
    running barriers only), its bound, the plain loop's time, the whole
    backward (gh, the loop, dw_hh and db_hh) with the kernel and with the
    plain loop, and cuDNN ``nn.GRU``'s (f32) backward alone (on a retained
    graph) and forward + backward, the library yardstick; then the whole
    backward on the card against ``gru_bwd_plain`` on the CPU (B = 2,
    T = 512, H = 1024).
11. One training step on the card against the CPU: seeded full-size
    weights, one small batch (B = 8), dropout 0.  Hard alignments and
    durations equal, losses and gradients within stated tolerances.
12. Where a training step's time goes: forward, backward and optimizer
    (CUDA events), the MAS kernel, the BiGRU forward kernel and the BiGRU
    backward (its loop kernel alone and with the matmuls around it) at the
    step's shapes, and ``torch.profiler``'s device
    busy share (kernel events only: user annotations' GPU spans left out) and
    launch count.

Then the long-bucket bf16 slice: the JAX package's own long-bucket training
config ``artifacts/flash_longbucket/flash/longbucket/config.json`` (the
full-size model, ``compute_dtype`` bfloat16, ``flash_attention``, dropout 0,
text bucket 768, frame bucket 3072), read where it lies:

13. The flash kernels against their plain version on the card: the forward
    (``out`` and ``lse``) in bf16 at the step's decoder [16, 2, 3072, 224]
    and encoder [16, 2, 768, 224] shapes and in f32 at the serving shapes
    [1, 2, 3072 | 768, 224]; dK/dV and dQ against autograd of the plain
    version, in bf16 and in f32, at B = 2 of the decoder shape and at the
    encoder's full shape; each with its time, TFLOP/s, share of its bound
    (f32: on the tensor cores at f32 accuracy, three TF32 products a
    product) and ``F.scaled_dot_product_attention``'s time (the same boolean
    mask; forward, forward + backward, and the backward alone on a retained
    graph).  The backward kernels are timed as the backward calls them,
    after one shared ``backward_inputs`` (timed apart), and their sum
    against SDPA's backward.  Kernels and SDPA are timed on a filled launch
    queue, so their times are the device's, not the host's issue rate.
    Three more cases in each dtype hold the forward and both backward
    kernels at the edges: T = 384 with a length of 201 (a 128-query tile
    straddles the real/pad boundary), T = 320 (the last 128-query tile is
    half outside) and T = 256 (the shortest length the model's gate
    passes); and head dims 64, 128, 256 and 96 (run zero-padded to 128) at
    T = 384: the forward in bf16, the backward in both dtypes.  The f32
    backward kernels (3xTF32 ``mma.sync``) print their TFLOP/s and share of
    the 3xTF32 bound at both shapes beside SDPA's f32 backward.  ``ptxas``'s
    register and spill report of every instance of the Hopper and
    tensor-core kernels is printed again; the bf16 dQ and every f32
    instance (forward, dK/dV, dQ) must not spill.
14. Training: ``Text2VecTrainer`` (bf16) takes ``WARMUP_STEPS`` then
    ``TIMED_STEPS`` steps on one synthetic batch at B = 16, N = 768,
    T = 3072 (3-4 frames per character); counters, set to 0 just before the
    timed steps: per step 8 flash forward, 8 dK/dV and 8 dQ launches, 1 MAS
    launch and 1 BiGRU forward launch; then its time split and profile as in
    phase 12, with the flash kernels' device time; then two steps of the
    same config through the dense attention branch, for their time and peak
    memory.
15. One bf16 flash step on the card against the CPU: seeded full-size
    weights, B = 8, N = 256, T = 512 (both stacks take the flash gate, so the
    CPU runs the plain version), a diagonal prior that leaves MAS no
    near-ties.  Hard alignments and durations equal, losses and gradients
    within stated tolerances.  Then the f32 flash step on the same weights
    and batch, card against CPU (8 launches of each flash kernel on the
    card), at the f32 step's tolerances (``STEP_LOSS_RTOL``,
    ``STEP_GRAD_GLOBAL_RTOL``, ``STEP_GRAD_RTOL``).
16. Serving with the long-bucket config in f32 (only ``vocab_path`` set to
    the demo vocabulary, whose ids lie below 803): one request through
    ``Synthesizer.synthesize`` padded to 768 characters and 3072 frames,
    8 flash forward launches.
17. Training in f32: the long-bucket config with ``compute_dtype`` float32
    (flash, dropout 0, N = 768, T = 3072 as the file says) at B = 8, not
    its 16, since f32 activations take about twice the bf16 step's memory;
    ``WARMUP_STEPS`` then ``TIMED_STEPS`` steps, counters set to 0 just
    before the timed steps: per step 8 flash forward, 8 dK/dV and 8 dQ
    launches (the f32 kernels), 1 MAS and 1 BiGRU forward launch; then its
    time split and profile as in phase 12, with the flash kernels' device
    time.

Then the Vec2Wav GAN training slice, on ``data/demo/vec2wav.json`` (the
512-channel Generator, x320; MPD periods 13, 17, 19; the MSD's three
scales), with seeded random weights and conv_post's gain set as in phase 2
(measured in train mode):

18. Training: a ``GANTrainer`` takes ``WARMUP_STEPS`` then ``TIMED_STEPS``
    D/G steps on one batch built as the JAX package's ``bench_v2w`` builds
    it: B = 2, T = 256 latent frames (81,920 samples an item), audio
    N(0, 0.1^2), the mel target from the port's host mel op.  Prints the
    median step (CUDA events), seconds of audio trained per second, peak
    device memory and the four scalars; every scalar must be finite and the
    mel loss must fall over those 7 steps (first against last).  Then the
    step's split (G forward; D forward + backward + AdamW; G loss +
    backward + AdamW), each discriminator's forward + backward alone, and
    ``torch.profiler``'s busy share, launches and top kernels.  (B = 8 is
    timed in phase 36, on the default MSD route.)  The fused ResBlock2
    kernel must not launch: the trainer's Generator is ``fused=False``.
19. One full-size GAN step on the card against the CPU: B = 2, T = 32,
    the same weights and noise.  Losses within ``STEP_LOSS_RTOL``, the
    gradients by ``STEP_GRAD_GLOBAL_RTOL`` over all and ``STEP_GRAD_RTOL``
    per tensor (the upsamplers' biases, 0 but for rounding, only in the
    former), every running statistic and spectral vector after the step
    within ``GAN_STATE_RTOL``.
20. ``vec2wav_loop.main`` trains 3 steps on the demo corpus (whole
    utterances; its run directory under a temporary one).

Then the serving stack, on phase 2's full-size models (seeded anew; conv_post's
gain and the duration bias set as there), the demo speakers
``data/demo/spk_emb/SSB0000.npy`` and ``SSB0001.npy`` and their reference
clips, run outside inference mode as a server runs it.  The launch
counters are set to 0 just before each phase drives its path and read just
after:

21. Checkpoint round trip: the weights saved as the torch reference's files
    (``checkpoint_0.pth.tar`` with key ``model``, ``g_00000000`` with key
    ``generator``), the serving stack built from them as ``cli serve`` builds
    it (``cli._build_serving_stack``), one request bit for bit against the
    Synthesizer of the in-memory weights.
22. ``serve_loop`` with ``--warmup`` over a burst of ``SERVE_REQUESTS``
    requests (two speakers, text buckets 32 and 64, frame bucket
    ``SERVE_FRAMES``), all queued at once, at max_batch 1 and
    ``SERVE_MAX_BATCH``: every line ``OK``, the client-perceived latency
    (median, p90) and utterances per second over the burst, launches of 30
    fused units and 1 BiGRU per forward (warm-up included), the BiGRU's
    route at each batch bucket, and each request's PCM coalesced against
    alone within ``COALESCE_LSB``.
23. PCM streaming (``stream_chunk`` ``STREAM_CHUNK``) of a request clipped
    at ``STREAM_FRAMES`` frames: the stitched PCM against the batched PCM
    within ``COALESCE_LSB``, the time to first audio against the request's
    latency, 30 fused launches a window; ``StreamingVocoder.vocode`` against
    the full f32 forward within ``STREAM_ATOL``, the gap printed.
24. ``serve_http`` on 127.0.0.1, port 0, in a thread: ``/health``,
    ``/speakers`` and ``HTTP_CLIENTS`` concurrent ``POST /synthesize``, each
    answer a wav of the request's length, at least one coalesced batch.
25. The bf16 serving Generator (``make_serving_generator(..., "bf16")``)
    against the f32 one on the 512- and 3000-frame requests' latents: no
    fused launch in bf16 and 30 a forward in f32, the distance within
    ``BF16_WAV_RTOL`` of the f32 norm, both Generators' ms (CUDA events,
    median of 3 after a warm-up); ``fused_conv_residual`` refuses bf16
    inputs on the card.
26. The long-bucket config (f32, flash) through ``serve_loop``: 2 requests
    coalesced at max_batch 2 (8 flash forward launches at B = 2), each
    against the same request alone through ``Synthesizer`` within
    ``COALESCE_LSB``.
27. Each kernel of that path against its plain version at the shapes it
    first met there: the fused unit at the streaming windows' lengths and in
    a batch of ``SERVE_MAX_BATCH``, the BiGRU at every batch bucket, the f32
    flash forward at B = 2 of the long bucket.

Then the training loops as jobs, at full size on the demo corpus, in one
temporary directory; the counters are set to 0 just before each loop or
request and read just after:

28. ``text2vec_loop.main`` on ``data/demo/text2vec.json`` with
    ``--validate``: ``LOOP_STEPS`` steps, a save, a log and a validation
    every ``LOOP_EVERY``.  ``checkpoint_{3,6}.pth.tar``, ``config.json``,
    ``logger/logger.txt`` and the scalars (TensorBoard events or
    ``scalars.jsonl``, the backend printed) must exist; every training loss
    must be finite, every validation loss finite or its batch counted
    non-finite; MAS and the BiGRU launch once a training step and once a
    validation batch, exactly.  Prints the median step (host clock between
    steps, the scalars fetched every step), each save's and validation's
    seconds and the card line.
29. ``--restore_step 3``: the loaded weights and LAMB state bit-equal to
    ``checkpoint_3.pth.tar``'s, the run going on at step 4.  Then, with
    dropout 0 on one full-size synthetic batch (B = 16 x 1024 frames,
    phase 8's) and cuDNN's deterministic algorithms: a step, a save, a load
    into a trainer of another seed and one step, against the unbroken
    trainer's next step: losses within ``RESUME_LOSS_RTOL``, weights within
    ``RESUME_WEIGHT_RTOL`` of their norm (bit-equality printed).
30. ``vec2wav_loop.main`` on ``data/demo/vec2wav.json`` with ``split=True``
    (windows of 25 latent frames and 8000 samples; a batch's shapes
    printed): ``GAN_LOOP_STEPS`` steps with a save and a validation every 2
    and a log every step, then a run that resumes from the newest
    ``g_``/``do_`` pair for ``GAN_LOOP_MORE`` more.  The files of steps 2,
    3, 4 and 5, the resumed step number, finite losses and validation mel
    L1, and the last pair loaded bit-equal (AdamW states, spectral
    vectors).  No kernel of the port launches.
31. The files phases 28 and 30 wrote, served: the run's ``config.json``,
    ``checkpoint_6.pth.tar`` and the last ``g_`` through
    ``init_import_models`` and one ``Synthesizer`` request: 30 fused
    launches and 1 BiGRU launch, a finite waveform.

Then the training data staged on the card and the GAN's remaining modes, in
one temporary directory; the counters are set to 0 just before each path
and read just after:

32. The demo corpus read by the native reader (``data/native_io.py``; the
    run fails if ``np.load`` read it) and staged on the card
    (``DeviceResidentData``): every batch of an epoch bit-equal to the host
    collate's on the card.  Then ``cli train-text2vec`` (the loop's
    ``main(parse_args(argv))``, as the subcommand runs it) on
    ``data/demo/text2vec.json`` with ``device_resident_data=true``, against
    the host path with and without its prefetch thread, 3 steps a run, each
    twice in turns (``DEVICE_LOOP_ORDER``), under cuDNN's deterministic
    algorithms: losses within ``DEVICE_LOSS_RTOL``, one MAS and one BiGRU
    launch a step; each path's host-clock step.
33. Staging at a real size: ``STAGE_ITEMS`` synthetic items of
    ``STAGE_FRAMES`` frames at 1024 dims, text ``STAGE_TEXT`` (bucket
    ``STAGE_N``): the staging seconds and bytes; a B = 16 x 1024-frame batch
    gathered on the card against the host collate plus its copy, and the
    bytes each path moves to the card a step; the full-size training step
    fed from the cache, a new batch gathered each step (one MAS and one
    BiGRU launch a step); ``READ_FILES`` of the corpus's items written as
    ``.npy`` files and read by ``load_buffer`` through the native reader
    and through ``np.load``, ``READ_PAIRS`` alternating pairs, each pair in
    a fresh process as a job's start reads them.
34. The windowed GAN loop from the card (``VocoderDeviceData``): the staged
    windows against the CPU cache's for the same (idx, fstart), bit for
    bit; ``cli train-vec2wav`` with ``split``, ``device_mel_target`` and
    ``device_resident_data`` at B = 2 (``GAN_LOOP_STEPS``, then resumed
    from its ``g_``/``do_`` files for ``GAN_LOOP_MORE``) and at B = 16 (the
    demo list four times over), the host-clock step of each; one request
    served from the last ``g_`` file (30 fused launches, 1 BiGRU).
35. The MSD repack (``ops/tiled_conv.py``): each grouped layer at the
    whole-utterance (B = 2 x 256 frames) and windowed (B = 16 x 25)
    pair-batched shapes by grouped ``F.conv1d`` and by the repack, values
    within ``REPACK_RTOL`` and gradients within ``REPACK_GRAD_RTOL`` of
    their largest, ms and TFLOP/s of each route; the gate as measured (the
    input lengths where the repack's forward + backward wins); the GAN step
    with the MSD on grouped convolutions, on the repack where the JAX
    package's gate admits a layer (``JAX_MIN_T_IN`` samples or more) and
    on the repack everywhere (the port's gate), ``REPACK_PAIRS``
    alternating rounds at both shapes; the profiler's top kernels of the
    repack's whole-utterance step.
36. The GAN step as ``GANTrainer(cfg)`` builds it by default, the MSD on
    the repack (phase 18's weights and batches): bf16 (``compute_dtype``
    bfloat16) at B = 2 and 8 x 256 frames; f32, and bf16 with the MSD on
    grouped convolutions, at B = 8 (f32 at B = 2 is phase 35's A/B); step
    ms, seconds of audio a second, peak memory.
    Then one bf16 card step against the CPU's bf16 step from phase 19's
    weights, noise and batch, the MSD on the repack on both: each loss
    within ``GAN_BF16_NOISE`` times the CPU's bf16-vs-f32 distance or
    ``GAN_BF16_FLOOR`` of the loss, a bound that phase 19's f32 card step
    must fail on at least one loss.

Then the data-preparation and model-upkeep commands, each through
``cli.main`` as a user runs it, in one temporary directory; the counters
are set to 0 just before each command or request and read just after:

37. ``prepare-data``: wav2vec 2.0 large (hidden 1024, 24 layers, 16 heads,
    FFN 4096, 7 x 512 convolutions, layer norm, stable layer norm) with
    seeded weights, saved as a local ``config.json`` + ``pytorch_model.bin``
    directory, over a synthetic AISHELL-3-shaped tree (``TOOLS_SPEAKERS`` x
    ``TOOLS_WAVS`` wavs of 2-10 s, labelled with eval's test sentences) at
    B = ``TOOLS_B``: every latent ``[1, T, 1024]`` at its wav's output
    length and finite, the filelists' halves, the vocabulary.  The
    featurizer's seconds of audio a second, its bound (operations at the
    CUDA cores' f32 rate) and peak memory; its latents on the card against
    the CPU's on ``W2V_CHECK_B`` x ``W2V_CHECK_S`` s within ``W2V_ATOL``.
38. ``pre-spk-emb`` over the tree with the repo's ECAPA (C = 1024, raw wav)
    and with SpeechBrain's ECAPA (``--speechbrain``), seeded: each speaker's
    embedding timed on the card and held against the CPU's within
    ``SPK_EMB_RTOL``.
39. ``recalibrate-bn`` on a full-size Text2Vec trainer's
    ``checkpoint_{RECAL_STEP}.pth.tar`` and a ``g_`` file over
    ``RECAL_ROWS`` filelist rows (phase 37's latents, phase 38's SpeechBrain
    embeddings), on the card and on the CPU: one BiGRU launch a Text2Vec
    batch, 30 fused launches a Generator batch; every entry but the
    running statistics carried over; the card's statistics within
    ``RECAL_STAT_RTOL`` of the CPU's; the files served by a ``Synthesizer``
    (30 fused launches, 1 BiGRU).
40. ``eval-text2vec --rtf`` on the recalibrated checkpoint (the demo
    config with phase 37's vocabulary): six sentences written, the RTF over
    ``EVAL_RTF_ITERS`` utterances, one BiGRU launch a sentence.
41. ``input_wav=True``: one full-size Text2Vec training forward and
    backward with raw reference waveforms (B = ``CHECK_B``), card against
    CPU at phase 11's tolerances; one MAS and one BiGRU launch.

Then data parallelism (``parallel/``), with ranks started as ``torchrun``
starts them (``parallel.launch.run_local``): two ranks on the one card over
gloo (NCCL takes one card a rank), then one rank over NCCL.  The counters
are set to 0 in each rank just before its step or job and read just after:

42. One Text2Vec step at full size (phase 8's config, dropout 0) on a
    global B = 16 at 64 x 1024, 8 a rank, and one GAN step (phase 18's
    modules) on a global B = ``DP_GAN_B`` x ``DP_GAN_T`` frames, each rank
    stepping its rows (``parallel.shard_batch``) from rank 0's state
    (``globalize_state``).  Each rank against one process stepping the whole
    global batch on the card: losses within ``DP_LOSS_RTOL``; gradients by
    norm within ``STEP_GRAD_GLOBAL_RTOL`` over all and ``STEP_GRAD_RTOL``
    for the worst tensor; the parameters after the update within
    ``DP_PARAM_ATOL`` in all but ``DP_PARAM_OFF`` of the elements, where the
    sign-like first step parts them, and within twice the largest step
    everywhere (``dp_compare``).  The ranks' states, spectral vectors
    included, bit-equal; 1 MAS and 1 BiGRU forward launch a rank.  Prints
    the bytes all-reduced a step, the gradients' all-reduce ms and the step
    ms at world size 2 (two ranks sharing one card: not a scaling figure)
    against 1.  Before the pair joins, rank 0 steps the Text2Vec global
    batch alone and rank 1 the GAN's (the one-process references); after
    the pair, rank 0, in a group of one over NCCL, steps them again:
    bit-equal to the steps with no process group, cuDNN's deterministic
    algorithms on; the world-size-1 step is timed there.  The checked step
    is each timing's warm-up.
43. In the same two ranks, ``cli train-text2vec`` and ``train-vec2wav``
    (the loops' ``main(parse_args(argv))``) on the full-size demo configs,
    ``JOB_STEPS`` steps each, a save a step: the ranks' losses equal, and
    held against one process stepping the same global batch (each rank's
    share of the file list, loader and padding, concatenated) from the same
    state (the seed, or the job's file of the step before; the GAN's step 1
    has none): the Text2Vec step's hard durations equal to one process's,
    and its losses within ``JOB_WITNESS_FACTOR`` times the distance of a
    second witness, one process on the same items in reverse order (at
    least ``DP_LOSS_RTOL``), the worst BatchNorm's E[x^2]/(Var + eps)
    printed; the
    GAN's within ``DP_LOSS_RTOL``; only rank 0 wrote files; the Text2Vec
    job's checkpoint of step
    ``JOB_RESUME_AT`` loaded on both ranks and stepped on the next global
    batch against the uninterrupted step (``RESUME_LOSS_RTOL``).
44. The benches (``infer/train_bench.py``, ``rtf_bench.py``,
    ``serve_bench.py``), ``BENCH_ITERS`` timed iterations each:
    ``train_bench`` at B = 16 x 1024 with and without remat, and the
    long-bucket bf16 step with flash (``LONG_BENCH_ITERS``) with and
    without remat, each pair from one seed under cuDNN's deterministic
    algorithms: the last step's loss, after the updates, and its gradients'
    global norm within ``REMAT_RTOL``, remat's peak memory lower; the GAN
    step;
    ``rtf_bench`` at B = 1 and 4; ``serve_bench`` at B = 1 and 8.  Every
    row carries the card's name.

Then flash attention past head dim 256 (the wide kernels of
``csrc/flash_attn.cu``: the head dim zero-padded to a multiple of 64, the
output's columns in chunks of 256 (``wide_chunks``), a block each, two a
block in the bf16 dQ, 128 in the f32 dQ (``wide_blocks``); the bf16 kernels
on wgmma and TMA, the f32 ones on 3xTF32 mma.sync, the f32 dK/dV with its
queries split over blocks where one head gives too few; the score products
streamed over the whole head dim), on the long-bucket config at one head
(``one_head_config``: d_model 448, so d_k = d_v = 448 in both stacks, the
same attention work as its two heads of 224):

45. Each wide kernel against autograd of the plain version at D in
    ``WIDE_DIMS`` (288 and 300: run at 320; 448 and 512: two chunks, K and V
    or Q resident (dQ: Q and dO to 448); 768: three chunks, the bf16
    kernels' own operand streamed): bf16
    at [16, 1, 3072, D] with the last item padded from ``WIDE_TAIL`` on, f32
    at [1, 1, 3072 | 768, D], and the f32 training shape [``LONG_F32_B``,
    1, 3072, 448], within phase 13's tolerances; each with its
    times (CUDA events on a filled queue), its bound (the function's own
    work at the unpadded D: 4 T^2 D B H operations forward, 8 dK/dV, 6 dQ,
    10 the backward), the plain version's times and SDPA's forward, forward
    + backward and backward (the same boolean mask; the backend PyTorch
    picks named by its own choice function); ``ptxas``'s registers and
    spills of the six wide instances (none may spill): ``wide_fwd_bf16``,
    ``wide_dkv_bf16``, ``wide_dq_bf16``, ``wide_fwd_f32``,
    ``wide_dkv_f32`` and ``wide_dq_f32`` (f32), and its C7515 (wgmma
    serialized) and C7519 (fences injected) lines about ``wide_dq_bf16``.
46. Phase 15 at one head: one bf16 flash step card against CPU (and the f32
    step) at B = 8, N = 256, T = 512, the same weights and tolerances; 8
    launches of each wide kernel a step and none of the templates'.
47. Training and serving at full width: ``WARMUP_STEPS`` then
    ``TIMED_STEPS`` bf16 steps of the one-head config at B = 16 x 768 x 3072,
    the counters (set to 0 just before the timed steps) showing per step 8
    launches of each wide kernel (one a kernel an FFT block: the column
    chunks are one grid) and none of the templates'; one f32 request of
    3072 frames through ``Synthesizer`` (8 wide forward launches).
48. ``text2vec_loop.main`` on the demo corpus (``data/demo/text2vec.json``)
    with ``--profile_dir`` and ``--precompile``: 9 steps, the precompile's
    seconds, the trace's spans (iterations 3-8) and device kernels counted,
    MAS, the f32 BiGRU and cuDNN's convolutions among them.

Then the JAX package's orbax checkpoints, read without JAX by the port's own
OCDBT, zarr and zstd readers (``orbax_format``), from the committed
fixtures ``tests/fixtures/jax_orbax`` (``tests/make_jax_orbax_fixtures.py``
writes them with the JAX package, on a machine that has it):

49. The reader's seconds and MB/s of stored chunk bytes on this host, for
    each fixture directory; one request served from the Text2Vec and
    Generator variables (the fused Generator, as the command line serves),
    its frame count equal and its latents and waveform within atol 1e-4
    and 2e-4 of the JAX package's committed answer (``ORBAX_LATENT_ATOL``,
    ``ORBAX_WAV_ATOL``), having launched ``fused_resblock``,
    ``gru_fwd_f32`` and ``flash_fwd``; one Text2Vec training step resumed
    from the fixture's ``T2VTrainState`` ``checkpoint_1`` (weights, LAMB
    moments, learning rate 0.005 and step 1 carried; dropout 0), its
    parameters held to the JAX package's committed next step at the
    port's step-parity tolerance (``STEP_PARITY_ATOL``,
    ``STEP_PARITY_SHARE``: ``tests/test_torch_train.py``) and its running
    statistics within 1e-5, having launched ``gru_bwd``, ``mas``,
    ``flash_bwd_dkv`` and ``flash_bwd_dq``.  None of ``JAX_MODULES``
    (``jax``, ``jaxlib``, ``flax``, ``orbax``, ``tensorstore``,
    ``ml_dtypes``, ``zstandard``, the JAX package) is imported afterwards.

Every float32 product and convolution in this run is full float32: TF32 is
off for matmuls and cuDNN.  Every Text2Vec config it drives but phase 3's
"pallas" copy says ``gru_impl`` "scan", so their BiGRU is the f32 kernel
(``gru_fwd_f32`` in the counters); each phase's launch check asserts that
the other kernel launched none.  The second-to-last line is a JSON object with
one entry per kernel (``serving_launches``: the launches of phases 22-24
and 26; ``loop_launches``: those of phases 28-31; ``data_launches``: those
of phases 32-36; ``tools_launches``: those of phases 37-41;
``parallel_launches``: those of phases 42-43 summed over the ranks;
``bench_launches``: those of phase 44; ``orbax_launches``: those of phase
49; the wide flash kernels' rows
``launches``: those of phase 47's timed steps, their times phase 45's at
[16, 1, 3072, 448] bf16, f32_ keys at [1, 1, 3072, 448], f32_train_ keys
(backward rows) at [``LONG_F32_B``, 1, 3072, 448]; a backward row's
``ms`` is a call with its preparation, ``kernel_ms`` the kernel alone); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt_module
from wavthruvec_pytorch_tpu_torch import cli, parallel
from wavthruvec_pytorch_tpu_torch.checkpoint import (
    load_text2vec,
    load_torch_state_dict,
    load_vec2wav,
    save_text2vec,
)

from wavthruvec_pytorch_tpu_torch.config import (
    Text2VecConfig,
    Vec2WavConfig,
    load_config,
    repo_path,
    save_config,
)
from wavthruvec_pytorch_tpu_torch.data import native_io
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader, load_buffer
from wavthruvec_pytorch_tpu_torch.data.device_cache import DeviceResidentData
from wavthruvec_pytorch_tpu_torch.data.ingest import Wav2VecFeaturizer
from wavthruvec_pytorch_tpu_torch.data.prior import beta_binomial_prior_distribution
from wavthruvec_pytorch_tpu_torch.data.spk_emb import SpeakerEmbedder, SpeechBrainEmbedder
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import (
    VocoderDataset,
    VocoderLoader,
    get_dataset_filelist,
    load_wav,
    mel_spectrogram_np,
)
from wavthruvec_pytorch_tpu_torch.data.vocoder_device_cache import VocoderDeviceData
from wavthruvec_pytorch_tpu_torch.entry import entry
from wavthruvec_pytorch_tpu_torch.infer.eval import TEST_SENTENCES
from wavthruvec_pytorch_tpu_torch.infer.http_serve import serve_http
from wavthruvec_pytorch_tpu_torch.infer.recalibrate import (
    recalibrate_generator_bn,
    recalibrate_text2vec_bn,
    text2vec_calibration_batches,
)
from wavthruvec_pytorch_tpu_torch.infer.serve import (
    SpeakerStore,
    _batch_buckets,
    _serve_noise,
    serve_loop,
)
from wavthruvec_pytorch_tpu_torch.infer.streaming import (
    StreamingVocoder,
    conservative_context_frames,
)
from wavthruvec_pytorch_tpu_torch.infer.synthesize import (
    Synthesizer,
    init_import_models,
    make_serving_generator,
)
from wavthruvec_pytorch_tpu_torch.models import layers
from wavthruvec_pytorch_tpu_torch.models.losses import attention_binarization_loss, dnn_loss
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import (
    LRELU_SLOPE,
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from wavthruvec_pytorch_tpu_torch.models.wav2vec2 import (
    feat_extract_output_lengths,
    large_config,
    random_model,
    save_pretrained,
)
from wavthruvec_pytorch_tpu_torch.ops import kernel_build
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import (
    conv_residual_plain,
    fused_conv_residual,
)
from wavthruvec_pytorch_tpu_torch.ops.gru import (
    device_limits,
    gru_barrier_loop,
    gru_bwd,
    gru_bwd_barrier_loop,
    gru_bwd_loop,
    gru_bwd_loop_plain,
    gru_bwd_plain,
    gru_bwd_plan,
    gru_bwd_steps,
    gru_fwd,
    gru_fwd_f32,
    gru_fwd_plain,
    gru_fwd_plan,
    gru_fwd_steps,
    gru_numerics,
)
from wavthruvec_pytorch_tpu_torch.ops.flash_attention import (
    KERNELS as FLASH_KERNELS,
    backward_inputs,
    dkv_f32_splits,
    dq_f32_chunks,
    dq_f32_splits,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_wide,
    flash_bwd_dq,
    flash_bwd_dq_wide,
    flash_fwd,
    flash_fwd_wide,
    kernel_width,
    kernels_for,
    wide_blocks,
    wide_chunks,
)
from wavthruvec_pytorch_tpu_torch.ops.mas import MAX_K as MAS_MAX_K
from wavthruvec_pytorch_tpu_torch.ops.mas import MAX_N as MAS_MAX_N
from wavthruvec_pytorch_tpu_torch.ops.mas import (
    mas_plan,
    mas_row_chain,
    mas_width1,
    mas_width1_plain,
    shared_limit,
)
from wavthruvec_pytorch_tpu_torch.ops.tiled_conv import tiled_grouped_conv1d
from wavthruvec_pytorch_tpu_torch.parallel.launch import free_port, run_local
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train import text2vec_loop, vec2wav_loop
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import (
    SCALAR_KEYS,
    VAL_KEYS,
    Text2VecTrainer,
    batch_to_device,
    make_padded_batch,
)
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS as GAN_KEYS
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer
from wavthruvec_pytorch_tpu_torch.utils import logging as logging_module

SEED = 0
FRAMES_PER_CHAR = 8.0  # ~0.16 s of speech per character at 50 latent frames/s
WAV_STD = 0.3
REPEATS = 3  # timed runs of each request; its median is reported
SAMPLE_RATE = 16000

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, bf16 and
# TF32 tensor cores, HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# f32 flash on the tensor cores: f32 accuracy takes three TF32 products for
# each product (3xTF32: hi hi + hi lo + lo hi), so the least time of f32
# work there is that of three times the TF32 operations
PEAK_F32_TC = PEAK_TF32 / 3

# tolerances of the kernel-vs-plain checks on the card
FUSED_ATOL = 1e-4  # f32 both sides, k*C-term sums in another order
GRU_ATOL = 1e-3    # same bf16 rounding both sides; a 1-ulp bf16 flip of h
                   # from a different f32 sum order propagates through T steps
GRU_F32_ATOL = 1e-5  # f32 both sides, no rounding to flip: H-term sums in another
                     # order (~1e-7 a step), carried through a contracting recurrence
# the full path on the card against the CPU on a small request
LATENT_ATOL = 1e-3
WAV_ATOL = 2e-3

# training: B x text bucket x frame bucket, steps
TRAIN_B, TRAIN_N, TRAIN_T = 16, 64, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the card-vs-CPU step: B = 8, not 2, since ECAPA's last BatchNorms
# normalise over the batch and at B = 2 map each feature to +-1 whatever its
# input, which leaves the gradient below them set by f32 rounding
CHECK_B, CHECK_N, CHECK_T = 8, 16, 64
GRU_BWD_RTOL = 1e-3   # atol, as a share of each gradient's largest value: f32 sums over T
# the backward kernel against its plain loop on the card, max |err| / max
# |plain| of dgi and of dgh: f32 both sides, only the order of the 3H-long
# sums of dh differs (~1e-7 a step), carried through a contracting recurrence
GRU_BWD_LOOP_RTOL = 1e-5
STEP_LOSS_RTOL = 1e-4
# gradients, as ||card - CPU|| / ||CPU||: of all of them at once, and of each
# tensor whose largest gradient exceeds 1e-5 (the rest are 0 but for
# rounding: biases in front of a softmax or a BatchNorm).  The BiGRU's bf16
# rounding of h flips on other sums, and the flips feed back through every
# layer; ECAPA's Res2Net convolutions, below two batch-wide BatchNorms, move
# most.
STEP_GRAD_GLOBAL_RTOL = 5e-3
STEP_GRAD_RTOL = 3e-2

# the long-bucket bf16 slice
LONG_CFG = ("artifacts", "flash_longbucket", "flash", "longbucket", "config.json")
LONG_B, LONG_N, LONG_T = 16, 768, 3072
LONG_F32_B = 8  # the f32 long-bucket step's batch: f32 activations take ~2x bf16's
FLASH_H, FLASH_D = 2, 224  # heads and head dim of both FFT stacks
# flash kernels vs plain, max |err| / max |plain|: in bf16 the kernels round
# the running (not the final) probabilities and dS to bf16 before their
# products, the plain version the final probabilities only; in f32 only the
# sums' order differs
FLASH_BF16_RTOL = 2e-2
FLASH_F32_RTOL = 1e-4
FLASH_LSE_ATOL = 1e-4  # f32 both sides; lse ~ log T
# the bf16 card-vs-CPU step: bf16 rounds at other sums on the two devices
# (cuDNN/cuBLAS and the kernels against oneDNN and the plain versions), and a
# flip of one rounding feeds every layer after it.  The gradients are held
# to bf16's own noise: per module, ||card - CPU|| may be at most
# BF16_GRAD_NOISE times the CPU's bf16-vs-f32 distance (plus 1e-3 of the f32
# norm), over all tensors BF16_GRAD_NOISE_ALL times
BF16_CHECK_B, BF16_CHECK_N, BF16_CHECK_T = 8, 256, 512
BF16_STEP_LOSS_RTOL = 2e-2
BF16_GRAD_NOISE = 2.0
BF16_GRAD_NOISE_ALL = 1.5

# the Vec2Wav GAN slice: the JAX package's bench shapes (infer/train_bench.py
# bench_v2w, sweep_v2w's first two rows), B x latent frames (x320 samples)
GAN_B, GAN_T = 2, 256
GAN_SWEEP_B = 8
# the card-vs-CPU GAN step: B x frames
GAN_CHECK_B, GAN_CHECK_T = 2, 32
# the upsamplers' biases feed a batch-statistics BatchNorm, which removes any
# constant: their gradient is 0 but for rounding, so the per-tensor
# STEP_GRAD_RTOL does not apply to them (they stay in the global norm)
GAN_ZERO_GRAD = re.compile(r"gen\.ups\.\d+\.bias")
# BatchNorm running statistics and spectral vectors after the step, card vs
# CPU: max |card - CPU| / max |CPU| of each buffer
GAN_STATE_RTOL = 1e-4

# the serving stack: the serve loop's frame bucket, its burst and largest
# batch bucket; the streamed request (125 characters at alpha 5 speak ~3,700
# frames, clipped to the 3000-frame buffer); the HTTP clients and coalescing
# window
SERVE_FRAMES = 1024
SERVE_REQUESTS, SERVE_MAX_BATCH = 16, 8
STREAM_FRAMES, STREAM_CHARS, STREAM_ALPHA, STREAM_CHUNK = 3000, 125, 5.0, 100
HTTP_CLIENTS, HTTP_COALESCE_MS = 8, 100.0
# a request's PCM coalesced against alone, and streamed against batched: one
# float rounding near a quantization step flips one LSB
COALESCE_LSB = 1
# stitched windows against the full forward, f32: the windows' convolutions
# may take other cuDNN algorithms than the full length's
STREAM_ATOL = 1e-4
# the bf16 serving Generator against the f32 one, ||bf16 - f32|| / ||f32||:
# bf16 keeps 8 bits of mantissa in every convolution's inputs and outputs
# over 5 stages (the JAX package's bf16 Generator lies 0.087 of the norm from
# its f32 one at the CPU tests' small config, tests/test_torch_serving_bf16.py)
BF16_WAV_RTOL = 0.25

# the training loops as jobs: Text2Vec steps with a save, a log and a
# validation every LOOP_EVERY; GAN steps, then the resumed run's
LOOP_STEPS, LOOP_EVERY = 6, 3
GAN_LOOP_STEPS, GAN_LOOP_MORE = 4, 2
# save, load and one step against the unbroken trainer's step on the card
# (cuDNN deterministic): the same kernels on the same inputs, measured
# bit-equal on an H100 80GB HBM3 at 700 W; the tolerance leaves room for
# atomic sums outside cuDNN, which may take another order at f32 rounding
RESUME_LOSS_RTOL = 1e-5
RESUME_WEIGHT_RTOL = 1e-5

# training data on the card and the GAN's modes (phases 32-36).  The
# device-resident loop against the host path, 3 steps under cuDNN's
# deterministic algorithms: the same batches, so the same kernels on the same
# inputs; atomic sums outside cuDNN may take another order
DEVICE_LOSS_RTOL = 1e-6
# phase 32's runs of the demo loop, in turns: from the device cache, from the
# host loader, and from the host loader without its prefetch thread
DEVICE_LOOP_ORDER = ("host", "device", "host, no prefetch", "host, no prefetch", "device",
                     "host")
# phase 33's synthetic corpus: items, frames and text ids an item (ranges),
# its text bucket; the batches whose assembly is timed
STAGE_ITEMS, STAGE_FRAMES, STAGE_TEXT, STAGE_N = 4000, (100, 400), (32, 120), 128
ASSEMBLE_BATCHES = 10
# the .npy files of phase 33 read by each reader, in alternating pairs
READ_FILES, READ_PAIRS = 500, 2
# the windowed GAN batch: B x frames (segment_size 8192 // 320)
GAN_WINDOW_B, WINDOW_T = 16, 25
# the MSD's repack against grouped F.conv1d (max |err| / max |ref|): the same
# products summed in another order, plus zero terms
REPACK_RTOL, REPACK_GRAD_RTOL = 1e-5, 1e-4
# the GAN step A/B: the MSD's routes (grouped F.conv1d; the repack where
# the JAX package's gate admits a layer, inputs of JAX_MIN_T_IN samples or
# more, ops/tiled_conv.py:47 there; the repack where the port's gate does,
# at every length), and the alternating rounds
REPACK_ROUTES = {"off": "grouped conv", "jax_gate": "repack at JAX's gate (16384)",
                 "on": "repack at the port's gate"}
JAX_MIN_T_IN = 16384
REPACK_PAIRS = 10

# data preparation and model upkeep (phases 37-41).  The synthetic
# AISHELL-3-shaped tree: speakers x wavs of TOOLS_SECONDS, featurized at
# batch TOOLS_B (one batch a speaker)
TOOLS_SPEAKERS, TOOLS_WAVS, TOOLS_B = 2, 8, 8
TOOLS_SECONDS = (2.0, 10.0)
# the card's latents against the CPU's on W2V_CHECK_B wavs of W2V_CHECK_S
# seconds: f32 both sides (TF32 off), 24 pre-LN layers, sums in another order;
# after the final LayerNorm the latents are of order 1
W2V_CHECK_B, W2V_CHECK_S = 2, 2.0
W2V_ATOL = 1e-3
# speaker embeddings, card vs CPU: max |card - CPU| / max |CPU|, f32 both
# sides; ECAPA pools thousands of frames
SPK_EMB_RTOL = 1e-4
# recalibration: filelist rows, Text2Vec's inference frame cap, the
# Generator's latent frames a row; card vs CPU, each running statistic's
# max |card - CPU| / max |CPU| (batch moments in f32: sums in another order)
RECAL_ROWS, RECAL_MAX_FRAMES, RECAL_GEN_FRAMES = 16, 512, 64
RECAL_STAT_RTOL = 1e-4
RECAL_STEP = 1000  # the step in the recalibrated checkpoint's name
# eval-text2vec --rtf: utterances timed after its warm-up
EVAL_RTF_ITERS = 12
# phase 41: the raw-wav reference of each item, seconds
WAV_REF_SECONDS = 2.0
# the bf16 GAN step, card vs CPU (the same code, the same rounding points):
# NOISE times the CPU's bf16-vs-f32 distance, or one bf16 ulp of the loss;
# below 1, so that a step computed in f32 fails it
GAN_BF16_NOISE, GAN_BF16_FLOOR = 0.5, 2.0 ** -8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1, queued: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls).  ``queued``: the card first
    spins ~30 ms (``torch.cuda._sleep``) while the host enqueues the calls,
    so the events time the device's work alone, not the host's issue rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(50_000_000)
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
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"  {name}: {line.strip()}")


def make_synthesizer(dev, t2v_cfg=None):
    """A Synthesizer with seeded random weights: the full-size demo Text2Vec
    config unless ``t2v_cfg`` is given, and the demo Vec2Wav config."""
    if t2v_cfg is None:
        t2v_cfg = load_config(Text2VecConfig, repo_path("data", "demo", "text2vec.json"))
    v2w_cfg = load_config(Vec2WavConfig, repo_path("data", "demo", "vec2wav.json"))
    torch.manual_seed(SEED)
    t2v = Text2Vec(t2v_cfg, device=dev)
    gen = Generator(v2w_cfg, device=dev)
    with torch.no_grad():
        t2v.length_regulator.duration_predictor.linear_layer.linear_layer.bias.add_(FRAMES_PER_CHAR)
    frontend = TextFrontend.from_vocab_file(repo_path(t2v_cfg.vocab_path))
    check(frontend.vocab_size <= t2v_cfg.vocab_size, "the vocabulary has more ids than the config")
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
    with torch.no_grad():
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
    """Phases 3-4.  The demo config's BiGRU computes f32 (its gru_impl is
    "scan"); a "pallas" copy of it (the same weights; B <= 2 at H = 1024,
    where JAX's gate holds) serves each request once more through the bf16
    kernel."""
    text, ref, spk = demo_inputs(syn)
    t2 = [text(60), text(25)]
    requests = [
        ("b1_f512", [text(40)], 512, False),
        ("b1_f3000", [text(120)], 3000, False),
        ("b2_f1024", t2, 1024, False),
        ("b2_f1024_pcm16", t2, 1024, True),
    ]
    pallas = Synthesizer(dataclasses.replace(syn.t2v_cfg, gru_impl="pallas"), syn.v2w_cfg,
                         syn.t2v.state_dict(), syn.gen.state_dict(), syn.frontend,
                         device=syn.device)

    def run(s, texts, max_frames, pcm16):
        B = len(texts)
        return s.synthesize(texts, np.repeat(ref, B, 0), np.repeat(spk, B, 0),
                            max_frames=max_frames, seed=SEED, pcm16=pcm16)

    for s in (syn, pallas):  # warm-up: allocator, cuDNN, kernel loads
        for _, texts, max_frames, pcm16 in requests:
            run(s, texts, max_frames, pcm16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_conv_residual.launches = 0
    reset_gru_counters()
    wavs = {}
    for s, repeats in ((syn, REPEATS), (pallas, 1)):
        for name, texts, max_frames, pcm16 in requests:
            B = len(texts)
            kind = numerics(s.t2v_cfg, B)
            kernel = GRU_KERNELS[kind][1]
            times = []
            for _ in range(repeats):
                f0, g0 = fused_conv_residual.launches, kernel.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                wav, n_samples = run(s, texts, max_frames, pcm16)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                check(fused_conv_residual.launches - f0 == 30,
                      f"{name}: {fused_conv_residual.launches - f0} fused ResBlock2 launches, "
                      "not 30")
                check(kernel.launches - g0 == 1,
                      f"{name}: {kernel.launches - g0} {kind} BiGRU launches, not 1")
            ms = float(np.median(times))
            frames = n_samples // syn.v2w_cfg.total_upsample
            check(wav.shape == (B, max_frames * syn.v2w_cfg.total_upsample),
                  f"{name}: wav shape {wav.shape}")
            check(wav.dtype == (np.int16 if pcm16 else np.float32), f"{name}: dtype {wav.dtype}")
            if not pcm16:
                check(bool(np.isfinite(wav).all()), f"{name}: non-finite audio")
            check(bool((frames > 0).all() and (frames <= max_frames).all()),
                  f"{name}: total_frames {frames} outside (0, {max_frames}]")
            wavs[s.t2v_cfg.gru_impl, name] = wav
            audio_s = float(n_samples.sum()) / SAMPLE_RATE
            print(f"request {name} (gru_impl {s.t2v_cfg.gru_impl!r}: the {kind} BiGRU): B={B} "
                  f"max_frames={max_frames} total_frames={frames.tolist()} median {ms:.2f} ms of "
                  f"{repeats} (min {min(times):.2f}, max {max(times):.2f}), {audio_s:.2f} s of "
                  f"speech, realtime factor {audio_s / (ms / 1e3):.1f}, "
                  f"wav std {wav.std() / (32767.0 if pcm16 else 1.0):.3f}")
    print(f"serving peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("b1_f512", "b1_f3000", "b2_f1024"):
        a, b = wavs["scan", name], wavs["pallas", name]
        print(f"  {name}: the bf16 BiGRU's waveform {np.linalg.norm(b - a) / np.linalg.norm(a):.3g}"
              " of the norm from the f32 one's")
    del pallas

    # pcm16 is the float waveform clipped, scaled and truncated toward zero
    want = (np.clip(wavs["scan", "b2_f1024"], -1.0, 1.0) * 32767.0).astype(np.int16)
    diff = np.abs(wavs["scan", "b2_f1024_pcm16"].astype(np.int32) - want.astype(np.int32)).max()
    check(diff <= 1, f"pcm16 differs from the float waveform by {diff} steps")

    # the port's entry(): its own seeded full-size models (the default
    # configs, gru_impl "scan") and inputs, text -> latents -> wav at B = 1
    # over 256 frames
    f0, g0 = fused_conv_residual.launches, gru_fwd_f32.launches
    fn, args = entry()
    wav, total = fn(*args)
    torch.cuda.synchronize()
    check(tuple(wav.shape) == (1, 256 * 320) and bool(torch.isfinite(wav).all()),
          f"entry(): wav {tuple(wav.shape)}")
    check(fused_conv_residual.launches - f0 == 30 and gru_fwd_f32.launches - g0 == 1,
          "entry(): launch counts")
    print(f"entry(): wav {tuple(wav.shape)}, total_frames {total.tolist()}")

    launches = dict(fused_resblock=fused_conv_residual.launches, gru_fwd=gru_fwd.launches,
                    gru_fwd_f32=gru_fwd_f32.launches, gru_fwd_steps=gru_step_launches())
    n_forwards = REPEATS * len(requests) + 1
    check(launches["fused_resblock"] == 30 * (n_forwards + len(requests)),
          f"launch counts {launches}")
    check(launches["gru_fwd_f32"] == n_forwards and launches["gru_fwd"] == len(requests),
          f"launch counts {launches}")
    # the BiGRU's serving shapes (B <= 2, H = 1024) take the persistent
    # route in both numerics: one device launch a call, not one a time step
    check(launches["gru_fwd_steps"] == n_forwards + len(requests),
          f"BiGRU device launches {launches}")
    steps = gru_fwd.time_steps + gru_fwd_f32.time_steps
    print(f"launches on the main path: {launches}; the persistent BiGRU kernels ran {steps} time "
          f"steps in {gru_step_launches()} launches, {steps - gru_step_launches()} step launches "
          "fewer than one a step")
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


def ptxas_report(source: str, kernels, no_spill=()) -> None:
    """ptxas's register and spill report of each instance of ``kernels``
    (names in ``csrc/<source>.cu``); those in ``no_spill`` must not spill."""
    log = kernel_build.build_log(source).splitlines()
    for i, line in enumerate(log):
        if "entry function" not in line:
            continue
        for kern in kernels:
            # the mangled name: its length, the name, then template arguments
            m = re.search(f"{len(kern)}{kern}" + r"(I(?:Li\d+E)+E)?", line)
            if m is None:
                continue
            args = ", ".join(re.findall(r"Li(\d+)E", m.group(1) or ""))
            name = f"{kern}<{args}>" if args else kern
            info = " ".join(x.strip() for x in log[i + 1:i + 4] if "registers" in x or "spill" in x)
            print(f"  {name}: {info}")
            if kern in no_spill:
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
                check(spills is not None and spills.groups() == ("0", "0"), f"{name} spills: {info}")


# (B, C, T, k, d) of the fused unit's edge cases in phase 5
FUSED_EDGES = ((2, 18, 77, 5, 2), (1, 48, 100, 11, 3), (2, 256, 130, 9, 1))


def check_fused(syn, frames: int = 512):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, err=0.0)
    print("fused ResBlock2 kernel, ptxas (kernel<time rows, channels, warp rows, warp channels, "
          "blocks an SM, taps (0: at run time)>):")
    ptxas_report("fused_resblock", ("fused_resblock_kernel",), ("fused_resblock_kernel",))
    print(f"fused ResBlock2 unit, kernel (3xTF32 mma.sync) vs plain (atol {FUSED_ATOL}), B=1, "
          f"{frames} frames; bounds at the CUDA cores' f32 {PEAK_F32 / 1e12:.0f} TFLOP/s and at "
          f"3xTF32's {PEAK_F32_TC / 1e12:.0f} TFLOP/s (three TF32 products a product):")
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
        tc, tc_by = bound_ms(n_bytes, n_ops, PEAK_F32_TC)
        print(f"  stage {stage} C={C:3d} T={T:6d} k={k:2d} d={d}: err {err:.2e}  kernel {ms:.3f} ms"
              f"  plain {plain:.3f} ms  conv1d {lib:.3f} ms  bound {bms:.3f} ms ({by}), 3xTF32 "
              f"{tc:.3f} ms ({tc_by}, {100 * tc / ms:.1f}%)  {n_ops / ms / 1e9:.1f} TFLOP/s")
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += n_bytes
        tot["ops"] += n_ops
        tot["err"] = max(tot["err"], err)
    # off the Generator's shapes: a width that is no multiple of 4 (one-float
    # copies), kernel sizes built with k at run time, partial tiles, B = 2
    for B, C, T, k, d in FUSED_EDGES:
        x = torch.randn((B, T, C), generator=g, device="cuda")
        w = torch.randn((k, C, C), generator=g, device="cuda") * 0.01
        b = torch.randn((C,), generator=g, device="cuda") * 0.01
        got = fused_conv_residual(x, w, b, dilation=d, neg_slope=LRELU_SLOPE)
        want = conv_residual_plain(x, w, b, dilation=d, neg_slope=LRELU_SLOPE)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= FUSED_ATOL, f"fused unit B={B} C={C} T={T} k={k} d={d}: max |err| {err:.3g}")
        print(f"  edge B={B} C={C:3d} T={T:6d} k={k:2d} d={d}: err {err:.2e}")
        tot["err"] = max(tot["err"], err)
    bms, by = bound_ms(tot["bytes"], tot["ops"], PEAK_F32)
    tc, tc_by = bound_ms(tot["bytes"], tot["ops"], PEAK_F32_TC)
    print(f"  30 units: kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"conv1d {tot['library_ms']:.3f} ms ({tot['ms'] / tot['library_ms']:.2f}x), bound "
          f"{bms:.3f} ms ({by}) at the CUDA cores' rate ({100 * bms / tot['ms']:.1f}%), "
          f"{tc:.3f} ms ({tc_by}) at 3xTF32's ({100 * tc / tot['ms']:.1f}%), "
          f"{tot['ops'] / 1e9:.1f} GFLOP")
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tc,
                bound_by=tc_by, library_ms=tot["library_ms"])


# (B, T) of the BiGRU kernel checks: the serving requests, the training
# batch and the long bucket; and a batch where JAX's gate refuses "pallas"
# at H = 1024 (B >= 29), so that both packages compute f32 there
GRU_SHAPES = ((1, 512), (2, 512), (1, 3000), (2, 3000), (TRAIN_B, TRAIN_T), (LONG_B, LONG_T))
GRU_GATE_SHAPE = (32, TRAIN_T)


def gru_case(bigru, x, kind: str, n_sm: int, smem: int) -> dict:
    """One BiGRU kernel (``kind`` "bf16" or "f32") at x's shape: against its
    plain version on both routes, its times (the planner's route and the
    one-launch-a-step route in turns, persistent, steps, steps, persistent,
    where the planner's is persistent), the serial floor, the plain
    version's time and the byte and operation bounds."""
    B, T, H = x.shape
    gi, w_hh, b_hh = bigru.recurrence_inputs(x)
    w_hh = w_hh.to(torch.bfloat16) if kind == "bf16" else w_hh
    kernel = GRU_KERNELS[kind][1]
    plan = gru_fwd_plan(2, B, H, n_sm, smem, kind)
    got = kernel(gi, w_hh, b_hh)
    got_steps = gru_fwd_steps(gi, w_hh, b_hh)
    want = gru_fwd_plain(gi, w_hh, b_hh, kind)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_steps = (got_steps - want).abs().max().item()
    del got, got_steps, want
    atol = GRU_ATOL if kind == "bf16" else GRU_F32_ATOL
    check(err <= atol and err_steps <= atol,
          f"{kind} BiGRU B={B} T={T}: max |err| {err:.3g} {plan.route}, {err_steps:.3g} steps")
    runs = {"persistent": [], "steps": []}
    order = (("persistent", kernel), ("steps", gru_fwd_steps), ("steps", gru_fwd_steps),
             ("persistent", kernel)) if plan.route == "persistent" else (("steps", kernel),)
    for route, fn in order:
        runs[route].append(cuda_ms(lambda: fn(gi, w_hh, b_hh), 3))
    steps_ms = float(np.mean(runs["steps"]))
    ms = float(np.mean(runs[plan.route]))
    floor = (cuda_ms(lambda: gru_barrier_loop(2, B, T, H, "cuda", kind), 3) * T / max(T - 1, 1)
             if plan.route == "persistent" else float("nan"))
    plain = cuda_ms(lambda: gru_fwd_plain(gi, w_hh, b_hh, kind), 1, warmup=0)
    n_bytes = (4.0 * gi.numel() + w_hh.element_size() * w_hh.numel() + 4.0 * b_hh.numel()
               + 4.0 * 2 * B * T * H)
    n_ops = 2.0 * 2 * B * T * H * gi.shape[-1]
    bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16 if kind == "bf16" else PEAK_F32)
    serial = max(bms, floor) if plan.route == "persistent" else bms
    line = (f"    {kind:4s} err {err:.2e} (steps route {err_steps:.2e})  {plan.route} {ms:.3f} ms "
            f"({1e3 * ms / T:.2f} us/step")
    if plan.route == "persistent":
        line += (f"; runs {runs['persistent'][0]:.3f}, {runs['persistent'][1]:.3f})  steps route "
                 f"{steps_ms:.3f} ms ({1e3 * steps_ms / T:.2f} us/step; {steps_ms / ms:.2f}x)  "
                 f"serial floor {floor:.3f} ms ({1e3 * floor / T:.2f} us/step)")
    else:
        line += ")"
    line += (f"  plain {plain:.3f} ms  bound {bms:.4f} ms ({by}, {n_ops / 1e9:.1f} GFLOP); the "
             f"larger with the floor {serial:.3f} ms ({'serial' if serial > bms else by}), "
             f"{100 * serial / ms:.1f}% of it; {plan.blocks} blocks of {plan.units} units, "
             f"{plan.smem} bytes of shared memory")
    print(line)
    return dict(max_abs_err=max(err, err_steps), ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, floor_ms=floor, route=plan.route)


def check_gru(syn):
    """Phase 5's BiGRU: both kernels (bf16, f32) at every ``GRU_SHAPES``
    entry and the f32 kernel at ``GRU_GATE_SHAPE``, beside cuDNN's f32
    ``nn.GRU`` (TF32 off), the library yardstick, timed only.  Returns the
    kernels line's entries of both (times at the 512-frame request's shape,
    the worst error over all shapes)."""
    bigru = syn.t2v.postnet.gru
    H = bigru.hidden_size
    check(not torch.backends.cudnn.allow_tf32, "cuDNN's yardstick must run without TF32")
    lib_gru = torch.nn.GRU(H, H, batch_first=True, bidirectional=True, device="cuda")
    lib_gru.load_state_dict(bigru.state_dict(), strict=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    first = {}
    print("BiGRU kernels, ptxas:")
    ptxas_report("gru_fwd", ("gru_persistent_kernel", "gru_persistent_f32_kernel",
                             "gru_barrier_loop_kernel", "gru_step_kernel"),
                 ("gru_persistent_kernel", "gru_persistent_f32_kernel"))
    n_sm, smem = device_limits(torch.device("cuda"))
    print(f"BiGRU recurrence, kernel vs plain (atol {GRU_ATOL} bf16, {GRU_F32_ATOL} f32), D=2, "
          f"H={H}, on {n_sm} SMs with {smem} bytes of shared memory a block; the serial floor is "
          f"T x a step of the persistent grid running barriers only; bounds at "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s (bf16) and {PEAK_F32 / 1e12:.0f} (f32, the CUDA cores):")
    for B, T in GRU_SHAPES + (GRU_GATE_SHAPE,):
        x = torch.randn((B, T, H), generator=g, device="cuda")
        kinds = {"pallas": gru_numerics("pallas", 2, B, H), "scan": gru_numerics("scan", 2, B, H)}
        check(kinds["scan"] == "f32", f"gru_impl scan at B={B}: {kinds}")
        if (B, T) == GRU_GATE_SHAPE:
            check(kinds["pallas"] == "f32", f"JAX's gate admits pallas at B={B}, H={H}: {kinds}")
        else:
            check(kinds["pallas"] == "bf16", f"JAX's gate refuses pallas at B={B}, H={H}: {kinds}")
        lib = cuda_ms(lambda: lib_gru(x), 3)
        print(f"  B={B:2d} T={T:4d}: gru_impl pallas -> {kinds['pallas']}, scan -> f32; cuDNN "
              f"nn.GRU (f32, TF32 off, with its input projection) {lib:.3f} ms")
        for kind in sorted(set(kinds.values())):
            case = gru_case(bigru, x, kind, n_sm, smem)
            name = GRU_KERNELS[kind][0]
            check(case["route"] == "persistent",
                  f"{kind} BiGRU B={B}: the planner picked {case['route']}")
            if name not in first:  # the 512-frame request's shape goes into the summary line
                first[name] = dict(max_abs_err=case["max_abs_err"], ms=case["ms"],
                                   plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                                   bound_by=case["bound_by"], library_ms=lib)
            first[name]["max_abs_err"] = max(first[name]["max_abs_err"], case["max_abs_err"])
        del x
        torch.cuda.empty_cache()
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


def device_events(prof) -> list:
    """The profile's device work by name: kernels, copies and fills.  The
    GPU spans of user annotations (``record_function`` labels such as
    ``Optimizer.step#Lamb.step``, which also appear among the host events
    under the same key) are dropped: they cover kernels that are counted
    already, and would count their time twice and the gaps between them as
    busy.  Prints what was dropped."""
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    kept, dropped = [], []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        annotation = e.key in host_keys or getattr(e, "is_user_annotation", False)
        (dropped if annotation else kept).append(e)
    spans = ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in dropped)
    print(f"  torch.profiler: {len(dropped)} user-annotation GPU spans left out of the busy sum"
          f"{': ' + spans if spans else ''}")
    return kept


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
    kernels = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    print(f"  torch.profiler: {n_launch} kernel launches of {len(kernels)} kernels, device busy "
          f"{busy_ms:.3f} ms = {100 * busy_ms / total:.1f}% of the uninstrumented {total:.3f} ms "
          f"request (the rest is idle, waiting on the host)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:5d}  {e.key[:110]}")


def train_config() -> Text2VecConfig:
    """The full-size demo config at the training batch of 16."""
    cfg = load_config(Text2VecConfig, repo_path("data", "demo", "text2vec.json"))
    return dataclasses.replace(cfg, batch_size=TRAIN_B)


def diagonal_prior(n: int, t: int) -> np.ndarray:
    """[t, n] prior: 1 at text position floor(i * n / t) of frame i, 1e-4
    elsewhere.  Its log makes any other monotonic path cost 9.2 a frame, far
    beyond what rounding moves in the soft alignment, so MAS has no near-ties."""
    prior = np.full((t, n), 1e-4, np.float32)
    prior[np.arange(t), np.arange(t) * n // t] = 1.0
    return prior


def synthetic_batch(cfg, B: int, N: int, T: int, seed: int, diagonal: bool = False):
    """B items with text lengths in [N/2, N] and 0.75-1 x T/N frames per
    character (12-16 at N = 64, T = 1024: 0.24-0.32 s a character at 50
    Hz), padded to (N, T); seeded 1024-d features and beta-binomial priors
    (``diagonal``: ``diagonal_prior``)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(B):
        n = int(rng.integers(N // 2, N + 1))
        t = min(T, int(round(n * rng.uniform(0.75, 1.0) * T / N)))
        prior = (diagonal_prior(n, t) if diagonal else beta_binomial_prior_distribution(
            n, t, cfg.betabinom_scaling_factor).astype(np.float32))
        items.append({
            "text_enc": rng.integers(3, cfg.vocab_size, n).astype(np.int32),
            "feat_gt_target": (rng.standard_normal((t, cfg.n_feat_dim)) * 0.5).astype(np.float32),
            "attn_prior": prior,
        })
    return make_padded_batch(items, cfg, text_pad=N, frame_pad=T)


def run_step(trainer, batch):
    total, metrics, _ = trainer.forward(batch)
    trainer.backward(total)
    trainer.apply_gradients()
    return metrics


def reset_gru_counters() -> None:
    for fn in (gru_fwd, gru_fwd_f32, gru_bwd_loop):
        fn.launches = fn.step_launches = fn.time_steps = 0


def reset_counters() -> None:
    mas_width1.launches = 0
    reset_gru_counters()
    for fn in FLASH_KERNELS:
        fn.launches = 0


def read_counters() -> dict:
    """The kernels' launches since ``reset_counters``; each of the BiGRU
    backward's must have been one device launch (its persistent route, which
    every training batch of the paths takes at H = 1024)."""
    check(gru_bwd_loop.step_launches == gru_bwd_loop.launches,
          f"BiGRU backward: {gru_bwd_loop.launches} kernel calls in "
          f"{gru_bwd_loop.step_launches} device launches")
    return dict(mas=mas_width1.launches, gru_fwd=gru_fwd.launches,
                gru_fwd_f32=gru_fwd_f32.launches, gru_bwd=gru_bwd_loop.launches,
                **{fn.__name__: fn.launches for fn in FLASH_KERNELS})


def flash_step_kernels(cfg) -> tuple:
    """The names of the three flash kernels a step of ``cfg`` launches (both
    FFT stacks take d_k = d_model // encoder_head; the long-bucket widths are
    equal) and of the three it must not."""
    d_k = cfg.decoder_model_dim // cfg.encoder_head
    used = tuple(fn.__name__ for fn in kernels_for(d_k))
    return used, tuple(fn.__name__ for fn in FLASH_KERNELS if fn.__name__ not in used)


# The two BiGRU kernels by the numerics ops.gru.gru_numerics picks for a
# config: bf16 (gru_impl "pallas" where JAX's gate holds) and f32 (every
# other case, "scan" among them, the gru_impl of every config in the repo)
GRU_KERNELS = {"bf16": ("gru_fwd", gru_fwd), "f32": ("gru_fwd_f32", gru_fwd_f32)}


def numerics(cfg, B: int) -> str:
    """The BiGRU numerics of a Text2Vec config at batch B, as JAX picks them."""
    return gru_numerics(cfg.gru_impl, 2, B, cfg.n_feat_dim)


def bigru_launches(counts: dict, cfg, B: int = 1) -> int:
    """The BiGRU launches in ``counts``; all of them must be the kernel of
    ``cfg``'s numerics at batch B (the other kernel launched none)."""
    want = GRU_KERNELS[numerics(cfg, B)][0]
    other = "gru_fwd" if want == "gru_fwd_f32" else "gru_fwd_f32"
    check(counts.get(other, 0) == 0, f"{other} launched on a {want} path: {counts}")
    return counts[want]


def gru_step_launches() -> int:
    """Device launches of both BiGRU kernels (1 a call on the persistent route)."""
    return gru_fwd.step_launches + gru_fwd_f32.step_launches


def timed_training(trainer, batch, frames: int, label: str, per_step: dict) -> dict:
    """``WARMUP_STEPS`` then ``TIMED_STEPS`` steps on one batch; the launch
    counters are set to 0 just before the timed steps and must read
    ``per_step`` times ``TIMED_STEPS`` after them.  Every loss must be
    finite and the total loss must fall.  Returns the counters."""
    totals = []
    for _ in range(WARMUP_STEPS):
        totals.append(run_step(trainer, batch)["total_loss"].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counters()
    times = []
    for _ in range(TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = run_step(trainer, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        values = torch.stack([metrics[k] for k in SCALAR_KEYS]).tolist()
        check(all(math.isfinite(v) for v in values), f"non-finite losses {values}")
        totals.append(values[0])
    launches = read_counters()
    steps = gru_fwd.time_steps + gru_fwd_f32.time_steps
    print(f"launches on the {label} path ({TIMED_STEPS} steps): {launches}, BiGRU device "
          f"launches {gru_step_launches()} for {steps} time steps "
          f"({steps - gru_step_launches()} step launches fewer than one a step)")
    want = {k: TIMED_STEPS * per_step.get(k, 0) for k in launches}
    check(launches == want, f"{label} launch counts {launches}, not {want}")
    # B = 16 at H = 1024 takes the persistent route: one device launch a call
    check(gru_step_launches() == launches["gru_fwd"] + launches["gru_fwd_f32"],
          f"{label}: {gru_step_launches()} BiGRU device launches in {launches} calls")
    ms = float(np.median(times))
    print(f"{label} step: median {ms:.2f} ms of {TIMED_STEPS} (min {min(times):.2f}, max "
          f"{max(times):.2f}), {frames / (ms / 1e3):.0f} frames/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("  last step's losses: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(SCALAR_KEYS, values)))
    print(f"  total loss over {len(totals)} steps of one batch: "
          + " ".join(f"{v:.4f}" for v in totals))
    check(totals[-1] < totals[0], f"total loss did not fall: {totals}")
    return launches


def train(dev):
    cfg = train_config()
    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    host = synthetic_batch(cfg, TRAIN_B, TRAIN_N, TRAIN_T, SEED)
    batch = trainer.to_device(host)
    frames = int(host["output_lengths"].sum())
    print(f"training: Text2Vec at full size, {sum(p.numel() for p in trainer.params) / 1e6:.1f} M "
          f"trained parameters, B={TRAIN_B} N={TRAIN_N} T={TRAIN_T}, {frames} real frames, "
          f"dropout {cfg.dropout}, lr {cfg.learning_rate}")
    print(f"the BiGRU's numerics: {numerics(cfg, TRAIN_B)} (gru_impl {cfg.gru_impl!r})")
    launches = timed_training(trainer, batch, frames, "training",
                              {"mas": 1, GRU_KERNELS[numerics(cfg, TRAIN_B)][0]: 1, "gru_bwd": 1})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_t2v_") as tmp:
        cfg = dataclasses.replace(load_config(Text2VecConfig, repo_path("data", "demo",
                                                                        "text2vec.json")),
                                  run_path=tmp)
        history = text2vec_loop.main(text2vec_loop.parse_args(["--max_steps", "3"]),
                                     cfg=cfg).steps
    check(len(history) == 3 and all(math.isfinite(v) for h in history.values()
                                    for v in h.values()), f"text2vec_loop: {history}")
    return trainer, batch, launches


def mas_inputs(B: int, T: int, N: int, seed: int):
    """A soft alignment on the card that looks like ConvAttention's: a
    diagonal band per item, exact zeros where the softmax underflows, lengths
    in [N/2, N] and [T/2, T] with item 0 full.  Returns (attn, in_lens,
    out_lens, share of exact zeros in the valid region)."""
    rng = np.random.default_rng(seed)
    in_lens = rng.integers(N // 2, N + 1, B)
    out_lens = rng.integers(T // 2, T + 1, B)
    in_lens[0], out_lens[0] = N, T
    i = np.arange(T)[None, :, None]
    j = np.arange(N)[None, None, :]
    centre = i * (in_lens / np.maximum(out_lens, 1))[:, None, None]
    logits = rng.standard_normal((B, T, N)) * 2.0 - (j - centre) ** 2 / 2.0
    attn = torch.softmax(torch.tensor(logits, dtype=torch.float32, device="cuda"), dim=-1)
    valid = torch.tensor((i < out_lens[:, None, None]) & (j < in_lens[:, None, None]),
                         device="cuda")
    zeros = float((attn[valid] == 0).float().mean())
    return (attn, torch.tensor(in_lens, dtype=torch.int32, device="cuda"),
            torch.tensor(out_lens, dtype=torch.int32, device="cuda"), zeros)


def sharp_mas_inputs(B: int, T: int, N: int, seed: int):
    """ConvAttention at temperature 0.0005: a softmax over text of logits in
    the hundreds underflows to exact zeros, on the best path too, so paths
    tie at -1e30 and the backtrack can leave the map (as in
    ``tests/test_torch_mas.py``'s "sharp" case).  Variable lengths."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, N)) * 200.0
    attn = torch.softmax(torch.tensor(logits, dtype=torch.float32, device="cuda"), dim=-1)
    in_lens = rng.integers(N // 2, N + 1, B)
    out_lens = rng.integers(T // 2, T + 1, B)
    in_lens[0], out_lens[0] = N, T
    return (attn, torch.tensor(in_lens, dtype=torch.int32, device="cuda"),
            torch.tensor(out_lens, dtype=torch.int32, device="cuda"))


def mas_equal(attn, il, ol, label: str):
    """The kernel's map against the plain version's on the same inputs:
    equal in every cell.  Returns (the kernel's map, max |err|)."""
    got = mas_width1(attn, il, ol)
    want = mas_width1_plain(attn, il, ol)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"MAS {label}: {n_diff} cells differ from the plain version")
    return got, float((got - want).abs().max()) if got.numel() else 0.0


def check_mas():
    """Phase 9: the MAS kernel against its plain version, bit for bit, at the
    main path's shapes (timed, with the bytes bound and the serial floor)
    and at the edges."""
    smem = shared_limit(torch.device("cuda"))
    lib_bytes = kernel_build.load("mas").mas_shared_bytes
    lib_bytes.argtypes, lib_bytes.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    # the serial floor: one row's dependent step on the chain warp, timed
    # over a long run of rows with no loads, logs or stores
    row_ns = {}
    for k in range(1, MAS_MAX_K + 1):
        rows = 32768
        row_ns[k] = 1e6 * cuda_ms(lambda: mas_row_chain(rows, k), 5) / rows
    print("MAS serial floor, one row's dependent step (a shuffle, compares, max, add, take-left "
          "bits): "
          + ", ".join(f"k={k} {ns:.1f} ns" for k, ns in row_ns.items()))
    print("MAS, kernel vs plain (equal), variable lengths; bound = max(bytes, serial floor = "
          "the longest item's rows x one row's step):")
    first = None
    # the training shape, the largest buckets, a width that is no multiple
    # of 32, and the long bucket
    for B, T, N in ((TRAIN_B, TRAIN_T, TRAIN_N), (16, 3000, 128), (4, 300, 300),
                    (LONG_B, LONG_T, LONG_N)):
        attn, il, ol, zeros = mas_inputs(B, T, N, SEED)
        check(zeros > 0.2, f"MAS input has {zeros:.2f} exact zeros in the valid region")
        plan = mas_plan(T, N, smem)
        check(plan.smem == lib_bytes(T, plan.k), f"MAS plan {plan}: shared memory other than "
              f"the kernel's {lib_bytes(T, plan.k)}")
        _, err = mas_equal(attn, il, ol, f"B={B} T={T} N={N}")
        ms = cuda_ms(lambda: mas_width1(attn, il, ol), 20, queued=True)
        plain = cuda_ms(lambda: mas_width1_plain(attn, il, ol), 1, warmup=0)
        # read: the valid cells of the rows walked; written: the whole map
        n_bytes = 4.0 * int((ol.long() * il.long()).sum()) + 4.0 * B * T * N + 8.0 * B
        n_ops = 5.0 * int(ol.sum()) * N  # log, clamp, compare, max, add per cell walked
        bms, by = bound_ms(n_bytes, n_ops, PEAK_F32)
        floor = 1e-6 * row_ns[plan.k] * int(ol.max())
        print(f"  B={B} T={T:4d} N={N:3d}: {zeros:.0%} exact zeros, equal; kernel {ms:.4f} ms "
              f"({1e3 * ms / T:.3f} us/row), plain {plain:.1f} ms; bytes bound {bms:.4f} ms "
              f"({by}), serial floor {floor:.4f} ms: {100 * max(bms, floor) / ms:.1f}% of the "
              f"larger; plan: clusters of {plan.cluster}, {32 * plan.k} columns a block, "
              f"{plan.smem} bytes of shared memory")
        if first is None:  # the training step's shape goes into the summary line
            first = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=None, serial_floor_ms=floor)
        first["max_abs_err"] = max(first["max_abs_err"], err)
        del attn
        torch.cuda.empty_cache()

    # the edges: one text position; the widest N at the long bucket's T; one
    # frame; a batch with out_len 0, in_len 0 and in_len > out_len; the
    # sharp input, whose best path goes through exact zeros
    for B, T, N in ((4, 64, 1), (LONG_B, LONG_T, MAS_MAX_N), (2, 1, 5)):
        attn, il, ol, _ = mas_inputs(B, T, N, SEED)
        mas_equal(attn, il, ol, f"B={B} T={T} N={N}")
        print(f"  edge B={B} T={T} N={N}: equal; plan {mas_plan(T, N, smem)}")
        del attn
    attn, _, _, _ = mas_inputs(5, 256, 96, SEED)
    il = torch.tensor([96, 0, 90, 40, 96], dtype=torch.int32, device="cuda")
    ol = torch.tensor([256, 200, 40, 0, 1], dtype=torch.int32, device="cuda")
    got, _ = mas_equal(attn, il, ol, "lengths (in_len 0, in_len > out_len, out_len 0 and 1)")
    check(int(got[3].sum()) == 0 and int(got[1].sum()) == 1 and float(got[1, 0, 0]) == 1.0,
          "MAS: an item with out_len 0 must stay 0, one with in_len 0 hold opt[0, 0] alone")
    print(f"  edge lengths in_len {il.tolist()}, out_len {ol.tolist()}: equal")
    attn, il, ol = sharp_mas_inputs(8, 512, 96, SEED)
    got, _ = mas_equal(attn, il, ol, "sharp")
    rows_hit = got.sum(-1)
    frames = torch.arange(attn.shape[1], device="cuda")[None] < ol.long()[:, None]
    left = int((rows_hit[frames] == 0).sum())
    check(left > 0, "MAS sharp input: no backtrack left the map, so the edge was not exercised")
    print(f"  edge sharp (B=8 T=512 N=96, {float((attn == 0).float().mean()):.0%} exact zeros): "
          f"equal; {left} valid frames without a text position (the backtrack left the map)")
    return first


# (B, T) of the BiGRU backward's checks and times: the loops' small batch,
# the B = 16 x 1024 step, the long bf16 step and the long f32 step
GRU_BWD_SHAPES = ((2, 512), (TRAIN_B, TRAIN_T), (LONG_B, LONG_T), (LONG_F32_B, LONG_T))


def gru_bwd_case(bigru, B: int, T: int, g, lib_gru, n_sm: int, smem: int) -> dict:
    """The backward kernel at (B, T), on seeded inputs from the BiGRU's own
    f32 forward (so the gates lie where training puts them; w_hh the
    transposed view the autograd function holds): its loop against
    ``gru_bwd_loop_plain`` on both routes, its times (persistent, steps,
    steps, persistent), the serial floor, the bound, the plain loop, the
    whole backward with the kernel and with the plain loop, and cuDNN's f32
    ``nn.GRU`` backward alone and forward + backward."""
    H = bigru.hidden_size
    plan = gru_bwd_plan(2, B, H, n_sm, smem)
    check(plan.route == "persistent", f"BiGRU backward B={B}: the planner picked {plan}")
    with torch.no_grad():
        gi, w_hh, b_hh = bigru.recurrence_inputs(torch.randn(B, T, H, generator=g,
                                                             device="cuda"))
        ys = gru_fwd_f32(gi, w_hh, b_hh)
        hprev = torch.cat([ys.new_zeros(2, B, 1, H), ys[:, :, :-1]], dim=2)
        gh = torch.matmul(hprev, w_hh[:, None]) + b_hh[:, None, None]
        dys = torch.randn(ys.shape, generator=g, device="cuda")
        del ys
        args = (dys, gi, gh, hprev, w_hh)
        want = gru_bwd_loop_plain(*args)
        errs, abs_err = {}, 0.0
        for route, fn in (("persistent", gru_bwd_loop), ("steps", gru_bwd_steps)):
            got = fn(*args)
            torch.cuda.synchronize()
            rel = []
            for a, b in zip(got, want):
                diff = float((a - b).abs().max())
                abs_err = max(abs_err, diff)
                rel.append(diff / float(b.abs().max()))
            errs[route] = rel
            check(all(math.isfinite(e) and e <= GRU_BWD_LOOP_RTOL for e in rel),
                  f"BiGRU backward B={B} T={T} {route}: dgi, dgh max |err| / max |plain| {rel}")
            del got
        del want
        runs = {"persistent": [], "steps": []}
        for route, fn in (("persistent", gru_bwd_loop), ("steps", gru_bwd_steps),
                          ("steps", gru_bwd_steps), ("persistent", gru_bwd_loop)):
            runs[route].append(cuda_ms(lambda: fn(*args), 3))
        ms, steps_ms = float(np.mean(runs["persistent"])), float(np.mean(runs["steps"]))
        floor = cuda_ms(lambda: gru_bwd_barrier_loop(2, B, T, H, "cuda"), 3) * T / max(T - 1, 1)
        plain = cuda_ms(lambda: gru_bwd_loop_plain(*args), 1, warmup=0)
        whole = cuda_ms(lambda: gru_bwd(dys, gi, hprev, w_hh, b_hh), 3)
        whole_plain = cuda_ms(lambda: gru_bwd_plain(dys, gi, hprev, w_hh, b_hh), 1, warmup=0)
    # the loop's least work: the product dgh . w_hh^T of every step (the
    # steps' gate arithmetic is O(1/H) of it); its tensors moved once
    n_ops = 2.0 * 2 * B * T * 3 * H * H
    n_bytes = 4.0 * (2 * dys.numel() + 2 * gi.numel() + w_hh.numel() + 2 * gi.numel())
    bms, by = bound_ms(n_bytes, n_ops, PEAK_F32)
    serial = max(bms, floor)
    del args, dys, gi, gh, hprev
    x = torch.randn(B, T, H, device="cuda", requires_grad=True)
    dout = torch.randn(B, T, 2 * H, device="cuda")
    params = list(lib_gru.parameters())
    out = lib_gru(x)[0]
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, [x] + params, dout, retain_graph=True), 3)
    del out
    lib_all = cuda_ms(lambda: torch.autograd.grad(lib_gru(x)[0], [x] + params, dout), 2)
    del x, dout
    torch.cuda.empty_cache()
    print(f"  B={B:2d} T={T:4d}: dgi, dgh max |err| / max |plain| persistent "
          f"{errs['persistent'][0]:.2e}, {errs['persistent'][1]:.2e}; steps route "
          f"{errs['steps'][0]:.2e}, {errs['steps'][1]:.2e} (max |err| {abs_err:.2e})\n"
          f"    loop: persistent {ms:.3f} ms ({1e3 * ms / T:.2f} us/step; runs "
          f"{runs['persistent'][0]:.3f}, {runs['persistent'][1]:.3f}), steps route "
          f"{steps_ms:.3f} ms ({steps_ms / ms:.2f}x), serial floor {floor:.3f} ms "
          f"({1e3 * floor / T:.2f} us/step), bound {bms:.3f} ms ({by}, {n_ops / 1e9:.1f} GFLOP); "
          f"the larger {serial:.3f} ms is {100 * serial / ms:.1f}% of the kernel; plain loop "
          f"{plain:.3f} ms ({plain / ms:.1f}x); {plan.blocks} blocks of {plan.units} units, "
          f"{plan.smem} bytes of shared memory\n"
          f"    whole backward (gh, loop, dw_hh, db_hh): {whole:.3f} ms with the kernel, "
          f"{whole_plain:.3f} ms with the plain loop; cuDNN nn.GRU (f32, TF32 off) backward "
          f"alone {lib_bwd:.3f} ms, forward + backward {lib_all:.3f} ms")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib_bwd, floor_ms=floor, steps_ms=steps_ms, whole_ms=whole,
                whole_plain_ms=whole_plain, library_fwd_bwd_ms=lib_all)


def check_gru_backward(bigru) -> dict:
    """Phase 10; returns the kernels line's entry of the backward kernel: its
    times at the B = 16 x 1024 step's shape, the worst error over all
    shapes and routes."""
    H = bigru.hidden_size
    check(not torch.backends.cudnn.allow_tf32, "cuDNN's yardstick must run without TF32")
    print("BiGRU backward kernel, ptxas:")
    ptxas_report("gru_bwd", ("gru_bwd_persistent_kernel", "gru_bwd_step_kernel"),
                 ("gru_bwd_persistent_kernel",))
    n_sm, smem = device_limits(torch.device("cuda"))
    print(f"BiGRU backward loop, kernel vs plain (rtol {GRU_BWD_LOOP_RTOL}), D=2, H={H}, on "
          f"{n_sm} SMs with {smem} bytes of shared memory a block; the serial floor is T x a "
          f"step of the persistent grid running barriers only; bound at "
          f"{PEAK_F32 / 1e12:.0f} TFLOP/s (f32, the CUDA cores); {card_line()}:")
    lib_gru = torch.nn.GRU(H, H, batch_first=True, bidirectional=True, device="cuda")
    lib_gru.load_state_dict(bigru.state_dict(), strict=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {shape: gru_bwd_case(bigru, *shape, g, lib_gru, n_sm, smem)
             for shape in GRU_BWD_SHAPES}
    del lib_gru
    row = {k: cases[TRAIN_B, TRAIN_T][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    row["max_abs_err"] = max(case["max_abs_err"] for case in cases.values())

    g = torch.Generator().manual_seed(SEED)
    B, T = 2, 512
    with torch.no_grad():
        gi, w_hh, b_hh = (t.detach().cpu() for t in bigru.recurrence_inputs(
            torch.randn(B, T, H, generator=g).cuda()))
    ys = gru_fwd_plain(gi, w_hh, b_hh, bigru.numerics(B))
    hprev = torch.cat([ys.new_zeros(2, B, 1, H), ys[:, :, :-1]], dim=2)
    dys = torch.randn(ys.shape, generator=g)
    args = (dys, gi, hprev, w_hh, b_hh)
    want = gru_bwd_plain(*args)
    got = gru_bwd(*(a.cuda() for a in args))
    errs = []
    for name, a, b in zip(("dgi", "dw_hh", "db_hh"), got, want):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        errs.append(err)
        check(err <= GRU_BWD_RTOL, f"BiGRU backward {name}: card vs CPU {err:.3g} of max")
    print(f"BiGRU backward (the kernel's loop), card vs CPU (plain) at B={B} T={T} H={H}: max "
          f"|err| / max |g| dgi {errs[0]:.2e}, dw_hh {errs[1]:.2e}, db_hh {errs[2]:.2e} (rtol "
          f"{GRU_BWD_RTOL})")
    reset_gru_counters()  # the steps route ran here: no later read may count it
    return row


def grad_spread(got, ref):
    """||got - ref|| / ||ref|| over all gradients, and the largest of it per
    tensor among those whose largest gradient exceeds 1e-5 (the rest are 0
    but for rounding), with that tensor's name."""
    worst, worst_name, sq_err, sq_ref = 0.0, "", 0.0, 0.0
    for name, g_ref in ref.items():
        diff = float((got[name] - g_ref).norm())
        sq_err, sq_ref = sq_err + diff ** 2, sq_ref + float(g_ref.norm()) ** 2
        if float(g_ref.abs().max()) > 1e-5 and diff / float(g_ref.norm()) > worst:
            worst, worst_name = diff / float(g_ref.norm()), name
    return math.sqrt(sq_err / sq_ref), worst, worst_name


def step_result(cfg, state, host, dev, dtype=None) -> dict:
    """One step's forward and backward (no update) of a model with the
    weights ``state`` on ``dev``: losses, hard alignment, durations and
    gradients, on the host."""
    model = Text2Vec(cfg, device=dev, dtype=dtype)
    model.load_state_dict(state, strict=True)
    tr = Text2VecTrainer(cfg, device=dev, model=model)
    total, metrics, out = tr.forward(tr.to_device(host))
    tr.backward(total)
    return dict(losses=[metrics[k].item() for k in SCALAR_KEYS],
                attn=out["attn"].cpu(), duration=out["duration"].cpu(),
                grads={n: p.grad.cpu() for n, p in model.named_parameters()
                       if p.grad is not None})


def compare_steps(card, cpu, loss_rtol) -> float:
    """Alignment and durations equal, losses within ``loss_rtol``, the same
    parameters with gradients; returns the losses' relative error."""
    check(torch.equal(card["attn"], cpu["attn"]) and torch.equal(card["duration"], cpu["duration"]),
          "hard alignment or durations differ between the card and the CPU")
    loss_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card["losses"], cpu["losses"]))
    check(loss_err <= loss_rtol, f"losses differ by {loss_err:.3g} (relative)")
    check(card["grads"].keys() == cpu["grads"].keys(), "different parameters got gradients")
    return loss_err


def grad_module(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "encoder" else parts[0]


def grad_dist(a, b, names) -> float:
    return math.sqrt(sum(float((a[n] - b[n]).norm()) ** 2 for n in names))


def check_step_against_cpu(cfg):
    """The same seeded full-size weights and one small batch through one
    step's forward and backward on the card and on the CPU (where the
    kernels take their plain versions), dropout 0.  The CPU runs again on
    one thread: how far its own sums in another order move the gradients
    is printed beside the card's difference."""
    cfg = dataclasses.replace(cfg, dropout=0.0)
    torch.manual_seed(SEED + 1)
    state = Text2Vec(cfg, device="cpu").state_dict()
    host = synthetic_batch(cfg, CHECK_B, CHECK_N, CHECK_T, SEED + 1)
    threads = torch.get_num_threads()
    card = step_result(cfg, state, host, "cuda")
    cpu = step_result(cfg, state, host, "cpu")
    torch.set_num_threads(1)
    cpu1 = step_result(cfg, state, host, "cpu")
    torch.set_num_threads(threads)
    loss_err = compare_steps(card, cpu, STEP_LOSS_RTOL)
    total_err, worst, worst_name = grad_spread(card["grads"], cpu["grads"])
    check(total_err <= STEP_GRAD_GLOBAL_RTOL, f"gradients: card vs CPU {total_err:.3g} of the norm")
    check(worst <= STEP_GRAD_RTOL, f"gradient {worst_name}: card vs CPU {worst:.3g} of its norm")
    cpu_total, cpu_worst, cpu_worst_name = grad_spread(cpu1["grads"], cpu["grads"])
    print(f"training step, card vs CPU (B={CHECK_B} N={CHECK_N} T={CHECK_T}, dropout 0): "
          f"hard alignment and durations equal, losses {loss_err:.2e} (rtol {STEP_LOSS_RTOL}), "
          f"{len(cpu['grads'])} gradients: ||card - CPU|| / ||CPU|| {total_err:.2e} in all "
          f"(rtol {STEP_GRAD_GLOBAL_RTOL}), worst tensor {worst:.2e} in {worst_name} "
          f"(rtol {STEP_GRAD_RTOL}); the CPU on 1 thread vs {threads}: {cpu_total:.2e} in all, "
          f"worst tensor {cpu_worst:.2e} in {cpu_worst_name}")


def profile_step(trainer, batch) -> None:
    """Where one training step's time goes."""
    def timed_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _, out = trainer.forward(batch)
        ev[1].record()
        trainer.backward(total)
        ev[2].record()
        trainer.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], out

    runs = sorted((timed_step()[0] for _ in range(3)), key=sum)
    fwd, bwd, opt = runs[1]
    step_ms = fwd + bwd + opt
    print(f"training step split (median of 3, CUDA events): forward {fwd:.2f} ms, backward "
          f"{bwd:.2f} ms, optimizer {opt:.2f} ms, {step_ms:.2f} ms in all")

    _, out = timed_step()
    attn = out["attn_soft"].detach().contiguous()
    il, ol = batch["input_lengths"], batch["output_lengths"]
    bigru = trainer.model.postnet.gru
    B, T = batch["feat_target"].shape[:2]
    x = torch.randn(B, T, bigru.hidden_size, device="cuda")
    with torch.no_grad():
        gi, w_hh, b_hh = bigru.recurrence_inputs(x)
        kind = bigru.numerics(B)
        fwd_kernel = GRU_KERNELS[kind][1]
        w_fwd = w_hh.to(torch.bfloat16) if kind == "bf16" else w_hh
        ys = fwd_kernel(gi, w_fwd, b_hh)
        hprev = torch.cat([ys.new_zeros(2, B, 1, ys.shape[-1]), ys[:, :, :-1]], dim=2)
        gh = torch.matmul(hprev, w_hh[:, None]) + b_hh[:, None, None]
        dys = torch.randn_like(ys)
        parts = {
            "MAS kernel": cuda_ms(lambda: mas_width1(attn, il, ol), 5),
            f"BiGRU forward kernel ({kind})": cuda_ms(lambda: fwd_kernel(gi, w_fwd, b_hh), 3),
            "BiGRU backward (gh, the loop kernel, dw_hh, db_hh)":
                cuda_ms(lambda: gru_bwd(dys, gi, hprev, w_hh, b_hh), 3),
            "  of which the loop kernel": cuda_ms(lambda: gru_bwd_loop(dys, gi, gh, hprev, w_hh),
                                                  3),
        }
        del gh
    for name, ms in parts.items():
        print(f"  {name} at B={B} T={T}: {ms:.2f} ms ({100 * ms / step_ms:.1f}% of the step)")
    # the backward's least work: gh recomputed, the reverse loop's product
    # and dw_hh, each 2*D*B*T*H*3H f32 operations; its tensors moved once
    n_ops = 3 * 2.0 * gi.numel() * hprev.shape[-1]
    n_bytes = 4.0 * (2 * dys.numel() + 2 * gi.numel() + 2 * w_hh.numel() + 2 * b_hh.numel())
    bms, by = bound_ms(n_bytes, n_ops, PEAK_F32)
    print(f"  BiGRU backward bound: {bms:.2f} ms ({by}; {n_ops / 1e9:.0f} GFLOP)")

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        timed_step()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    print(f"  torch.profiler, one step: {n_launch} kernel launches of {len(kernels)} kernels, "
          f"device busy {busy_ms:.2f} ms = {100 * busy_ms / step_ms:.1f}% of the uninstrumented "
          f"{step_ms:.2f} ms step (profiled wall {wall_ms:.1f} ms)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:6d}  {e.key[:100]}")
    flash = {}
    for e in kernels:
        name = re.search(r"flash_\w+|wide_\w+", e.key)
        if name:
            ms, n = flash.get(name.group(0), (0.0, 0))
            flash[name.group(0)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if flash:
        flash_ms = sum(ms for ms, _ in flash.values())
        parts = ", ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in sorted(flash.items()))
        print(f"  flash kernels: {flash_ms:.2f} ms of device time ({100 * flash_ms / busy_ms:.1f}% "
              f"of busy): {parts}")


def long_config() -> Text2VecConfig:
    """The JAX package's long-bucket training config, read where it lies."""
    return load_config(Text2VecConfig, repo_path(*LONG_CFG))


def flash_case(B: int, T: int, dtype, seed: int, lens=None, D: int = FLASH_D, H: int = FLASH_H):
    """q, k, v [B, H, T, D] as the model passes them (transposed views of
    [B, T, H, D]), seeded N(0, 1), and segment ids of the lengths ``lens``,
    by default mixed lengths in [T/2, T] (the first item full)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device="cuda")
               .to(dtype).transpose(1, 2) for _ in range(3))
    if lens is None:
        lens = np.random.default_rng(seed).integers(T // 2, T + 1, B)
        lens[0] = T
    seg = (torch.arange(T, device="cuda")[None]
           < torch.tensor(lens, device="cuda")[:, None]).to(torch.int32)
    return q, k, v, seg


def flash_bound(B: int, T: int, dtype, n_products: int, n_in: int, n_out: int, n_rows: int,
                peak_f32: float = PEAK_F32_TC, H: int = FLASH_H, D: int = FLASH_D):
    """Bound of a flash kernel: ``n_products`` products of 2 B H T^2 D
    operations at the bf16 tensor-core peak, or in f32 at ``peak_f32`` (by
    default f32-accurate work on the tensor cores, ``PEAK_F32_TC``); bytes:
    ``n_in`` [B, T, H, D] tensors read and ``n_out`` written, ``n_rows`` f32
    [B, H, T] rows moved and the int32 segment ids.  D is the function's own
    head dim, before any padding."""
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (size * (n_in + n_out) * B * T * H * D + 4.0 * n_rows * B * H * T + 4.0 * B * T)
    n_ops = 2.0 * n_products * B * H * T * T * D
    return bound_ms(n_bytes, n_ops, PEAK_BF16 if dtype == torch.bfloat16 else peak_f32)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# edge cases of phase 13, in both dtypes: (label, T, lengths)
FLASH_EDGES = (("straddling tile", 384, (384, 201)), ("half tile", 320, (320, 201)),
               ("shortest gated", 256, (256, 131)))
# head dims of phase 13 besides the model's 224 (the forward in bf16, the
# backward in both dtypes): the other instantiated widths, and one the
# wrapper zero-pads (96 -> 128); at T = 384, lengths 384, 201
FLASH_HEAD_DIMS = (64, 128, 256, 96)


def rate(n_ops: float, ms: float, bms: float) -> str:
    return f"{n_ops / ms / 1e9:.0f} TFLOP/s, {100 * bms / ms:.1f}% of bound"


def flash_ptxas() -> None:
    """ptxas's register and spill report of each instance of the Hopper and
    tensor-core kernels; the bf16 dQ and every f32 instance must not spill."""
    print("flash kernels, ptxas (kernel<head dim>):")
    f32 = ("flash_fwd_f32", "flash_bwd_dkv_f32", "flash_bwd_dq_f32")
    ptxas_report("flash_attn", ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16") + f32,
                 ("flash_bwd_dq_bf16",) + f32)


def check_flash():
    """Phase 13: each flash kernel against its plain version at the path's
    shapes, with times, rates, bounds and SDPA's times.  The summary line
    takes the training decoder's shape."""
    scale = 1.0 / math.sqrt(FLASH_D)
    rows = {}

    def record(name, err, ms=None, plain=None, bms=None, by=None, lib=None):
        """max_abs_err over every case; the times of the first timed case"""
        row = rows.setdefault(name, dict(max_abs_err=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if ms is not None and "ms" not in row:
            row.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)

    flash_ptxas()
    print(f"flash forward, kernel vs plain (out: rtol {FLASH_BF16_RTOL} bf16, {FLASH_F32_RTOL} f32 "
          f"of max |out|; lse: atol {FLASH_LSE_ATOL}), H={FLASH_H}; f32 bounds: 3xTF32, three "
          f"TF32 products a product at {PEAK_TF32 / 1e12:.0f} TFLOP/s:")
    cases = [("training decoder", LONG_B, LONG_T, torch.bfloat16, None, FLASH_D),
             ("training encoder", LONG_B, LONG_N, torch.bfloat16, None, FLASH_D),
             ("serving decoder", 1, LONG_T, torch.float32, None, FLASH_D),
             ("serving encoder", 1, LONG_N, torch.float32, None, FLASH_D)]
    cases += [(label, len(lens), T, dtype, lens, FLASH_D) for label, T, lens in FLASH_EDGES
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [("head dim", 2, 384, torch.bfloat16, (384, 201), D) for D in FLASH_HEAD_DIMS]
    old_yardstick = True
    for label, B, T, dtype, lens, D in cases:
        q, k, v, seg = flash_case(B, T, dtype, SEED, lens, D)
        scale_d = 1.0 / math.sqrt(D)
        out, lse = flash_fwd(q, k, v, seg, scale_d)
        want, want_lse = flash_attention_plain(q, k, v, seg, scale_d)
        torch.cuda.synchronize()
        err, lse_err = rel_err(out, want), float((lse - want_lse).abs().max())
        tol = FLASH_BF16_RTOL if dtype == torch.bfloat16 else FLASH_F32_RTOL
        check(err <= tol and lse_err <= FLASH_LSE_ATOL,
              f"flash forward {label} D={D} {dtype}: out {err:.3g} of max, lse {lse_err:.3g}")
        head = (f"  {label} [{B}, {FLASH_H}, {T}, {D}] {str(dtype)[6:]}: out {err:.2e} of "
                f"max, lse {lse_err:.2e}")
        abs_err = float((out.float() - want.float()).abs().max())
        if lens is not None:
            print(f"{head}, lengths {list(lens)}")
            record("flash_fwd", abs_err)
            continue
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]
        reps = 10
        ms = cuda_ms(lambda: flash_fwd(q, k, v, seg, scale), reps, queued=True)
        plain = cuda_ms(lambda: flash_attention_plain(q, k, v, seg, scale), 1, warmup=0)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
                      reps, queued=True)
        bms, by = flash_bound(B, T, dtype, 2, 3, 1, 1)
        n_ops = 2 * 2.0 * B * FLASH_H * T * T * FLASH_D
        extra = ""
        if dtype == torch.float32 and old_yardstick:
            old, _ = flash_bound(B, T, dtype, 2, 3, 1, 1, peak_f32=PEAK_F32)
            extra = (f" (at the CUDA cores' {PEAK_F32 / 1e12:.0f} TFLOP/s, the yardstick of "
                     f"the f32 kernels before the tensor-core forward: {old:.4f} ms)")
            old_yardstick = False
        print(f"{head}; kernel {ms:.3f} ms ({rate(n_ops, ms, bms)}), plain {plain:.3f} ms, "
              f"SDPA {lib:.3f} ms, bound {bms:.4f} ms ({by}){extra}")
        record("flash_fwd", abs_err, ms, plain, bms, by, lib)

    print(f"flash backward, kernels vs autograd of the plain version (rtol {FLASH_BF16_RTOL} bf16, "
          f"{FLASH_F32_RTOL} f32 of max |grad|):")
    cases = [("training decoder", 2, LONG_B, LONG_T, dtype, None, FLASH_D)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("training encoder", LONG_B, LONG_B, LONG_N, dtype, None, FLASH_D)
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(label, len(lens), None, T, dtype, lens, FLASH_D) for label, T, lens in FLASH_EDGES
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [("head dim", 2, None, 384, dtype, (384, 201), D) for D in FLASH_HEAD_DIMS
              for dtype in (torch.bfloat16, torch.float32)]
    for label, B_cmp, B, T, dtype, lens, D in cases:
        q, k, v, seg = flash_case(B_cmp, T, dtype, SEED + 1, lens, D)
        scale_d = 1.0 / math.sqrt(D)
        dout = torch.randn(q.shape, device="cuda").to(dtype)
        out, lse = flash_fwd(q, k, v, seg, scale_d)
        ins = backward_inputs(q, k, v, seg, out, lse, dout)
        dk, dv = flash_bwd_dkv(ins, scale_d)
        dq = flash_bwd_dq(ins, scale_d)
        del ins
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(flash_attention_plain(*qkv, seg, scale_d)[0], qkv, dout)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        tol = FLASH_BF16_RTOL if dtype == torch.bfloat16 else FLASH_F32_RTOL
        check(max(errs.values()) <= tol, f"flash backward {label} D={D} {dtype}: {errs}")
        head = (f"  {label} [{B_cmp}, {FLASH_H}, {T}, {D}] {str(dtype)[6:]}: dq {errs['dq']:.2e}, "
                f"dk {errs['dk']:.2e}, dv {errs['dv']:.2e} of max")
        abs_err = {n: float((a.float() - b.float()).abs().max())
                   for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        if lens is not None:
            print(f"{head}, lengths {list(lens)}")
            record("flash_bwd_dkv", max(abs_err["dk"], abs_err["dv"]))
            record("flash_bwd_dq", abs_err["dq"])
            continue
        times = flash_backward_times(B, T, dtype, scale)
        b_dkv, by_dkv = flash_bound(B, T, dtype, 4, 4, 2, 2)
        b_dq, by_dq = flash_bound(B, T, dtype, 3, 4, 1, 2)
        product = 2.0 * B * FLASH_H * T * T * FLASH_D
        total = times["prep"] + times["dkv"] + times["dq"]
        print(f"{head}; at B={B}: dK/dV kernel {times['dkv']:.3f} ms "
              f"({rate(4 * product, times['dkv'], b_dkv)}; bound {b_dkv:.4f}, {by_dkv}), dQ kernel "
              f"{times['dq']:.3f} ms ({rate(3 * product, times['dq'], b_dq)}; bound {b_dq:.4f}, "
              f"{by_dq}), their shared preparation (delta, layouts) {times['prep']:.3f} ms; a call "
              f"alone with its preparation: dK/dV {times['call_dkv']:.3f} ms, dQ "
              f"{times['call_dq']:.3f} ms; plain backward {times['plain']:.3f} ms, SDPA forward + "
              f"backward {times['sdpa']:.3f} ms, SDPA backward alone {times['sdpa_bwd']:.3f} ms; "
              f"the backward (preparation + dK/dV + dQ) {total:.3f} ms, "
              f"{total / times['sdpa_bwd']:.2f}x SDPA's backward")
        # the bf16 step's dtype gives the kernels line's times; f32 under f32_ keys
        for name, err, call, bms, by in (
                ("flash_bwd_dkv", max(abs_err["dk"], abs_err["dv"]), times["call_dkv"], b_dkv,
                 by_dkv),
                ("flash_bwd_dq", abs_err["dq"], times["call_dq"], b_dq, by_dq)):
            if dtype == torch.bfloat16:
                record(name, err, call, times["plain"], bms, by, times["sdpa"])
                continue
            record(name, err)
            row = rows[name]
            if "f32_ms" not in row:
                row.update(f32_ms=call, f32_plain_ms=times["plain"], f32_bound_ms=bms,
                           f32_bound_by=by, f32_sdpa_bwd_ms=times["sdpa_bwd"])
    return rows


def flash_backward_times(B: int, T: int, dtype, scale: float) -> dict:
    """Times of the backward kernels at [B, 2, T, 224] (mixed lengths): each
    kernel alone on one shared ``backward_inputs`` (timed apart), as the
    backward calls them, and each call made alone with its own preparation;
    the plain backward, SDPA's forward + backward and SDPA's backward alone
    (``autograd.grad`` on a retained graph), with the same boolean mask."""
    q, k, v, seg = flash_case(B, T, dtype, SEED + 1)
    dout = torch.randn(q.shape, device="cuda").to(dtype)
    out, lse = flash_fwd(q, k, v, seg, scale)
    reps = 10
    ins = backward_inputs(q, k, v, seg, out, lse, dout)
    t = dict(prep=cuda_ms(lambda: backward_inputs(q, k, v, seg, out, lse, dout), reps, queued=True),
             dkv=cuda_ms(lambda: flash_bwd_dkv(ins, scale), reps, queued=True),
             dq=cuda_ms(lambda: flash_bwd_dq(ins, scale), reps, queued=True))
    del ins
    t["call_dkv"] = cuda_ms(lambda: flash_bwd_dkv(backward_inputs(q, k, v, seg, out, lse, dout),
                                                  scale), reps, queued=True)
    t["call_dq"] = cuda_ms(lambda: flash_bwd_dq(backward_inputs(q, k, v, seg, out, lse, dout),
                                                scale), reps, queued=True)
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    o_plain = flash_attention_plain(*qkv, seg, scale)[0]
    t["plain"] = cuda_ms(lambda: torch.autograd.grad(o_plain, qkv, dout, retain_graph=True), 1,
                         warmup=0)
    del o_plain
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=scale)
        torch.autograd.grad(o, qkv, dout)

    t["sdpa"] = cuda_ms(sdpa_fwd_bwd, reps, queued=True)
    o_sdpa = F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=scale)
    t["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(o_sdpa, qkv, dout, retain_graph=True), reps,
                            queued=True)
    return t


def train_long(dev, cfg=None):
    """Phase 14 (the long-bucket config) and phase 47 (its one-head copy):
    the long-bucket bf16 training step."""
    cfg = long_config() if cfg is None else cfg
    check(cfg.compute_dtype == "bfloat16" and cfg.flash_attention and cfg.dropout == 0.0,
          f"{'/'.join(LONG_CFG)} is not the bf16 flash config")
    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    check(trainer.model.decoder.layer_stack[0].slf_attn.w_qs.compute_dtype == torch.bfloat16,
          "the trainer did not build a bf16 model")
    host = synthetic_batch(cfg, LONG_B, LONG_N, LONG_T, SEED)
    batch = trainer.to_device(host)
    frames = int(host["output_lengths"].sum())
    heads = f"{cfg.encoder_head} head(s) of {cfg.decoder_model_dim // cfg.encoder_head}"
    print(f"long-bucket training: {'/'.join(LONG_CFG)}, {heads}, bf16, flash attention, "
          f"{sum(p.numel() for p in trainer.params) / 1e6:.1f} M trained parameters, "
          f"B={LONG_B} N={LONG_N} T={LONG_T}, {frames} real frames, dropout {cfg.dropout}, "
          f"lr {cfg.learning_rate}; {card_line()}")
    used, _ = flash_step_kernels(cfg)
    launches = timed_training(trainer, batch, frames, f"long-bucket training, {heads}",
                              {"mas": 1, GRU_KERNELS[numerics(cfg, LONG_B)][0]: 1, "gru_bwd": 1,
                               **{name: 8 for name in used}})
    return trainer, host, batch, launches


def train_long_f32(dev):
    """Phase 17: the long-bucket step in f32 (``compute_dtype`` float32, the
    rest as the config says) at B = ``LONG_F32_B``."""
    cfg = dataclasses.replace(long_config(), compute_dtype="float32")
    check(cfg.flash_attention and cfg.dropout == 0.0, f"{'/'.join(LONG_CFG)}: not flash, dropout 0")
    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    check(trainer.model.decoder.layer_stack[0].slf_attn.w_qs.compute_dtype is None,
          "the trainer did not build an f32 model")
    host = synthetic_batch(cfg, LONG_F32_B, LONG_N, LONG_T, SEED)
    batch = trainer.to_device(host)
    frames = int(host["output_lengths"].sum())
    print(f"f32 long-bucket training: {'/'.join(LONG_CFG)} with compute_dtype float32, flash "
          f"attention, B={LONG_F32_B} (cut from the config's {LONG_B}: f32 activations take about "
          f"twice the bf16 step's memory) N={LONG_N} T={LONG_T}, {frames} real frames, dropout "
          f"{cfg.dropout}, lr {cfg.learning_rate}")
    launches = timed_training(trainer, batch, frames, "f32 long-bucket training",
                              {"mas": 1, GRU_KERNELS[numerics(cfg, LONG_F32_B)][0]: 1,
                               "gru_bwd": 1, "flash_fwd": 8, "flash_bwd_dkv": 8,
                               "flash_bwd_dq": 8})
    return trainer, batch, launches


def dense_long_step(dev, host) -> None:
    """The long-bucket step through the dense attention branch
    (``flash_attention=False``, the rest as the config says): its step time
    and peak device memory beside the flash step's."""
    cfg = dataclasses.replace(long_config(), flash_attention=False)
    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    batch = trainer.to_device(host)
    run_step(trainer, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run_step(trainer, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(f"  the same step, dense attention branch: {min(times):.2f} and {max(times):.2f} ms, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def check_flash_launches(cfg, per_kernel: int, label: str) -> None:
    """Each of the three flash kernels of ``cfg``'s head dim launched
    ``per_kernel`` times since the counters were set to 0; the other
    family's three, none."""
    used, other = flash_step_kernels(cfg)
    counts = read_counters()
    check(all(counts[n] == per_kernel for n in used) and not any(counts[n] for n in other),
          f"{label}: flash launches {counts}, want {per_kernel} of each of {used}")


def check_flash_step_against_cpu(cfg=None):
    """Phase 15 (the long-bucket config) and phase 46 (its one-head copy):
    one bf16 flash step, card against CPU; the CPU's f32 step on the same
    weights measures bf16's own noise in the gradients.  Then the card's f32
    flash step against that CPU f32 step.  The weights are seeded alike at
    one head and two (the projections' shapes do not depend on the head
    count)."""
    cfg = long_config() if cfg is None else cfg
    heads = f"{cfg.encoder_head} head(s) of {cfg.decoder_model_dim // cfg.encoder_head}"
    torch.manual_seed(SEED + 2)
    state = Text2Vec(cfg, device="cpu").state_dict()
    host = synthetic_batch(cfg, BF16_CHECK_B, BF16_CHECK_N, BF16_CHECK_T, SEED + 2, diagonal=True)
    reset_counters()
    card = step_result(cfg, state, host, "cuda", torch.bfloat16)
    check_flash_launches(cfg, 8, "card step")
    t0 = time.perf_counter()
    cpu = step_result(cfg, state, host, "cpu", torch.bfloat16)
    cpu_s = time.perf_counter() - t0
    cpu_f32 = step_result(cfg, state, host, "cpu")  # no dtype: an f32 model, flash as configured
    f32 = cpu_f32["grads"]
    loss_err = compare_steps(card, cpu, BF16_STEP_LOSS_RTOL)
    zeros = {n: torch.zeros_like(g) for n, g in f32.items()}
    print(f"bf16 flash training step, {heads}, card vs CPU (B={BF16_CHECK_B} N={BF16_CHECK_N} "
          f"T={BF16_CHECK_T}, diagonal prior; CPU bf16 part {cpu_s:.1f} s): hard alignment and "
          f"durations equal, losses {loss_err:.2e} (rtol {BF16_STEP_LOSS_RTOL}); gradients, "
          f"||card - CPU|| against the CPU's ||bf16 - f32||, as shares of ||f32||:")
    groups = sorted({grad_module(n) for n in f32})
    for mod in groups + ["all"]:
        names = [n for n in f32 if mod == "all" or grad_module(n) == mod]
        err = grad_dist(card["grads"], cpu["grads"], names)
        noise, norm = grad_dist(cpu["grads"], f32, names), grad_dist(f32, zeros, names)
        bound = (BF16_GRAD_NOISE_ALL * noise if mod == "all"
                 else BF16_GRAD_NOISE * noise + 1e-3 * norm)
        print(f"  {mod} ({len(names)} tensors): {err / norm:.2e} against {noise / norm:.2e}")
        check(err <= bound, f"bf16 gradients of {mod}: card vs CPU {err / norm:.3g}, "
                            f"bf16 vs f32 {noise / norm:.3g} of the norm")

    reset_counters()
    card_f32 = step_result(cfg, state, host, "cuda")
    check_flash_launches(cfg, 8, "card f32 step")
    loss_err = compare_steps(card_f32, cpu_f32, STEP_LOSS_RTOL)
    total_err, worst, worst_name = grad_spread(card_f32["grads"], f32)
    check(total_err <= STEP_GRAD_GLOBAL_RTOL, f"f32 flash step gradients: card vs CPU "
                                              f"{total_err:.3g} of the norm")
    check(worst <= STEP_GRAD_RTOL, f"f32 flash step gradient {worst_name}: card vs CPU "
                                   f"{worst:.3g} of its norm")
    print(f"f32 flash training step, {heads}, card vs CPU (same weights and batch; 8 launches "
          f"of each flash kernel on the card): hard alignment and durations equal, losses {loss_err:.2e} "
          f"(rtol {STEP_LOSS_RTOL}), {len(f32)} gradients: ||card - CPU|| / ||CPU|| "
          f"{total_err:.2e} in all (rtol {STEP_GRAD_GLOBAL_RTOL}), worst tensor {worst:.2e} in "
          f"{worst_name} (rtol {STEP_GRAD_RTOL})")


def serve_long(dev, cfg=None):
    """Phase 16 (the long-bucket config) and phase 47 (its one-head copy):
    one long-bucket request in f32 through the flash forward."""
    cfg = dataclasses.replace(long_config() if cfg is None else cfg,
                              vocab_path="data/demo/vocab.txt")
    syn = make_synthesizer(dev, cfg)
    text, ref, spk = demo_inputs(syn)
    texts = [text(300)]

    def run():
        return syn.synthesize(texts, ref, spk, seed=SEED)

    run()  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        wav, n_samples = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    fwd = flash_step_kernels(cfg)[0][0]
    counts = read_counters()
    check(counts[fwd] == 8 * REPEATS and sum(counts[fn.__name__] for fn in FLASH_KERNELS)
          == 8 * REPEATS, f"long-bucket request: flash launches {counts} in {REPEATS}, not 8 "
          f"{fwd} each")
    frames = n_samples // syn.v2w_cfg.total_upsample
    check(wav.shape == (1, LONG_T * syn.v2w_cfg.total_upsample) and bool(np.isfinite(wav).all())
          and 0 < int(frames[0]) <= LONG_T, f"long-bucket request: wav {wav.shape}, {frames}")
    ms = float(np.median(times))
    audio_s = float(n_samples.sum()) / SAMPLE_RATE
    print(f"long-bucket request (f32, flash, {cfg.encoder_head} head(s) of "
          f"{cfg.decoder_model_dim // cfg.encoder_head}, text bucket {LONG_N}, {LONG_T} frames): "
          f"total_frames {frames.tolist()}, median {ms:.2f} ms of {REPEATS} (min {min(times):.2f}, "
          f"max {max(times):.2f}), {audio_s:.2f} s of speech, realtime factor "
          f"{audio_s / (ms / 1e3):.1f}, 8 {fwd} launches a request; {card_line()}")


# phase 45: head dims past 256 on the wide kernels.  The bf16 training shape
# [WIDE_B, 1, LONG_T, D] with its last item padded from WIDE_TAIL on, the
# f32 serving shapes [1, 1, LONG_T | LONG_N, D] and, at WIDE_ROW_D, the f32
# training shape [LONG_F32_B, 1, LONG_T, D]; D = 288 and 300 run
# zero-padded to 320 (chunks of 256 and 64), 448 (the long bucket's d_model
# at one head) unpadded in chunks of 256 and 192, 768 in three of 256 with
# the bf16 kernels' own operand streamed; the f32 dQ takes one chunk up to
# 512 and two of 384 at 768 (Q and dO streamed).  Tolerances: phase 13's
# FLASH_*_RTOL and FLASH_LSE_ATOL.
WIDE_DIMS = (288, 300, 448, 512, 768)
WIDE_B, WIDE_TAIL = LONG_B, 2000
WIDE_ROW_D = 448  # the kernels line's times: the one-head long-bucket step's shapes


def one_head_config() -> Text2VecConfig:
    """The long-bucket config at one head: d_k = d_v = 448 in both FFT
    stacks, the same attention work as its two heads of 224."""
    return dataclasses.replace(long_config(), encoder_head=1, decoder_head=1)


def wide_ptxas() -> None:
    """ptxas's register and spill report of each wide instance (the bf16
    forward, dK/dV and dQ on wgmma, the f32 forward, dK/dV and dQ); none
    may spill.  Also ptxas's C7515 (wgmma
    serialized) and C7519 (fences injected) lines about the bf16 dQ."""
    log = kernel_build.build_log("flash_attn").splitlines()
    seen = 0
    diags = [line.strip() for line in log
             if re.search(r"\(C751[59]\)", line) and "wide_dq_bf16" in line]
    print(f"  wide_dq_bf16: {len(diags)} C7515/C7519 line(s)"
          + "".join(f"\n    {d}" for d in diags))
    for i, line in enumerate(log):
        # the mangled name: its length, the name
        m = re.search(r"\d+(wide_(?:fwd|dkv|dq)_(?:bf16|f32))E", line)
        if m is None or "entry function" not in line:
            continue
        info = " ".join(x.strip() for x in log[i + 1:i + 4] if "registers" in x or "spill" in x)
        name = m.group(1)
        print(f"  {name}: {info}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
        check(spills is not None and spills.groups() == ("0", "0"), f"{name} spills: {info}")
        seen += 1
    check(seen == 6, f"ptxas reported {seen} wide instances, not 6")


def sdpa_backend(q, k, v, mask, scale: float) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these inputs,
    by PyTorch's own choice function."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0, False, scale=scale)).name.lower()


def check_flash_wide():
    """Phase 45: the wide kernels (forward, dK/dV, dQ) against autograd of
    the plain version at ``WIDE_DIMS``, each with its times, bound (its own
    work at the unpadded D) and SDPA's forward and forward + backward; the
    kernels line's rows take the training shape at ``WIDE_ROW_D`` (f32_ keys:
    the f32 serving decoder's)."""
    print(f"wide flash kernels (head dims past 256), ptxas; {card_line()}:")
    wide_ptxas()
    print(f"wide flash kernels vs the plain version (out, grads: rtol {FLASH_BF16_RTOL} bf16, "
          f"{FLASH_F32_RTOL} f32 of max; lse: atol {FLASH_LSE_ATOL}), H=1; bounds at the "
          f"function's own work (4 T^2 D B H forward, 8 and 6 T^2 D B H dK/dV and dQ, 10 the "
          f"backward) at the unpadded D; {card_line()}:")
    rows = {}
    cases = []
    for D in WIDE_DIMS:
        cases += [("training decoder", WIDE_B, LONG_T, D, torch.bfloat16,
                   [LONG_T] * (WIDE_B - 1) + [WIDE_TAIL]),
                  ("serving decoder", 1, LONG_T, D, torch.float32, [LONG_T]),
                  ("serving encoder", 1, LONG_N, D, torch.float32, [LONG_N])]
    cases.append(("f32 training decoder", LONG_F32_B, LONG_T, WIDE_ROW_D, torch.float32,
                  [LONG_T] * (LONG_F32_B - 1) + [WIDE_TAIL]))
    for label, B, T, D, dtype, lens in cases:
        q, k, v, seg = flash_case(B, T, dtype, SEED + 3, lens, D, H=1)
        dout = torch.randn(q.shape, device="cuda").to(dtype)
        scale = 1.0 / math.sqrt(D)
        out, lse = flash_fwd_wide(q, k, v, seg, scale)
        ins = backward_inputs(q, k, v, seg, out, lse, dout)
        dk, dv = flash_bwd_dkv_wide(ins, scale)
        dq = flash_bwd_dq_wide(ins, scale)
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o_plain, lse_plain = flash_attention_plain(*qkv, seg, scale)
        want = torch.autograd.grad(o_plain, qkv, dout, retain_graph=True)
        torch.cuda.synchronize()
        errs = {"out": rel_err(out, o_plain)}
        errs.update({n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want)})
        lse_err = float((lse - lse_plain).abs().max())
        tol = FLASH_BF16_RTOL if dtype == torch.bfloat16 else FLASH_F32_RTOL
        check(max(errs.values()) <= tol and lse_err <= FLASH_LSE_ATOL,
              f"wide flash {label} D={D} {dtype}: {errs}, lse {lse_err:.3g}")
        abs_err = {n: float((a.float() - b.float()).abs().max())
                   for n, a, b in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                                      (o_plain,) + tuple(want))}
        reps = 3 if dtype == torch.bfloat16 else 10
        t = dict(fwd=cuda_ms(lambda: flash_fwd_wide(q, k, v, seg, scale), reps, queued=True),
                 prep=cuda_ms(lambda: backward_inputs(q, k, v, seg, out, lse, dout), reps,
                              queued=True),
                 dkv=cuda_ms(lambda: flash_bwd_dkv_wide(ins, scale), reps, queued=True),
                 dq=cuda_ms(lambda: flash_bwd_dq_wide(ins, scale), reps, queued=True))
        t["call_dkv"] = cuda_ms(lambda: flash_bwd_dkv_wide(
            backward_inputs(q, k, v, seg, out, lse, dout), scale), reps, queued=True)
        t["call_dq"] = cuda_ms(lambda: flash_bwd_dq_wide(
            backward_inputs(q, k, v, seg, out, lse, dout), scale), reps, queued=True)
        t["plain"] = cuda_ms(lambda: flash_attention_plain(q, k, v, seg, scale), 1, warmup=0)
        t["plain_bwd"] = cuda_ms(lambda: torch.autograd.grad(o_plain, qkv, dout,
                                                             retain_graph=True), 1, warmup=0)
        del o_plain, ins
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=scale)
            torch.autograd.grad(o, qkv, dout)

        t["sdpa"] = cuda_ms(sdpa, reps, queued=True)
        t["sdpa_fb"] = cuda_ms(sdpa_fwd_bwd, reps, queued=True)
        o_sdpa = F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=scale)
        t["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(o_sdpa, qkv, dout, retain_graph=True),
                                reps, queued=True)
        del o_sdpa
        backend = sdpa_backend(q, k, v, mask, scale)
        b_fwd, by_fwd = flash_bound(B, T, dtype, 2, 3, 1, 1, H=1, D=D)
        b_dkv, by_dkv = flash_bound(B, T, dtype, 4, 4, 2, 2, H=1, D=D)
        b_dq, by_dq = flash_bound(B, T, dtype, 3, 4, 1, 2, H=1, D=D)
        b_bwd, _ = flash_bound(B, T, dtype, 5, 4, 3, 2, H=1, D=D)
        product = 2.0 * B * T * T * D
        bwd = t["prep"] + t["dkv"] + t["dq"]
        W = kernel_width(D)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        f32 = dtype == torch.float32
        splits = dkv_f32_splits(B, T, n_sm, len(wide_chunks(W))) if f32 else 1
        dq_splits = dq_f32_splits(B, T, n_sm, len(dq_f32_chunks(W))) if f32 else 1
        print(f"  {label} [{B}, 1, {T}, {D}] {str(dtype)[6:]} (run at {W}, chunks "
              f"{wide_chunks(W)}, dQ blocks {wide_blocks('flash_bwd_dq_wide', dtype, W)}, dK/dV "
              f"query splits {splits}, dQ key splits {dq_splits}): out {errs['out']:.2e}, lse "
              f"{lse_err:.2e}, "
              f"dq {errs['dq']:.2e}, dk {errs['dk']:.2e}, dv {errs['dv']:.2e} of max; forward "
              f"{t['fwd']:.3f} ms ({rate(2 * product, t['fwd'], b_fwd)}; bound {b_fwd:.4f}, "
              f"{by_fwd}), dK/dV {t['dkv']:.3f} ms ({rate(4 * product, t['dkv'], b_dkv)}), dQ "
              f"{t['dq']:.3f} ms ({rate(3 * product, t['dq'], b_dq)}), preparation "
              f"{t['prep']:.3f} ms, the backward {bwd:.3f} ms (bound {b_bwd:.4f}); a call alone "
              f"with its preparation: dK/dV {t['call_dkv']:.3f}, dQ {t['call_dq']:.3f} ms; plain "
              f"forward {t['plain']:.3f}, backward {t['plain_bwd']:.3f} ms; SDPA [{backend}] "
              f"forward {t['sdpa']:.3f}, forward + backward {t['sdpa_fb']:.3f}, backward "
              f"{t['sdpa_bwd']:.3f} ms; the dQ call {t['call_dq'] / t['sdpa_bwd']:.2f}x SDPA's "
              f"backward, {t['call_dq'] / t['plain_bwd']:.2f}x the plain one")
        row_err = {"flash_fwd_wide": abs_err["out"],
                   "flash_bwd_dkv_wide": max(abs_err["dk"], abs_err["dv"]),
                   "flash_bwd_dq_wide": abs_err["dq"]}
        for name, err in row_err.items():
            row = rows.setdefault(name, dict(max_abs_err=0.0))
            row["max_abs_err"] = max(row["max_abs_err"], err)
        if D != WIDE_ROW_D:
            continue
        if label == "training decoder":
            rows["flash_fwd_wide"].update(ms=t["fwd"], plain_ms=t["plain"], bound_ms=b_fwd,
                                          bound_by=by_fwd, library_ms=t["sdpa"])
            # ms: a call with its share of the preparation; kernel_ms: the kernel alone
            for name, call, alone, bms, by in (
                    ("flash_bwd_dkv_wide", t["call_dkv"], t["dkv"], b_dkv, by_dkv),
                    ("flash_bwd_dq_wide", t["call_dq"], t["dq"], b_dq, by_dq)):
                rows[name].update(ms=call, kernel_ms=alone, plain_ms=t["plain_bwd"], bound_ms=bms,
                                  bound_by=by, library_ms=t["sdpa_fb"])
        elif label == "serving decoder":
            rows["flash_fwd_wide"].update(f32_ms=t["fwd"], f32_plain_ms=t["plain"],
                                          f32_bound_ms=b_fwd, f32_bound_by=by_fwd,
                                          f32_library_ms=t["sdpa"])
        if dtype == torch.float32 and label != "serving encoder":
            key = "f32_" if label == "serving decoder" else "f32_train_"
            for name, call, alone, bms, by in (
                    ("flash_bwd_dkv_wide", t["call_dkv"], t["dkv"], b_dkv, by_dkv),
                    ("flash_bwd_dq_wide", t["call_dq"], t["dq"], b_dq, by_dq)):
                rows[name].update({key + "ms": call, key + "kernel_ms": alone,
                                   key + "plain_ms": t["plain_bwd"], key + "bound_ms": bms,
                                   key + "bound_by": by, key + "sdpa_bwd_ms": t["sdpa_bwd"]})
    return rows


def profile_t2v_loop(dev) -> None:
    """Phase 48: ``cli train-text2vec``'s loop on the demo corpus with
    ``--profile_dir`` and ``--precompile``: 9 steps, the trace of the steps
    from iteration 3 to 8 (one span each), its device kernels counted, MAS,
    the f32 BiGRU and cuDNN's convolutions among them; the precompile's
    seconds."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as tmp:
        cfg = dataclasses.replace(load_config(Text2VecConfig, repo_path("data", "demo",
                                                                        "text2vec.json")),
                                  run_path=os.path.join(tmp, "run"), epochs=4, save_step=1000,
                                  log_step=1000)
        prof_dir = os.path.join(tmp, "prof")
        args = text2vec_loop.parse_args(["--max_steps", "9", "--profile_dir", prof_dir,
                                         "--precompile"])
        buf = io.StringIO()
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rec = text2vec_loop.main(args, cfg=cfg)
        wall = time.perf_counter() - t0
        said = [line for line in buf.getvalue().splitlines()
                if line.startswith(("precompiled", "profile:"))]
        check(sorted(rec.steps) == list(range(1, 10)), f"profiled loop steps {sorted(rec.steps)}")
        check(any(line.startswith("precompiled the step's kernels") for line in said),
              f"--precompile printed nothing: {said}")
        files = os.listdir(prof_dir)
        check(files == ["text2vec_rank0.pt.trace.json"], f"--profile_dir wrote {files}")
        path = os.path.join(prof_dir, files[0])
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path) / 2**20
    spans = sorted(int(e["name"].rsplit(" ", 1)[1]) for e in events
                   if e.get("name", "").startswith(text2vec_loop.PROFILE_SPAN)
                   and e.get("cat") == "user_annotation")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    convs = [n for n in by_name if re.search(r"cudnn|implicit_gemm|fprop|dgrad|wgrad", n, re.I)]
    has = {what: any(what in n for n in by_name)
           for what in ("mas_cluster_kernel", "gru_persistent_f32_kernel")}
    check(spans == list(range(text2vec_loop.PROFILE_START, text2vec_loop.PROFILE_STOP + 1)),
          f"trace spans {spans}")
    check(all(has.values()) and convs, f"trace kernels: {has}, cuDNN convolutions {convs[:3]}")
    counts = read_counters()
    check(counts["mas"] == 9 and counts["gru_fwd_f32"] == 9, f"profiled loop launches {counts}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"text2vec loop with --profile_dir and --precompile (demo config, 9 steps, {wall:.1f} s "
          f"of wall time): {'; '.join(said)}; the trace ({size:.1f} MiB) holds the spans of "
          f"iterations {spans}, {len(kernels)} device kernel launches of {len(by_name)} kernels, "
          f"{len(convs)} of them cuDNN convolution kernels; MAS and the f32 BiGRU present; "
          f"{card_line()}")
    for name, (ms, n) in top:
        print(f"    {ms:8.3f} ms  x{n:5d}  {name[:100]}")


def gan_config() -> Vec2WavConfig:
    return load_config(Vec2WavConfig, repo_path("data", "demo", "vec2wav.json"))


def gan_batch(cfg, B: int, T: int, seed: int) -> dict:
    """``bench_v2w``'s batch: audio N(0, 0.1^2) of T x 320 samples an item,
    N(0, 1) latents and speaker embeddings, and the mel target from the
    port's host mel op."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, T * cfg.total_upsample, 1)) * 0.1).astype(np.float32)
    mel = np.stack([mel_spectrogram_np(a[:, 0], cfg.n_fft, cfg.num_mels, cfg.sampling_rate,
                                       cfg.hop_size, cfg.win_size, cfg.fmin, cfg.fmax_for_loss)
                    for a in audio])
    return {"wv_feat": rng.standard_normal((B, T, cfg.n_feat_dim)).astype(np.float32),
            "spk_emb": rng.standard_normal((B, cfg.spk_dim)).astype(np.float32),
            "audio": audio, "mel_loss": mel}


def gan_modules(cfg, dev, seed: int, dtype=None, tiled_conv: bool = False):
    """Seeded random Generator (``fused=False``), MPD and MSD on ``dev``;
    conv_post's gain is set so that, in train mode on a probe batch, the
    waveform before the tanh has a standard deviation of ``WAV_STD`` (as
    phase 2 sets the serving Generator's).  The probe runs under no_grad, in
    an f32 copy, so the modules' statistics and spectral vectors stay at
    init.  ``dtype`` (bf16: the same f32 weights, bf16 convolutions) and
    ``tiled_conv`` (the MSD's repack) as the modules take them."""
    torch.manual_seed(seed)
    gen = Generator(cfg, device="cpu", fused=False, dtype=dtype)
    mpd = MultiPeriodDiscriminator(cfg, cfg.disc_pair_batched, dtype=dtype, device="cpu")
    msd = MultiScaleDiscriminator(cfg.disc_pair_batched, tiled_conv=tiled_conv, dtype=dtype,
                                  device="cpu")
    probe = gan_batch(cfg, 1, 64, seed)
    seen = {}
    copy = Generator(cfg, device="cpu", fused=False)
    copy.load_state_dict(gen.state_dict())
    hook = copy.conv_post.register_forward_hook(
        lambda mod, args, out: seen.update(std=(out - mod.bias).std().item()))
    with torch.no_grad():
        copy.train()(torch.tensor(probe["wv_feat"]), torch.tensor(probe["spk_emb"]),
                     torch.randn(1, cfg.noise_dim, generator=torch.Generator().manual_seed(seed)))
    hook.remove()
    check(seen["std"] > 0, "the random Generator's output does not depend on its input")
    with torch.no_grad():
        gen.conv_post.weight_g.mul_(WAV_STD / seen["std"])
    return tuple(m.to(dev) for m in (gen, mpd, msd))


def gan_trainer(cfg, dev, seed: int = SEED, dtype=None, tiled_conv: bool = False) -> GANTrainer:
    gen, mpd, msd = gan_modules(cfg, dev, seed, dtype, tiled_conv)
    return GANTrainer(cfg, device=dev, seed=seed, generator=gen, mpd=mpd, msd=msd)


def timed_gan(trainer, batch, label: str, steps: int) -> list:
    """``WARMUP_STEPS`` then ``steps`` timed steps on one device batch;
    prints the median step, seconds of audio trained per second and peak
    device memory.  Returns every step's scalars (warm-up ones first)."""
    cfg = trainer.cfg
    history = []
    for _ in range(WARMUP_STEPS):
        metrics = trainer.step(batch)
        history.append([metrics[k].item() for k in GAN_KEYS])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = trainer.step(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        history.append([metrics[k].item() for k in GAN_KEYS])
    B, L = batch["audio"].shape[:2]
    ms = float(np.median(times))
    audio_s = B * L / cfg.sampling_rate
    print(f"{label} step: median {ms:.2f} ms of {steps} (min {min(times):.2f}, max "
          f"{max(times):.2f}), {audio_s / (ms / 1e3):.2f} s of audio trained per second "
          f"({audio_s:.2f} s a step), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("  last step: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(GAN_KEYS, history[-1])))
    check(all(math.isfinite(v) for h in history for v in h), f"{label}: non-finite {history}")
    return history


def train_gan(dev):
    """Phase 18: the full-size GAN step at B = ``GAN_B``, the MSD on grouped
    convolutions (timed, learning checked, profiled)."""
    cfg = gan_config()
    trainer = gan_trainer(cfg, dev)
    host = gan_batch(cfg, GAN_B, GAN_T, SEED)
    batch = trainer.to_device(host)
    print(f"GAN training: data/demo/vec2wav.json, Generator "
          f"{sum(p.numel() for p in trainer.gen_params) / 1e6:.2f} M and discriminators "
          f"{sum(p.numel() for p in trainer.disc_params) / 1e6:.2f} M trained parameters, "
          f"B={GAN_B} T={GAN_T} ({GAN_T * cfg.total_upsample} samples an item), "
          f"pair_batched {cfg.disc_pair_batched}, lr {cfg.learning_rate}")
    fused_conv_residual.launches = 0
    history = timed_gan(trainer, batch, f"GAN B={GAN_B}", TIMED_STEPS)
    mel = [h[GAN_KEYS.index("mel_loss")] for h in history]
    print(f"  mel loss over {len(mel)} steps of one batch, which must fall from the first to the "
          f"last ({mel[0]:.4f} -> {mel[-1]:.4f}): " + " ".join(f"{v:.4f}" for v in mel))
    check(mel[-1] < mel[0], f"the mel loss did not fall over {len(mel)} steps: {mel}")
    profile_gan_step(trainer, batch)
    check(fused_conv_residual.launches == 0,
          f"{fused_conv_residual.launches} fused ResBlock2 launches in GAN training")
    del trainer, batch
    torch.cuda.empty_cache()


def profile_gan_step(trainer, batch) -> None:
    """Where one GAN step's time goes: the Generator's forward, the D step
    (forward, backward, AdamW) and the G step (mel and D forwards, backward,
    AdamW) by CUDA events; each discriminator's forward + backward alone;
    then ``torch.profiler``'s busy share, launches and top kernels."""
    def timed_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        y_mel = trainer.mel_target(batch)
        y_hat = trainer.generate(batch)
        ev[1].record()
        trainer.d_step(batch, y_hat)
        ev[2].record()
        trainer.g_step(batch, y_hat, y_mel)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    runs = sorted((timed_step() for _ in range(3)), key=sum)
    gen_ms, d_ms, g_ms = runs[1]
    step_ms = gen_ms + d_ms + g_ms
    print(f"GAN step split (median of 3, CUDA events): G forward {gen_ms:.2f} ms, D forward + "
          f"backward + AdamW {d_ms:.2f} ms, G loss + backward + AdamW {g_ms:.2f} ms, "
          f"{step_ms:.2f} ms in all")
    y, y_hat = batch["audio"], trainer.generate(batch).detach()
    for name, disc in (("MPD", trainer.mpd), ("MSD", trainer.msd)):
        def fwd_bwd(disc=disc):
            r, g, _, _ = disc(y, y_hat)
            sum(torch.mean((1.0 - a) ** 2) + torch.mean(b ** 2) for a, b in zip(r, g)).backward()
        ms = cuda_ms(fwd_bwd, 3)
        print(f"  {name} forward + backward on (y, y_hat): {ms:.2f} ms "
              f"({100 * ms / step_ms:.1f}% of the step; the step runs it twice, the G step's "
              f"backward without weight gradients)")
    trainer.opt_d.zero_grad(set_to_none=True)
    msd_layers(trainer.msd.discriminators[1], torch.cat([y, y_hat]).transpose(1, 2))

    profile_gan_kernels(lambda: sum(timed_step()), step_ms)


def profile_gan_kernels(step, step_ms: float, top: int = 12) -> list:
    """``torch.profiler`` over one call of ``step`` (which returns its own
    ms by CUDA events): busy share, launches and the ``top`` kernels by
    device time, printed and returned as (ms, count, name)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        profiled_ms = step()
    kernels = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    print(f"  torch.profiler, one step: {n_launch} kernel launches of {len(kernels)} kernels, "
          f"device busy {busy_ms:.2f} ms = {100 * busy_ms / step_ms:.1f}% of the uninstrumented "
          f"{step_ms:.2f} ms step ({100 * busy_ms / profiled_ms:.1f}% of the profiled step's "
          f"own {profiled_ms:.2f} ms, CUDA events)")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    for e in ranked:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:6d}  {e.key[:100]}")
    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in ranked]


def msd_layers(disc, x) -> None:
    """Each conv of one MSD scale (``disc``, weight-normed) at the step's
    shapes (x [2B, 1, L], the pair-batched input of the first scale):
    forward, and forward + backward (input and weight gradients), by CUDA
    events, with its operations and rate against the f32 peak."""
    print(f"  MSD convolutions at the first scale's shapes (x {tuple(x.shape)}), cuDNN f32:")
    for conv in disc.convs:
        w = conv.weight().detach().requires_grad_()
        xin = x.detach().requires_grad_()
        kw = dict(stride=conv.stride, padding=conv.padding, groups=conv.groups)
        out = F.conv1d(xin, w, conv.bias, **kw)
        dout = torch.randn_like(out)
        fwd = cuda_ms(lambda: F.conv1d(xin, w, conv.bias, **kw), 3)
        both = cuda_ms(lambda: torch.autograd.grad(F.conv1d(xin, w, conv.bias, **kw),
                                                   (xin, w), dout), 3)
        flop = 2.0 * out.numel() * w.shape[1] * w.shape[2]
        print(f"    {x.shape[1]:4d} -> {w.shape[0]:4d}, k {w.shape[2]:2d}, stride {conv.stride}, "
              f"groups {conv.groups:2d}: forward {fwd:7.3f} ms ({flop / fwd / 1e9:5.1f} TFLOP/s), "
              f"forward + backward {both:7.3f} ms ({3 * flop / both / 1e9:5.1f} TFLOP/s, "
              f"{100 * 3 * flop / (both / 1e3) / PEAK_F32:4.1f}% of f32 peak)")
        with torch.no_grad():
            x = F.leaky_relu(out, LRELU_SLOPE)


def gan_step_result(cfg, states, host, noise, dev, dtype=None, tiled_conv: bool = False) -> dict:
    """One GAN step from the weights ``states`` on ``dev`` (``dtype``: the
    modules' compute dtype; ``tiled_conv``: the MSD's repack): its scalars,
    the gradients it left (the D step's on the discriminators, the G step's
    on the Generator) and the buffers after it, on the host."""
    gen = Generator(cfg, device=dev, fused=False, dtype=dtype)
    mpd = MultiPeriodDiscriminator(cfg, cfg.disc_pair_batched, dtype=dtype, device=dev)
    msd = MultiScaleDiscriminator(cfg.disc_pair_batched, tiled_conv=tiled_conv, dtype=dtype,
                                  device=dev)
    for m, sd in zip((gen, mpd, msd), states):
        m.load_state_dict(sd, strict=True)
    trainer = GANTrainer(cfg, device=dev, generator=gen, mpd=mpd, msd=msd)
    metrics = trainer.step(host, noise=noise)
    modules = {"gen": gen, "mpd": mpd, "msd": msd}
    return dict(
        losses=[metrics[k].item() for k in GAN_KEYS],
        grads={f"{n}.{k}": p.grad.cpu() for n, m in modules.items()
               for k, p in m.named_parameters()},
        buffers={f"{n}.{k}": b.cpu() for n, m in modules.items() for k, b in m.named_buffers()
                 if b.is_floating_point()})


def check_gan_step_against_cpu() -> dict:
    """Phase 19: one full-size GAN step on the card against the CPU, the
    same seeded weights, batch and noise, TF32 off.  Returns the weights,
    batch, noise and both steps' losses, for phase 36."""
    cfg = gan_config()
    states = [{k: v.cpu() for k, v in m.state_dict().items()}
              for m in gan_modules(cfg, "cpu", SEED + 3)]
    host = gan_batch(cfg, GAN_CHECK_B, GAN_CHECK_T, SEED + 3)
    noise = torch.randn(GAN_CHECK_B, cfg.noise_dim, generator=torch.Generator().manual_seed(SEED))
    card = gan_step_result(cfg, states, host, noise, "cuda")
    t0 = time.perf_counter()
    cpu = gan_step_result(cfg, states, host, noise, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card["losses"], cpu["losses"]))
    check(loss_err <= STEP_LOSS_RTOL, f"GAN step losses differ by {loss_err:.3g} (relative)")
    total_err, _, _ = grad_spread(card["grads"], cpu["grads"])
    kept = {n: g for n, g in cpu["grads"].items() if not GAN_ZERO_GRAD.fullmatch(n)}
    _, worst, worst_name = grad_spread(card["grads"], kept)
    check(total_err <= STEP_GRAD_GLOBAL_RTOL, f"GAN gradients: card vs CPU {total_err:.3g} of "
                                              f"the norm")
    check(worst <= STEP_GRAD_RTOL, f"GAN gradient {worst_name}: card vs CPU {worst:.3g} of its "
                                   f"norm")
    state_err, state_name = 0.0, ""
    for n, b in cpu["buffers"].items():
        err = float((card["buffers"][n] - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        if err > state_err:
            state_err, state_name = err, n
    check(state_err <= GAN_STATE_RTOL, f"GAN step buffer {state_name}: card vs CPU {state_err:.3g}")
    print(f"GAN step, card vs CPU (full size, B={GAN_CHECK_B} T={GAN_CHECK_T}, the same noise; "
          f"CPU {cpu_s:.1f} s): losses {loss_err:.2e} (rtol {STEP_LOSS_RTOL}), "
          f"{len(cpu['grads'])} gradients: ||card - CPU|| / ||CPU|| {total_err:.2e} in all (rtol "
          f"{STEP_GRAD_GLOBAL_RTOL}), worst tensor {worst:.2e} in {worst_name} (rtol "
          f"{STEP_GRAD_RTOL}); {len(cpu['buffers'])} running statistics and spectral vectors "
          f"after the step: worst {state_err:.2e} in {state_name} (rtol {GAN_STATE_RTOL})")
    return dict(states=states, host=host, noise=noise, cpu_losses=cpu["losses"],
                card_losses=card["losses"])


def train_gan_loop():
    """Phase 20: ``vec2wav_loop.main`` trains 3 steps on the demo corpus."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_v2w_") as tmp:
        history = vec2wav_loop.main(vec2wav_loop.parse_args(["--max_steps", "3"]),
                                    cfg=dataclasses.replace(gan_config(), run_path=tmp)).steps
    check(len(history) == 3 and all(math.isfinite(v) for h in history.values()
                                    for v in h.values()), f"vec2wav_loop: {history}")


# ---------------------------------------------------------------------------
# The serving stack (phases 21-26)
# ---------------------------------------------------------------------------

def serving_argv(out_dir: str, t2v_file: str, gen_file: str) -> list:
    """The ``cli serve`` flags of the full-size demo stack from checkpoint
    files, with the demo speakers and their reference clips."""
    return ["--t2v_config", repo_path("data", "demo", "text2vec.json"),
            "--v2w_config", repo_path("data", "demo", "vec2wav.json"),
            "--t2v_checkpoint", t2v_file, "--gen_checkpoint", gen_file,
            "--spk_emb_dir", repo_path("data", "demo", "spk_emb"),
            "--ref_feat_dir", repo_path("data", "demo", "w2v_feat", "train"),
            "--out_dir", out_dir, "--device", "cuda"]


def fused_units(cfg) -> int:
    """ResBlock2 units in one Generator forward: two a resblock (30 at full
    size: 5 stages x 3 kernels)."""
    return 2 * len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)


def reset_serving_counters() -> None:
    fused_conv_residual.launches = 0
    reset_counters()


def read_serving_counters() -> dict:
    return dict(fused_resblock=fused_conv_residual.launches, gru_fwd=gru_fwd.launches,
                gru_fwd_f32=gru_fwd_f32.launches, gru_fwd_steps=gru_step_launches(),
                flash_fwd=flash_fwd.launches)


def median_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` timed calls (CUDA events each) after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def parse_pcm(raw: bytes) -> list:
    """The PCM framing of ``serve_loop(pcm=True)`` -> [(header, int16 samples
    or None)]: ``PCM``/``PCMEND`` blocks, ``PCMSTART``/``PCMCHUNK``/``PCMEND``
    streams (the header is the ``PCMEND`` line) and bare lines."""
    out, i = [], 0
    while i < len(raw):
        j = raw.index(b"\n", i)
        line, i = raw[i:j].decode(), j + 1
        if line.startswith("PCM "):
            n = int(line.split()[1])
            data, i = np.frombuffer(raw[i:i + 2 * n], "<i2"), i + 2 * n
            j = raw.index(b"\n", i)
            check(raw[i:j] == b"PCMEND", f"PCM block not closed: {raw[i:j][:40]!r}")
            out.append((line, data))
            i = j + 1
        elif line.startswith("PCMSTART"):
            chunks = []
            while True:
                j = raw.index(b"\n", i)
                sub, i = raw[i:j].decode(), j + 1
                if sub.startswith("PCMCHUNK "):
                    nb = int(sub.split()[1])
                    chunks.append(np.frombuffer(raw[i:i + nb], "<i2"))
                    i += nb
                elif sub.startswith("PCMEND "):
                    data = np.concatenate(chunks) if chunks else np.zeros(0, "<i2")
                    check(data.shape[0] == int(sub.split()[1]), f"stream length: {sub}")
                    out.append((sub, data))
                    break
                else:
                    check(False, f"unexpected line in a PCM stream: {sub!r}")
        else:
            out.append((line, None))
    return out


def lsb(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


def check_checkpoint_round_trip(syn, tmp: str):
    """Phase 21: phase 2's weights saved as the torch reference's files, the
    serving stack built from them as ``cli serve`` builds it, one request
    bit for bit against the Synthesizer of the in-memory weights."""
    t2v_file = os.path.join(tmp, "checkpoint_0.pth.tar")
    gen_file = os.path.join(tmp, "g_00000000")
    t0 = time.perf_counter()
    torch.save({"model": {k: v.cpu() for k, v in syn.t2v.state_dict().items()}}, t2v_file)
    torch.save({"generator": {k: v.cpu() for k, v in syn.gen.state_dict().items()}}, gen_file)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    synth, store = cli._build_serving_stack(
        cli._serving_parser().parse_args(serving_argv(os.path.join(tmp, "out"), t2v_file,
                                                      gen_file)))
    build_s = time.perf_counter() - t0
    check(store.speakers() == ["SSB0000", "SSB0001"], f"speakers {store.speakers()}")
    for a, b in ((synth.t2v, syn.t2v), (synth.gen, syn.gen)):
        sa, sb = a.state_dict(), b.state_dict()
        check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
              f"checkpoint round trip: {type(a).__name__} weights differ")
    text, ref, spk = demo_inputs(syn)
    texts = [text(40)]

    def request(s):
        return s.synthesize(texts, ref, spk, max_frames=512, seed=SEED)

    # run to run the same Synthesizer moves at rounding level (cuDNN may
    # choose nondeterministic algorithms); bit for bit holds with cuDNN's
    # deterministic ones
    runs = [request(syn)[0] for _ in range(2)]
    jitter = float(np.abs(runs[0] - runs[1]).max())
    torch.backends.cudnn.deterministic = True
    try:
        got, n_got = request(synth)
        want, n_want = request(syn)
    finally:
        torch.backends.cudnn.deterministic = False
    check(np.array_equal(n_got, n_want) and np.array_equal(got, want),
          f"checkpoint round trip: max |diff| {np.abs(got - want).max():.3g}, frames "
          f"{n_got} vs {n_want}")
    size = (os.path.getsize(t2v_file) + os.path.getsize(gen_file)) / 2**20
    print(f"checkpoint round trip: checkpoint_0.pth.tar + g_00000000 ({size:.0f} MiB) saved in "
          f"{save_s:.1f} s, serving stack built from them in {build_s:.1f} s (cli "
          f"_build_serving_stack); weights bit-equal; one 512-frame request bit-equal to the "
          f"in-memory weights' under cuDNN's deterministic algorithms "
          f"({int(n_got[0]) // syn.v2w_cfg.total_upsample} frames); run to run without them the "
          f"same Synthesizer moves by max |diff| {jitter:.3g}")
    return synth, store


class StampedOut(io.StringIO):
    """A text stream that notes the host time of every write."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def write(self, s):
        self.stamps.append((time.perf_counter(), s))
        return super().write(s)


def burst_lines(syn, n: int) -> str:
    """``n`` requests over the two demo speakers and two text buckets (25
    and 50 characters: buckets 32 and 64)."""
    text, _, _ = demo_inputs(syn)
    return "".join(f"SSB{i % 2:04d}|{text(25 if i % 4 < 2 else 50)}\n" for i in range(n)) + "QUIT\n"


def serve_burst(synth, store, out_dir: str, lines: str, max_batch: int) -> dict:
    """One ``serve_loop`` call with ``--warmup`` over a burst of requests,
    all queued before the first is taken.  Client-perceived latency: from
    the ``WARM`` line (the loop's first read follows it) to each ``OK``
    line."""
    stdout = StampedOut()
    reset_serving_counters()
    n = serve_loop(synth, store, out_dir, max_frames=SERVE_FRAMES, stdin=io.StringIO(lines),
                   stdout=stdout, do_warmup=True, max_batch=max_batch)
    torch.cuda.synchronize()
    counts = read_serving_counters()
    warm = [t for t, s in stdout.stamps if s.startswith("WARM")]
    ok = [(t, s) for t, s in stdout.stamps if s.startswith("OK ")]
    others = [s for _, s in stdout.stamps if s.strip() and not s.startswith(("OK ", "WARM"))]
    check(len(warm) == 1 and len(ok) == n == lines.count("|") and not others,
          f"serve_loop max_batch={max_batch}: {n} served, lines {others[:3]}")
    lat = [(t - warm[0]) * 1e3 for t, _ in ok]
    batched = [int(re.search(r"batched=(\d+)", s).group(1)) for _, s in ok]
    own = [float(re.search(r"latency=([\d.]+)ms", s).group(1)) for _, s in ok]
    n_warm = len(_batch_buckets(max_batch)) * len(synth.t2v_cfg.text_buckets)
    n_batches = round(sum(1 / b for b in batched))
    return dict(n=n, lat=lat, batched=batched, own=own, counts=counts, n_warm=n_warm,
                n_batches=n_batches, utt_s=n / ((ok[-1][0] - warm[0])),
                paths=[s.split()[1] for _, s in ok])


def check_serve_loop(synth, store, tmp: str) -> dict:
    """Phase 22: a burst of ``SERVE_REQUESTS`` requests through ``serve_loop``
    at max_batch 1 and ``SERVE_MAX_BATCH``; a request's PCM from a coalesced
    batch against the same request alone."""
    n_sm, smem = device_limits(torch.device("cuda"))
    H = synth.t2v.postnet.gru.hidden_size
    plans = {B: (numerics(synth.t2v_cfg, B),
                 gru_fwd_plan(2, B, H, n_sm, smem, numerics(synth.t2v_cfg, B)).route)
             for B in _batch_buckets(SERVE_MAX_BATCH)}
    check(all(r == "persistent" for _, r in plans.values()),
          f"BiGRU routes by batch bucket {plans}")
    print(f"BiGRU numerics and route by batch bucket (D=2, H={H}): {plans}")
    lines = burst_lines(synth, SERVE_REQUESTS)
    runs = {mb: serve_burst(synth, store, os.path.join(tmp, f"burst{mb}"), lines, mb)
            for mb in (1, SERVE_MAX_BATCH)}
    for mb, r in runs.items():
        forwards = r["n_warm"] + r["n_batches"]
        c = r["counts"]
        check(c["fused_resblock"] == fused_units(synth.v2w_cfg) * forwards
              and bigru_launches(c, synth.t2v_cfg) == forwards and c["gru_fwd_steps"] == forwards,
              f"serve_loop max_batch={mb}: launches {c} for {forwards} forwards")
        print(f"serve_loop burst of {r['n']} (max_batch {mb}, frame bucket {SERVE_FRAMES}, "
              f"--warmup {r['n_warm']} shapes): client-perceived latency median "
              f"{np.median(r['lat']):.2f} ms, p90 {np.percentile(r['lat'], 90):.2f} ms (n={r['n']}), "
              f"max {max(r['lat']):.2f}; {r['utt_s']:.2f} utterances/s over the burst; "
              f"batches {r['n_batches']} of sizes {sorted(set(r['batched']))}, a batch's own "
              f"latency (the OK line's) median {np.median(r['own']):.2f} ms; launches {c} "
              f"({forwards} forwards: {fused_units(synth.v2w_cfg)} fused and 1 BiGRU each)")
    check(max(runs[SERVE_MAX_BATCH]["batched"]) > 1, "serve_loop never coalesced")
    worst = 0
    for alone, batch in zip(runs[1]["paths"], runs[SERVE_MAX_BATCH]["paths"]):
        _, a = wavfile.read(alone)
        _, b = wavfile.read(batch)
        check(a.shape == b.shape and a.shape[0] > 0, f"{batch}: {b.shape} vs alone {a.shape}")
        worst = max(worst, lsb(a, b))
    check(worst <= COALESCE_LSB, f"coalesced PCM differs from alone by {worst} LSB")
    print(f"coalesced vs alone, {SERVE_REQUESTS} requests: max {worst} LSB "
          f"(tolerance {COALESCE_LSB})")
    return runs


def check_streaming(synth, store, tmp: str) -> dict:
    """Phase 23: a ~3000-frame request streamed as PCM chunks of
    ``STREAM_CHUNK`` frames against the batched PCM, and
    ``StreamingVocoder.vocode`` against the full forward."""
    cfg = synth.v2w_cfg
    text, _, _ = demo_inputs(synth)
    line = f"SSB0000|{text(STREAM_CHARS)}\nQUIT\n"
    kw = dict(alpha=STREAM_ALPHA, max_frames=STREAM_FRAMES, pcm=True)
    reset_serving_counters()
    stdout = io.BytesIO()
    serve_loop(synth, store, tmp, stdin=io.StringIO(line), stdout=stdout,
               stream_chunk=STREAM_CHUNK, **kw)
    torch.cuda.synchronize()
    counts = read_serving_counters()
    (header, streamed), = [(h, d) for h, d in parse_pcm(stdout.getvalue()) if d is not None]
    stdout = io.BytesIO()
    t0 = time.perf_counter()
    serve_loop(synth, store, tmp, stdin=io.StringIO(line), stdout=stdout, **kw)
    batched_ms = (time.perf_counter() - t0) * 1e3
    (bheader, batched), = [(h, d) for h, d in parse_pcm(stdout.getvalue()) if d is not None]
    frames = streamed.shape[0] // cfg.total_upsample
    windows = -(-frames // STREAM_CHUNK)
    K = conservative_context_frames(cfg)
    check(counts["fused_resblock"] == fused_units(cfg) * windows
          and bigru_launches(counts, synth.t2v_cfg) == 1,
          f"streaming launches {counts} for {windows} windows")
    check(streamed.shape == batched.shape and frames == STREAM_FRAMES,
          f"streamed {streamed.shape} vs batched {batched.shape}: not clipped at "
          f"{STREAM_FRAMES} frames")
    diff = lsb(streamed, batched)
    check(diff <= COALESCE_LSB, f"streamed PCM differs from batched by {diff} LSB")
    ttfa = float(re.search(r"ttfa=([\d.]+)ms", header).group(1))
    latency = float(re.search(r"latency=([\d.]+)ms", header).group(1))
    print(f"PCM streaming, {frames} frames in {windows} windows of {STREAM_CHUNK} (context "
          f"K={K}: windows of {STREAM_CHUNK + K} frames at the edges, {STREAM_CHUNK + 2 * K} "
          f"inside): time to first audio {ttfa:.2f} ms, last audio {latency:.2f} ms; the "
          f"batched request (PCM, one forward over {STREAM_FRAMES} frames) {batched_ms:.2f} ms "
          f"({bheader.split()[3]}); streamed vs batched PCM max {diff} LSB; launches {counts}")
    # the stitched waveform against the full forward, float
    spk = store.vocoder_emb("SSB0000")[None]
    out = synth.text_to_latents([line.split("|", 1)[1].strip()], None, alpha=STREAM_ALPHA,
                                max_frames=STREAM_FRAMES,
                                t2v_spk_emb=store.t2v_emb_or_fallback("SSB0000"), keep_device=True)
    lat = out["feat_postnet_output"]
    noise = _serve_noise(synth, 1)
    full = synth.gen(lat, torch.as_tensor(spk, device=lat.device), noise)[..., 0].cpu().numpy()
    stitched = StreamingVocoder(synth.gen, cfg, chunk_frames=STREAM_CHUNK).vocode(lat, spk, noise)
    gap = float(np.abs(stitched - full).max())
    check(stitched.shape == full.shape and gap <= STREAM_ATOL,
          f"stitched vs full forward: max |diff| {gap:.3g} (atol {STREAM_ATOL})")
    print(f"StreamingVocoder.vocode over the padded {STREAM_FRAMES} frames vs the full f32 "
          f"forward: max |diff| {gap:.3g} (atol {STREAM_ATOL}), max |y| {np.abs(full).max():.3f}")
    return dict(windows=windows, counts=counts)


def check_http(synth, store) -> dict:
    """Phase 24: ``serve_http`` on 127.0.0.1, port 0, in a thread: /health,
    /speakers and ``HTTP_CLIENTS`` concurrent POST /synthesize."""
    box, ready = {}, threading.Event()

    def on_ready(server, service):
        box.update(server=server, service=service)
        ready.set()

    def run():
        box["served"] = serve_http(synth, store, port=0, max_frames=SERVE_FRAMES,
                                   max_batch=SERVE_MAX_BATCH, ready_cb=on_ready,
                                   coalesce_wait_ms=HTTP_COALESCE_MS)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    check(ready.wait(60), "serve_http did not start")
    base = f"http://127.0.0.1:{box['server'].server_address[1]}"
    with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(f"{base}/speakers", timeout=60) as r:
        speakers = json.loads(r.read())
    check(health["status"] == "ok" and health["speakers"] == 2, f"/health {health}")
    check(speakers == ["SSB0000", "SSB0001"], f"/speakers {speakers}")
    text, _, _ = demo_inputs(synth)
    reqs = [(f"SSB{i % 2:04d}", text(20 + 4 * i)) for i in range(HTTP_CLIENTS)]
    results = [None] * HTTP_CLIENTS
    reset_serving_counters()

    def client(i):
        spk, txt = reqs[i]
        body = json.dumps({"text": txt, "speaker": spk}).encode()
        req = urllib.request.Request(f"{base}/synthesize", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = (r.status, dict(r.headers), r.read(), (time.perf_counter() - t0) * 1e3)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=300)
    counts = read_serving_counters()
    box["server"].shutdown()
    th.join(timeout=60)
    check(not th.is_alive() and all(not c.is_alive() for c in clients), "HTTP threads still run")
    check(all(r is not None for r in results), "an HTTP request failed")
    up = synth.v2w_cfg.total_upsample
    for (spk, txt), (status, headers, body, _) in zip(reqs, results):
        with wave.open(io.BytesIO(body)) as w:
            n = w.getnframes()
            check(w.getframerate() == SAMPLE_RATE and w.getsampwidth() == 2 and status == 200,
                  f"HTTP answer {status}, {w.getframerate()} Hz")
        want = synth.text_to_latents([txt], None, max_frames=SERVE_FRAMES,
                                     t2v_spk_emb=store.t2v_emb_or_fallback(spk))["total_frames"]
        check(n == min(int(want[0]), SERVE_FRAMES) * up > 0,
              f"HTTP wav of {n} samples, want {int(want[0])} frames")
    batched = [int(h["X-Batched"]) for _, h, _, _ in results]
    lat = [r[3] for r in results]
    check(max(batched) > 1, f"the HTTP service never coalesced: {batched}")
    n_batches = round(sum(1 / b for b in batched))
    check(counts["fused_resblock"] == fused_units(synth.v2w_cfg) * n_batches
          and bigru_launches(counts, synth.t2v_cfg, HTTP_CLIENTS) == n_batches,
          f"HTTP launches {counts} for {n_batches} batches")
    print(f"HTTP: /health {health}, {HTTP_CLIENTS} concurrent POST /synthesize (coalescing "
          f"window {HTTP_COALESCE_MS:g} ms): batched {batched}, client latency median "
          f"{np.median(lat):.2f} ms, max {max(lat):.2f}; launches {counts}; served "
          f"{box['served']}")
    return counts


def check_bf16_generator(synth, store) -> None:
    """Phase 25: the bf16 serving Generator against the f32 one on the
    512- and 3000-frame requests' latents."""
    cfg, dev = synth.v2w_cfg, synth.device
    gen16, state16 = make_serving_generator(cfg, synth.gen.state_dict(), "bf16", device=dev)
    gen16.load_state_dict(state16, strict=True)
    x = torch.randn(1, 64, 32, device=dev, dtype=torch.bfloat16)
    w = torch.randn(3, 32, 32, device=dev, dtype=torch.bfloat16)
    try:
        fused_conv_residual(x, w, torch.zeros(32, device=dev, dtype=torch.bfloat16))
        check(False, "fused_conv_residual took bf16 inputs on the card")
    except ValueError as e:
        check("float32" in str(e), f"fused_conv_residual's bf16 refusal: {e}")
    text, _, _ = demo_inputs(synth)
    spk = torch.as_tensor(store.vocoder_emb("SSB0000")[None], device=dev)
    noise = _serve_noise(synth, 1)
    for frames, chars, alpha in ((512, 40, 1.0), (STREAM_FRAMES, STREAM_CHARS, STREAM_ALPHA)):
        lat = synth.text_to_latents([text(chars)], None, alpha=alpha, max_frames=frames,
                                    t2v_spk_emb=store.t2v_emb_or_fallback("SSB0000"),
                                    keep_device=True)["feat_postnet_output"]
        fused_conv_residual.launches = 0
        w16 = gen16(lat, spk, noise)
        torch.cuda.synchronize()
        n16 = fused_conv_residual.launches
        w32 = synth.gen(lat, spk, noise)
        torch.cuda.synchronize()
        n32 = fused_conv_residual.launches - n16
        check(n16 == 0 and n32 == fused_units(cfg), f"fused launches: bf16 {n16}, f32 {n32}")
        check(w16.dtype == torch.float32 and bool(torch.isfinite(w16).all()),
              f"bf16 waveform {w16.dtype}, finite {bool(torch.isfinite(w16).all())}")
        rel = float((w16 - w32).norm() / w32.norm())
        check(rel <= BF16_WAV_RTOL, f"bf16 vs f32 waveform {rel:.3g} of its norm")
        ms16 = median_ms(lambda: gen16(lat, spk, noise))
        ms32 = median_ms(lambda: synth.gen(lat, spk, noise))
        print(f"bf16 serving Generator, {frames} frames: ||bf16 - f32|| / ||f32|| = {rel:.4g} "
              f"(tolerance {BF16_WAV_RTOL}), max |diff| {float((w16 - w32).abs().max()):.3g}; "
              f"fused launches bf16 {n16}, f32 {n32}; Generator ms (median of 3) bf16 "
              f"{ms16:.3f}, f32 {ms32:.3f} ({ms16 / ms32:.2f}x)")


def serve_long_loop(dev, tmp: str) -> dict:
    """Phase 26: two long-bucket requests (f32, flash; text bucket 768,
    3072 frames) coalesced through ``serve_loop`` at max_batch 2, each
    against the same request alone through ``Synthesizer``."""
    cfg = dataclasses.replace(long_config(), vocab_path="data/demo/vocab.txt")
    syn = make_synthesizer(dev, cfg)
    store = SpeakerStore(syn, repo_path("data", "demo", "spk_emb"),
                         repo_path("data", "demo", "w2v_feat", "train"))
    text, _, _ = demo_inputs(syn)
    reqs = [("SSB0000", text(300)), ("SSB0001", text(280))]
    lines = "".join(f"{s}|{t}\n" for s, t in reqs) + "QUIT\n"
    serve_loop(syn, store, tmp, max_frames=LONG_T, stdin=io.StringIO(lines),
               stdout=io.BytesIO(), pcm=True, max_batch=2)  # warm-up
    reset_serving_counters()
    stdout = io.BytesIO()
    t0 = time.perf_counter()
    n = serve_loop(syn, store, tmp, max_frames=LONG_T, stdin=io.StringIO(lines), stdout=stdout,
                   pcm=True, max_batch=2)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_serving_counters()
    blocks = [(h, d) for h, d in parse_pcm(stdout.getvalue()) if d is not None]
    check(n == 2 and len(blocks) == 2 and all("batched=2" in h for h, _ in blocks),
          f"long-bucket serve_loop: {n} served, {[h for h, _ in blocks]}")
    n_flash = cfg.encoder_n_layer + cfg.decoder_n_layer
    check(counts["flash_fwd"] == n_flash and bigru_launches(counts, syn.t2v_cfg, 2) == 1
          and counts["fused_resblock"] == fused_units(syn.v2w_cfg),
          f"long-bucket serve_loop launches {counts}: one batch of 2")
    worst = 0
    for (spk, txt), (_, got) in zip(reqs, blocks):
        want, n_samples = syn.synthesize([txt], None, store.vocoder_emb(spk)[None],
                                         max_frames=LONG_T,
                                         t2v_spk_emb=store.t2v_emb_or_fallback(spk),
                                         noise=_serve_noise(syn, 1).cpu().numpy(), pcm16=True)
        k = min(int(n_samples[0]), LONG_T * syn.v2w_cfg.total_upsample)
        check(got.shape[0] == k > 0, f"long-bucket request: {got.shape[0]} samples, want {k}")
        worst = max(worst, lsb(got, want[0, :k]))
    check(worst <= COALESCE_LSB, f"long-bucket serve_loop vs Synthesizer: {worst} LSB")
    print(f"long-bucket serve_loop (f32, flash, text bucket {LONG_N}, {LONG_T} frames): 2 "
          f"requests in one batch of 2, {ms:.2f} ms; launches {counts}; each vs Synthesizer "
          f"alone max {worst} LSB")
    return counts


def check_serving_shapes(synth) -> None:
    """Phase 27: each kernel of the serving path against its plain version
    at the shapes phases 22-26 first gave it: the fused unit at the
    streaming windows' lengths (B = 1) and in a coalesced batch (B =
    ``SERVE_MAX_BATCH``), the BiGRU at every batch bucket, the f32 flash
    forward at B = 2 of the long bucket."""
    dev = synth.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    K = conservative_context_frames(synth.v2w_cfg)
    errs = {}
    for B, frames in ((1, STREAM_CHUNK + K), (1, STREAM_CHUNK + 2 * K),
                      (SERVE_MAX_BATCH, SERVE_FRAMES)):
        err = 0.0
        for _, C, T, k, d, conv in fused_unit_cases(synth, frames):
            w = conv.weight().permute(2, 1, 0).contiguous()
            x = torch.randn((B, T, C), generator=g, device=dev)
            got = fused_conv_residual(x, w, conv.bias, dilation=d, neg_slope=LRELU_SLOPE)
            want = conv_residual_plain(x, w, conv.bias, dilation=d, neg_slope=LRELU_SLOPE)
            err = max(err, (got - want).abs().max().item())
        check(err <= FUSED_ATOL, f"fused unit at B={B} x {frames} frames: max |err| {err:.3g}")
        errs[f"fused B={B} x {frames} frames"] = err
    bigru = synth.t2v.postnet.gru
    for B in _batch_buckets(SERVE_MAX_BATCH):
        x = torch.randn((B, SERVE_FRAMES, bigru.hidden_size), generator=g, device=dev)
        gi, w_hh, b_hh = bigru.recurrence_inputs(x)
        kind = bigru.numerics(B)
        atol = GRU_ATOL if kind == "bf16" else GRU_F32_ATOL
        w_hh = w_hh.to(torch.bfloat16) if kind == "bf16" else w_hh
        got = GRU_KERNELS[kind][1](gi, w_hh, b_hh)
        err = (got - gru_fwd_plain(gi, w_hh, b_hh, kind)).abs().max().item()
        check(err <= atol, f"BiGRU ({kind}) at B={B} x {SERVE_FRAMES}: max |err| {err:.3g}")
        errs[f"BiGRU {kind} B={B} x {SERVE_FRAMES}"] = err
    for T in (LONG_N, LONG_T):
        q, k, v, seg = flash_case(2, T, torch.float32, SEED)
        scale = 1.0 / math.sqrt(FLASH_D)
        out, lse = flash_fwd(q, k, v, seg, scale)
        want, want_lse = flash_attention_plain(q, k, v, seg, scale)
        err, lse_err = rel_err(out, want), float((lse - want_lse).abs().max())
        check(err <= FLASH_F32_RTOL and lse_err <= FLASH_LSE_ATOL,
              f"f32 flash forward at [2, {FLASH_H}, {T}, {FLASH_D}]: {err:.3g}, lse {lse_err:.3g}")
        errs[f"flash f32 [2, {FLASH_H}, {T}, {FLASH_D}] (of max)"] = err
    print("kernels vs plain at the serving shapes (atol: fused "
          f"{FUSED_ATOL}, BiGRU {GRU_ATOL} bf16, {GRU_F32_ATOL} f32; flash {FLASH_F32_RTOL} of "
          "max): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def serving_stack(dev) -> dict:
    """Phases 21-25 on phase 2's full-size models (seeded anew), outside
    inference mode as a server runs; then phase 26."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        syn = make_synthesizer(dev)
        synth, store = check_checkpoint_round_trip(syn, tmp)
        del syn
        burst = check_serve_loop(synth, store, tmp)
        stream = check_streaming(synth, store, tmp)
        http = check_http(synth, store)
        check_bf16_generator(synth, store)
        with torch.inference_mode():
            check_serving_shapes(synth)
        del synth, store
        torch.cuda.empty_cache()
        long_counts = serve_long_loop(dev, tmp)
    b8 = burst[SERVE_MAX_BATCH]
    per_batch = {k: v // (b8["n_warm"] + b8["n_batches"]) for k, v in b8["counts"].items()}
    print(f"launches on the serving path: a request or a coalesced batch of any size "
          f"{per_batch}; a streamed utterance {stream['counts']} ({stream['windows']} windows); "
          f"a long-bucket batch {long_counts}")
    return {k: b8["counts"][k] + stream["counts"][k] + http[k] + long_counts[k]
            for k in ("fused_resblock", "gru_fwd", "gru_fwd_f32", "flash_fwd")}


# ---------------------------------------------------------------------------
# The training loops as jobs (phases 28-31)
# ---------------------------------------------------------------------------

def read_loop_counters() -> dict:
    return dict(read_counters(), fused_resblock=fused_conv_residual.launches)


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def tensors_equal(a, b) -> bool:
    """Two nested state dicts hold the same keys and bit-equal tensors."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(tensors_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


def t2v_loop_config(tmp: str) -> Text2VecConfig:
    """The full-size demo config with its run directory under ``tmp`` and
    a save, a log and a validation every ``LOOP_EVERY`` steps."""
    return dataclasses.replace(load_config(Text2VecConfig, repo_path("data", "demo",
                                                                     "text2vec.json")),
                               run_path=os.path.join(tmp, "t2v"), save_step=LOOP_EVERY,
                               log_step=LOOP_EVERY, val_step=LOOP_EVERY)


def train_t2v_loop(tmp: str, loop_counts: dict) -> Text2VecConfig:
    """Phase 28: ``text2vec_loop.main`` at full size on the demo corpus:
    ``LOOP_STEPS`` steps with ``--validate``, the scalars fetched every step
    (so that the host clock between steps reads a step).  Its files, its
    losses and its launches: one MAS and one BiGRU launch a training step
    and a validation batch."""
    cfg = t2v_loop_config(tmp)
    with open(cfg.val_list[0], encoding="utf-8") as f:
        val_batches = sum(1 for line in f if line.strip()) // cfg.batch_size
    args = text2vec_loop.parse_args(["--max_steps", str(LOOP_STEPS), "--validate",
                                     "--metric_flush_steps", "1"])
    reset_serving_counters()
    t0 = time.perf_counter()
    rec = text2vec_loop.main(args, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_loop_counters()
    add_counts(loop_counts, counts)
    run = os.path.join(cfg.run_path, cfg.log_seed)
    files = [os.path.join("model_new", f"checkpoint_{s}.pth.tar")
             for s in range(LOOP_EVERY, LOOP_STEPS + 1, LOOP_EVERY)]
    files += ["config.json", os.path.join("logger", "logger.txt")]
    missing = [f for f in files if not os.path.isfile(os.path.join(run, f))]
    check(not missing, f"text2vec_loop wrote no {missing}")
    scalars = os.listdir(os.path.join(run, "tb_logs"))
    check(("scalars.jsonl" in scalars) if rec.backend == "jsonl"
          else any(n.startswith("events.out.tfevents") for n in scalars),
          f"text2vec_loop: {rec.backend} scalars missing: {scalars}")
    check(sorted(rec.steps) == list(range(1, LOOP_STEPS + 1))
          and all(math.isfinite(v) for h in rec.steps.values() for v in h.values()),
          f"text2vec_loop losses {rec.steps}")
    n_val = len(rec.validations)
    check(n_val == LOOP_STEPS // LOOP_EVERY, f"text2vec_loop validations {rec.validations}")
    for step, v in rec.validations.items():
        finite = all(math.isfinite(v[k]) for k in VAL_KEYS)
        check(finite or v["nonfinite_batches"] > 0, f"validation at {step}: {v}")
        print(f"  validation at step {step}: " + ", ".join(
            f"{k} {v[k]:.4f}" for k in VAL_KEYS) + f", non-finite batches "
            f"{v['nonfinite_batches']} of {val_batches}, {v['seconds']:.2f} s")
    n_fwd = LOOP_STEPS + n_val * val_batches
    check(counts["mas"] == n_fwd and bigru_launches(counts, cfg, cfg.batch_size) == n_fwd
          and counts["gru_bwd"] == LOOP_STEPS and counts["fused_resblock"] == 0,
          f"text2vec_loop launches {counts}: want MAS and BiGRU {LOOP_STEPS} steps + "
          f"{n_val * val_batches} validation batches")
    step_s = [rec.seconds[s] for s in sorted(rec.seconds)]
    size = os.path.getsize(os.path.join(run, files[0])) / 2**20
    print(f"text2vec_loop at full size: {LOOP_STEPS} steps (B = {cfg.batch_size}, demo corpus), "
          f"{wall:.1f} s of wall time; logger backend {rec.backend}; median step "
          f"{1e3 * float(np.median(step_s)):.2f} ms (host clock between steps, steps 2-"
          f"{LOOP_STEPS}: " + " ".join(f"{1e3 * t:.1f}" for t in step_s) + "); saves "
          + ", ".join(f"step {k} {v:.2f} s" for k, v in rec.saves.items())
          + f" ({size:.0f} MiB a file); validations "
          + ", ".join(f"step {k} {v['seconds']:.2f} s" for k, v in rec.validations.items())
          + f"; launches {counts}; {card_line()}")
    print("  losses: " + "; ".join(f"{s}: " + " ".join(f"{x:.4f}" for x in h.values())
                                    for s, h in rec.steps.items()))
    return cfg


def resume_t2v(cfg: Text2VecConfig, loop_counts: dict) -> None:
    """Phase 29: ``--restore_step`` after phase 28, then save, load and step
    against an unbroken trainer."""
    path = os.path.join(cfg.checkpoint_path, f"checkpoint_{LOOP_EVERY}.pth.tar")
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    torch.manual_seed(SEED + 1)
    trainer = Text2VecTrainer(dataclasses.replace(cfg, vocab_size=frontend.vocab_size))
    t0 = time.perf_counter()
    epoch = load_text2vec(path, trainer)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    saved = torch.load(path, map_location="cpu", weights_only=False)
    state = trainer.state_dict()
    check(tensors_equal(state["model"], saved["model"])
          and tensors_equal(state["optimizer"], saved["optimizer"])
          and trainer.step_count == LOOP_EVERY,
          f"checkpoint_{LOOP_EVERY}.pth.tar: loaded state differs from the file's")
    n_moments = sum(len(v) for v in state["optimizer"]["state"].values())
    del trainer, state, saved
    args = text2vec_loop.parse_args(["--max_steps", str(LOOP_EVERY + 1), "--restore_step",
                                     str(LOOP_EVERY), "--metric_flush_steps", "1"])
    reset_serving_counters()
    rec = text2vec_loop.main(args, cfg=cfg)
    counts = read_loop_counters()
    add_counts(loop_counts, counts)
    check(sorted(rec.steps) == [LOOP_EVERY + 1]
          and all(math.isfinite(v) for v in rec.steps[LOOP_EVERY + 1].values()),
          f"--restore_step {LOOP_EVERY}: steps {rec.steps}")
    check(counts["mas"] == 1 and bigru_launches(counts, cfg, cfg.batch_size) == 1,
          f"resumed step launches {counts}")
    print(f"--restore_step {LOOP_EVERY}: weights and LAMB state ({n_moments} moment tensors) "
          f"bit-equal to checkpoint_{LOOP_EVERY}.pth.tar (epoch {epoch}), loaded in "
          f"{load_s:.2f} s; the run went on at step {LOOP_EVERY + 1}, losses "
          + " ".join(f"{v:.4f}" for v in rec.steps[LOOP_EVERY + 1].values()))

    # save, load and one step against the unbroken trainer's step, dropout 0
    step_cfg = dataclasses.replace(train_config(), dropout=0.0)
    host = synthetic_batch(step_cfg, TRAIN_B, TRAIN_N, TRAIN_T, SEED)
    torch.backends.cudnn.deterministic = True
    try:
        torch.manual_seed(SEED)
        unbroken = Text2VecTrainer(step_cfg)
        batch = unbroken.to_device(host)
        run_step(unbroken, batch)
        file = os.path.join(cfg.run_path, "resume_check",
                            f"checkpoint_{unbroken.step_count}.pth.tar")
        save_text2vec(file, unbroken, 0)
        torch.manual_seed(SEED + 2)
        resumed = Text2VecTrainer(step_cfg)
        load_text2vec(file, resumed)
        got = run_step(resumed, batch)
        want = run_step(unbroken, batch)
    finally:
        torch.backends.cudnn.deterministic = False
    loss_err = max(abs(got[k].item() - want[k].item()) / abs(want[k].item())
                   for k in SCALAR_KEYS)
    pairs = list(zip(resumed.params, unbroken.params))
    w_err = (torch.sqrt(sum(((a - b) ** 2).sum() for a, b in pairs))
             / torch.sqrt(sum((b ** 2).sum() for _, b in pairs))).item()
    w_max = max((a - b).abs().max().item() for a, b in pairs)
    bits = all(torch.equal(a, b) for a, b in pairs)
    check(loss_err <= RESUME_LOSS_RTOL and w_err <= RESUME_WEIGHT_RTOL,
          f"save, load and step vs the unbroken step: losses {loss_err:.3g}, weights "
          f"{w_err:.3g} of the norm")
    print(f"save, load and one step (B = {TRAIN_B} x {TRAIN_T} frames, dropout 0, cuDNN "
          f"deterministic) vs the unbroken trainer's step: losses max rel {loss_err:.3g} (rtol "
          f"{RESUME_LOSS_RTOL}), weights ||d|| / ||w|| {w_err:.3g} (rtol {RESUME_WEIGHT_RTOL}), "
          f"max |d| {w_max:.3g}, bit-equal: {bits}")
    os.remove(file)


def train_gan_loop_windowed(tmp: str, loop_counts: dict) -> str:
    """Phase 30: ``vec2wav_loop.main`` windowed (``split=True``) at full
    size: ``GAN_LOOP_STEPS`` steps, then a second run that resumes from the
    newest ``g_``/``do_`` pair for ``GAN_LOOP_MORE`` more.  Returns the
    last ``g_`` file."""
    cfg = dataclasses.replace(gan_config(), split=True, run_path=os.path.join(tmp, "v2w"),
                              save_step=2, val_step=2, log_step=1)
    train_files, _ = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    probe = next(VocoderLoader(VocoderDataset(train_files, cfg), cfg.batch_size, seed=cfg.seed,
                               num_workers=0).epoch())
    want_t = cfg.segment_size // cfg.total_upsample
    check(probe["wv_feat"].shape == (cfg.batch_size, want_t, cfg.n_feat_dim)
          and probe["audio"].shape == (cfg.batch_size, want_t * cfg.total_upsample, 1),
          f"windowed batch {probe['wv_feat'].shape}, {probe['audio'].shape}")
    print(f"windowed GAN batches: wv_feat {list(probe['wv_feat'].shape)}, audio "
          f"{list(probe['audio'].shape)}, mel_loss {list(probe['mel_loss'].shape)}")
    runs = []
    for max_steps in (GAN_LOOP_STEPS, GAN_LOOP_STEPS + GAN_LOOP_MORE):
        reset_serving_counters()
        t0 = time.perf_counter()
        rec = vec2wav_loop.main(vec2wav_loop.parse_args(
            ["--max_steps", str(max_steps), "--stdout_interval", "1"]), cfg=cfg)
        torch.cuda.synchronize()
        counts = read_loop_counters()
        add_counts(loop_counts, counts)
        check(not any(counts.values()), f"GAN loop launched {counts}")
        runs.append((rec, time.perf_counter() - t0))
    (first, first_s), (second, second_s) = runs
    check(sorted(first.steps) == list(range(GAN_LOOP_STEPS))
          and sorted(second.steps) == list(range(GAN_LOOP_STEPS, GAN_LOOP_STEPS + GAN_LOOP_MORE)),
          f"GAN loop steps {sorted(first.steps)}, resumed {sorted(second.steps)}")
    for rec in (first, second):
        check(all(math.isfinite(v) for h in rec.steps.values() for v in h.values()),
              f"GAN loop losses {rec.steps}")
        check(rec.validations and all(math.isfinite(v["mel_spec_error"])
                                      for v in rec.validations.values()),
              f"GAN validation {rec.validations}")
    names = sorted(os.listdir(cfg.checkpoint_path))
    want = sorted(f"{p}_{s:08d}" for p in ("g", "do")
                  for s in (2, GAN_LOOP_STEPS - 1, 4, GAN_LOOP_STEPS + GAN_LOOP_MORE - 1))
    check(names == want, f"GAN checkpoints {names}, want {want}")

    # the AdamW states (and every module's state) as loaded, bit for bit
    last = GAN_LOOP_STEPS + GAN_LOOP_MORE - 1
    g_file = os.path.join(cfg.checkpoint_path, f"g_{last:08d}")
    do_file = os.path.join(cfg.checkpoint_path, f"do_{last:08d}")
    trainer = GANTrainer(cfg, seed=SEED)
    t0 = time.perf_counter()
    resumed = load_vec2wav(g_file, do_file, trainer)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    do = torch.load(do_file, map_location="cpu", weights_only=False)
    state = trainer.state_dict()
    check(all(tensors_equal(state[k], do[k]) for k in ("mpd", "msd", "optim_g", "optim_d"))
          and tensors_equal(state["generator"],
                            torch.load(g_file, map_location="cpu")["generator"])
          and resumed["steps"] == last + 1,
          f"{os.path.basename(do_file)}: loaded state differs from the files'")
    spectral = sum(1 for k in state["msd"] if k.endswith("weight_u"))
    step_s = list(first.seconds.values()) + list(second.seconds.values())
    mb = (os.path.getsize(g_file) + os.path.getsize(do_file)) / 2**20
    del trainer, state, do
    print(f"vec2wav_loop windowed at full size: {GAN_LOOP_STEPS} steps in {first_s:.1f} s, then "
          f"resumed from do_{GAN_LOOP_STEPS - 1:08d} at step {min(second.steps)} for "
          f"{GAN_LOOP_MORE} more in {second_s:.1f} s; files {names} (a pair {mb:.0f} MiB); "
          "saves " + ", ".join(f"step {k} {v:.2f} s" for r in (first, second)
                               for k, v in r.saves.items())
          + "; validation mel L1 " + ", ".join(
              f"step {k} {v['mel_spec_error']:.4f} ({v['seconds']:.2f} s)"
              for r in (first, second) for k, v in r.validations.items())
          + f"; host s/step median {float(np.median(step_s)):.3f}"
          f"; do_{last:08d} loaded bit-equal (AdamW states, {spectral} MSD spectral u) in "
          f"{load_s:.2f} s; {card_line()}")
    print("  losses: " + "; ".join(f"{s}: " + " ".join(f"{x:.3f}" for x in h.values())
                                    for r in (first, second) for s, h in r.steps.items()))
    return g_file


def serve_trained(t2v_cfg: Text2VecConfig, g_file: str, loop_counts: dict) -> None:
    """Phase 31: the files phases 28 and 30 wrote, served: the run's own
    ``config.json`` and ``checkpoint_{LOOP_STEPS}.pth.tar``, the last ``g_``
    file, through ``init_import_models`` and one ``Synthesizer`` request at
    ``alpha`` ``FRAMES_PER_CHAR``: six steps leave the duration predictor
    near 0, and ``floor((d + 0.5) * alpha)`` then speaks 4 frames a
    character or more."""
    run_cfg = load_config(Text2VecConfig, os.path.join(t2v_cfg.run_path, t2v_cfg.log_seed,
                                                       "config.json"))
    v2w_cfg = gan_config()
    t2v_state, gen_state = init_import_models(
        run_cfg, v2w_cfg, t2v_checkpoint=os.path.join(
            t2v_cfg.checkpoint_path, f"checkpoint_{LOOP_STEPS}.pth.tar"),
        gen_checkpoint=g_file)
    syn = Synthesizer(run_cfg, v2w_cfg, t2v_state, gen_state,
                      TextFrontend.from_vocab_file(run_cfg.vocab_path))
    text, ref, spk = demo_inputs(syn)
    reset_serving_counters()
    with torch.inference_mode():
        wav, n = syn.synthesize([text(24)], ref, spk, alpha=FRAMES_PER_CHAR, max_frames=512,
                                seed=SEED)
    counts = read_loop_counters()
    add_counts(loop_counts, counts)
    check(counts["fused_resblock"] == fused_units(v2w_cfg)
          and bigru_launches(counts, run_cfg) == 1, f"serving the trained files: launches {counts}")
    check(np.isfinite(wav).all() and wav.shape[1] == 512 * v2w_cfg.total_upsample and n[0] > 0,
          f"served waveform {wav.shape}, {n[0]} samples, finite {np.isfinite(wav).all()}")
    print(f"served the trained checkpoint_{LOOP_STEPS}.pth.tar and {os.path.basename(g_file)}: "
          f"{int(n[0]) // v2w_cfg.total_upsample} frames spoken, waveform finite, std "
          f"{float(wav[0, :int(n[0])].std()) if n[0] else 0.0:.3g}; launches {counts}")


def training_jobs(dev) -> dict:
    """Phases 28-31 in one temporary directory; returns the launches of
    each kernel over their paths."""
    loop_counts: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jobs_") as tmp:
        cfg = train_t2v_loop(tmp, loop_counts)
        torch.cuda.empty_cache()
        resume_t2v(cfg, loop_counts)
        torch.cuda.empty_cache()
        g_file = train_gan_loop_windowed(tmp, loop_counts)
        torch.cuda.empty_cache()
        serve_trained(cfg, g_file, loop_counts)
    return loop_counts


# ---------------------------------------------------------------------------
# Training data on the card and the GAN's modes (phases 32-36)
# ---------------------------------------------------------------------------

def t2v_demo_config(run_path: str, **changes) -> Text2VecConfig:
    """The full-size demo config, its vocabulary size taken from the vocab
    file as the loop takes it, its run directory ``run_path``."""
    cfg = load_config(Text2VecConfig, repo_path("data", "demo", "text2vec.json"))
    vocab = TextFrontend.from_vocab_file(cfg.vocab_path).vocab_size
    return dataclasses.replace(cfg, vocab_size=vocab, run_path=run_path, **changes)


def loop_argv(cfg, tmp: str, name: str, *flags: str) -> list:
    """``cfg`` written to ``{tmp}/{name}.json`` and the argv of ``cli
    train-*`` that trains from it; the loop's ``main(parse_args(argv))`` is
    what the subcommand runs."""
    path = os.path.join(tmp, f"{name}.json")
    save_config(cfg, path)
    return ["--config", path, *flags]


def rel_diffs(got: dict, want: dict) -> float:
    """The largest relative difference of two runs' scalars, step by step."""
    check(sorted(got) == sorted(want), f"steps {sorted(got)} vs {sorted(want)}")
    return max(abs(got[s][k] - want[s][k]) / max(abs(want[s][k]), 1e-12)
               for s in want for k in want[s])


def device_t2v_loop(tmp: str, counts: dict) -> None:
    """Phase 32: the demo corpus through the native reader, staged on the
    card; every batch of an epoch against the host collate's on the card,
    bit for bit; ``cli train-text2vec`` with ``device_resident_data=true``
    against the host path (with and without its prefetch thread), 3 steps a
    run in the turns of ``DEVICE_LOOP_ORDER``, under cuDNN's deterministic
    algorithms: every run's losses within ``DEVICE_LOSS_RTOL`` of the
    first's, one MAS and one BiGRU launch a step."""
    cfg = t2v_demo_config(os.path.join(tmp, "t2v_host"))
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    t0 = time.perf_counter()
    buffer = load_buffer(list(cfg.train_list), cfg, frontend)
    load_s = time.perf_counter() - t0
    check(native_io.reader() == "native", "the native .npy reader did not build: np.load read")
    loader = BucketedLoader(buffer, cfg, seed=SEED)
    cache = DeviceResidentData(buffer, cfg)
    n = 0
    for idx in loader.epoch_indices():
        got, want = cache.batch(idx), batch_to_device(loader.batch(idx), cache.device)
        check(all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                  for k in want), f"staged batch {idx} differs from the host collate's")
        n += 1
    print(f"device-resident Text2Vec data (demo corpus, {len(buffer)} items read by the "
          f"{native_io.reader()} reader in {load_s:.2f} s): {cache.nbytes() / 2**20:.2f} MiB "
          f"staged; the {n} batches of an epoch bit-equal to the host collate's on the card")
    del cache

    device_cfg = dataclasses.replace(cfg, device_resident_data=True,
                                     run_path=os.path.join(tmp, "t2v_device"))
    flags = ("--max_steps", "3", "--metric_flush_steps", "1")
    runs = {"host": loop_argv(cfg, tmp, "t2v_host", *flags),
            "host, no prefetch": loop_argv(cfg, tmp, "t2v_host", *flags, "--no-prefetch"),
            "device": loop_argv(device_cfg, tmp, "t2v_device", *flags)}
    records = {name: [] for name in runs}
    torch.backends.cudnn.deterministic = True
    try:
        for name in DEVICE_LOOP_ORDER:
            reset_serving_counters()
            records[name].append(text2vec_loop.main(text2vec_loop.parse_args(runs[name])))
            launches = read_loop_counters()
            add_counts(counts, launches)
            check(launches["mas"] == 3 and bigru_launches(launches, cfg, cfg.batch_size) == 3
                  and launches["gru_bwd"] == 3,
                  f"{name} Text2Vec loop launches {launches}: want one MAS and BiGRU a step")
    finally:
        torch.backends.cudnn.deterministic = False
    want = records["host"][0].steps
    err = max(rel_diffs(r.steps, want) for rs in records.values() for r in rs)
    check(err <= DEVICE_LOSS_RTOL, f"device-resident Text2Vec losses differ by {err:.3g}")
    ms = {name: 1e3 * float(np.median([t for r in rs for t in r.seconds.values()]))
          for name, rs in records.items()}
    print(f"cli train-text2vec with device_resident_data=true against the host path, with and "
          f"without its prefetch thread (3 steps a run, runs in the order {DEVICE_LOOP_ORDER}, "
          f"B = {cfg.batch_size}, cuDNN deterministic): losses max rel diff {err:.3g} (rtol "
          f"{DEVICE_LOSS_RTOL}); host clock between steps, median of steps 2-3 of both runs: "
          + ", ".join(f"{name} {v:.2f} ms" for name, v in ms.items())
          + f"; one MAS and one BiGRU launch a step; {card_line()}")


def staging_corpus(cfg, seed: int) -> list:
    """``STAGE_ITEMS`` synthetic items: ``STAGE_FRAMES`` frames of 1024-d
    features (views into one seeded table, so the host holds them once),
    ``STAGE_TEXT`` text ids and a prior (a view of one seeded [frames,
    text] table)."""
    rng = np.random.default_rng(seed)
    lo, hi = STAGE_FRAMES
    table = (rng.standard_normal((4 * hi, cfg.n_feat_dim), dtype=np.float32) * 0.5)
    prior = rng.random((hi, cfg.text_buckets[-1]), dtype=np.float32)
    items = []
    for _ in range(STAGE_ITEMS):
        t = int(rng.integers(lo, hi + 1))
        n = int(rng.integers(STAGE_TEXT[0], STAGE_TEXT[1] + 1))
        o = int(rng.integers(0, 3 * hi))
        items.append({"text_enc": rng.integers(3, cfg.vocab_size, n).astype(np.int32),
                      "feat_gt_target": table[o:o + t], "attn_prior": prior[:t, :n],
                      "audiopath": ""})
    return items


def read_once(tmp: str, order: list) -> None:
    """One pair of ``read_at_scale``, in a process of its own:
    ``load_buffer`` over ``{tmp}/read.txt`` by each reader of ``order``,
    every buffer kept, so that each reads into memory the process has not
    used yet, as a job's start does; prints the seconds and each feature's
    sum by reader as the last line, in JSON."""
    cfg = t2v_demo_config(tmp, feat_ground_truth=os.path.join(tmp, "read"),
                          use_attn_prior_masking=False)
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    native_lib, out, kept = native_io.get_lib, {}, []
    for reader in order:
        native_io.get_lib = native_lib if reader == "native" else (lambda: None)
        check(native_io.reader() == reader, f"the reader is {native_io.reader()}, not {reader}")
        t0 = time.perf_counter()
        kept.append(load_buffer([os.path.join(tmp, "read.txt")], cfg, frontend))
        out[reader] = {"s": time.perf_counter() - t0,
                       "sums": [float(it["feat_gt_target"].sum(dtype=np.float64))
                                for it in kept[-1]]}
    print(json.dumps(out))


def read_at_scale(items: list, tmp: str) -> None:
    """``READ_FILES`` of ``items`` written as ``[1, T, 1024]`` ``.npy``
    files (the demo list's texts, no prior), then ``load_buffer`` over them
    by the native prefetcher and by ``np.load`` (the reader taken where the
    library is missing), ``READ_PAIRS`` alternating pairs, each pair in a
    fresh process (``read_once``), as a training job reads its corpus at
    its start; the buffers equal.  The files were just written, so they
    come from the page cache."""
    root = os.path.join(tmp, "read")
    os.makedirs(root)
    cfg = t2v_demo_config(tmp)
    with open(cfg.train_list[0], encoding="utf-8") as f:
        texts = [x.split("|")[1] for x in f.read().split("\n") if x]
    lines = []
    for i, it in enumerate(items[:READ_FILES]):
        np.save(os.path.join(root, f"u{i}.npy"), it["feat_gt_target"][None])
        lines.append(f"u{i}.npy|{texts[i % len(texts)]}|SSB0000")
    with open(os.path.join(tmp, "read.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    mib = sum(it["feat_gt_target"].nbytes for it in items[:READ_FILES]) / 2**20
    seconds = {"native": [], "np.load": []}
    for r in range(READ_PAIRS):
        order = ["native", "np.load"][::1 if r % 2 == 0 else -1]
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.read_once({tmp!r}, {order!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, f"the readers' process: {proc.stderr[-2000:]}")
        check("np.load for" not in proc.stdout, "a file fell back to np.load")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        check(out["native"]["sums"] == out["np.load"]["sums"], "the readers' buffers differ")
        for name in seconds:
            seconds[name].append(out[name]["s"])
    print(f"  load_buffer over {READ_FILES} of these items as .npy files ({mib:.1f} MiB, page "
          f"cache), each pair of readers in a fresh process, {READ_PAIRS} alternating pairs, s "
          f"(MiB/s of the median): " + "; ".join(
              f"{name} " + " ".join(f"{x:.3f}" for x in v) + f" ({mib / np.median(v):.0f})"
              for name, v in seconds.items()) + f"; {card_line()}")


def stage_at_scale(dev, tmp: str, counts: dict) -> None:
    """Phase 33: a synthetic corpus at a real size staged on the card: the
    staging seconds and bytes; a B = 16 x 1024-frame batch assembled on the
    card against the host collate plus its copy; the bytes that cross a
    step; the full-size training step fed from the cache; the readers of
    ``load_buffer`` over part of it (``read_at_scale``)."""
    cfg = dataclasses.replace(train_config(), text_buckets=(STAGE_N,), frame_buckets=(TRAIN_T,))
    items = staging_corpus(cfg, SEED + 33)
    frames = sum(it["feat_gt_target"].shape[0] for it in items)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = DeviceResidentData(items, cfg)
    stage_s = time.perf_counter() - t0
    gib = cache.nbytes() / 2**30
    print(f"staging at scale: {len(items)} items of {STAGE_FRAMES[0]}-{STAGE_FRAMES[1]} frames "
          f"({frames} in all) at {cfg.n_feat_dim} dims, text {STAGE_TEXT[0]}-{STAGE_TEXT[1]}: "
          f"{gib:.3f} GiB staged in {stage_s:.2f} s ({gib / stage_s:.2f} GiB/s, host build and "
          f"copy); {card_line()}")
    loader = BucketedLoader(items, cfg, seed=SEED)
    batches = [idx for _, idx in zip(range(ASSEMBLE_BATCHES), loader.epoch_indices())]
    got, want = cache.batch(batches[0]), batch_to_device(loader.batch(batches[0]), dev)
    check(all(torch.equal(got[k], want[k]) for k in want), "staged batch != host collate's")
    check(tuple(got["feat_target"].shape) == (TRAIN_B, TRAIN_T, cfg.n_feat_dim),
          f"staged batch {tuple(got['feat_target'].shape)}")
    host_bytes = sum(np.asarray(v).nbytes for v in loader.batch(batches[0]).values())
    card_ms, host_ms = [], []
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache.batch(idx)
        torch.cuda.synchronize()
        card_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        batch_to_device(loader.batch(idx), dev)
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"  a B = {TRAIN_B} x {TRAIN_T}-frame batch (median of {len(batches)}, host clock to a "
          f"synchronize): gathered on the card {np.median(card_ms):.3f} ms, host collate + copy "
          f"{np.median(host_ms):.3f} ms; bytes to the card a step: {TRAIN_B * 8} (the index "
          f"vector) vs {host_bytes} ({host_bytes / 2**20:.1f} MiB)")

    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    order = iter(loader.epoch_indices())
    times = []
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        if step == WARMUP_STEPS:
            torch.cuda.synchronize()
            reset_counters()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = run_step(trainer, cache.batch(next(order)))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        check(all(math.isfinite(metrics[k].item()) for k in SCALAR_KEYS), f"losses {metrics}")
    launches = read_counters()
    add_counts(counts, launches)
    check(launches["mas"] == TIMED_STEPS and launches["gru_bwd"] == TIMED_STEPS
          and bigru_launches(launches, cfg, TRAIN_B) == TIMED_STEPS,
          f"fed from the cache: {launches}")
    ms = float(np.median(times[WARMUP_STEPS:]))
    print(f"  training fed from the cache (B = {TRAIN_B}, N = {STAGE_N}, T = {TRAIN_T}, a "
          f"new batch gathered each step and timed with it): median {ms:.2f} ms of "
          f"{TIMED_STEPS} (phase 8's step, one host batch at N = {TRAIN_N}, above); launches "
          f"{launches}")
    del cache, trainer
    torch.cuda.empty_cache()
    read_at_scale(items, tmp)


def device_gan_loop(tmp: str, counts: dict) -> None:
    """Phase 34: the windowed GAN loop from the card's corpus: staged
    windows against the CPU cache's for fixed (idx, fstart), bit for bit;
    ``cli train-vec2wav`` with ``split``, ``device_mel_target`` and
    ``device_resident_data`` at B = 2 (the config's) for
    ``GAN_LOOP_STEPS`` steps, resumed for ``GAN_LOOP_MORE``, one request
    served from the last ``g_`` file; at B = 16 (the demo list four times
    over) for ``GAN_LOOP_STEPS`` steps."""
    cfg = dataclasses.replace(gan_config(), split=True, device_mel_target=True,
                              device_resident_data=True, run_path=os.path.join(tmp, "v2w_dev"),
                              save_step=2, val_step=1000, log_step=1)
    files, _ = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    ds = VocoderDataset(files, cfg)
    card, cpu = VocoderDeviceData(ds, cfg), VocoderDeviceData(ds, cfg, device="cpu")
    idx = np.arange(len(files))
    fstart = card.draw_fstarts(idx)
    got, want = card.batch(idx, fstart), cpu.batch(idx, fstart)
    check(all(torch.equal(got[k].cpu(), want[k]) for k in want), "staged windows differ")
    print(f"device-resident windows: {len(files)} items, {card.nbytes() / 2**20:.2f} MiB staged, "
          f"windows at starts {fstart.tolist()} bit-equal to the CPU cache's")
    del card, cpu

    def run(c, name, max_steps):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rec = vec2wav_loop.main(vec2wav_loop.parse_args(loop_argv(
                c, tmp, name, "--max_steps", str(max_steps), "--stdout_interval", "1")))
        check("device-resident dataset" in out.getvalue(), f"{name}: no device-resident data")
        check(rec.steps and all(math.isfinite(v) for h in rec.steps.values() for v in h.values()),
              f"{name} losses {rec.steps}")
        return rec, [rec.seconds[s] for s in sorted(rec.seconds)]

    first, first_s = run(cfg, "v2w_dev", GAN_LOOP_STEPS)
    second, second_s = run(cfg, "v2w_dev", GAN_LOOP_STEPS + GAN_LOOP_MORE)
    check(sorted(second.steps) == list(range(GAN_LOOP_STEPS, GAN_LOOP_STEPS + GAN_LOOP_MORE)),
          f"resumed steps {sorted(second.steps)}")
    listing = os.path.join(tmp, "train16.txt")
    with open(cfg.input_training_file, encoding="utf-8") as f:
        lines = [x for x in f.read().split("\n") if x]
    with open(listing, "w", encoding="utf-8") as f:
        f.write("\n".join(lines * 4) + "\n")
    wide = dataclasses.replace(cfg, batch_size=GAN_WINDOW_B, input_training_file=listing,
                               run_path=os.path.join(tmp, "v2w_dev16"), save_step=1000)
    _, wide_s = run(wide, "v2w_dev16", GAN_LOOP_STEPS)
    print(f"cli train-vec2wav windowed from the card (split, device_mel_target, "
          f"device_resident_data): host s/step (steps 1-{GAN_LOOP_STEPS - 1}, the first ~1 s "
          f"apart) B = {cfg.batch_size} median {np.median(first_s[1:]):.3f} ("
          + " ".join(f"{x:.3f}" for x in first_s) + f"), resumed at step {min(second.steps)}: "
          + " ".join(f"{x:.3f}" for x in second_s) + f"; B = {GAN_WINDOW_B} median "
          f"{np.median(wide_s[1:]):.3f} (" + " ".join(f"{x:.3f}" for x in wide_s)
          + f"); {card_line()}")

    last = GAN_LOOP_STEPS + GAN_LOOP_MORE - 1
    g_file = os.path.join(cfg.checkpoint_path, f"g_{last:08d}")
    t2v_cfg = load_config(Text2VecConfig, repo_path("data", "demo", "text2vec.json"))
    t2v_state, gen_state = init_import_models(t2v_cfg, gan_config(), gen_checkpoint=g_file)
    syn = Synthesizer(t2v_cfg, gan_config(), t2v_state, gen_state,
                      TextFrontend.from_vocab_file(t2v_cfg.vocab_path))
    text, ref, spk = demo_inputs(syn)
    reset_serving_counters()
    with torch.inference_mode():
        wav, n = syn.synthesize([text(24)], ref, spk, alpha=FRAMES_PER_CHAR, max_frames=512,
                                seed=SEED)
    launches = read_loop_counters()
    add_counts(counts, launches)
    check(launches["fused_resblock"] == fused_units(gan_config())
          and bigru_launches(launches, t2v_cfg) == 1,
          f"serving the device-trained g_: launches {launches}")
    check(np.isfinite(wav).all() and n[0] > 0, "served waveform not finite")
    print(f"  served {os.path.basename(g_file)}: {int(n[0])} samples, finite; launches {launches}")


def repack_layers(msd, B: int, T: int, label: str) -> list:
    """Each grouped convolution of the weight-normed MSD scale at the
    pair-batched input of ``B`` items of ``T`` frames: forward and
    forward + backward by grouped ``F.conv1d`` and by the repack (CUDA
    events), the values and both gradients held to each other.  Returns
    (T_in, plain ms, repack ms) of forward + backward per layer."""
    disc = msd.discriminators[1]
    x = torch.randn(2 * B, 1, T * 320, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda") * 0.1
    rows = []
    print(f"  MSD grouped convolutions at {label} (x {tuple(x.shape)}, f32):")
    for conv in disc.convs:
        kw = dict(stride=conv.stride, padding=conv.padding, groups=conv.groups)
        w, b = conv.weight().detach(), conv.bias.detach()
        if conv.groups > 1:
            xin = x.detach().requires_grad_()
            wg = w.clone().requires_grad_()
            plain = lambda: F.conv1d(xin, wg, b, **kw)  # noqa: E731
            repack = lambda: tiled_grouped_conv1d(xin, wg, b, **kw)  # noqa: E731
            out = plain()
            dout = torch.randn_like(out)
            ref = torch.autograd.grad(out, (xin, wg), dout)
            got_out = repack()
            got = torch.autograd.grad(got_out, (xin, wg), dout)
            errs = [float((got_out - out).abs().max() / out.abs().max())] + [
                float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
            check(errs[0] <= REPACK_RTOL and max(errs[1:]) <= REPACK_GRAD_RTOL,
                  f"repack vs grouped conv at {tuple(x.shape)}: {errs}")
            flop = 2.0 * out.numel() * w.shape[1] * w.shape[2]
            ms = {}
            for name, fn in (("plain", plain), ("repack", repack)):
                ms[name] = (cuda_ms(fn, 3), cuda_ms(lambda fn=fn: torch.autograd.grad(
                    fn(), (xin, wg), dout), 3))
            print(f"    {x.shape[1]:4d} -> {w.shape[0]:4d}, stride {conv.stride}, groups "
                  f"{conv.groups:2d}, T_in {x.shape[2]:6d}: forward {ms['plain'][0]:7.3f} | "
                  f"{ms['repack'][0]:7.3f} ms ({flop / ms['plain'][0] / 1e9:5.1f} | "
                  f"{flop / ms['repack'][0] / 1e9:5.1f} TFLOP/s), forward + backward "
                  f"{ms['plain'][1]:7.3f} | {ms['repack'][1]:7.3f} ms "
                  f"({3 * flop / ms['plain'][1] / 1e9:5.1f} | "
                  f"{3 * flop / ms['repack'][1] / 1e9:5.1f} TFLOP/s) (grouped conv | repack); "
                  f"max errors {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e}")
            rows.append((x.shape[2], ms["plain"][1], ms["repack"][1]))
        with torch.no_grad():
            x = F.leaky_relu(F.conv1d(x, w, b, **kw), LRELU_SLOPE)
    return rows


def repack_ab(trainers: dict, batch: dict, label: str) -> dict:
    """The GAN step of each trainer (the same weights; the MSD on each of
    ``REPACK_ROUTES``) on ``batch``, in ``REPACK_PAIRS`` alternating rounds
    (forward order, then reverse); prints and returns the median ms of
    each.  JAX's gate: the repack's calls on inputs shorter than
    ``JAX_MIN_T_IN`` samples go to grouped ``F.conv1d`` instead."""
    def jax_gate(x, *args, **kw):
        conv = tiled_grouped_conv1d if x.shape[2] >= JAX_MIN_T_IN else F.conv1d
        return conv(x, *args, **kw)

    def step(name):
        if name == "jax_gate":
            layers.tiled_grouped_conv1d = jax_gate
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainers[name].step(batch)
            end.record()
            torch.cuda.synchronize()
        finally:
            layers.tiled_grouped_conv1d = tiled_grouped_conv1d
        return start.elapsed_time(end)

    names = list(trainers)
    for name in names:
        step(name)  # warm-up
    times = {name: [] for name in names}
    for r in range(REPACK_PAIRS):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(step(name))
    med = {name: float(np.median(v)) for name, v in times.items()}
    print(f"  GAN step A/B at {label} ({REPACK_PAIRS} alternating rounds, CUDA events): "
          + "; ".join(f"{REPACK_ROUTES[n]} {med[n]:.2f} ms ({min(times[n]):.2f}-"
                      f"{max(times[n]):.2f})" for n in names)
          + f"; {card_line()}")
    return med


def msd_repack(dev) -> None:
    """Phase 35: the MSD's grouped layers by both routes at the
    whole-utterance and windowed shapes; the GAN step A/B at both; the
    profiler's top kernels of the repack's whole-utterance step; the gate's
    threshold as measured."""
    cfg = gan_config()
    torch.manual_seed(SEED)
    msd = MultiScaleDiscriminator(cfg.disc_pair_batched, device=dev)
    print("MSD repack (ops/tiled_conv.py) against grouped F.conv1d:")
    rows = repack_layers(msd, GAN_B, GAN_T, f"B = {GAN_B} x {GAN_T} frames")
    rows += repack_layers(msd, GAN_WINDOW_B, WINDOW_T, f"B = {GAN_WINDOW_B} x {WINDOW_T} frames")
    del msd
    wins = sorted(t for t, plain, rep in rows if rep < plain)
    losses = sorted(t for t, plain, rep in rows if rep >= plain)
    print(f"  the gate, as measured (forward + backward of each layer): the repack is faster at "
          f"T_in {wins}, slower at {losses}; the port's gate admits every length")
    trainers = {name: gan_trainer(cfg, dev, tiled_conv=(name != "off"))
                for name in REPACK_ROUTES}
    whole = trainers["off"].to_device(gan_batch(cfg, GAN_B, GAN_T, SEED))
    windowed = trainers["off"].to_device(gan_batch(cfg, GAN_WINDOW_B, WINDOW_T, SEED))
    repack_ab(trainers, whole, f"B = {GAN_B} x {GAN_T} frames")
    repack_ab(trainers, windowed, f"windowed B = {GAN_WINDOW_B} x {WINDOW_T} frames")
    print("  top kernels of the repack's step (the port's gate, whole utterances):")

    def timed():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainers["on"].step(whole)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    profile_gan_kernels(timed, float(np.median([timed() for _ in range(3)])))


def gan_bf16(dev, phase19: dict) -> None:
    """Phase 36: the GAN step as ``GANTrainer(cfg)`` builds it, the MSD on
    the repack (``cfg.msd_tiled_conv``), at full size (phase 18's weights
    and batches): bf16 at B = ``GAN_B`` and ``GAN_SWEEP_B``; f32, and bf16
    with the MSD on grouped convolutions, at ``GAN_SWEEP_B``.  Then one bf16
    card step against
    the CPU's bf16 step from phase 19's weights, noise and batch, both on
    the repack, held to |card - CPU bf16| at most ``GAN_BF16_NOISE`` times
    |CPU bf16 - CPU f32| or ``GAN_BF16_FLOOR`` of the loss; phase 19's f32
    card step must fail that bound on at least one loss."""
    cfg = gan_config()
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    check(cfg.msd_tiled_conv, "the demo config keeps the MSD off the repack")
    for label, B, c, dtype, tiled in (
            ("bf16", GAN_B, bf16, torch.bfloat16, True), ("f32", GAN_SWEEP_B, cfg, None, True),
            ("bf16", GAN_SWEEP_B, bf16, torch.bfloat16, True),
            ("bf16, MSD grouped", GAN_SWEEP_B, bf16, torch.bfloat16, False)):
        trainer = gan_trainer(c, dev, dtype=dtype, tiled_conv=tiled)
        batch = trainer.to_device(gan_batch(c, B, GAN_T, SEED))
        timed_gan(trainer, batch, f"GAN {label} B={B}", TIMED_STEPS)
        del trainer, batch
        torch.cuda.empty_cache()
    print(f"  (the MSD on the repack unless marked, the default; phase 18's f32 step is on "
          f"grouped convolutions; {card_line()})")
    args = (bf16, phase19["states"], phase19["host"], phase19["noise"])
    card = gan_step_result(*args, "cuda", dtype=torch.bfloat16, tiled_conv=True)["losses"]
    cpu = gan_step_result(*args, "cpu", dtype=torch.bfloat16, tiled_conv=True)["losses"]
    bounds = [max(GAN_BF16_NOISE * abs(b - f32), GAN_BF16_FLOOR * abs(b))
              for b, f32 in zip(cpu, phase19["cpu_losses"])]
    for k, a, b, bound in zip(GAN_KEYS, card, cpu, bounds):
        check(abs(a - b) <= bound, f"bf16 GAN step {k}: card {a} vs CPU {b} (bound {bound:.3g})")
    f32_out = [k for k, a, b, bound in zip(GAN_KEYS, phase19["card_losses"], cpu, bounds)
               if abs(a - b) > bound]
    check(bool(f32_out), "the f32 card step passes the bf16 bound: it cannot tell the two apart")
    print(f"GAN bf16 step, card vs CPU (B={GAN_CHECK_B} T={GAN_CHECK_T}, phase 19's weights and "
          f"noise, the MSD on the repack; bound {GAN_BF16_NOISE} x |CPU bf16 - CPU f32| or "
          f"{GAN_BF16_FLOOR} of the loss): " + ", ".join(
              f"{k} {a:.5g} vs {b:.5g} (|diff| {abs(a - b):.3g}, bound {bound:.3g}; CPU f32 "
              f"{f:.5g}, card f32 {g:.5g})" for k, a, b, bound, f, g in
              zip(GAN_KEYS, card, cpu, bounds, phase19["cpu_losses"], phase19["card_losses"]))
          + f"; the f32 card step fails the bound at {f32_out}")


def data_and_gan_modes(dev, phase19: dict) -> dict:
    """Phases 32-36; returns each kernel's launches over them."""
    counts: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        for phase, fn in ((32, lambda: device_t2v_loop(tmp, counts)),
                          (33, lambda: stage_at_scale(dev, tmp, counts)),
                          (34, lambda: device_gan_loop(tmp, counts)),
                          (35, lambda: msd_repack(dev)),
                          (36, lambda: gan_bf16(dev, phase19))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Data preparation and model upkeep (phases 37-41)
# ---------------------------------------------------------------------------

def tools_tree(tmp: str) -> dict:
    """A synthetic AISHELL-3-shaped tree: ``{tmp}/wav/{spk}/{spk}{n}.wav``,
    ``TOOLS_SPEAKERS`` x ``TOOLS_WAVS`` voiced wavs (five harmonics of a
    wavering f0, plus noise) of ``TOOLS_SECONDS``, 16 kHz int16, and
    ``content.txt`` giving each the characters of one of eval's test
    sentences, each followed by a pinyin token as AISHELL-3's labels are
    (``clean_label_text`` strips them)."""
    rng = np.random.default_rng(SEED)
    root = os.path.join(tmp, "wav")
    lines, samples = [], 0
    for s in range(TOOLS_SPEAKERS):
        spk = f"SSB{s:04d}"
        os.makedirs(os.path.join(root, spk))
        for u in range(TOOLS_WAVS):
            n = int(rng.uniform(*TOOLS_SECONDS) * SAMPLE_RATE)
            t = np.arange(n) / SAMPLE_RATE
            f0 = rng.uniform(90.0, 250.0) * (1.0 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 1) * t))
            phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
            wav = 0.2 * sum(np.sin(k * phase) / k for k in range(1, 6))
            wav = wav + 0.01 * rng.standard_normal(n)
            name = f"{spk}{u:04d}.wav"
            wavfile.write(os.path.join(root, spk, name), SAMPLE_RATE,
                          (wav * 20000).astype(np.int16))
            text = TEST_SENTENCES[(s * TOOLS_WAVS + u) % len(TEST_SENTENCES)]
            lines.append(f"{name}\t" + " ".join(f"{c} a{k % 5 + 1}" for k, c in enumerate(text)))
            samples += n
    content = os.path.join(tmp, "content.txt")
    with open(content, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return dict(wavs=root, content=content, seconds=samples / SAMPLE_RATE)


def w2v_flops(cfg, n_samples: int, n_frames: int) -> float:
    """Operations (2 a multiply-add) of one wav of ``n_samples`` through
    wav2vec 2.0, its transformer over ``n_frames`` frames: the feature
    encoder's convolutions, the projection, the positional convolution, and
    each layer's projections, attention products and feed-forward."""
    ops, length, c_in = 0.0, n_samples, 1
    for c, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
        ops += 2.0 * length * c * c_in * k
        c_in = c
    h, T = cfg.hidden_size, n_frames
    ops += 2.0 * T * c_in * h
    ops += 2.0 * T * h * (h // cfg.num_conv_pos_embedding_groups) * cfg.num_conv_pos_embeddings
    ops += cfg.num_hidden_layers * (2.0 * T * (4 * h * h + 2 * h * cfg.intermediate_size)
                                    + 4.0 * T * T * h)
    return ops


def speaker_wavs(root: str) -> dict:
    return {spk: [load_wav(os.path.join(root, spk, f))[0]
                  for f in sorted(os.listdir(os.path.join(root, spk)))]
            for spk in sorted(os.listdir(root))}


def prepare_data_phase(dev, tmp: str, counts: dict) -> dict:
    """Phase 37: wav2vec 2.0 large with seeded weights, saved as a local
    checkpoint directory (``config.json`` and ``pytorch_model.bin``); ``cli
    prepare-data`` over ``tools_tree``; the latents, filelists and vocabulary
    it wrote; the featurizer's seconds of audio a second (host clock, each
    batch ends in a host copy), against its bound at the CUDA cores' f32
    rate, and its peak memory; the card's latents against the CPU's."""
    tree = tools_tree(tmp)
    w2v_dir = os.path.join(tmp, "w2v")
    t0 = time.perf_counter()
    w2v = random_model(large_config(), SEED, device="cpu")
    cfg = w2v.cfg
    save_pretrained(w2v, w2v_dir)
    n_params = sum(p.numel() for p in w2v.parameters())
    del w2v
    save_s = time.perf_counter() - t0
    out = {name: os.path.join(tmp, name) for name in ("feat", "train.txt", "val.txt",
                                                       "vocab.txt")}
    argv = ["prepare-data", "--wavs_path", tree["wavs"], "--feat_output_path", out["feat"],
            "--label_file_path", tree["content"], "--enc_train_list_path", out["train.txt"],
            "--enc_val_list_path", out["val.txt"], "--vocab_path", out["vocab.txt"],
            "--model_path", w2v_dir, "--n_speakers", str(TOOLS_SPEAKERS),
            "--n_files_per_speaker", str(TOOLS_WAVS), "--batch_size", str(TOOLS_B),
            "--device", str(dev)]
    reset_serving_counters()
    t0 = time.perf_counter()
    check(cli.main(argv) == 0, "cli prepare-data failed")
    cli_s = time.perf_counter() - t0
    add_counts(counts, read_loop_counters())

    wavs = speaker_wavs(tree["wavs"])
    for spk, items in wavs.items():
        for f, w in zip(sorted(os.listdir(os.path.join(tree["wavs"], spk))), items):
            lat = np.load(os.path.join(out["feat"], spk, f[:-4] + ".npy"))
            want = (1, int(feat_extract_output_lengths(len(w), cfg)), cfg.hidden_size)
            check(lat.shape == want and lat.dtype == np.float32 and np.isfinite(lat).all(),
                  f"{spk}/{f}: latents {lat.shape} {lat.dtype}, want {want} finite f32")
    rows = {k: open(out[k], encoding="utf-8").read().splitlines() for k in ("train.txt",
                                                                          "val.txt")}
    half = TOOLS_SPEAKERS * TOOLS_WAVS // 2
    check(len(rows["train.txt"]) == half and len(rows["val.txt"]) == half,
          f"filelists of {len(rows['train.txt'])} and {len(rows['val.txt'])} rows")
    vocab = open(out["vocab.txt"], encoding="utf-8").read()
    check(vocab == "PE " + "".join(sorted(set("".join(TEST_SENTENCES)))),
          f"vocabulary {vocab!r}")

    featurizer = Wav2VecFeaturizer(w2v_dir, device=dev)
    batches = [items[i: i + TOOLS_B] for items in wavs.values()
               for i in range(0, len(items), TOOLS_B)]
    featurizer.extract_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches:
        featurizer.extract_batch(b)
    feat_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    audio_s = tree["seconds"]
    real = sum(w2v_flops(cfg, len(w), int(feat_extract_output_lengths(len(w), cfg)))
               for items in wavs.values() for w in items)
    run = 0.0
    for b in batches:
        pad = featurizer._bucket(max(len(w) for w in b))
        run += len(b) * w2v_flops(cfg, pad, int(feat_extract_output_lengths(pad, cfg)))
    bms, by = bound_ms(n_params * 4.0, real, PEAK_F32)
    print(f"prepare-data (wav2vec 2.0 large, {n_params / 1e6:.1f} M parameters, seeded; "
          f"saved as config.json + pytorch_model.bin in {save_s:.1f} s): cli over "
          f"{TOOLS_SPEAKERS} x {TOOLS_WAVS} wavs ({audio_s:.1f} s of audio, B = {TOOLS_B}) in "
          f"{cli_s:.2f} s, its model load included; launches {read_loop_counters()}")
    print(f"  featurizer: {feat_s * 1e3:.1f} ms for {audio_s:.1f} s of audio "
          f"({audio_s / feat_s:.1f} s of audio a second, {len(batches)} batches padded to "
          f"{[featurizer._bucket(max(len(w) for w in b)) for b in batches]} samples); "
          f"{real / 1e12:.3f} TFLOP for the wavs' own frames ({run / 1e12:.3f} as run, "
          f"padded): {real / feat_s / 1e12:.1f} TFLOP/s, bound {bms:.1f} ms ({by}, f32 "
          f"{PEAK_F32 / 1e12:.0f} TFLOP/s) = {bms / 1e3 / feat_s:.1%} of it; peak memory "
          f"{peak:.2f} GiB; {card_line()}")

    n = int(W2V_CHECK_S * SAMPLE_RATE)
    check_wavs = [w[:n] for w in batches[0][:W2V_CHECK_B]]
    check(all(len(w) == n for w in check_wavs), "a check wav is shorter than its cut")
    got = featurizer.extract_batch(check_wavs)
    del featurizer
    torch.cuda.empty_cache()
    want = Wav2VecFeaturizer(w2v_dir, device="cpu").extract_batch(check_wavs)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    scale = max(float(np.abs(b).max()) for b in want)
    check(err <= W2V_ATOL, f"latents card vs CPU: {err:.3g} > {W2V_ATOL}")
    print(f"  latents, card vs CPU ({W2V_CHECK_B} x {W2V_CHECK_S:g} s, {got[0].shape[0]} frames "
          f"each): max |diff| {err:.3g} (atol {W2V_ATOL}; max |latent| {scale:.3g})")
    return dict(tree=tree, **out)


def pre_spk_emb_phase(dev, tmp: str, prep: dict, counts: dict) -> dict:
    """Phase 38: ``cli pre-spk-emb`` over the tree with both embedders (the
    repo's ECAPA, C = 1024, on raw wav; SpeechBrain's ECAPA at its published
    widths), each at seeded weights; each speaker's embedding timed on the
    card (host clock, median of ``REPEATS`` after a warm-up) and held against
    the CPU's.  Returns the embedding directories."""
    wavs = speaker_wavs(prep["tree"]["wavs"])
    dirs = {}
    for key, label, flags, build in (
            ("ecapa", "ECAPA C = 1024 on raw wav", [], SpeakerEmbedder),
            ("speechbrain", "SpeechBrain's ECAPA", ["--speechbrain"], SpeechBrainEmbedder)):
        out = dirs[key] = os.path.join(tmp, f"spk_emb_{key}")
        reset_serving_counters()
        t0 = time.perf_counter()
        check(cli.main(["pre-spk-emb", "--wavs_root", prep["tree"]["wavs"], "--out_dir", out,
                        "--n_files_per_speaker", str(TOOLS_WAVS), *flags,
                        "--device", str(dev)]) == 0, f"cli pre-spk-emb {flags} failed")
        cli_s = time.perf_counter() - t0
        add_counts(counts, read_loop_counters())
        card, cpu = build(device=dev), build(device="cpu")
        rows = []
        for spk, items in wavs.items():
            got = np.load(os.path.join(out, f"{spk}.npy"))
            card.embed_concat(items)
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                card.embed_concat(items)
                times.append(time.perf_counter() - t0)
            want = cpu.embed_concat(items)
            err = float(np.abs(got - want).max()) / float(np.abs(want).max())
            check(got.shape == (192,) and np.isfinite(got).all(),
                  f"{key} {spk}: embedding {got.shape}")
            check(err <= SPK_EMB_RTOL, f"{key} {spk}: card vs CPU {err:.3g} > {SPK_EMB_RTOL}")
            seconds = sum(len(w) for w in items) / SAMPLE_RATE
            rows.append(f"{spk} ({seconds:.1f} s) {np.median(times) * 1e3:.2f} ms, card vs CPU "
                        f"{err:.2e}")
        print(f"pre-spk-emb, {label}: cli {cli_s:.2f} s for {len(wavs)} speakers; per speaker "
              f"on the card: {'; '.join(rows)} (rtol {SPK_EMB_RTOL}); {card_line()}")
        del card, cpu
    return dirs


def recal_stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def check_carried(src: dict, out: dict, key: str, label: str) -> None:
    """Every entry of ``out`` but the model's running statistics equals
    ``src``'s, and at least one running statistic moved."""
    check(src.keys() == out.keys(), f"{label}: entries {sorted(src)} -> {sorted(out)}")
    check(tensors_equal({k: v for k, v in src.items() if k != key},
                        {k: v for k, v in out.items() if k != key}),
          f"{label}: an entry besides {key} changed")
    stats = recal_stats(src[key])
    check(tensors_equal({k: v for k, v in src[key].items() if k not in stats},
                        {k: v for k, v in out[key].items() if k not in stats}),
          f"{label}: a weight or buffer besides the running statistics changed")
    check(not tensors_equal(stats, recal_stats(out[key])),
          f"{label}: no running statistic moved")


def recal_err(card_file: str, cpu_file: str, key: str) -> tuple:
    card = recal_stats(torch.load(card_file, map_location="cpu", weights_only=False)[key])
    cpu = recal_stats(torch.load(cpu_file, map_location="cpu", weights_only=False)[key])
    errs = {k: float((card[k] - cpu[k]).abs().max()) / max(float(cpu[k].abs().max()), 1e-12)
            for k in cpu}
    worst = max(errs, key=errs.get)
    return errs[worst], worst, len(errs)


def tools_t2v_config(tmp: str, vocab: str) -> tuple:
    """The full-size demo config with phase 37's vocabulary, written to
    ``{tmp}/text2vec.json``."""
    cfg = dataclasses.replace(load_config(Text2VecConfig, repo_path("data", "demo",
                                                                    "text2vec.json")),
                              vocab_path=vocab,
                              vocab_size=TextFrontend.from_vocab_file(vocab).vocab_size)
    path = os.path.join(tmp, "text2vec.json")
    save_config(cfg, path)
    return cfg, path


def recal_batch_ms(dev, cfg, v2w_cfg, files: dict, filelist: str, prep: dict,
                   spk_dir: str) -> dict:
    """Each recalibration's own time a batch on the card, apart from the
    command's file reading and writing: ``recalibrate_text2vec_bn`` and
    ``recalibrate_generator_bn`` over phase 39's batches, built as the
    command builds them (``median_ms``, CUDA events)."""
    rows = cli._parse_filelist(filelist, RECAL_ROWS)
    feats = [np.load(os.path.join(prep["feat"], npy))[0] for npy, _, _ in rows]
    t2v = Text2Vec(cfg, device=dev)
    t2v.load_state_dict(load_torch_state_dict(files["Text2Vec"], key="model"), strict=True)
    t2v_batches = text2vec_calibration_batches(
        TextFrontend.from_vocab_file(cfg.vocab_path), cfg,
        [(text, f) for (_, text, _), f in zip(rows, feats)], batch_size=TOOLS_B)
    gen = Generator(v2w_cfg, device=dev)
    gen.load_state_dict(load_torch_state_dict(files["Generator"], key="generator"), strict=True)
    noise = torch.Generator().manual_seed(SEED)
    gen_batches = []
    for i in range(0, len(rows), TOOLS_B):
        chunk = range(i, min(i + TOOLS_B, len(rows)))
        gen_batches.append((
            np.stack([feats[j][:RECAL_GEN_FRAMES] for j in chunk]),
            np.stack([np.load(os.path.join(spk_dir, f"{rows[j][2]}.npy")) for j in chunk]),
            torch.randn((len(chunk), v2w_cfg.noise_dim), generator=noise).numpy()))
    return {"Text2Vec": median_ms(lambda: recalibrate_text2vec_bn(
                t2v, t2v_batches, max_frames=RECAL_MAX_FRAMES)) / len(t2v_batches),
            "Generator": median_ms(lambda: recalibrate_generator_bn(gen, gen_batches))
            / len(gen_batches)}


def recalibrate_phase(dev, tmp: str, prep: dict, spk_dirs: dict, counts: dict) -> dict:
    """Phase 39: ``cli recalibrate-bn`` on a full-size Text2Vec
    ``checkpoint_{RECAL_STEP}.pth.tar`` (a trainer's file: the model, LAMB's
    state, the lr and the epoch; the duration bias set as in phase 2) and a
    ``g_`` file, over ``RECAL_ROWS`` rows of phase 37's filelists, on the
    card and on the CPU: one BiGRU launch a Text2Vec batch and 30 fused
    launches a Generator batch; every entry but the running statistics
    carried over; the card's statistics against the CPU's; the written
    files served by a ``Synthesizer``."""
    cfg, cfg_path = tools_t2v_config(tmp, prep["vocab.txt"])
    v2w_cfg = gan_config()
    v2w_path = os.path.join(tmp, "vec2wav.json")
    save_config(v2w_cfg, v2w_path)
    src_dir = os.path.join(tmp, "ckpt")
    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    with torch.no_grad():
        trainer.model.length_regulator.duration_predictor.linear_layer.linear_layer.bias.add_(
            FRAMES_PER_CHAR)
    t2v_src = os.path.join(src_dir, f"checkpoint_{RECAL_STEP}.pth.tar")
    save_text2vec(t2v_src, trainer, epoch=3)
    del trainer
    torch.manual_seed(SEED)
    g_src = os.path.join(src_dir, f"g_{RECAL_STEP:08d}")
    torch.save({"generator": Generator(v2w_cfg, device="cpu").state_dict()}, g_src)
    filelist = os.path.join(tmp, "calibration.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        for name in ("train.txt", "val.txt"):
            f.write(open(prep[name], encoding="utf-8").read())
    n_batches = -(-RECAL_ROWS // TOOLS_B)

    common = ["--filelist", filelist, "--feat_root", prep["feat"], "--max_items", str(RECAL_ROWS),
              "--batch_size", str(TOOLS_B)]
    runs = {}
    for label, key, argv, kernel, per_batch in (
            ("Text2Vec", "model", ["--t2v_checkpoint", t2v_src, "--config", cfg_path,
                                   "--max_frames", str(RECAL_MAX_FRAMES)],
             GRU_KERNELS[numerics(cfg, TOOLS_B)][0], 1),
            ("Generator", "generator", ["--generator_checkpoint", g_src, "--config", v2w_path,
                                        "--spk_emb_dir", spk_dirs["speechbrain"],
                                        "--gen_frames", str(RECAL_GEN_FRAMES)],
             "fused_resblock", fused_units(v2w_cfg))):
        files = {}
        for where in ("card", "cpu"):
            out_dir = os.path.join(tmp, f"recal_{where}")
            reset_serving_counters()
            t0 = time.perf_counter()
            check(cli.main(["recalibrate-bn", *argv, *common, "--out", out_dir, "--device",
                            str(dev) if where == "card" else "cpu"]) == 0,
                  f"cli recalibrate-bn ({label}, {where}) failed")
            seconds = time.perf_counter() - t0
            launches = read_loop_counters()
            if where == "card":
                add_counts(counts, launches)
                check(launches[kernel] == per_batch * n_batches,
                      f"{label} recalibration: launches {launches}, want {per_batch} "
                      f"{kernel} a batch over {n_batches} batches")
                card_s, card_launches = seconds, launches
            files[where] = os.path.join(out_dir, os.path.basename(argv[1]))
        src = torch.load(argv[1], map_location="cpu", weights_only=False)
        check_carried(src, torch.load(files["card"], map_location="cpu", weights_only=False),
                      key, label)
        err, worst, n_stats = recal_err(files["card"], files["cpu"], key)
        check(err <= RECAL_STAT_RTOL, f"{label} statistics card vs CPU: {worst} {err:.3g}")
        print(f"recalibrate-bn, {label} ({RECAL_ROWS} rows, {n_batches} batches of "
              f"{TOOLS_B}): cli on the card {card_s:.2f} s (CPU {seconds:.2f} s), launches "
              f"{card_launches}; every other entry carried over; {n_stats} running statistics, "
              f"card vs CPU worst {err:.2e} ({worst}; rtol {RECAL_STAT_RTOL}); {card_line()}")
        runs[label] = files["card"]
    per_batch = recal_batch_ms(dev, cfg, v2w_cfg, runs, filelist, prep, spk_dirs["speechbrain"])
    print(f"  the recalibration alone, a batch of {TOOLS_B} on the card: Text2Vec "
          f"{per_batch['Text2Vec']:.2f} ms ({RECAL_MAX_FRAMES} frames), Generator "
          f"{per_batch['Generator']:.2f} ms ({RECAL_GEN_FRAMES} frames)")

    t2v_state, gen_state = init_import_models(cfg, v2w_cfg, t2v_checkpoint=runs["Text2Vec"],
                                              gen_checkpoint=runs["Generator"])
    syn = Synthesizer(cfg, v2w_cfg, t2v_state, gen_state, TextFrontend.from_vocab_file(
        cfg.vocab_path), device=dev)
    ref = np.load(os.path.join(prep["feat"], "SSB0000", "SSB00000000.npy"))
    spk = np.load(os.path.join(spk_dirs["speechbrain"], "SSB0000.npy"))[None]
    reset_serving_counters()
    with torch.inference_mode():
        wav, n = syn.synthesize([TEST_SENTENCES[1]], ref, spk, max_frames=512, seed=SEED)
    launches = read_loop_counters()
    add_counts(counts, launches)
    check(launches["fused_resblock"] == fused_units(v2w_cfg)
          and bigru_launches(launches, cfg) == 1,
          f"serving the recalibrated files: launches {launches}")
    check(np.isfinite(wav).all() and n[0] > 0, f"served waveform finite "
          f"{np.isfinite(wav).all()}, {n[0]} samples")
    print(f"  the recalibrated files served: {int(n[0]) // v2w_cfg.total_upsample} frames "
          f"spoken, waveform finite; launches {launches}")
    return dict(cfg_path=cfg_path, checkpoint_dir=os.path.dirname(runs["Text2Vec"]))


def eval_phase(dev, tmp: str, prep: dict, recal: dict, counts: dict) -> None:
    """Phase 40: ``cli eval-text2vec --rtf`` on the recalibrated checkpoint
    (the demo config with phase 37's vocabulary, which holds every character
    of the test sentences), phase 37's latents as the reference clips: six
    sentences written, then a warm-up and ``EVAL_RTF_ITERS`` timed ones, one
    BiGRU launch each."""
    refs = [os.path.join(prep["feat"], "SSB0000", f"SSB0000{u:04d}.npy")
            for u in range(len(TEST_SENTENCES))]
    results = os.path.join(tmp, "results")
    argv = ["eval-text2vec", "--config", recal["cfg_path"], "--checkpoint_path",
            recal["checkpoint_dir"], "--step", str(RECAL_STEP), "--results_dir", results,
            "--ref_npys", *refs, "--rtf", "--rtf_iters", str(EVAL_RTF_ITERS),
            "--device", str(dev)]
    reset_serving_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_loop_counters()
    add_counts(counts, launches)
    log = buf.getvalue()
    check(rc == 0, f"cli eval-text2vec failed: {log[-2000:]}")
    check(f"loaded checkpoint_{RECAL_STEP}.pth.tar" in log, "eval did not load the checkpoint")
    want = len(TEST_SENTENCES) + 1 + EVAL_RTF_ITERS
    check(bigru_launches(launches, load_config(Text2VecConfig, recal["cfg_path"])) == want,
          f"eval launches {launches}, want {want} BiGRU")
    for i in range(len(TEST_SENTENCES)):
        feat = np.load(os.path.join(results, "1", f"{RECAL_STEP}_{i}_feat.postnet.npy"))
        check(feat.ndim == 2 and feat.shape[0] > 0 and np.isfinite(feat).all(),
              f"eval sentence {i}: {feat.shape}")
    rtf = re.search(r"t2v RTF: ([0-9.]+) \(([0-9.]+)x realtime\), ([0-9.]+) utt/s", log)
    check(rtf is not None, f"no RTF line in {log[-500:]}")
    print(f"eval-text2vec --rtf: RTF {rtf.group(1)} ({rtf.group(2)}x realtime, "
          f"{rtf.group(3)} utterances a second over {EVAL_RTF_ITERS}); the command "
          f"{seconds:.2f} s; launches {launches}; {card_line()}")
    for line in log.splitlines():
        print(f"  | {line}")


def wav_step_result(cfg, state, host, ref_wav, dev) -> dict:
    """``step_result`` with ECAPA on raw reference waveforms: the training
    forward (``ref_wav``), the trainer's losses and the backward."""
    model = Text2Vec(cfg, device=dev)
    model.load_state_dict(state, strict=True)
    model.train()
    b = batch_to_device(host, torch.device(dev))
    out = model(b["text"], b["src_pos"], b["feat_target"], b["input_lengths"],
                b["output_lengths"], b["feat_pos"], attn_prior=b["attn_prior"],
                ref_wav=torch.as_tensor(ref_wav, device=dev))
    wvf, postnet, duration = dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                      b["feat_target"], out["duration_predictor_output"],
                                      out["duration"])
    binarization = attention_binarization_loss(out["attn"], out["attn_soft"])
    total = wvf + postnet + duration + cfg.binarization_loss_weight * binarization
    total.backward()
    return dict(losses=[x.item() for x in (total, wvf, postnet, duration, binarization)],
                attn=out["attn"].cpu(), duration=out["duration"].cpu(),
                grads={n: p.grad.cpu() for n, p in model.named_parameters()
                       if p.grad is not None})


def input_wav_phase(dev, counts: dict) -> None:
    """Phase 41: the full-size demo config with ``input_wav=True`` (dropout
    0): one training forward and backward, ECAPA on raw reference
    waveforms of ``WAV_REF_SECONDS``, at B = ``CHECK_B`` (phase 11's batch
    shape, the diagonal prior), on the card against the CPU: hard alignment
    and durations equal, losses and gradients at phase 11's tolerances; one
    MAS launch and one BiGRU forward launch on the card."""
    cfg = dataclasses.replace(load_config(Text2VecConfig, repo_path("data", "demo",
                                                                    "text2vec.json")),
                              input_wav=True, dropout=0.0)
    torch.manual_seed(SEED + 41)
    state = Text2Vec(cfg, device="cpu").state_dict()
    check(state["encoder.speaker_encoder.conv1.weight"].shape[1] == 80,
          "ECAPA's conv1 does not take the fbank's 80 bands")
    host = synthetic_batch(cfg, CHECK_B, CHECK_N, CHECK_T, SEED + 41, diagonal=True)
    rng = np.random.default_rng(SEED + 41)
    n = int(WAV_REF_SECONDS * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    ref_wav = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (CHECK_B, 1)) * t)
               + 0.05 * rng.standard_normal((CHECK_B, n))).astype(np.float32)
    reset_serving_counters()
    t0 = time.perf_counter()
    card = wav_step_result(cfg, state, host, ref_wav, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_loop_counters()
    add_counts(counts, launches)
    check(launches["mas"] == 1 and bigru_launches(launches, cfg, CHECK_B) == 1
          and launches["gru_bwd"] == 1, f"input_wav step launches {launches}")
    cpu = wav_step_result(cfg, state, host, ref_wav, "cpu")
    loss_err = compare_steps(card, cpu, STEP_LOSS_RTOL)
    total_err, worst, worst_name = grad_spread(card["grads"], cpu["grads"])
    check(total_err <= STEP_GRAD_GLOBAL_RTOL, f"input_wav gradients: {total_err:.3g} of the norm")
    check(worst <= STEP_GRAD_RTOL, f"input_wav gradient {worst_name}: {worst:.3g} of its norm")
    print(f"input_wav=True training forward + backward (B={CHECK_B} N={CHECK_N} T={CHECK_T}, "
          f"{WAV_REF_SECONDS:g} s reference waveforms, dropout 0): card {card_s * 1e3:.1f} ms "
          f"(first call, host clock), launches {launches}; card vs CPU: hard alignment and "
          f"durations equal, losses {loss_err:.2e} (rtol {STEP_LOSS_RTOL}), gradients "
          f"{total_err:.2e} of the norm (rtol {STEP_GRAD_GLOBAL_RTOL}), worst tensor "
          f"{worst:.2e} in {worst_name} (rtol {STEP_GRAD_RTOL}); {card_line()}")


def data_tools(dev) -> dict:
    """Phases 37-41 in one temporary directory; returns each kernel's
    launches over their paths."""
    counts: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        state: dict = {}
        for phase, fn in ((37, lambda: state.update(prep=prepare_data_phase(dev, tmp, counts))),
                          (38, lambda: state.update(spk=pre_spk_emb_phase(dev, tmp, state["prep"],
                                                                          counts))),
                          (39, lambda: state.update(recal=recalibrate_phase(
                              dev, tmp, state["prep"], state["spk"], counts))),
                          (40, lambda: eval_phase(dev, tmp, state["prep"], state["recal"],
                                                  counts)),
                          (41, lambda: input_wav_phase(dev, counts))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Data parallelism, a two-rank job and the benches (phases 42-44).  The ranks
# are processes of ``parallel.launch.run_local``, two on one card over gloo
# (NCCL takes one card a rank; rank 0 then runs a group of one over NCCL);
# the rank functions below run there, this module imported anew in each.

# the ranks' results must match one process on the global batch: losses
# within DP_LOSS_RTOL; gradients by norm as phase 11 holds the card against
# the CPU; parameters after the update within DP_PARAM_ATOL in all but
# DP_PARAM_OFF of the elements and within twice the tensor's largest step
# everywhere, as tests/test_torch_train.py holds the port's step against
# JAX's: the first LAMB or AdamW step is sign-like, so where a gradient is
# rounding noise the two runs step apart, and LAMB's per-tensor trust ratio
# moves with them
DP_LOSS_RTOL = 1e-5
DP_PARAM_ATOL = 1e-5
DP_PARAM_OFF = 1e-3
DP_WORLD = 2
DP_GAN_B, DP_GAN_T = 4, 256
DP_STEP_REPS = 1
DP_TIMEOUT = 900.0
JOB_STEPS, JOB_RESUME_AT = 3, 2
# a Text2Vec job's step against one process on the same global batch from
# the same state: the hard durations equal, and the losses within
# JOB_WITNESS_FACTOR times the distance between two one-process runs that
# differ only in the order of the items (at least DP_LOSS_RTOL).  The job's
# global batch is two items, and ECAPA's bn5 takes its statistics over
# their two pooled vectors, where flax's E[x^2] - E[x]^2 cancels:
# E[x^2] / (Var + eps) reaches ~5e5 on the card, so the f32 rounding of the
# sums, which the items' order or their split over the ranks changes, moves
# the losses by up to ~3e-3 in one process alone (phase 42's B = 16: 1e-7).
# A fault of the data or of the losses' reduction moves the durations, or
# the losses far past the witness
JOB_WITNESS_FACTOR = 10.0
BENCH_ITERS = 3
# the long bf16 flash steps of phase 44, with and without remat
LONG_BENCH_ITERS = 1
# remat against no remat after the updates: the recomputed blocks run the
# same kernels on the same inputs, dropout's mask replayed, so bit-equal
REMAT_RTOL = 0.0


def dp_flags() -> None:
    """A rank's settings: TF32 off, as in the parent, and cuDNN's
    deterministic algorithms; half the host's cores (two ranks share them)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // DP_WORLD))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def dp_setup(spec: dict):
    """``dp_flags``, then join the launcher's group."""
    dp_flags()
    return parallel.maybe_distributed_init(spec["device"], spec["backend"])


def dp_batch_norm_bytes(model) -> list:
    """Counts, through pre-hooks, the bytes that train-mode BatchNorms
    all-reduce in a step: ``(2C + 1)`` floats forward and as many backward."""
    seen = [0]

    def hook(mod, args):
        if mod.training:
            seen[0] += 2 * 4 * (2 * args[0].shape[-1] + 1)

    for m in model.modules():
        if isinstance(m, layers.BatchNorm):
            m.register_forward_pre_hook(hook)
    return seen


def dp_batch_norm_conditioning(model) -> list:
    """Pre-hooks on the train-mode BatchNorms that record, for each call,
    (the largest E[x^2] / (Var + eps) over its channels, its name): the
    factor by which flax's E[x^2] - E[x]^2 magnifies the relative rounding
    of the sums into the normalizing scale rsqrt(Var + eps).  Returns the
    list they fill."""
    seen = []

    def hook(name):
        def pre(mod, args):
            if mod.training:
                x = args[0].detach().float()
                dims = tuple(range(x.dim() - 1))
                m, m2 = x.mean(dim=dims), (x * x).mean(dim=dims)
                ratio = (m2 / (torch.clamp(m2 - m * m, min=0.0) + mod.eps)).max().item()
                seen.append((ratio, name))
        return pre

    for name, m in model.named_modules():
        if isinstance(m, layers.BatchNorm):
            m.register_forward_pre_hook(hook(name))
    return seen


def dp_compare(got: dict, ref: dict, grads: dict, ref_grads: dict, start: dict) -> dict:
    """One rank's step against the one-process step: the gradients' distance
    by norm, over all and the worst tensor; the parameters after the update,
    the elements beyond ``DP_PARAM_ATOL`` counted (the tensors with most of
    them named), and every element within twice the tensor's largest step.
    Tensors whose gradient is 0 but for rounding (the GAN's upsampler
    biases, ``GAN_ZERO_GRAD``, and any whose largest is 1e-5 or less) count
    only in the global distance: their update's direction is noise."""
    num = den = worst = 0.0
    worst_name = ""
    n_off = n_all = 0
    bad, offs = [], []
    for n, g in ref_grads.items():
        d, gn = (grads[n] - g).norm().item(), g.norm().item()
        num, den = num + d * d, den + gn * gn
        if g.abs().max().item() <= 1e-5 or GAN_ZERO_GRAD.fullmatch(n):  # 0 but for rounding
            continue
        if d / gn > worst:
            worst, worst_name = d / gn, n
        p, q = got[n].detach().float(), ref[n].float()
        step = (q - start[n].float()).abs().max()
        diff = (p - q).abs()
        if not bool((diff <= 2 * step + DP_PARAM_ATOL).all()):
            bad.append(f"{n} (largest {diff.max().item():.3g}, step {step.item():.3g})")
        off = int((diff > DP_PARAM_ATOL).sum())
        if off:
            offs.append((off, n, diff.numel()))
        n_off, n_all = n_off + off, n_all + diff.numel()
    return {"grad_global": math.sqrt(num / max(den, 1e-30)), "grad_worst": worst,
            "grad_worst_name": worst_name, "param_off": n_off, "param_all": n_all,
            "param_bad": bad, "param_top": sorted(offs, reverse=True)[:4]}


def dp_digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_text2vec_step(cfg, host: dict, world, dev, ref: dict = None, reps: int = 0,
                     keep: bool = False) -> dict:
    """A seeded trainer (rank 0's state on every rank), one step on this
    rank's rows of ``host``: its losses, launches, all-reduced bytes and
    state digest, against ``ref`` (the one-process step) when given; with
    ``keep`` the gradients and parameters too (a reference); then ``reps``
    more steps timed, and the gradients' all-reduce, the checked step their
    warm-up."""
    torch.manual_seed(SEED)
    trainer = Text2VecTrainer(cfg, device=dev)
    parallel.globalize_state([trainer.model], [trainer.optimizer])
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    bn_bytes = dp_batch_norm_bytes(trainer.model)
    batch = trainer.to_device(parallel.shard_batch({k: host[k] for k in DP_BATCH_KEYS}, world,
                                                   dev))
    reset_serving_counters()
    metrics = run_step(trainer, batch)
    counts = read_loop_counters()
    grads = {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None}
    out = {"losses": [metrics[k].item() for k in SCALAR_KEYS], "launches": counts,
           "grad_bytes": sum(g.numel() * g.element_size() for g in grads.values()),
           "bn_bytes": bn_bytes[0], "digest": dp_digest(trainer.model.state_dict().values())}
    if ref is not None:
        out.update(dp_compare(dict(trainer.model.named_parameters()), ref["state"], grads,
                              ref["grads"], start))
    if keep:
        out["grads"] = {n: g.clone() for n, g in grads.items()}
        out["state"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    if reps:
        flat = [g.clone() for g in grads.values()]
        out["all_reduce_ms"] = dp_host_ms(lambda: parallel.all_reduce_mean(flat), reps, dev)
        out["step_ms"] = dp_host_ms(lambda: run_step(trainer, batch), reps, dev)
    return out


def dp_gan_step(cfg, host: dict, world, dev, ref: dict = None, keep: bool = False) -> dict:
    """A seeded ``GANTrainer`` (phase 18's modules), rank 0's state on every
    rank, one step on this rank's rows: losses, state digest, spectral
    vectors' digest, against ``ref`` when given."""
    trainer = gan_trainer(cfg, dev)
    modules = (trainer.gen, trainer.mpd, trainer.msd)
    parallel.globalize_state(modules, [trainer.opt_g, trainer.opt_d])
    named = dp_gan_params(trainer)
    start = {n: p.detach().clone() for n, p in named.items()}
    metrics = trainer.step(parallel.shard_batch(host, world, dev))
    out = {"losses": [metrics[k].item() for k in GAN_KEYS],
           "digest": dp_digest([v for m in modules for v in m.state_dict().values()]),
           "spectral": dp_digest([v for m in modules for n, v in m.state_dict().items()
                                  if n.endswith(("_u", "_v"))])}
    grads = {n: p.grad for n, p in named.items() if p.grad is not None}
    if ref is not None:
        out.update(dp_compare(named, ref["state"], grads, ref["grads"], start))
    if keep:
        out["grads"] = grads
        out["state"] = {n: p.detach() for n, p in named.items()}
    return out


def dp_gan_params(trainer) -> dict:
    return {f"{m}.{n}": p for m, mod in (("gen", trainer.gen), ("mpd", trainer.mpd),
                                          ("msd", trainer.msd))
            for n, p in mod.named_parameters()}


def dp_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_host_ms(fn, reps: int, dev) -> float:
    """Median host milliseconds of ``fn()`` ended by a synchronize; the
    caller has run it once already (the warm-up)."""
    dp_sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        dp_sync(dev)
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def dp_job(stage: str, argv: list, cfg) -> dict:
    """``cli train-text2vec`` or ``train-vec2wav`` as the subcommand runs it
    (the loop's ``main(parse_args(argv))``), with ``cfg``; returns its
    losses, launches, saves, the files this rank wrote and, for Text2Vec,
    each training step's hard durations (this rank's rows)."""
    loop = text2vec_loop if stage == "t2v" else vec2wav_loop
    written, durations = [], []
    saved, snapshot, logger_cls = ckpt_module._save, loop.save_config, logging_module.TrainLogger
    forward = Text2VecTrainer.forward

    def recording_forward(trainer, batch):
        total, metrics, out = forward(trainer, batch)
        if trainer.model.training:
            durations.append(out["duration"].cpu().numpy())
        return total, metrics, out

    def recording(fn, name):
        def wrapped(*args, **kwargs):
            written.append(name(*args))
            return fn(*args, **kwargs)
        return wrapped

    ckpt_module._save = recording(saved, lambda obj, path: os.path.basename(path))
    loop.save_config = recording(snapshot, lambda c, path: os.path.basename(path))
    logging_module.TrainLogger = recording(logger_cls, lambda *a: "logger")
    Text2VecTrainer.forward = recording_forward
    reset_serving_counters()
    try:
        rec = loop.main(loop.parse_args(argv), cfg=cfg)
    finally:
        ckpt_module._save, loop.save_config, logging_module.TrainLogger = (saved, snapshot,
                                                                            logger_cls)
        Text2VecTrainer.forward = forward
    return {"steps": rec.steps, "saves": sorted(rec.saves), "written": written,
            "launches": read_loop_counters(), "seconds": rec.seconds, "durations": durations}


def dp_t2v_job_batches(cfg, rank: int, world: int) -> list:
    """Rank ``rank``'s batches of the job's first epoch, as its loop makes
    them: its share of the file list, seed 0, its local batch, padded to the
    largest bucket pair.  Runs outside a process group."""
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    cfg = dataclasses.replace(cfg, vocab_size=frontend.vocab_size)
    shard = parallel.process_shard(load_buffer(list(cfg.train_list), cfg, frontend), rank, world)
    loader = BucketedLoader(shard, cfg, seed=0, batch_size=cfg.batch_size // world,
                            pad_to_max=True)
    return [loader.batch(idx) for idx in loader.epoch_indices()]


def dp_gan_job_batches(cfg, rank: int, world: int) -> list:
    files, _ = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    ds = VocoderDataset(parallel.process_shard(files, rank, world), cfg)
    loader = VocoderLoader(ds, cfg.batch_size // world, seed=cfg.seed, num_workers=0,
                           pad_to_max=True)
    return list(loader.epoch())


def dp_concat(batches: list) -> dict:
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]
            if k not in ("audiopaths", "filenames")}


def dp_pair_rank(spec: dict) -> dict:
    """One of two ranks on one card (gloo).  Before they join the group,
    rank 0 steps the whole Text2Vec global batch alone and rank 1 the GAN's
    (the one-process references, side by side on the card).  Then phase
    42's Text2Vec and GAN steps, each held against its reference by the
    rank that holds it, and phase 43's two jobs and the resumed step."""
    t2v_cfg, gan_cfg = spec["t2v_cfg"], spec["gan_cfg"]
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    dp_flags()  # one process, no group: the references, one a rank, side by side
    dev = torch.device(spec["device"])
    ref = ({"t2v": dp_text2vec_step(t2v_cfg, spec["t2v_batch"], None, dev, keep=True)}
           if os.environ["RANK"] == "0" else
           {"gan": dp_gan_step(gan_cfg, spec["gan_batch"], None, dev, keep=True)})
    lap("start and references")
    dev = dp_setup(spec)
    check(parallel.world_size() == DP_WORLD, f"world size {parallel.world_size()}")
    out = {"rank": parallel.rank(), "seconds": seconds,
           "alone": {k: {key: v for key, v in r.items() if key not in ("grads", "state")}
                     for k, r in ref.items()}}
    world = parallel.mesh_for_batch(len(spec["t2v_batch"]["text"]), dev)
    out["t2v"] = dp_text2vec_step(t2v_cfg, spec["t2v_batch"], world, dev, ref.get("t2v"),
                                  reps=DP_STEP_REPS)
    torch.cuda.empty_cache()
    lap("Text2Vec step")
    out["gan"] = dp_gan_step(gan_cfg, spec["gan_batch"], world, dev, ref.get("gan"))
    del ref
    torch.cuda.empty_cache()
    lap("GAN step")

    job_cfg = spec["job_t2v_cfg"]
    common = ["--max_steps", str(JOB_STEPS), "--device", spec["device"],
              "--dist_backend", spec["backend"]]
    out["job_t2v"] = dp_job("t2v", ["--config", spec["job_t2v_file"]] + common, None)
    lap("Text2Vec job")
    out["job_gan"] = dp_job("v2w", ["--config", spec["job_gan_file"], "--num_workers", "0",
                                    "--stdout_interval", "1"] + common, None)
    lap("GAN job")
    # the resumed step: checkpoint JOB_RESUME_AT loaded on every rank, then the
    # uninterrupted job's next global batch
    frontend = TextFrontend.from_vocab_file(job_cfg.vocab_path)
    cfg = dataclasses.replace(job_cfg, vocab_size=frontend.vocab_size)
    trainer = Text2VecTrainer(cfg, device=dev)
    load_text2vec(os.path.join(cfg.checkpoint_path, f"checkpoint_{JOB_RESUME_AT}.pth.tar"),
                  trainer)
    parallel.globalize_state([trainer.model], [trainer.optimizer])
    loader = BucketedLoader(load_buffer(list(cfg.train_list), cfg, frontend), cfg, seed=0,
                            batch_size=parallel.local_batch_size(cfg.batch_size))
    idx = list(loader.epoch_indices())[JOB_RESUME_AT]
    metrics = run_step(trainer, trainer.to_device(loader.batch(idx)))
    out["resumed"] = [metrics[k].item() for k in SCALAR_KEYS]
    del trainer
    torch.cuda.empty_cache()
    lap("resumed step")
    if parallel.rank() == 0:
        out["single"] = dp_single(spec, dev)
        lap("world size 1")
    return out


def dp_single(spec: dict, dev) -> dict:
    """Rank 0 after the pair: a group of one (NCCL on the card), where the
    gradients' and the losses' all-reduces run, and phase 42's steps in it,
    for their digests against the same steps with no group; the Text2Vec
    step timed there, the card to itself."""
    torch.distributed.destroy_process_group()
    os.environ.update(WORLD_SIZE="1", MASTER_PORT=str(free_port()))
    got = parallel.maybe_distributed_init(spec["device"], None)
    backend = torch.distributed.get_backend()
    check(got == dev and backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"the group on {got}, backend {backend}")
    check(parallel.mesh_for_batch(len(spec["t2v_batch"]["text"]), dev) is None,
          "a world at world size 1")
    return {"backend": backend,
            "t2v": dp_text2vec_step(spec["t2v_cfg"], spec["t2v_batch"], None, dev,
                                    reps=DP_STEP_REPS),
            "gan": dp_gan_step(spec["gan_cfg"], spec["gan_batch"], None, dev)}


DP_BATCH_KEYS = ("text", "src_pos", "feat_target", "input_lengths", "output_lengths",
                 "feat_pos", "attn_prior")


def dp_job_reference(job_t2v, job_gan, dev) -> dict:
    """One process on each global batch of the two-rank jobs (the ranks'
    batches concatenated), from the state the job stepped it from: the seed
    for the first step, the job's checkpoint of the step before for a later
    one (the GAN's first file is its step 1's, so its step 1 is left out:
    None).  A Text2Vec step's losses and hard durations come from its
    forward, run twice: on the ranks' items in rank order and, a second
    witness, in the reverse order (the same losses but for the order of
    f32 sums; its durations put back in rank order).  The GAN's G losses
    follow the D update, so it steps, its noise stream advanced by one
    global draw a step."""
    frontend = TextFrontend.from_vocab_file(job_t2v.vocab_path)
    cfg = dataclasses.replace(job_t2v, vocab_size=frontend.vocab_size)
    batches = [dp_t2v_job_batches(job_t2v, r, DP_WORLD) for r in range(DP_WORLD)]
    t2v, durations, swapped, swapped_durations, bn = [], [], [], [], []
    torch.manual_seed(0)  # the loop's --seed
    trainer = Text2VecTrainer(cfg, device=dev)
    worst = dp_batch_norm_conditioning(trainer.model)
    for k in range(JOB_STEPS):
        if k:
            load_text2vec(os.path.join(cfg.checkpoint_path, f"checkpoint_{k}.pth.tar"), trainer)
        parts = [b[k] for b in batches]
        for order, losses, durs in ((parts, t2v, durations),
                                    (parts[::-1], swapped, swapped_durations)):
            worst.clear()
            _, metrics, out = trainer.forward(trainer.to_device(dp_concat(order)))
            losses.append([metrics[key].item() for key in SCALAR_KEYS])
            durs.append(out["duration"].cpu().numpy())
            if order is parts:
                bn.append(max(worst, default=(0.0, "")))
        n_last = len(parts[-1]["text"])
        swapped_durations[-1] = np.concatenate([swapped_durations[-1][n_last:],
                                                swapped_durations[-1][:n_last]])
    del trainer, out
    batches = [dp_gan_job_batches(job_gan, r, DP_WORLD) for r in range(DP_WORLD)]
    gan = []
    for k in range(JOB_STEPS):
        if k == 1:
            gan.append(None)
            continue
        torch.manual_seed(job_gan.seed)
        trainer = GANTrainer(job_gan, device=dev, seed=job_gan.seed)
        if k:
            load_vec2wav(*(os.path.join(job_gan.checkpoint_path, f"{p}_{k - 1:08d}")
                           for p in ("g", "do")), trainer)
        batch = dp_concat([b[k] for b in batches])
        for _ in range(k):
            torch.randn((len(batch["audio"]), job_gan.noise_dim), generator=trainer.noise_rng,
                        device=dev)
        metrics = trainer.step(batch)
        gan.append([metrics[key].item() for key in GAN_KEYS])
        del trainer
    torch.cuda.empty_cache()
    return {"t2v": t2v, "gan": gan, "durations": durations, "swapped": swapped,
            "swapped_durations": swapped_durations, "batch_norm": bn}


def dp_moved(got: np.ndarray, ref: np.ndarray) -> list:
    """The hard durations that differ: (item, token, got, ref) each."""
    diff = got.astype(np.int64) - ref.astype(np.int64)
    return [(int(i), int(j), int(got[i, j]), int(ref[i, j])) for i, j in np.argwhere(diff)]


def dp_rel(row: list, want: list) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(row, want))


def dp_job_t2v(ranks: list, want: dict, got_losses: list) -> list:
    """The Text2Vec job against one process on the same global batches:
    each step's hard durations (the ranks' rows in rank order) equal to one
    process's, and its losses within ``JOB_WITNESS_FACTOR`` times the
    second witness's distance (one process on the items in reverse order;
    at least ``DP_LOSS_RTOL``); printed with the worst BatchNorm's
    conditioning.  Returns each step's (distance, bound)."""
    check(all(len(d) == JOB_STEPS for d in ranks),
          f"job t2v: {[len(d) for d in ranks]} training forwards, want {JOB_STEPS}")
    out = []
    for k, ref in enumerate(want["durations"]):
        got = np.concatenate([d[k] for d in ranks])
        where = dp_moved(got, ref) if got.shape == ref.shape else [got.shape, ref.shape]
        swap = dp_moved(want["swapped_durations"][k], ref)
        err = dp_rel(got_losses[k], want["t2v"][k])
        witness = dp_rel(want["swapped"][k], want["t2v"][k])
        bound = max(DP_LOSS_RTOL, JOB_WITNESS_FACTOR * witness)
        ratio, name = want["batch_norm"][k]
        print(f"  job t2v step {k + 1}: hard durations "
              + ("equal to one process's" if not where else f"moved {where[:8]}")
              + f"; losses {err:.2e} from one process's; one process on the items in reverse "
              "order: durations " + ("equal" if not swap else f"moved {swap[:8]}")
              + f", losses {witness:.2e} (bound {bound:.2e}); the worst BatchNorm's "
              f"E[x^2]/(Var + eps) {ratio:.3g} ({name})")
        check(not where, f"job t2v step {k + 1}: hard durations differ from one process's "
              f"(item, token, job, one process): {where[:8]}")
        check(err <= bound, f"job t2v step {k + 1}: losses {got_losses[k]} vs one process "
              f"{want['t2v'][k]}: {err:.3g} past {bound:.3g}")
        out.append((err, bound))
    return out


def dp_check_step(label: str, ranks: list, want: list, per_rank: dict = None) -> None:
    check(ranks[0]["digest"] == ranks[1]["digest"], f"{label}: the ranks' states differ")
    r0 = next(r for r in ranks if "grad_global" in r)  # the rank that held the reference
    check(r0["grad_global"] <= STEP_GRAD_GLOBAL_RTOL and r0["grad_worst"] <= STEP_GRAD_RTOL,
          f"{label}: gradients {r0['grad_global']:.2e} of the norm, worst "
          f"{r0['grad_worst']:.2e} ({r0['grad_worst_name']})")
    check(not r0["param_bad"] and r0["param_off"] <= DP_PARAM_OFF * r0["param_all"],
          f"{label}: {r0['param_off']} of {r0['param_all']} parameter elements off, most in "
          f"{r0['param_top']}; past twice the step: {r0['param_bad'][:5]}")
    for r in ranks:
        err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(r["losses"], want))
        check(err <= DP_LOSS_RTOL, f"{label} rank losses {r['losses']} vs one process {want}")
        if per_rank is not None:
            check({k: r["launches"][k] for k in per_rank} == per_rank,
                  f"{label}: launches {r['launches']}, want {per_rank} a rank")
    print(f"  {label}: ranks bit-equal; losses {r0['losses']} (one process {want}; rtol "
          f"{DP_LOSS_RTOL}); gradients against one process {r0['grad_global']:.2e} of the norm, "
          f"worst tensor {r0['grad_worst']:.2e} ({r0['grad_worst_name']}); parameters after the "
          f"update: {r0['param_off']} of {r0['param_all']} beyond {DP_PARAM_ATOL} (at most "
          f"{DP_PARAM_OFF} of them; most in {r0['param_top']}), all within twice the largest "
          "step")


def data_parallel(dev, t2v_cfg=None, gan_cfg=None, shapes=None) -> dict:
    """Phases 42 and 43; returns each kernel's launches summed over the
    ranks.  ``t2v_cfg``, ``gan_cfg`` and ``shapes`` (B, N, T, GAN B, GAN T)
    default to the full-size configs and ``DP_*``."""
    t2v_cfg = dataclasses.replace(t2v_cfg or train_config(), dropout=0.0)
    gan_cfg = gan_cfg or gan_config()
    B, N, T, GB, GT = shapes or (TRAIN_B, TRAIN_N, TRAIN_T, DP_GAN_B, DP_GAN_T)
    t2v_batch = synthetic_batch(t2v_cfg, B, N, T, SEED)
    gb = gan_batch(gan_cfg, GB, GT, SEED)
    backend = "gloo"
    counts: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        job_t2v = dataclasses.replace(t2v_demo_config(os.path.join(tmp, "job_t2v")),
                                      dropout=0.0, save_step=1)
        job_gan = dataclasses.replace(gan_config(), run_path=os.path.join(tmp, "job_gan"),
                                      save_step=1)
        files = {}
        for name, cfg in (("t2v", job_t2v), ("gan", job_gan)):
            files[name] = os.path.join(tmp, f"{name}.json")
            save_config(cfg, files[name])
        spec = dict(device=str(torch.device(dev.type, 0)) if dev.type == "cuda" else "cpu",
                    backend=backend, t2v_cfg=t2v_cfg, gan_cfg=gan_cfg, t2v_batch=t2v_batch,
                    gan_batch=gb, job_t2v_cfg=job_t2v, job_t2v_file=files["t2v"],
                    job_gan_file=files["gan"])
        t0 = time.perf_counter()
        ranks = run_local(dp_pair_rank, DP_WORLD, (spec,), timeout=DP_TIMEOUT)
        print(f"phase 42: {DP_WORLD} ranks on {spec['device']} over {backend} ran phases 42-43 "
              f"in {time.perf_counter() - t0:.1f} s; the rank seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items()))
        alone = {**ranks[0]["alone"], **ranks[1]["alone"]}
        want = {k: v["losses"] for k, v in alone.items()}
        dp_check_step(f"Text2Vec step, global B = {B} at {N} x {T}, {B // DP_WORLD} a rank",
                      [r["t2v"] for r in ranks], want["t2v"],
                      {"mas": 1, "gru_bwd": 1, "fused_resblock": 0, "gru_fwd": 0,
                       "gru_fwd_f32": 0, GRU_KERNELS[numerics(t2v_cfg, B // DP_WORLD)][0]: 1}
                      if dev.type == "cuda" else None)  # the CPU launches no kernel
        dp_check_step(f"GAN step, global B = {GB} x {GT} frames, {GB // DP_WORLD} a rank",
                      [r["gan"] for r in ranks], want["gan"])
        check(ranks[0]["gan"]["spectral"] == ranks[1]["gan"]["spectral"],
              "the ranks' spectral vectors differ")
        for r in ranks:
            add_counts(counts, r["t2v"]["launches"])
        r0 = ranks[0]["t2v"]
        print(f"  all-reduced a Text2Vec step: {r0['grad_bytes'] / 2**20:.2f} MiB of gradients "
              f"in buckets of {parallel.mesh.BUCKET_BYTES // 2**20} MiB, "
              f"{r0['bn_bytes'] / 2**10:.1f} KiB of BatchNorm statistics (forward and "
              f"backward), 24 B of losses and the binarization count; the gradients' "
              f"all-reduce {r0['all_reduce_ms']:.2f} ms (gloo, two ranks sharing one card)")

        single = ranks[0]["single"]
        for k in ("t2v", "gan"):
            check(alone[k]["digest"] == single[k]["digest"]
                  and alone[k]["losses"] == single[k]["losses"],
                  f"{k}: the {single['backend']} group at world size 1 is not bit-equal to no "
                  "group")
        print(f"  {single['backend']} at world size 1 (rank 0, after the pair): the Text2Vec and "
              "GAN steps bit-equal to the same steps with no process group (losses and every "
              f"state entry); the gradients' all-reduce {single['t2v']['all_reduce_ms']:.2f} ms")
        print(f"  Text2Vec step ms, global B = {B}: {r0['step_ms']:.2f} at world size 2 (two ranks "
              f"sharing one card over gloo, {B // DP_WORLD} items each: not a scaling figure) "
              f"against {single['t2v']['step_ms']:.2f} at world size 1 (one process, {B} items, "
              f"in the group of one); {card_line()}")

        # phase 43: the two jobs, against one process from their own files
        jobs_want = dp_job_reference(job_t2v, job_gan, dev)
        for stage, keys, first in (("t2v", SCALAR_KEYS, 1), ("gan", GAN_KEYS, 0)):
            jobs = [r[f"job_{stage}"] for r in ranks]
            got = [[[j["steps"][first + k][key] for key in keys] for k in range(JOB_STEPS)]
                   for j in jobs]
            check(got[0] == got[1], f"job {stage}: the ranks' losses differ {got}")
            if stage == "t2v":
                errs, tols = zip(*dp_job_t2v([j["durations"] for j in jobs], jobs_want, got[0]))
            else:
                errs = [dp_rel(row, wrow) for row, wrow in zip(got[0], jobs_want[stage])
                        if wrow is not None]
                tols = [DP_LOSS_RTOL] * len(errs)
                check(all(e <= t for e, t in zip(errs, tols)),
                      f"job {stage}: {got[0]} vs one process {jobs_want[stage]}: {errs}")
            check(jobs[1]["written"] == [] and "config.json" in jobs[0]["written"]
                  and "logger" in jobs[0]["written"], f"job {stage}: files written "
                  f"{[j['written'] for j in jobs]}")
            check(jobs[0]["saves"] == jobs[1]["saves"] and jobs[0]["saves"],
                  f"job {stage}: saves {[j['saves'] for j in jobs]}")
            for j in jobs:
                add_counts(counts, j["launches"])
            print(f"  job {stage} ({JOB_STEPS} steps, 2 ranks): losses {got[0]}; one process "
                  f"{jobs_want[stage]} (max rel a step {[f'{e:.2e}' for e in errs]}, bounds "
                  f"{[f'{t:.2e}' for t in tols]}); rank 0 wrote "
                  f"{sorted(set(jobs[0]['written']))}, rank 1 nothing; saves at "
                  f"{jobs[0]['saves']}; launches {[j['launches'] for j in jobs]}")
        resumed = [r["resumed"] for r in ranks]
        uninterrupted = [ranks[0]["job_t2v"]["steps"][JOB_RESUME_AT + 1][k] for k in SCALAR_KEYS]
        err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(resumed[0], uninterrupted))
        check(resumed[0] == resumed[1] and err <= RESUME_LOSS_RTOL,
              f"resumed step {resumed} vs uninterrupted {uninterrupted}")
        print(f"  resumed from checkpoint_{JOB_RESUME_AT} on both ranks: step "
              f"{JOB_RESUME_AT + 1}'s losses {resumed[0]}, uninterrupted {uninterrupted} "
              f"({'bit-equal' if resumed[0] == uninterrupted else f'max rel {err:.2e}'})")
    return counts


def benches(dev, t2v_cfg=None, v2w_cfg=None, long_cfg=None, shapes=None) -> dict:
    """Phase 44: the three benches; returns each kernel's launches over them."""
    from wavthruvec_pytorch_tpu_torch.infer import rtf_bench, serve_bench, train_bench

    B, T, LB, LN, LT, batches = shapes or (TRAIN_B, TRAIN_T, LONG_B, LONG_N, LONG_T, (1, 8))
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    reset_serving_counters()
    torch.backends.cudnn.deterministic = True  # the remat pairs, bit for bit
    rows = [train_bench.run("t2v", B=B, T=T, remat=rm, t2v_cfg=t2v_cfg, device=dev,
                            iters=BENCH_ITERS)[0] for rm in (False, True)]
    long_rows = [train_bench.bench_t2v(B=LB, N=LN, T=LT, dtype="bfloat16", remat=rm, flash=True,
                                       dropout=0.0, cfg=long_cfg or long_config(), device=dev,
                                       iters=LONG_BENCH_ITERS) for rm in (False, True)]
    torch.backends.cudnn.deterministic = False
    for label, pair in (("f32", rows), ("long bf16 flash", long_rows)):
        if pair is long_rows:
            print("\n".join(json.dumps(r) for r in pair))
        err = max(abs(pair[1][k] - pair[0][k]) / abs(pair[0][k])
                  for k in ("first_total_loss", "last_total_loss", "last_grad_norm"))
        check(err <= REMAT_RTOL, f"train_bench {label}: remat moved the losses or the "
              f"gradients' norm by {err:.3g} (rtol {REMAT_RTOL}): {pair}")
        check(dev.type != "cuda" or pair[1]["peak_mem_gib"] < pair[0]["peak_mem_gib"],
              f"train_bench {label}: remat did not lower the peak memory: {pair}")
        print(f"  train_bench {label} B = {pair[0]['batch']} x {pair[0]['frame_pad']}: peak "
              f"memory {pair[0]['peak_mem_gib']} GiB without remat, {pair[1]['peak_mem_gib']} "
              f"GiB with it; {pair[0]['sec_per_step'] * 1e3:.2f} against "
              f"{pair[1]['sec_per_step'] * 1e3:.2f} ms a step; after the updates the last loss "
              f"{pair[0]['last_total_loss']!r} against {pair[1]['last_total_loss']!r}, its "
              f"gradients' norm {pair[0]['last_grad_norm']!r} against "
              f"{pair[1]['last_grad_norm']!r} (max rel {err:.3g}, rtol {REMAT_RTOL})")
    gan_row = train_bench.bench_v2w(cfg=v2w_cfg, device=dev, iters=BENCH_ITERS)
    print(json.dumps(gan_row))
    rtf = rtf_bench.run((1, 4), iters=BENCH_ITERS, t2v_cfg=t2v_cfg, v2w_cfg=v2w_cfg, device=dev)
    serve_out = serve_bench.run(list(batches), iters=BENCH_ITERS, t2v_cfg=t2v_cfg,
                                v2w_cfg=v2w_cfg, device=dev)
    counts = read_loop_counters()
    for row in rows + long_rows + [gan_row] + rtf + serve_out["batches"]:
        check(row["device"] == name, f"bench row without the card's name: {row}")
        check(all(math.isfinite(v) for v in row.values() if isinstance(v, float)),
              f"bench row not finite: {row}")
    print(f"  the benches' launches {counts}; {card_line()}")
    return counts


# ---------------------------------------------------------------------------
# The JAX package's orbax checkpoints (phase 49)
# ---------------------------------------------------------------------------

ORBAX_FIXTURES = repo_path("tests", "fixtures", "jax_orbax")
ORBAX_DIRS = ("checkpoint_1", "t2v_variables", "gen_variables")
ORBAX_LATENT_ATOL = 1e-4   # tests/test_torch_checkpoint.py's latent tolerance
ORBAX_WAV_ATOL = 2e-4      # ROADMAP.md's Generator tolerance
# the port's step-parity tolerance (tests/test_torch_train.py
# test_step_running_stats_and_update): parameters within STEP_PARITY_ATOL of
# JAX's in all but STEP_PARITY_SHARE of their elements, those within twice
# the tensor's largest step; running statistics within STEP_PARITY_ATOL
STEP_PARITY_ATOL, STEP_PARITY_SHARE = 1e-5, 1e-3
JAX_MODULES = ("jax", "jaxlib", "flax", "orbax", "tensorstore", "ml_dtypes", "zstandard",
               "wavthruvec_pytorch_tpu")


def orbax_checkpoints(dev) -> dict:
    """Phase 49: the launches of the served request and of the resumed
    step, by kernel."""
    t2v_cfg = load_config(Text2VecConfig, os.path.join(ORBAX_FIXTURES, "text2vec.json"))
    v2w_cfg = load_config(Vec2WavConfig, os.path.join(ORBAX_FIXTURES, "vec2wav.json"))
    want = np.load(os.path.join(ORBAX_FIXTURES, "expected.npz"))
    for name in ORBAX_DIRS:
        stats = {}
        ckpt_module.restore_checkpoint(os.path.join(ORBAX_FIXTURES, name), stats)
        print(f"phase 49: read {name}: {stats['bytes']} chunk bytes in {stats['seconds']:.4f} s, "
              f"{stats['bytes'] / stats['seconds'] / 1e6:.3f} MB/s (this host's CPU)")

    t2v_state, gen_state = init_import_models(
        t2v_cfg, v2w_cfg, t2v_checkpoint=os.path.join(ORBAX_FIXTURES, "t2v_variables"),
        gen_checkpoint=os.path.join(ORBAX_FIXTURES, "gen_variables"))
    gen, gen_state = make_serving_generator(v2w_cfg, gen_state, "f32", device=dev)
    synth = Synthesizer(t2v_cfg, v2w_cfg, t2v_state, gen_state,
                        TextFrontend.from_vocab_file(repo_path("data", "demo", "vocab.txt")),
                        device=dev, gen=gen)
    reset_serving_counters()
    with torch.inference_mode():
        lat = synth.text_to_latents([str(want["text"])], want["ref"],
                                    max_frames=t2v_cfg.frame_buckets[-1])
        wav = synth.latents_to_wav(lat["feat_postnet_output"], want["spk"], noise=want["noise"])
    torch.cuda.synchronize()
    served = read_serving_counters()
    frames = int(want["total_frames"][0])
    n = frames * v2w_cfg.total_upsample
    check(np.array_equal(lat["total_frames"], want["total_frames"]),
          f"orbax serving: {lat['total_frames']} frames, JAX {want['total_frames']}")
    lat_err = float(np.abs(lat["feat_postnet_output"][:, :frames] - want["latents"]).max())
    wav_err = float(np.abs(wav[:, :n] - want["wav"]).max())
    check(lat_err <= ORBAX_LATENT_ATOL, f"orbax serving: latents {lat_err:.3g} from JAX's")
    check(wav_err <= ORBAX_WAV_ATOL, f"orbax serving: waveform {wav_err:.3g} from JAX's")
    for name in ("fused_resblock", "gru_fwd_f32", "flash_fwd"):
        check(served[name] > 0, f"orbax serving launched no {name}")
    check(served["gru_fwd"] == 0, "orbax serving launched the bf16 BiGRU")
    print(f"phase 49: served from the JAX variables: {int(want['total_frames'][0])} frames, "
          f"latents {lat_err:.3g} (atol {ORBAX_LATENT_ATOL}), wav {wav_err:.3g} "
          f"(atol {ORBAX_WAV_ATOL}) from the JAX package's; launches {served}")
    del synth, gen

    trainer = Text2VecTrainer(t2v_cfg, device=dev)
    load_text2vec(os.path.join(ORBAX_FIXTURES, "checkpoint_1"), trainer)
    check(trainer.step_count == int(want["step"]) and
          abs(trainer.learning_rate - float(want["lr"])) <= 1e-9,
          f"orbax resume: step {trainer.step_count}, lr {trainer.learning_rate}")
    start = {k: p.detach().cpu().clone() for k, p in trainer.model.named_parameters()}
    batch = {k[len("step_"):]: want[k] for k in want.files if k.startswith("step_")}
    reset_counters()
    trainer.step(batch)
    torch.cuda.synchronize()
    step_counts = read_counters()
    for name in ("gru_bwd", "mas", "flash_bwd_dkv", "flash_bwd_dq"):
        check(step_counts[name] > 0, f"orbax resumed step launched no {name}")
    buffers = {k: b.cpu() for k, b in trainer.model.named_buffers()}
    params = {k: p.detach().cpu() for k, p in trainer.model.named_parameters()}
    n_off = n_all = n_stats = 0
    worst_stat = 0.0
    for key in want.files:
        if not key.startswith("next/"):
            continue
        name, ref = key[len("next/"):], want[key]
        if name.endswith(("running_mean", "running_var")):
            worst_stat = max(worst_stat, float(np.abs(buffers[name].numpy() - ref).max()))
            n_stats += 1
        elif name in params:
            diff = np.abs(params[name].numpy() - ref)
            step = np.abs(ref - start[name].numpy())
            off = diff > STEP_PARITY_ATOL
            check(bool((diff[off] <= 2 * step.max() + STEP_PARITY_ATOL).all()),
                  f"orbax resumed step: {name} past twice its largest step from JAX's")
            n_off, n_all = n_off + int(off.sum()), n_all + diff.size
    check(n_stats > 0 and n_all > 0 and worst_stat <= STEP_PARITY_ATOL,
          f"orbax resumed step: running statistics {worst_stat:.3g} from JAX's")
    check(n_off <= STEP_PARITY_SHARE * n_all,
          f"orbax resumed step: {n_off} of {n_all} elements past {STEP_PARITY_ATOL}")
    print(f"phase 49: one step resumed from the JAX T2VTrainState: {n_off} of {n_all} parameter "
          f"elements beyond {STEP_PARITY_ATOL} of the JAX package's next step (at most "
          f"{STEP_PARITY_SHARE:.1%} allowed), {n_stats} running statistics within "
          f"{worst_stat:.3g}; launches {step_counts}")
    loaded = [m for m in sys.modules if m.split(".")[0] in JAX_MODULES]
    check(not loaded, f"phase 49 imported {loaded}")
    counts = dict(served)
    for name, value in step_counts.items():
        counts[name] = counts.get(name, 0) + value
    return counts


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
    del syn

    trainer, batch, train_launches = train(dev)
    mas = check_mas()
    gru_bwd_row = check_gru_backward(trainer.model.postnet.gru)
    check_step_against_cpu(trainer.cfg)
    profile_step(trainer, batch)
    del trainer, batch

    flash = check_flash()
    trainer, host, batch, long_launches = train_long(dev)
    profile_step(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    dense_long_step(dev, host)
    torch.cuda.empty_cache()
    check_flash_step_against_cpu()
    with torch.inference_mode():
        serve_long(dev)
    torch.cuda.empty_cache()
    trainer, batch, _ = train_long_f32(dev)
    profile_step(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()

    train_gan(dev)
    gan_check = check_gan_step_against_cpu()
    train_gan_loop()
    torch.cuda.empty_cache()

    serving = serving_stack(dev)
    torch.cuda.empty_cache()
    loop = training_jobs(dev)
    torch.cuda.empty_cache()
    data = data_and_gan_modes(dev, gan_check)
    torch.cuda.empty_cache()
    tools = data_tools(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par = data_parallel(dev)
    print(f"phases 42-43: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = benches(dev)
    print(f"phase 44: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    wide = check_flash_wide()
    torch.cuda.empty_cache()
    check_flash_step_against_cpu(one_head_config())
    trainer, _, _, wide_launches = train_long(dev, one_head_config())
    del trainer
    torch.cuda.empty_cache()
    with torch.inference_mode():
        serve_long(dev, one_head_config())
    torch.cuda.empty_cache()
    profile_t2v_loop(dev)
    print(f"phases 45-48: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    orbax = orbax_checkpoints(dev)
    print(f"phase 49: {time.perf_counter() - t0:.1f} s")

    kernels = [
        dict(name="fused_resblock", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/fused_resblock.cu",
             replaces="wavthruvec_pytorch_tpu/ops/fused_resblock.py:29",
             launches=launches["fused_resblock"],
             serving_launches=serving["fused_resblock"], **fused),
        dict(name="gru_fwd", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/gru_fwd.cu",
             replaces="wavthruvec_pytorch_tpu/ops/gru_pallas.py:41",
             launches=launches["gru_fwd"], serving_launches=serving["gru_fwd"],
             **gru["gru_fwd"]),
        dict(name="gru_fwd_f32", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/gru_fwd.cu",
             replaces="wavthruvec_pytorch_tpu/models/layers.py:776",
             launches=launches["gru_fwd_f32"], serving_launches=serving["gru_fwd_f32"],
             **gru["gru_fwd_f32"]),
        dict(name="gru_bwd", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/gru_bwd.cu",
             replaces="wavthruvec_pytorch_tpu/models/layers.py:829",
             launches=train_launches["gru_bwd"], **gru_bwd_row),
        dict(name="mas", route="cuda",
             source="wavthruvec_pytorch_tpu_torch/csrc/mas.cu",
             replaces="wavthruvec_pytorch_tpu/ops/mas_pallas.py:30",
             launches=train_launches["mas"], **mas),
    ]
    flash_src = "jax/experimental/pallas/ops/tpu/flash_attention.py"  # jax 0.9.0
    for name, line in (("flash_fwd", 589), ("flash_bwd_dkv", 941), ("flash_bwd_dq", 1287)):
        kernels.append(dict(name=name, route="cuda",
                            source="wavthruvec_pytorch_tpu_torch/csrc/flash_attn.cu",
                            replaces=f"{flash_src}:{line}", launches=long_launches[name],
                            **flash[name]))
    next(k for k in kernels if k["name"] == "flash_fwd")["serving_launches"] = serving["flash_fwd"]
    for name, line in (("flash_fwd_wide", 589), ("flash_bwd_dkv_wide", 941),
                       ("flash_bwd_dq_wide", 1287)):
        kernels.append(dict(name=name, route="cuda",
                            source="wavthruvec_pytorch_tpu_torch/csrc/flash_attn.cu",
                            replaces=f"{flash_src}:{line}", launches=wide_launches[name],
                            **wide[name]))
    for kern in kernels:
        kern["loop_launches"] = loop.get(kern["name"], 0)
        kern["data_launches"] = data.get(kern["name"], 0)
        kern["tools_launches"] = tools.get(kern["name"], 0)
        kern["parallel_launches"] = par.get(kern["name"], 0)
        kern["bench_launches"] = bench.get(kern["name"], 0)
        kern["orbax_launches"] = orbax.get(kern["name"], 0)
    for kern in kernels:
        keys = ("ms", "plain_ms", "bound_ms") + (("f32_ms", "f32_plain_ms", "f32_bound_ms",
                                                   "f32_sdpa_bwd_ms")
                                                  if kern["name"].startswith("flash_bwd") else ())
        if kern["name"] in ("flash_bwd_dkv_wide", "flash_bwd_dq_wide"):
            keys += ("f32_train_ms", "f32_train_kernel_ms", "f32_train_plain_ms",
                     "f32_train_bound_ms", "f32_train_sdpa_bwd_ms")
        if kern["name"] == "flash_fwd_wide":
            keys += ("f32_ms", "f32_plain_ms", "f32_bound_ms", "f32_library_ms")
        check(all(math.isfinite(kern[key]) for key in keys), f"{kern['name']}: non-finite time")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
