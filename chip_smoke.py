#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line, in this order:

1. device: the card, its power limit, the fp32 matmul flags (full fp32,
   no TF32) the parity checks need, and cuDNN's flags as found; the
   conv nets' forward and gradients on the card within 1e-5 of the CPU
   under those flags (the port's convolutions run in fp32 with
   deterministic algorithms whatever the global flags say); a short
   trace's device rows read through ``device_rows`` equal to
   ``key_averages``' (every later profile is read the first way);
2. build: the CUDA kernels (``nvcc``, sm_90a, one process per source:
   ``online_sgd`` (with ``online_sgd_momentum``), ``dfa_epoch_int8``,
   ``meta_update``, ``ssd_scan``, ``flash_decode``, ``client_mean``) are
   built from this checkout's sources, all at the same time, beside
   phase 1;
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors, at the shapes the main paths give it and at harder
   ones, timed with CUDA events (median of repeats) and the profiler
   beside its bound and the one PyTorch call that computes the same
   function, where there is one (host-paced and on the device);
   ``online_sgd`` bit for bit at the quickstart's (1, 1153), the serving
   (64, 1153) and flat 2^24 in fp32 and bf16; ``online_sgd_momentum``
   bit for bit at 1,153, (64, 1153) and flat 2^24 in fp32 and bf16,
   beside ``torch._fused_sgd_``; ``dfa_epoch_int8`` exact
   (the loss within 1e-6) at the serving shape for each layer and mixed,
   the S = 512 rails, dims (5, 16, 12, 3) and the round engine's TIFeD
   epoch (B = 64, S = 32, the sine MLP), the last and the serving shape
   also through the generic instantiation, timed beside it; ``ssd_scan``
   at the JAX package's test shapes, the LM path's and a 16-chunk
   sequence (its bound at the tensor cores' TF32 rate, three products
   for each fp32 one), at the last two also its three kernels, each
   against its plain phase, and its third at every heads-a-block
   setting; ``online_sgd`` and ``meta_update`` also at mamba2-130m's
   two flat buffers, and bit for bit at the conv nets' phi (20,612 and
   112,709) and KWS Reptile c4's (4, 20,612) cohort; ``meta_update`` (one
   fused multiply-add, as the JAX engine's jitted interpolation) bit for
   bit at every size it runs: 1,153, the LM's two buffers, 2^24 in fp32
   and bf16 and the conv nets';
   ``flash_decode`` at the JAX package's 24 test cases, at the decode
   path's shape (tinyllama at batch 8 and cache 2048, bf16) at L = 1, 64,
   128, 320, 577, 640 and 2048 and with a window, with their mean over
   the L = 1 ... 640 of a decode wave (``path_run_mean``), and at the
   32k fp32 shape of ``benchmarks/kernels_bench.py``, beside
   ``scaled_dot_product_attention``, within 3e-4 (fp32) or 2e-2 (bf16)
   relative and that times min(1, max |want|) absolute; at the path and
   32k shapes also the device-L route (L an int32 on the card, as the
   decode graph launches it), bit-equal to the host-int call, with its
   own ``path_run_mean_devL``; ``client_mean`` (the weighted client mean
   in the jitted JAX engine's order) bit for bit at C = 1, 4, 8, 32, 33,
   64 over 1,153, 20,612 and 2^20 parameters, beside torch.sum(w q, 0),
   on the device at the engine's (8, 1,153), (64, 1,153) and (4,
   20,612); ``online_sgd`` and ``meta_update`` bit for bit at
   tinyllama-1.1b's flat bf16 buffer (1,100,048,384), beside torch.add
   and torch.lerp;
4. serve decode reduced: ``serve --mode decode --arch tinyllama-1.1b
   --reduced`` (4 requests, batch 2, 16 + 16 tokens, cache 64) on the
   card and on the CPU from the same init: every step's logits within
   1e-4, the same tokens, 128 ``flash_decode`` launches and no other;
   the step built once (``decode_build``: trace_count 1, capture seconds,
   graph nodes) and replayed;
5. serve decode tinyllama-1.1b: full width and depth, bf16, random
   weights from seed 0, 8 requests at batch 8 (one wave), 512 + 128
   tokens, cache 2048, the step built once and replayed 640 times:
   finite logits, 14,080 ``flash_decode`` launches, tokens/s, step time
   and peak memory; then the same weights in fp32, 16 teacher-forced steps at
   batch 2 on the card and on the CPU (within 1e-3 of the largest
   logit), and the bf16 choices held near the fp32 maximum;
6. profile decode: 16 replays of the full-width decode step under
   torch.profiler: idle share, kernels per step, top kernels,
   ``flash_decode``'s share; then a 64 + 32-token wave of tinyllama-1.1b
   replayed against the same step run eagerly (for phase 20); then
   ``prefill_dense_full``: ``prefill_fn`` of the same weights at 8 x 512
   against the teacher-forced decode logits at position 511, within 4
   bf16 steps of the largest; ``joint_step_full``: three
   ``make_joint_train_step`` steps of the same weights (AdamW, cosine(3e-5,
   3, warmup=1)) on one batch of 8 x 2,048, the loss falling, peak
   memory; ``decode_mamba2_130m``: ``serve --mode decode --arch
   mamba2-130m`` at phase 5's traffic (8 requests at batch 8, 512 + 128
   tokens), the step built once and replayed, no kernel launched,
   tokens/s and step time, a 64 + 32-token wave replayed bit-equal to
   eager, and the decode logits at positions 0, 63 and 511 against
   ``prefill_fn`` (the ``ssd_scan`` route): in fp32 (the weights cast)
   within 1e-3 of the largest logit, in bf16 reported;
7. serve fp32: 512 requests through ``AdaptationServer`` with the
   ``serve --mode adapt`` defaults, launch counters set to 0 just before
   and read just after, the tick built (captured) once; 32 requests held
   against the port on the CPU;
8. serve TIFeD: the same through the int8 route (support 8, k_max 6);
   adapted weights exact against the CPU;
9. profile: device busy share of one fp32 drain (torch.profiler);
10. train TinyReptile: the quickstart's 600-round run, launch counters
    set to 0 just before and read just after, the round built (captured)
    once, checked against the random init; a 60-round run of the same
    configuration against the port on the CPU;
11. train Reptile: the train launcher's ``--strategy reptile`` defaults
    (64 clients, 20 rounds), in-process, against the CPU;
12. train baselines: FedAvg, FedSGD and Transfer at the launcher
    defaults, and TinyReptile with 8 straggling clients, against the CPU;
    each train run's round built once, with its capture time and graph
    size;
13. profile train: device busy share of 60 TinyReptile rounds;
13b. client_mean queue C: ROADMAP queue C's TIFeD launcher case
    (``--strategy tifed --rounds 6 --clients 4 --pool-size 30
    --availability markov --buffer-size 4``) on the card and on the
    CPU: params and pool state exact, six ``client_mean`` launches a
    round;
14. fleet tifed: the train launcher's ``--strategy tifed`` defaults (64
    clients, support 32, 8 integer epochs, 20 rounds) on the card and on
    the CPU: the integer params and bytes exact, the int8 loss within
    1e-6, one build, 160 ``dfa_epoch_int8`` launches (one an epoch for
    the whole cohort, the kernel's S = 32 instantiation), rounds/s;
15. fleet partial: TinyReptile at 64 clients on
    ``PartialCommChannel(0.25)``, the mask fixed and rotating, 200
    rounds each (bills exact), the first 60 against the CPU (1e-4);
16. fleet pool: the sine MLP's TinyReptile over a persistent
    ``ClientPool`` of 100,000 devices (vectorized sampler), a cohort of
    64 under ``DiurnalAvailability(24)`` with
    ``BufferedAggregation(16, flush_staleness=8)``, 500 rounds (the pool
    state equal to a host replay of the plan, the first 20 rounds
    against the CPU), then 1,000,000 devices with their state in host
    slabs for 50 rounds against the CPU (pool state exact, 1e-4); one
    build each, launches as reckoned (the flush's ``meta_update`` and
    ``client_mean`` every round); ``profile_fleet``: 20 replayed pooled
    rounds under the profiler (idle share, kernels a round, top
    kernels); ``fleet_pool_drift`` (reported): how far one ulp added to
    every init weight moves each run on the card, at 20, 34, 50 and 60
    rounds of the 100,000 devices and 50 of the 1,000,000, and the card
    against the CPU at each length of the 100,000;
17. fleet kws: the port's KWS example with its persistent fleet
    (``--pool-size 1000 --availability markov --buffer-size 4``, 200
    rounds) on the card and on the CPU: accuracy within one query
    sample, the pool state and bills exact;
18. paper models: Table I (params, fp32 size), Table II
    (``algorithm_memory_report`` at S = 32, equal to the JAX package's)
    and Tables III-IV (one client's TinyReptile against Reptile update
    at S = 32, eager and built once) for the three paper models;
19. fig4 conv: Fig. 4 on Omniglot 5-way and KWS 4-way (TinyReptile and
    serial Reptile 120 rounds, Reptile at 4 clients 30), rounds/s,
    accuracy after adaptation beside the random init's and chance, each
    round built once, launches exact; KWS TinyReptile above 0.35 at the
    JAX package's test setting; each net on the card against the CPU
    (1e-4); a profile of 20 replayed Omniglot TinyReptile rounds;
20. graphs vs eager: the captured round (TinyReptile, Reptile and FedAvg
    at 8 clients, the int8 wire, the pooled and buffered sine round,
    TIFeD at 64 clients, Omniglot TinyReptile, KWS Reptile at 4
    clients), tick (fp32, TIFeD) and decode step (phase 6's wave: every
    step's logits and the tokens) against the same round, tick and step
    run eagerly on the card, bit for bit, launch counts equal;
21. train LM reduced: the LM launcher (``--arch mamba2 --reduced``) on
    the card and on the CPU from the same init, rows and params within
    1e-4, ``comm_mb`` exact, launches as reckoned;
22. train LM mamba2-130m: full width and depth, bf16, ``--rounds 6
    --batch 8 --seq 2048 --k-inner 4``: finite losses, the client adapts
    (mean last inner loss below the first), launches as reckoned,
    rounds/s, tokens/s and peak device memory;
23. profile LM: one full-width round under torch.profiler: idle share,
    top kernels, the shares of ``ssd_scan`` (its three kernels) and of
    its plain backward; then the dense LM: ``train_dense_reduced`` (the
    reduced tinyllama and starcoder2, window 64 at 256 tokens, on the
    card against the CPU: rows and params within 1e-4) and
    ``train_dense_tinyllama_1_1b`` (``--arch tinyllama-1.1b --rounds 4
    --batch 8 --seq 2048 --k-inner 4 --beta 0.002``, full width and
    depth, bf16: 16
    ``online_sgd`` and 4 ``meta_update`` launches, finite losses, the
    client adapts in at least 3 rounds of 4, rounds/s, tokens/s, peak
    memory, and one more round under the profiler: device time, idle
    share);
24. ckpt resume (after phase 17): crash and resume on the card, snapshots
    every 4 rounds, for TinyReptile at 64 clients (16 rounds), TIFeD at
    the launcher's defaults (alpha 1 annealed, 16 rounds), the pooled
    fleet (100,000 devices, diurnal check-ins, FedBuff(16, deadline 8),
    40 rounds) on the card and in host slabs under Markov check-ins:
    each run crashed right after its round-4 snapshot and resumed equals
    the uninterrupted one exactly (params, history, bills, pool state),
    each config's round built once across all three; the async writer's
    files equal a synchronous run's; a run resumed past its horizon (16
    -> 24) equals a 24-round run;
25. ckpt sigkill: a child process runs the TinyReptile case with the
    async writer and is SIGKILLed after its first durable snapshot; its
    resume here equals the uninterrupted card run exactly;
26. ckpt overhead: the quickstart's 600 rounds without and with a
    snapshot every 10 rounds, timed in turns: rounds/s of each, their
    ratio (the JAX package's target is under 5%; reported, not gated),
    and a snapshot's milliseconds on the training and writer threads.
27. engine LM reduced (run right after the kernels, before phase 4):
    the train launcher's engine LM route, ``--strategy
    reptile|fedavg|fedsgd|transfer --arch mamba2`` and ``--strategy
    reptile --arch transformer`` at ``--clients 8 --rounds 6`` (the
    launcher's ``--batch 8 --seq 64``), and a pooled run (1,000
    vectorized devices, diurnal check-ins, ``--buffer-size 4``), each on
    the card from a seeded init: launches as reckoned, bills exact, each
    round built once (trace_count, capture seconds, graph nodes); each
    run's first round on the card against the same round on the CPU:
    params and query loss within 1e-4, bills and the pool state exact;
    TinyReptile through ``run_federated`` at the same size, held the
    same way;
    a Reptile run crashed right after its round-3 snapshot of 6 and
    resumed, equal to the uninterrupted card run exactly, one build
    across the three runs; then ``--strategy reptile --arch mamba2`` at
    32 clients (cut from the launcher's 64 for the script's time) x 20
    rounds on the card alone:
    rounds/s, tokens/s, graph size, the query loss below the init's;
28. engine LM mamba2-130m: full width in fp32 at 16 of its 24 layers
    (FULL_LM_RUN_LAYERS; the one-step gradient checks below keep all 24
    and the 128,983,488 parameters), ``ReptileStrategy(epochs=8)`` at a
    cohort of 8 (not the launcher's 64: one (C, P) fp32 buffer is 33.0
    GB at 64), 8 x 64 tokens a client, 2 rounds (depth and rounds cut
    for the script's time) at beta 0.002, one eval: each round's inner
    loss by epoch (read from the captured round's own outputs) falling,
    the query loss below the init's; one inner SGD step at cohort 2 and
    support 2 against the CPU: the engine's cohort gradient leaf by leaf
    within a share of each leaf's largest entry (FULL_LM_GRAD_TOL: 1e-4
    at the widths cut to 2 layers, 5e-3 at the 24), the losses within
    1e-5, the worst leaves named;
    rounds/s, tokens/s, peak memory, graph size; one replayed round
    under the profiler (idle share, top kernels, ``ssd_scan``'s share)
    and one eager epoch's plain ``ssd_chunked`` backward share;
29. examples: ``repro_torch.examples.llm_meta_training`` on
    tinyllama-1.1b and mamba2-130m reduced (30 rounds, its asserts, 8
    greedy tokens through ``DecodeRunner``) and
    ``repro_torch.examples.quickstart`` at its 600 rounds, their printed
    lines in the row. The kernels phase also holds ``ssd_scan`` at the
    engine's two shapes, ``online_sgd`` at the full-width cohort (8,
    128,983,488) fp32 and ``meta_update`` at its phi.

30. families reduced (after phase 23): the decoder-only families of
    slice 15 at their reduced widths (FAMILY_REDUCED: mixtral at 2 and 4
    layers, maverick at 4 with its dense and MoE blocks alternating,
    zamba2 at 5, glm4, minicpm), each from one seeded init on the card
    against the CPU: the loss and every gradient leaf (1e-4; 4e-4 with
    Mamba2 layers), the routing alike, one decode wave (1e-3 of the
    largest logit, the same tokens) replayed bit-equal to eager; then
    ``--strategy reptile --arch moe`` at ``--clients 8 --rounds 6``, its
    first round within 1e-4 of the CPU, its round built once;
31. families decode: mixtral-8x22b cut to 8 layers, llama4-maverick cut
    to 2 (dense, MoE), zamba2-1.2b, glm4-9b and minicpm-2b at full width
    and depth, bf16, weights drawn on the card, through ``serve.
    run_decode`` at phase 5's traffic: flash_decode launches as
    reckoned, finite logits, one build, tokens/s, step time, peak memory;
    each in fp32 teacher-forced on the card and the CPU (cut to
    FAMILY_DECODE's layers; the routing alike), maverick's MoE block alone
    at full width in bf16 (4 bf16 steps), and one replayed mixtral step
    profiled (idle share, top kernels, the experts' share);
32. families train: TinyReptile LM meta-training at full width, bf16,
    ``--batch 8 --seq 2048 --k-inner 4`` at beta 0.002: mixtral-8x22b
    cut to 4 layers (3 rounds), zamba2-1.2b at full depth (4 rounds):
    launches as reckoned, the inner loss by round, tokens/s, peak
    memory; one fp32 gradient at full width (mixtral 1 layer, zamba2 one
    group) on the card against the CPU leaf by leaf, the routing alike.
    The kernels phase also times flash_decode at these families' decode
    shapes (head_dim 128 at R = 6, 5 and 16; head_dim 64 as MHA), each
    against SDPA and its bound, online_sgd in place, and ssd_scan at
    zamba2's (2, 64, 8, 256, 64, 64).
33. slice 16, the encoder-decoder whisper-tiny and the VLM paligemma-3b,
    inside phases 30-32: their reduced configs in ``families_reduced``
    (with frames or patch embeddings; every config there now also holds
    ``prefill_fn``'s logits to the CPU's within 1e-3 of the largest);
    ``decode_whisper_full`` and ``decode_paligemma_full`` at full width
    and depth, bf16, at phase 5's traffic (whisper's cross step one more
    flash_decode a layer, over its zero cross cache of 1,500 rows), each
    in fp32 against the CPU (paligemma cut to 4 layers) and with a
    DECODE_GRAPH wave replayed bit-equal to the eager one; and
    ``train_whisper_full`` and ``train_paligemma_full`` through the LM
    launcher, ``python -m repro_torch.launch.train --arch whisper-tiny
    --rounds 3`` (paligemma-3b: 2 rounds) ``--batch 8 --seq 2048
    --k-inner 4 --beta 0.002``, its own host init, random frames or
    patch embeddings and prefetch: launches as reckoned, tokens/s, peak
    memory, one fp32 gradient against the CPU (paligemma at 2 layers).
    Every round of phases 32 and 33 must lower its inner loss. The
    decode phase runs with Python's cyclic collector
    off, and ``free_card`` prints after each config what a collection
    frees on the card and fails if it frees a runner (ROADMAP queue C
    item 1). The kernels phase also holds flash_decode at paligemma's
    head dim 256 (8, 8, 1, 256) through the device-L route in bf16 and
    fp32, and at whisper's cross (8, 6, 6, 64) over L = 1,500 through
    the host-int route, each beside its bound and SDPA, with ptxas's
    register report of the head-dim-256 instantiations.
34. slice 17, the LMs in their own dtypes, right after the kernel
    phases (``kernels_mixed``: ``client_mean`` on bf16 rows at (8, 2^20)
    and (64, 1,153), bit for bit, beside its bytes bound and
    torch.sum(w q.float(), 0); ``meta_update`` with a bf16 w and an fp32
    w_hat at 1,153 and mamba2-130m's bf16 group): ``engine_lm_mixed_
    reduced``, the reduced mamba2 with bf16 weights and fp32 SSM
    scalars on ``run_federated`` under Reptile, FedAvg, FedSGD, a pooled
    FedBuff fleet under diurnal availability and PartialCommChannel(0.25),
    8 clients x 6 rounds (MIXED_*): launches per dtype group as
    reckoned, every leaf in its dtype, each captured run bit-equal to
    the same run eager on the card, each first round within 4 bf16 steps
    of the CPU's, the pooled run's crash after round 3 and resume exact;
    ``engine_lm_mamba2_130m_mixed``, mamba2-130m in its own dtypes at
    full width cut to 4 layers, Reptile(epochs=8) at a cohort of 8 for 2
    rounds beside one round of the same run in fp32 (peak memory,
    launches per group), its first round at 1 client and 1 epoch within
    4 bf16 steps of the CPU's; ``train_lm_fleet``, the LM launcher with ``--pool-size 1000
    --availability diurnal --buffer-size 2 --ckpt-every 2``: the reduced
    fp32 mamba2 against the CPU row by row (1e-4), then mamba2-130m at
    full width and depth, ``--batch 8 --seq 2048 --k-inner 4``, 6 rounds
    in a child process SIGKILLed right after its round-4 snapshot and
    resumed here, its rows and every leaf equal bit for bit to a run
    stopped cleanly after that snapshot (in this process, while the
    child runs) and resumed. Each prints its
    seconds; ``slice_17`` their sum and the script's time so far.
35. ``runtime/flags.py``'s levers on starcoder2-15b (a window of 4,096
    in all 40 layers), before phase 34's
    (``kernels_ringkv``: flash_decode as the ringkv route launches it,
    (8, 48, 4, 128) over a ring of 4,096 rows, window 0, L = min(c + 1,
    S) computed on the card from a cursor past the wrap, against its
    plain version, beside its bound and SDPA): ``ringkv_reduced``, the
    reduced starcoder2 at window 16 in fp32, one 24 + 24-token wave
    through the decode runner with the ring and without, on the card
    against the CPU (1e-3 of the largest logit, the same tokens), each
    replay bit-equal to its eager step; ``decode_starcoder2_ringkv``,
    full width cut to 4 of its 40 layers, bf16, 8 prompts of 4,160
    tokens and 64 new through a ring of 4,096 rows and a cache of 4,224,
    every shared step past the window within 4 bf16 steps of the
    largest logit, the tokens equal where the top-two gap clears
    BF16_CHOICE_TOL, step time and cache bytes; ``prefill_starcoder2_
    banded``, the same weights' prefill of 8,192 tokens under ``banded``
    against the masked route (4 bf16 steps of the largest logit), both
    timed; ``decode_starcoder2_full``, full width and depth (31.9 GB),
    ``serve --mode decode --batch 8 --cache-len 16384``, 64 + 64 tokens
    with the ring and without, bit for bit, tokens/s and step time
    beside the weights' bound, peak memory and graph nodes. ``levers``
    prints their seconds.

36. slice 19, the engine across processes, right after the levers
    phases: ``mesh_engine_sine``, two ranks (started beside the build
    and set up before the kernel phases, idle until their go; they share
    the card through gloo) run ``run_federated(mesh=2)`` on the
    sine MLP for the five fp32 strategies, TIFeD and a pooled FedBuff
    fleet under diurnal availability (the CPU test's cases): both ranks'
    phi bit for bit, the bills and identity state exactly the card's
    mesh=None run's, phi within the CPU test's tolerance of it, each
    round built once (run eagerly: gloo cannot be captured); the round
    of Reptile at the launcher's defaults timed on mesh=2 and mesh=None,
    the gloo all-reduce alone at 1,153 parameters and at mamba2-130m's
    groups; ``pod_client_mamba2_130m``, the LM launcher with ``--mesh pod``
    on the two ranks at full width and depth (beta 0.002), its first round
    against the same round computed in one rank (each pod's inner loop in
    turn, the weighted mean, the interpolation; 4 bf16 steps), ssd_scan,
    online_sgd, meta_update and client_mean launched on both ranks;
    ``mesh_engine_nccl1``, a one-rank NCCL group in this process:
    ``run_federated(mesh=1)`` with its all-reduce inside the captured
    round (made at the capture, at no replay), bit for bit mesh=None,
    built once, and its round timed; ``launcher_two_process``, started
    and read before any later phase runs: the launcher's
    ``--num-processes 2 --coordinator 127.0.0.1:<port> --process-id
    0|1`` row equal to its ``--devices 2`` row. The CPU references are
    submitted after these phases, which time host-paced collectives.
    Phases 5 and 23 and ``train_paligemma_full`` draw their weights
    on the card (``draw_on_card``): the host draws of tinyllama-1.1b
    (three times) and paligemma-3b took some 45 s.
37. slice 20, the 2-D ``("clients", "model")`` route, after the streams
    and before the families: four ranks on a 2 x 2 mesh sharing the card
    through gloo (started with the streams, idle until their go).
    ``mesh2d_engine_reduced``: the CPU test's cases (the tiny
    transformer, the sine MLP plain, under partial participation and
    with a FedBuff pool, the tiny mamba2 through ``ssd_scan``) on
    ``run_federated(mesh=client_model_mesh(2, 2))``, each rank holding its
    shards; gathered, every rank the same and within 1e-4 of the card's
    mesh=None run, bills and pool state exact, built once, online_sgd,
    meta_update, client_mean (and ssd_scan) launched on every rank.
    ``launcher_mesh2d``: the launcher's ``--mesh clients:2,model:2
    --arch transformer`` row on the four ranks against its row without
    the mesh. ``mesh2d_tinyllama_1_1b``: tinyllama-1.1b at full width and
    depth, bf16, drawn on the card (each rank keeps only its shards), on
    the 2 x 2 mesh: Reptile on ``LmTaskDistribution(32000, 128)``, 4
    clients a round, support 2, 2 epochs, 2 rounds, one eval; this process
    runs it with mesh=None (eagerly) beside the ranks' reduced cases, and
    the 2-D run's first round is held to that one's at 4 bf16 steps, the
    bills exactly; each rank's parameter bytes
    at most 0.6 of the whole's; its peak memory, the rounds' seconds, the
    model group's all-reduces a client step and the clients group's bytes
    a round.

The order: the kernel phases, the levers (35) and slice 19 (36) run
first, with nothing beside them. Then three streams run at once, each in
a process of its own on the card (STREAMS): this process runs slice
17's two engine phases (34), 27 and 28; ``decode_lm`` runs 4-6,
``train_lm_fleet`` (34) and 23's dense LM; ``sine`` runs 7-13b, 24-26,
18-20, 29, 14-17 and 21-23's mamba2 LM. A stream's lines are printed when it ends, each with its
``stream``. Slice 20 (37) runs once they are done; the families
(30-33) run last, alone on the card.

The CPU references that depend only on a seed or an argv (the engine LM
runs' first rounds, the partial wire's, the pool's and the pool drift's
CPU runs, the KWS fleet) run in a worker process (``CpuRefs``) of the
process whose phases take them, submitted after slice 19's phases
(whose host-paced times it would share the host with).
``phase_seconds`` gives each phase's seconds in this process,
``streams`` each stream's, and ``cpu_refs`` how long a phase waited for
each reference and when the worker was done with it.

Then the kernels line, the card's ``nvidia-smi`` name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure is a
traceback and a non-zero exit; without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # TF32 tensor-core peak, dense
INT8_OPS_PER_S = 1979e12       # int8 tensor-core peak, dense
BF16_OPS_PER_S = 989e12        # bf16 tensor-core peak, dense
PASSES = 7                     # timing repeats; the median is kept

SUPPORT, QUERY, K_MAX, SLOTS, STEPS_PER_TICK = 10, 20, 10, 64, 5
T_SUPPORT, T_K_MAX = 8, 6
N_REQUESTS, N_HELD = 512, 32
# the round engine's TIFeD: the train launcher's --strategy tifed defaults
# (64 clients, support 32, 8 epochs, 20 rounds); its dfa_epoch_int8 row
TIFED_CLIENTS, TIFED_SUPPORT, TIFED_EPOCHS = 64, 32, 8
ENGINE_DFA = "engine_B64_S32_mixed"

# examples/quickstart.py's TinyReptile run and eval protocol
TR_ROUNDS, TR_CHECK_ROUNDS, TR_SUPPORT = 600, 60, 32
TR_EVAL = dict(num_tasks=10, support=8, k_steps=8, lr=0.02, query=64)
PHI_BYTES = 1153 * 4           # one fp32 copy of the sine MLP on the wire

# ssd_scan: tests/test_kernels.py's three shapes, then the LM path's
# (B, H, nc, Q, P, N) at --batch 8 --seq 2048 --k-inner 4: 2 sequences
# of 8 chunks of 256 per inner step, mamba2-130m's 24 heads of 64 and
# state 128; then one 4,096-token sequence (16 chunks)
SSD_SHAPES = (("test_1x2x2x16x64x16", (1, 2, 2, 16, 64, 16)),
              ("test_2x3x4x32x64x32", (2, 3, 4, 32, 64, 32)),
              ("test_1x24x2x64x64x128", (1, 24, 2, 64, 64, 128)),
              ("path_2x24x8x256x64x128", (2, 24, 8, 256, 64, 128)),
              ("nc16_1x24x16x256x64x128", (1, 24, 16, 256, 64, 128)),
              # the engine LM route's: a client's 8 sequences of 64 tokens,
              # the reduced mamba2 (8 heads, chunks of 32, state 32) and
              # mamba2-130m (one 256-position chunk, padded from 64)
              ("engine_reduced_8x8x2x32x64x32", (8, 8, 2, 32, 64, 32)),
              ("engine_full_8x24x1x256x64x128", (8, 24, 1, 256, 64, 128)),
              # zamba2-1.2b at --batch 8 --seq 2048 --k-inner 4: 64 heads
              # of 64, state 64
              ("zamba2_2x64x8x256x64x64", (2, 64, 8, 256, 64, 64)))
# 2e-4 is the JAX package's tolerance for the scan (tests/test_kernels.py);
# it holds at the path's shape too: the outputs stay below about 25, the
# in-chunk sums are damped by exp(sum dA), and both versions sum fp32
# products in orders that differ by a few ulp of those magnitudes
SSD_TOL = 2e-4
# heads a chunk-outputs block owns: the settings held and timed at the
# large shapes, beside ssd_scan.heads_per_block's choice
SSD_HEAD_GROUPS = (1, 2, 3, 4, 5, 6, 8, 12, 24)
# the LM launcher's runs: the reduced config against the CPU, then
# mamba2-130m at full width and depth
LM_REDUCED = ["--arch", "mamba2", "--reduced", "--rounds", "4", "--seq", "64",
              "--batch", "4", "--k-inner", "2"]
LM_FULL = ["--arch", "mamba2-130m", "--rounds", "6", "--batch", "8",
           "--seq", "2048", "--k-inner", "4"]
LM_PROFILE_ROUNDS = 1          # two until PR 24: one keeps the script short
# mamba2-130m's parameters: the bf16 group and the fp32 group (dt_bias,
# A_log and D of 24 layers), the two flat buffers of every update
LM_BF16, LM_FP32 = 128_981_760, 1_728

# flash_decode, as (B, H, Kv, hd, S): tests/test_kernels.py's three shapes
# (each at its four (L, window) cases and both dtypes, its tolerances),
# the decode path's (tinyllama-1.1b at --batch 8 --cache-len 2048) in
# bf16, and benchmarks/kernels_bench.py's 32k cache in fp32
FD_TEST_SHAPES = ((1, 4, 4, 64, 512), (2, 8, 2, 64, 1024),
                  (1, 8, 1, 128, 2048))
FD_PATH, FD_32K = (8, 32, 4, 64, 2048), (4, 8, 4, 64, 32768)
# the path shape's (L, window) rows: a decode wave of 512 + 128 steps
# passes through L = 1 ... 640 (the rows up to 640 give path_run_mean),
# then the cache's full 2,048 and a window
PATH_CASES = ((1, 0), (64, 0), (128, 0), (320, 0), (577, 0), (640, 0),
              (2048, 0), (1024, 256))
PATH_RUN = (1, 640)
# the kernel is held at tol x min(1, max |want|) absolute and tol relative:
# at the path's L = 2,048 the softmax is nearly flat, |out| is some 0.03,
# and a fixed 2e-2 would be two thirds of a typical value; the library
# call, whose time only is used, keeps the fixed tolerance
FD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
# the serve launcher's decode runs: the reduced config against the CPU,
# then tinyllama-1.1b at full width and depth (TinyLlama's context is
# 2,048 tokens) for one wave at batch 8: a second wave doubled every
# full-width decode phase's time and checked nothing the first does not
DECODE_REDUCED = ["--mode", "decode", "--arch", "tinyllama-1.1b",
                  "--reduced", "--requests", "4", "--batch", "2",
                  "--prompt-len", "16", "--max-new", "16", "--cache-len",
                  "64"]
DECODE_FULL = ["--mode", "decode", "--arch", "tinyllama-1.1b", "--requests",
               "8", "--batch", "8", "--prompt-len", "512", "--max-new",
               "128", "--cache-len", "2048"]
TINYLLAMA_PARAMS = 1_100_048_384
# the fp32 stretch at full width: 16 teacher-forced steps at batch 2, the
# card (full fp32 matmuls) against the CPU within 1e-3 of the largest
# |logit|: fp32 sums over d_model 2048 and d_ff 5632 in other orders,
# through 22 layers
CHECK_STEPS, CHECK_BATCH, CHECK_TOL = 16, 2, 1e-3
# a bf16 greedy choice may differ from the fp32 argmax where two logits
# are closer than bf16's rounding through 22 layers; its fp32 logit is
# held within 2^-4 of the largest fp32 |logit| (16 bf16 steps) of the max
BF16_CHOICE_TOL = 2 ** -4
DECODE_PROFILE_STEPS, DECODE_PROFILE_AT = 16, 512
# graphs_vs_eager's decode wave: tinyllama-1.1b at full width and depth,
# 8 prompts of 64 tokens and 32 new, cache 2048, replayed against eager
DECODE_GRAPH = dict(batch=8, prompt_len=64, max_new=32, cache_len=2048)

# the fleet phases: TinyMetaFed's partial wire on TinyReptile at 64
# clients; the persistent pool of tests/test_pool_scale.py (100,000 sine
# devices, vectorized sampler) under diurnal check-ins with a FedBuff
# buffer, then 1,000,000 devices with their state in host slabs; the
# KWS example's persistent fleet, at its defaults (200 rounds)
PARTIAL_ROUNDS, PARTIAL_CLIENTS, PARTIAL_FRACTION = 200, 64, 0.25
# the card is held to the CPU over the first FLEET_CHECK_ROUNDS of a long
# sine run, as the quickstart's 600 rounds are over 60: past some 100
# rounds a 64-client TinyReptile run amplifies fp32 reordering (the
# card's GEMMs against the CPU's) beyond 1e-4; the long run's bills and
# pool state are held exactly all the same
FLEET_CHECK_ROUNDS = 60
# the 100,000-device pooled, buffered run is held to the CPU over its
# first POOL_CHECK_ROUNDS: past them its dynamics turn a last-bit
# difference into a jump past 1e-4 at some rounds and not at others, on
# the CPU alone and with the weighted mean taken as an FMA chain or as
# rounded products summed (PERF.md, "fleet_pool's length"). pool_drift
# reports that growth at POOL_DRIFT_ROUNDS, from one
# ulp added to every init weight, and the card against the CPU
POOL_CHECK_ROUNDS = 20
POOL_DRIFT_ROUNDS = (20, 34, 50, 60)
POOL_SIZE, POOL_BIG, POOL_COHORT = 100_000, 1_000_000, 64
POOL_ROUNDS, POOL_BIG_ROUNDS, FLEET_PROFILE_ROUNDS = 500, 50, 20
POOL_BUFFER, POOL_DEADLINE, POOL_PERIOD = 16, 8, 24
KWS_FLEET = ["--pool-size", "1000", "--availability", "markov",
             "--buffer-size", "4"]
CKPT_EVERY, CKPT_EVAL_EVERY, CKPT_ROUNDS, CKPT_PAST = 4, 8, 16, 24
CKPT_POOL_ROUNDS = 40
OVERHEAD_EVERY, OVERHEAD_PAIRS = 10, 3

# the paper models' parameters (Table I): the sine MLP and the conv nets
# KWS_CONV and OMNIGLOT_CONV, whose flat phi and (4, P) Reptile c4 cohort
# the kernel rows take
PAPER_PARAMS = {"sine_mlp": 1_153, "kws_conv": 20_612,
                "omniglot_conv": 112_709}
# paper Table II as the JAX package's metering/memory.py gives it at S = 32
# (algorithm_memory_report, run with the JAX package; constants here)
TABLE2 = {
    "sine_mlp": {"model": "sine_mlp", "params": 1153, "param_bytes": 4612,
                 "reptile_bytes": 17928, "tinyreptile_bytes": 5140,
                 "reduction_factor": 3.4879377431906615,
                 "fits_arduino_256kb_reptile": True,
                 "fits_arduino_256kb_tinyreptile": True},
    "kws_conv": {"model": "kws_conv", "params": 20612, "param_bytes": 82448,
                 "reptile_bytes": 1020064, "tinyreptile_bytes": 141172,
                 "reduction_factor": 7.225682146601309,
                 "fits_arduino_256kb_reptile": False,
                 "fits_arduino_256kb_tinyreptile": True},
    "omniglot_conv": {"model": "omniglot_conv", "params": 112709,
                      "param_bytes": 450836, "reptile_bytes": 3274024,
                      "tinyreptile_bytes": 625324,
                      "reduction_factor": 5.235724200574422,
                      "fits_arduino_256kb_reptile": False,
                      "fits_arduino_256kb_tinyreptile": False}}
# Tables III-IV (benchmarks/table34_round_time.py): one client's update,
# TinyReptile against Reptile with 8 epochs, at S = 32
T34_S, T34_EPOCHS = 32, 8
# Fig. 4 (benchmarks/fig4_omniglot_kws.py): 120 rounds of TinyReptile and
# of serial Reptile, 30 of Reptile at 4 clients, one eval at the end
FIG4_ROUNDS, FIG4_C4_ROUNDS, FIG4_CLIENTS = 120, 30, 4
FIG4_KW = dict(alpha=1.0, beta=0.01, support=16, seed=4)
FIG4_EVAL = dict(num_tasks=6, support=16, k_steps=8, lr=0.01, query=32)
# tests/test_core_algorithms.py::test_kws_tasks_learnable: KWS TinyReptile,
# 60 rounds, seed 6, the init from seed 1, must beat 0.35 (chance 0.25)
KWS_GATE = dict(rounds=60, alpha=1.0, beta=0.01, support=16, seed=6)
KWS_GATE_EVAL = dict(num_tasks=5, support=8, k_steps=8, lr=0.01, query=32)
KWS_GATE_MIN = 0.35
# the conv runs on the card against the CPU: TinyReptile rounds of each
# net, KWS Reptile c4 rounds; then the profiled Omniglot rounds
CONV_CHECK_ROUNDS, CONV_CHECK_C4_ROUNDS, CONV_PROFILE_ROUNDS = 10, 4, 20

# client_mean (the weighted client mean as the jitted JAX engine sums it):
# cohorts through the FMA chain (<= 32) and the windows of 32 (33, 64),
# over the sine MLP, KWS and 2^20 parameters; on the device at the
# engine's shapes; and ROADMAP queue C's TIFeD launcher case
CM_CLIENTS = (1, 4, 8, 32, 33, 64)
CM_SIZES = (1_153, 20_612, 1 << 20)
CM_TIMED = ((8, 1_153), (64, 1_153), (4, 20_612))
QUEUE_C_TIFED = ["--strategy", "tifed", "--rounds", "6", "--clients", "4",
                 "--pool-size", "30", "--availability", "markov",
                 "--buffer-size", "4"]
# online_sgd and meta_update at tinyllama-1.1b's flat bf16 buffer; the
# plain versions run in pieces (meta_update's works in float64)
TL_CHUNK = 1 << 26
# the dense LM through the LM launcher: the reduced tinyllama and
# starcoder2 (window 64) at 256 tokens against the CPU, then
# tinyllama-1.1b at full width and depth at TinyLlama's context
DENSE_REDUCED = {
    arch: ["--arch", arch, "--reduced", "--rounds", "4", "--seq", "256",
           "--batch", "4", "--k-inner", "2"]
    for arch in ("transformer", "starcoder2-15b")}
# the launcher's batch and inner steps at TinyLlama's context; at the
# launcher's beta 0.02 the random-init 1.1B model's inner loss climbs
# within a round, so the client's rate is 0.002, and one more round at
# 0.02 is reported beside it (DENSE_DEFAULT_BETA)
DENSE_SHAPE = ["--arch", "tinyllama-1.1b", "--batch", "8", "--seq", "2048",
               "--k-inner", "4"]
DENSE_FULL = DENSE_SHAPE + ["--rounds", "4", "--beta", "0.002"]
DENSE_DEFAULT_BETA = DENSE_SHAPE + ["--rounds", "1"]
# the joint-training baseline: AdamW on one fixed batch of 8 x 2,048,
# cosine(JOINT_LR, 3, warmup=1) (the first step's lr is 0); AdamW's first
# step moves each of the 1.1B weights by about lr, and the loss falls at
# 3e-5; three steps at JOINT_LR_HIGH (a pretraining rate) are reported
# beside them, where it rises
JOINT_STEPS, JOINT_BATCH, JOINT_SEQ, JOINT_LR = 3, 8, 2048, 3e-5
JOINT_LR_HIGH = 3e-4
# prefill against the teacher-forced decode path, both bf16: within 4
# bf16 steps of the largest logit
PREFILL_BATCH, PREFILL_LEN, PREFILL_TOL = 8, 512, 4 * 2 ** -8
# the serve launcher's decode mode on mamba2-130m, at the dense decode
# phase's traffic; decode held to prefill at these positions in fp32 (the
# same weights cast), within CHECK_TOL of the largest logit. In bf16 the
# two routes round in other places every layer and part by several
# percent of the largest logit, in the JAX package as in the port
# (PERF.md, "mamba2 bf16"): reported there, and the card's bf16 decode
# step is held to the CPU's layer by layer at PREFILL_TOL
DECODE_MAMBA = ["--mode", "decode", "--arch", "mamba2-130m", "--requests",
                "8", "--batch", "8", "--prompt-len", "512", "--max-new",
                "128", "--cache-len", "640"]
MAMBA_AT = (0, 63, 511)
# the engine's LM route (--strategy ... --arch): the launcher's --batch 8
# --seq 64 at a cohort of 8 for 6 rounds, each run on the card and on the
# CPU (the CPU takes 3-18 s a run here; the launcher's 64 clients x 20
# rounds would take minutes a strategy), then a larger cohort on the card
# alone (ENGINE_LM_RATE): 32 clients x 20 rounds, cut from the launcher's
# 64 to keep the script inside its limit (the 64-client run took 61.1 s on
# an H100, 28.0 of them capturing its 352,595-node round)
ENGINE_LM = ["--clients", "8", "--rounds", "6"]
ENGINE_LM_RUNS = (
    ("reptile_mamba2", ["--strategy", "reptile", "--arch", "mamba2"]),
    ("fedavg_mamba2", ["--strategy", "fedavg", "--arch", "mamba2"]),
    ("fedsgd_mamba2", ["--strategy", "fedsgd", "--arch", "mamba2"]),
    ("transfer_mamba2", ["--strategy", "transfer", "--arch", "mamba2"]),
    ("reptile_transformer", ["--strategy", "reptile", "--arch",
                             "transformer"]),
    ("reptile_mamba2_pool", ["--strategy", "reptile", "--arch", "mamba2",
                             "--pool-size", "1000", "--pool-sampler",
                             "vectorized", "--availability", "diurnal",
                             "--buffer-size", "4"]))
ENGINE_LM_RATE = ["--strategy", "reptile", "--arch", "mamba2", "--clients",
                  "32"]
ENGINE_LM_CKPT = 3             # the crash: right after round 3 of 6
LM_EVAL = dict(num_tasks=2, support=4, k_steps=4, lr=0.01, query=8)
# card against CPU: each engine LM run's first round, params and query
# loss within LM_ENGINE_TOL. Later rounds are not compared: 8 epochs of
# full-batch SGD a round amplify last-bit differences (one ulp on the
# init moves the reduced mamba2's 6-round Reptile run by 3.1e-4 on the
# card; tests/test_torch_lm_engine.py), so a whole run's distance says
# how chaotic the trajectory is, not whether the port is right
LM_ENGINE_TOL = 1e-4
# mamba2-130m on the engine at full width and depth, fp32 (the engine
# packs one buffer): a cohort of 8, not the launcher's 64, since one
# (C, P) fp32 buffer is 33.0 GB at 64 and at least three are live. At the
# launcher's beta 0.02 each client's 8 epochs fit its own domain's head
# (the inner loss 10.83 -> 10.26-10.44 a round), and after 4 rounds the
# adapted query loss of the init is above the random init's (10.8116
# against 10.8014), so the clients' rate here is 0.002
FULL_LM_CLIENTS, FULL_LM_ROUNDS, FULL_LM_BETA = 8, 2, 0.002
FULL_LM_PARAMS = 128_983_488
# the engine run's layers: 16 of mamba2-130m's 24. At all 24 and 2 rounds
# the whole script took 1,105.9 s (its aim is 1,100; this phase 146.5 s,
# the round's capture alone 33-36 s); the one-step gradient checks keep
# all 24. At 12 layers and 2 rounds the query loss ends above the init's
# (10.7576 against 10.7516), failing its gate, so 16 stays
FULL_LM_RUN_LAYERS = 16
# its backward held to the CPU's: one inner SGD step's cohort gradient (2
# clients, 2 sequences each), leaf by leaf, within a fixed share of each
# leaf's largest entry, by depth. Each tolerance is derived from a float64
# run of the port's plain path on the same inputs
# (kernels/ssd_grad_float64.py, on an H100): the card's fp32 gradient
# (ssd_scan's route) and the CPU's (the plain scan) each sit some
# distance d_card, d_cpu from it, as a share of a leaf's largest entry,
# so by the triangle inequality they sit at most d_card + d_cpu (the worst
# leaves' sum) from each other; twice that, rounded up, leaves room for
# another run's rounding. At 24 layers d_card = 8.3e-4, d_cpu = 1.25e-3:
# 2 x 2.08e-3 -> 5e-3 (the card read 1.29e-3 from the CPU). Leaf by
# leaf the card's distance is a median 0.70 of the CPU's, but 3 to 5.9
# times it at 6 of the 314 leaves (the largest layers/3/mamba/w_C, 7.9e-4
# against 1.4e-4) and 3 to 5.3 times the card's own plain scan's at 11:
# the kernel's 3xTF32 forward rounds otherwise there (ROADMAP queue C,
# open). At 2 layers d_card = 2.3e-5, d_cpu = 3.2e-5 give 1.1e-4; 1e-4,
# the bound the CPU port is held to against the JAX package's gradient
# there (tests/test_torch_lm_rounding.py), is kept
FULL_LM_GRAD_TOL = {2: 1e-4, 24: 5e-3}

# the decoder-only families of slice 15. The reduced configs held against
# the CPU (phase 30): (name, arch, overrides of .reduced()): mixtral at 2
# layers and at 4 (the JAX package's scan layout), maverick at 4 with its
# dense and MoE blocks alternating and its global layer, zamba2 at 5 (two
# groups of 2 Mamba2 layers and a tail of 1, the shared block applied 3
# times), glm4 and minicpm
FAMILY_REDUCED = (
    ("mixtral_2l", "mixtral-8x22b", {}),
    ("mixtral_4l", "mixtral-8x22b", {"num_layers": 4}),
    ("maverick_4l", "llama4-maverick-400b-a17b",
     {"num_layers": 4, "moe_every": 2}),
    ("zamba2_5l", "zamba2-1.2b", {"num_layers": 5}),
    ("glm4", "glm4-9b", {}),
    ("minicpm", "minicpm-2b", {}),
    # slice 16: the encoder-decoder and the VLM
    ("whisper", "whisper-tiny", {}),
    ("paligemma", "paligemma-3b", {}))
FAMILY_TOKENS = (2, 64)        # the loss's batch of next-token sequences
FAMILY_TOL = 1e-4              # the loss (relative), each gradient leaf
# a gradient leaf of a config with Mamba2 layers, derived from a float64
# run of the port's plain path on the reduced zamba2's inputs
# (kernels/ssd_grad_float64.py, on an H100), as FULL_LM_GRAD_TOL is: the
# card's fp32 gradient sits at most 1.10e-4 of a leaf's largest entry
# from it, the CPU's 8.9e-5 (both at layers/2/mamba/A_log, whose largest
# entry is 3.8e-4: small terms that cancel), so twice their sum, 3.98e-4,
# rounded up (the card read 2.0e-4 from the CPU there)
FAMILY_SSM_GRAD_TOL = 4e-4
FAMILY_WAVE = dict(batch=2, prompt_len=8, max_new=8, cache_len=32)
ENGINE_MOE = ["--strategy", "reptile", "--arch", "moe"] + ENGINE_LM
# a token routed otherwise on the card than on the CPU is a rounding place
# only where its k-th and (k+1)-th probabilities are this close
ROUTE_FLIP_GAP = 1e-6
BF16_RTOL_4 = 2 ** -6          # 4 bf16 steps
# full-width decode at DECODE_FULL's traffic (phase 31): (arch, layers cut
# to fit one card in bf16 or None for full depth, the layers of the fp32
# check against the CPU or None). mixtral's 56 layers are 112 GB, 8 are
# 40.9 GB; one maverick MoE layer is 32.2 GB, so 2 layers (dense, MoE) are
# 37.1 GB and 4 would be 70.1 GB beside the cache; the fp32 check takes
# one mixtral MoE layer (11.6 GB), maverick's dense one (its MoE block is
# held alone in bf16), and as many of the others as the CPU runs quickly
FAMILY_DECODE = (("mixtral-8x22b", 8, 1),
                 ("llama4-maverick-400b-a17b", 2, 1),
                 ("zamba2-1.2b", None, None), ("glm4-9b", None, 4),
                 ("minicpm-2b", None, 8),
                 # slice 16: whisper-tiny whole (36.5 M params), paligemma
                 # at full depth in bf16 (3.8 GB), its fp32 check at 4 of
                 # its 18 layers (3.6 GB on the CPU)
                 ("whisper-tiny", None, None), ("paligemma-3b", None, 4))
# the full-width decode configs whose DECODE_GRAPH wave is also replayed
# against the same wave run eagerly (graphs_vs_eager_decode)
FAMILY_REPLAY_CHECK = ("whisper-tiny", "paligemma-3b")
FAMILY_CHECK_STEPS = 8
# full-width TinyReptile meta-training (phase 32): (arch, layers, rounds,
# the layers of the fp32 gradient against the CPU). mixtral at 4 layers is
# 10.4 B params, 20.8 GB in bf16; the inner loop holds phi, the working
# params and their gradient (62.5 GB) beside the activations. zamba2 at
# full depth; its gradient check takes one group (6 Mamba2 layers and the
# shared block)
FAMILY_TRAIN = (("mixtral-8x22b", 4, 3, 1), ("zamba2-1.2b", None, 4, 6))
FAMILY_TRAIN_SHAPE = dict(batch=8, seq=2048, k_inner=4)
FAMILY_TRAIN_BETA = 0.002
FAMILY_GRAD_TOKENS = (1, 64)
# slice 16's full-width meta-training through the LM launcher (phase 33),
# both at full depth: (arch, --rounds, the layers of the fp32 gradient
# against the CPU: whisper's whole, paligemma's at 2, the 257,216 x 2,048
# embedding and 2 blocks, 2.8 GB in fp32)
ENCDEC_VLM_TRAIN = (("whisper-tiny", 3, 4), ("paligemma-3b", 2, 2))
ENCDEC_VLM_ARGV = ["--batch", "8", "--seq", "2048", "--k-inner", "4",
                   "--beta", "0.002"]
# online_sgd in place (out = p), as the LM inner loop runs it: 2^28 bf16
INPLACE_SGD_N = 1 << 28
# flash_decode at the new families' decode shapes (B, H, Kv, hd, S): head
# dim 128 at 6 (mixtral), 5 (maverick) and 16 (glm4) query heads a KV
# head, head dim 64 as MHA (minicpm's 36 heads, zamba2's shared block's 32)
FD_FAMILY_SHAPES = (("mixtral", (8, 48, 8, 128, 2048)),
                    ("maverick", (8, 40, 8, 128, 2048)),
                    ("glm4", (8, 32, 2, 128, 2048)),
                    ("minicpm", (8, 36, 36, 64, 2048)),
                    ("zamba2", (8, 32, 32, 64, 2048)))
FD_FAMILY_L = (1, 320, 640, 2048)
# slice 16's flash_decode shapes (B, H, Kv, hd, S): paligemma-3b's decode
# (head dim 256, 8 query heads over one KV head) through the device-L
# route at FD_FAMILY_L, in bf16 and fp32; whisper-tiny's cross decode (6
# heads of 64, MHA) over its fixed L = encoder_tokens = 1,500 through the
# host-int route, as decode_fn passes it
FD_PALIGEMMA = (8, 8, 1, 256, 2048)
FD_PALIGEMMA_FP32_L = (1, 2048)
FD_WHISPER_CROSS = (8, 6, 6, 64, 1500)


T0 = time.perf_counter()
# seconds by phase: the time from the previous phase line to each phase
# line, summed by the phase's name (printed before the kernels line); the
# lines a phase prints on its way (SUB_LINES) leave their time to it
PHASE_S: dict = {}
SUB_LINES = ("decode_build", "free_card")
_LAST_LINE = [T0]
STREAM: list = [None]          # this process's stream (STREAMS), in its lines


def emit(obj):
    """One JSON line; a phase's line carries the seconds since start, and
    the seconds since the previous phase line go to its phase's sum."""
    if STREAM[0] is not None:
        obj = {**obj, "stream": STREAM[0]}
    if "phase" in obj:
        now = time.perf_counter()
        if obj["phase"] not in SUB_LINES:
            PHASE_S[obj["phase"]] = PHASE_S.get(obj["phase"], 0.0) + (
                now - _LAST_LINE[0])
            _LAST_LINE[0] = now
        obj = {**obj, "t_s": now - T0}
    print(json.dumps(obj), flush=True)


# -- CPU references in a worker process ---------------------------------------

# CPU references that depend only on their arguments (a launcher's argv, a
# seed) run in one worker process, submitted once the phases that time
# kernels on the host are done, while the card runs the phases before the
# one that holds the card to them; that phase waits for its result
# (CpuRefs.take). The worker takes CPU_REF_THREADS of the host's 8 cores
# for torch (with 4, the phases that run CPU work in this process beside
# it ran slower)
CPU_REF_THREADS = 2


def _cpu_worker_init():
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(CPU_REF_THREADS)


def cpu_ref(kind, *args):
    """One CPU reference, computed in the worker (its printout dropped):
    ``("engine_lm", argv)`` the train launcher's engine route for one
    round; ``("kws",)`` the KWS example's fleet (KWS_FLEET);
    ``("partial", rotate)`` fleet_partial's check run; ``("pool", size,
    rounds, residency)`` a ``pool_run``. Returns (the result, the wall
    clock when it was done)."""
    return _cpu_ref(kind, *args), time.time()


def _cpu_ref(kind, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        if kind == "engine_lm":
            from repro_torch.launch import train as tl
            (argv,) = args
            return tl.run_engine_strategy(tl.parse_args(
                list(argv) + ["--rounds", "1", "--device", "cpu"]))[1]
        if kind == "kws":
            from repro_torch.examples import federated_keyword_spotting
            return federated_keyword_spotting.main(KWS_FLEET
                                                   + ["--device", "cpu"])
        if kind == "partial":
            return partial_run(sine_tm(), *args, FLEET_CHECK_ROUNDS, "cpu")
        if kind == "pool":
            return pool_run(sine_tm(), *args, "cpu")
    raise ValueError(f"cpu_ref: unknown reference {kind!r}")


class CpuRefs:
    """The worker process and its references, by key (``cpu_ref``'s
    arguments; a key submitted again is computed once). ``take`` waits
    for one (any number of times) and records, by key, the seconds waited
    and when the worker was done with it (seconds since the start);
    ``close`` stops the worker."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)
        self.start = time.time()
        self.jobs = {}
        self.log = {}

    def submit(self, *key):
        if key not in self.jobs:
            self.jobs[key] = self.pool.submit(cpu_ref, *key)

    def take(self, *key):
        t0 = time.perf_counter()
        out, done = self.jobs[key].result()
        name = " ".join(" ".join(a) if isinstance(a, tuple) else str(a)
                        for a in key)
        self.log[name] = {"waited_s": time.perf_counter() - t0,
                          "done_at_s": done - self.start}
        return out

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def submit_cpu_refs(refs, which="engine"):
    """The references of the script's process (``"engine"``: the engine's
    LM runs and the families') or of the sine stream (``"sine"``: the
    fleet's), in the order the phases take them."""
    if which == "engine":
        for _, argv in ENGINE_LM_RUNS:
            refs.submit("engine_lm", tuple(argv + ENGINE_LM))
        refs.submit("engine_lm", tuple(ENGINE_MOE))
        return
    for rotate in (False, True):
        refs.submit("partial", rotate)
    refs.submit("pool", POOL_SIZE, POOL_CHECK_ROUNDS, "device")
    refs.submit("pool", POOL_BIG, POOL_BIG_ROUNDS, "host")
    for rounds in POOL_DRIFT_ROUNDS:
        refs.submit("pool", POOL_SIZE, rounds, "device")
    refs.submit("kws")


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters):
    """Median over PASSES of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(PASSES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_rows(torch, prof):
    """The device rows of ``prof.key_averages()``, as (key, self device
    us, count) for each group of device events of one name, read from
    the profiler's own events without building its tree of function
    events (whose Python objects took minutes over this script's traces
    of 10^5 kernels; ``check_device_rows`` holds the two readings
    equal)."""
    cuda = torch.autograd.DeviceType.CUDA
    groups = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if name.startswith("ProfilerStep#"):
            name = "ProfilerStep*"
        # an async event counts no device time, as in FunctionEvent
        us = (0.0 if e.is_async() or e.start_thread_id() != e.end_thread_id()
              else (e.end_ns() - e.start_ns()) / 1e3)
        g = groups.setdefault((name, getattr(e, "is_user_annotation",
                                             lambda: False)()), [0.0, 0])
        g[0] += us
        g[1] += 1
    return [(name, us, n) for (name, _), (us, n) in groups.items()]


def check_device_rows(torch, prof, where):
    """``device_rows`` against ``key_averages``' device rows on a trace
    whose tree is built anyway: the same groups, counts and times."""
    cuda = torch.autograd.DeviceType.CUDA
    want = sorted((ev.key, ev.self_device_time_total, ev.count)
                  for ev in prof.key_averages() if ev.device_type == cuda)
    got = sorted(device_rows(torch, prof))
    check(len(got) == len(want) and all(
        a[0] == b[0] and a[2] == b[2] and abs(a[1] - b[1]) <= 1e-6 * max(
            1.0, abs(b[1])) for a, b in zip(got, want)),
        f"{where}: the profiler's device rows read two ways differ")
    return len(got)


def device_ms(torch, fn, key="device_ms", calls=20, windows=3,
              max_windows=10, match=None):
    """Mean device time of one call of ``fn``, from torch.profiler: the
    GPU's own time, without the host's, over ``windows`` windows of
    2 x ``calls`` calls each. Only events on the device are summed (an
    operator's row also carries the time of the kernels it launched).

    The tracer loses device events now and then: a window may record
    none, or only some launches of a kernel. So each kernel (by its full
    name) counts at its mean time over the launches recorded, times its
    launches per call: the most any window recorded, over 2 x ``calls``,
    rounded up; while no window has recorded anything, more windows are
    opened, up to ``max_windows``. Only kernels whose name holds
    ``match`` count, where it is given. Returns ``{key: ms, key +
    "_traced": share}``, the share being the launches recorded over
    those reckoned, and with ``match`` also ``kernels_per_call``, the
    launches a call so reckoned, summed over the kernels counted."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 2 * calls
    time_us, count, per_call = ({} for _ in range(3))
    opened = 0
    while opened < windows or (not count and opened < max_windows):
        opened += 1
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for k, us, c in device_rows(torch, prof):
            if c and (match is None or match in k):
                time_us[k] = time_us.get(k, 0) + us
                count[k] = count.get(k, 0) + c
                per_call[k] = max(per_call.get(k, 0), -(-c // n))
    check(count, f"the profiler saw no device time in {opened} windows")
    ms = sum(time_us[k] / count[k] * per_call[k] for k in count) / 1e3
    out = {key: ms, key + "_traced": sum(count.values())
           / (opened * n * sum(per_call.values()))}
    if match is not None:
        out["kernels_per_call"] = sum(per_call.values())
    return out


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- inputs -------------------------------------------------------------------

def tifed_case(torch, np, dims, S, B, seed, layers, dev, extreme=False):
    """B slots of random (or all-rails) integer operands of one epoch."""
    rng = np.random.default_rng(seed)
    din, h1, h2, dout = dims

    def ints(lo, hi, shape, dtype):
        a = (rng.choice([lo, hi], shape) if extreme
             else rng.integers(lo, hi + 1, shape))
        return torch.from_numpy(a.astype(dtype)).to(dev)

    blim = 2 ** 22 if extreme else 2 ** 15
    ylim = 2 ** 21 if extreme else 2 ** 15
    ws = tuple(ints(-127, 127, (B,) + s, np.int8)
               for s in ((din, h1), (h1, h2), (h2, dout)))
    bs = tuple(ints(-blim, blim, (B, n), np.int32) for n in (h1, h2, dout))
    xq = ints(-127, 127, (B, S, din), np.int8)
    yal = ints(-ylim, ylim, (B, S, dout), np.int32)
    fb = tuple(ints(-127, 127, (dout, h), np.int8) for h in (h1, h2))
    dither = tuple(torch.from_numpy(
        rng.random((B,) + s).astype(np.float32)).to(dev)
        for s in ((din, h1), (h1, h2), (h2, dout)))
    scales = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -9, 2.0 ** -4 / S,
                           2.0 ** -8, 2.0 ** -9, 2.0 ** -10,
                           2.0 ** -6, 2.0 ** -7, 2.0 ** -8],
                          dtype=torch.float32, device=dev)
    lay = torch.tensor([layers[i % len(layers)] for i in range(B)],
                       dtype=torch.int32, device=dev)
    return ws, bs, xq, yal, lay, fb, dither, scales


def dfa_bytes_ops(args):
    """Bytes the epoch must move (each input read once, each output
    written once; only the selected layer's dither plane is needed) and
    the integer operations it must do, for these inputs."""
    ws, bs, xq, yal, lay, fb, dither, scales = args
    B, S, din = xq.shape
    h1, h2, dout = ws[0].shape[2], ws[1].shape[2], ws[2].shape[2]
    nbytes = lambda t: t.numel() * t.element_size()          # noqa: E731
    sizes = (din * h1, h1 * h2, h2 * dout)
    layers = lay.cpu().tolist()
    moved = (nbytes(xq) + nbytes(yal) + nbytes(scales) + nbytes(lay)
             + sum(nbytes(f) for f in fb)
             + 2 * (sum(nbytes(w) for w in ws) + sum(nbytes(b) for b in bs))
             + 4 * B + sum(4 * sizes[min(max(l, 0), 2)] for l in layers))
    forward = 2 * S * sum(sizes)
    ops = 0
    for l in layers:
        l = min(max(l, 0), 2)
        H = (h1, h2, dout)[l]
        delta = 2 * S * H * dout if l < 2 else 0
        ops += forward + delta + 2 * S * sizes[l]
    return moved, ops


# -- phases -------------------------------------------------------------------

def phase_device(torch, np):
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision must be 'highest'")
    cudnn = torch.backends.cudnn
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "cudnn_version": cudnn.version(),
          "cudnn_allow_tf32": cudnn.allow_tf32,
          "cudnn_deterministic": cudnn.deterministic,
          "cudnn_benchmark": cudnn.benchmark,
          "conv_fp32": conv_fp32_check(torch, np),
          "profiler_device_rows": profiler_rows_check(torch)})
    return name, smi


def profiler_rows_check(torch):
    """``device_rows`` held to ``key_averages`` at once, on a traced
    range of small products and copies on the card, before any phase
    reads a profile through it: the number of device groups."""
    x = torch.randn(256, 256, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("profiler_rows_check"):
            for _ in range(8):
                x = torch.tanh(x @ x / 256)
            x.cpu()
        torch.cuda.synchronize()
    n = check_device_rows(torch, prof, "profiler_rows_check")
    check(n >= 2, f"profiler_rows_check: {n} device groups")
    return n


def conv_fp32_check(torch, np):
    """The conv nets' forward and gradients on the card against the CPU,
    with cuDNN's global flags as this process found them (TF32 allowed
    by default): the port's convolutions set their own flags (full
    fp32, deterministic algorithms) for the forward and the backward, so
    they agree within 1e-5 of the largest value. Then the second layer
    on a random input, as one plain ``F.conv2d`` under the global flags
    and as the port's ``_Conv``, each against the CPU."""
    import torch.nn.functional as F

    from repro_torch.configs.paper_models import KWS_CONV, OMNIGLOT_CONV
    from repro_torch.models import paper_nets

    with paper_nets._fp32_cudnn():
        c = torch.backends.cudnn
        inside = {"allow_tf32": c.allow_tf32, "deterministic": c.deterministic,
                  "benchmark": c.benchmark, "enabled": c.enabled}
    check(inside == {"allow_tf32": False, "deterministic": True,
                     "benchmark": False, "enabled": True},
          f"the port's conv scope sets {inside}")
    out = {"port_conv_flags": inside}
    for cfg in (KWS_CONV, OMNIGLOT_CONV):
        params = paper_nets.init_paper_model(
            cfg, torch.Generator().manual_seed(0), "cpu")
        r = np.random.default_rng(1)
        x = torch.from_numpy(r.standard_normal((64,) + cfg.input_shape)
                             .astype(np.float32))
        y = torch.from_numpy(r.integers(0, cfg.num_outputs, 64)
                             .astype(np.int32))
        got = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.detach().to(dev).requires_grad_()
                 for k, v in params.items()}
            logits = paper_nets.paper_model_apply(cfg, p, x.to(dev))
            paper_nets.paper_model_loss(cfg, p, {"x": x.to(dev),
                                                 "y": y.to(dev)}).backward()
            got[dev] = (logits.detach().cpu(),
                        {k: v.grad.cpu() for k, v in p.items()})
        scale = got["cpu"][0].abs().max().item()
        err = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
        gerr = max((got["cuda"][1][k] - g).abs().max().item()
                   / max(g.abs().max().item(), 1e-30)
                   for k, g in got["cpu"][1].items())
        check(err <= 1e-5 * scale and gerr <= 1e-5,
              f"{cfg.name}: the conv net on the card is {err} (of {scale}) "
              f"from the CPU, its gradients {gerr} relative: not fp32")
        # the second layer (32 or 64 input channels) on a random input:
        # one plain F.conv2d under the global flags, and the port's _Conv
        h, w, c = paper_nets.conv_shapes(cfg)[0]
        x1 = F.pad(torch.from_numpy(r.standard_normal((64, c, h, w))
                                    .astype(np.float32)),
                   paper_nets.same_pads(w) + paper_nets.same_pads(h))
        w1 = params["conv1"].permute(3, 2, 0, 1).contiguous()
        b1 = torch.zeros(w1.shape[0])
        want = F.conv2d(x1, w1, b1, stride=2)
        layer1 = {}
        for how, conv in (("global_flags", lambda a, b, c: F.conv2d(
                a, b, c, stride=2)), ("port", lambda a, b, c:
                                      paper_nets._Conv.apply(a, b, c, 1))):
            got1 = conv(x1.cuda(), w1.cuda(), b1.cuda()).cpu()
            layer1[f"{how}_conv1_max_abs_err"] = (got1 - want).abs().max() \
                .item()
        check(layer1["port_conv1_max_abs_err"] <= 1e-5
              * want.abs().max().item(),
              f"{cfg.name}: the port's conv1 is not fp32: {layer1}")
        out[cfg.name] = {
            "logits_max_abs_err": err, "logits_max_abs": scale,
            "grad_max_rel_err": gerr, **layer1,
            "conv1_max_abs": want.abs().max().item()}
    return out


BUILD_SOURCES = ("online_sgd", "dfa_epoch_int8", "meta_update", "ssd_scan",
                 "flash_decode", "client_mean")


def start_build(build):
    """One nvcc per CUDA source, all started at once, waited for on a
    thread, so that the device phase runs beside the compilers. Returns
    the thread; ``phase_build`` joins it."""
    def run():
        t0 = time.perf_counter()
        try:
            thread.result = build.build(BUILD_SOURCES)
        except BaseException as e:              # raised in phase_build
            thread.result = e
        thread.nvcc_s = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def phase_build(build, thread):
    """``start_build``'s compilers joined and the libraries loaded.
    Returns ptxas's lines (registers, spills) by source."""
    thread.join()
    reports = thread.result
    if isinstance(reports, BaseException):
        raise reports
    nvcc_s = thread.nvcc_s
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name, rep in reports.items()}
    for name in BUILD_SOURCES:
        build.load(name)
    emit({"phase": "build", "nvcc_s": round(nvcc_s, 3), "ptxas": ptxas})
    return ptxas


def phase_kernels(torch, np, ops, ref):
    from repro_torch.kernels.online_sgd_int8 import \
        dfa_epoch_int8_generic as generic

    dev = torch.device("cuda")
    rows = {}
    g = torch.Generator(device="cpu").manual_seed(0)
    lr = 0.01
    # online_sgd: the quickstart's client (19,208 of its launches), the
    # serving shape, then flat 2^24 in fp32 and bf16; bit for bit
    for tag, shape, dtype in (
            ("quickstart_1x1153_fp32", (1, 1153), torch.float32),
            ("serve_64x1153_fp32", (SLOTS, 1153), torch.float32),
            ("flat_2^24_fp32", (1 << 24,), torch.float32),
            ("flat_2^24_bf16", (1 << 24,), torch.bfloat16)):
        p = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn(shape, generator=g).to(dev, dtype)
        got = ops.online_sgd(p, gr, lr)
        want = ref.online_sgd(p, gr, lr)
        check(torch.equal(got, want), f"online_sgd {tag}: not bit-exact")
        err = (got.float() - want.float()).abs().max().item()
        iters = 200 if p.numel() < 1e6 else 20
        n = p.numel()
        moved = 3 * n * p.element_size()
        bound = 1e3 * max(moved / HBM_BYTES_PER_S, 2 * n / FP32_OPS_PER_S)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
               "tol": "exact", "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.online_sgd(p, gr, lr), iters),
               **device_ms(torch, lambda: ops.online_sgd(p, gr, lr)),
               "plain_ms": cuda_ms(torch, lambda: ref.online_sgd(p, gr, lr),
                                   iters),
               "library_ms": cuda_ms(
                   torch, lambda: torch.add(p, gr, alpha=-lr), iters),
               **device_ms(torch, lambda: torch.add(p, gr, alpha=-lr),
                           "library_device_ms"),
               "bound_ms": bound,
               "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                            >= 2 * n / FP32_OPS_PER_S else "operations")}
        rows[f"online_sgd/{tag}"] = row
        emit({"phase": "kernel", "kernel": "online_sgd", "case": tag, **row})

    # dfa_epoch_int8: the serving shape for each layer and mixed, the
    # S = 512 all-rails envelope, and din > 1 / dout > 1
    cases = [(f"serve_B64_S8_layer{l}", (1, 32, 32, 1), 8, SLOTS, [l], False)
             for l in (0, 1, 2)]
    cases += [("serve_B64_S8_mixed", (1, 32, 32, 1), 8, SLOTS, [0, 1, 2],
               False),
              ("rails_B8_S512", (1, 8, 8, 1), 512, 8, [0, 1, 2], True),
              ("wide_B16_S32", (5, 16, 12, 3), 32, 16, [0, 1, 2], False),
              # the round engine's TIFeD epoch: the launcher's 64 clients
              # at support 32, the sine MLP; its own instantiation
              (ENGINE_DFA, (1, 32, 32, 1), TIFED_SUPPORT, TIFED_CLIENTS,
               [0, 1, 2], False)]
    for i, (tag, dims, S, B, layers, extreme) in enumerate(cases):
        args = tifed_case(torch, np, dims, S, B, 100 + i, layers, dev,
                          extreme)
        gw, gb, gl = ops.dfa_epoch_int8(*args)
        ww, wb, wl = ref.dfa_int8_epoch(*args)
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(gw + gb, ww + wb):
            check(a.dtype == b.dtype, f"dfa {tag}: dtype {a.dtype}")
            err = max(err, (a.long() - b.long()).abs().max().item())
        check(err == 0, f"dfa {tag}: weights/biases differ by {err}")
        torch.testing.assert_close(gl, wl, rtol=1e-6, atol=0)
        rel = ((gl.double() - wl.double()).abs()
               / wl.double().abs().clamp_min(1e-30)).max().item()
        moved, nops = dfa_bytes_ops(args)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S
        row = {"B": B, "S": S, "dims": list(dims), "layers": layers,
               "max_abs_err": err, "loss_max_rel_err": rel,
               "ms": cuda_ms(torch, lambda: ops.dfa_epoch_int8(*args), 100),
               **device_ms(torch, lambda: ops.dfa_epoch_int8(*args)),
               "plain_ms": cuda_ms(torch, lambda: ref.dfa_int8_epoch(*args),
                                   10),
               "library_ms": None, "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "int_ops": nops}
        if tag in (ENGINE_DFA, "serve_B64_S8_mixed"):
            # the specialized instantiation against the generic one on
            # the same operands, in this call (bit-equal first)
            ggw, ggb, ggl = generic(*args)
            check(all(torch.equal(a, b) for a, b in zip(ggw + ggb, gw + gb))
                  and torch.equal(ggl, gl),
                  f"dfa {tag}: the generic instantiation differs")
            row["generic_ms"] = cuda_ms(torch, lambda: generic(*args), 100)
            row.update(device_ms(torch, lambda: generic(*args),
                                 "generic_device_ms"))
        if tag == ENGINE_DFA:
            row["serve_B64_S8_mixed_device_ms"] = rows[
                "dfa_epoch_int8/serve_B64_S8_mixed"]["device_ms"]
        rows[f"dfa_epoch_int8/{tag}"] = row
        emit({"phase": "kernel", "kernel": "dfa_epoch_int8", "case": tag,
              **row})

    # meta_update: the training shape (phi of the sine MLP), then flat
    # 2^24 in fp32 and bf16, each at alpha 0, 0.37, 0.55 and 1 (one
    # fused multiply-add, bit for bit); timed at 0.37
    for tag, n, dtype in (
            ("train_1153_fp32", 1153, torch.float32),
            ("flat_2^24_fp32", 1 << 24, torch.float32),
            ("flat_2^24_bf16", 1 << 24, torch.bfloat16)):
        w = torch.randn(n, generator=g).to(dev, dtype)
        wh = torch.randn(n, generator=g).to(dev, dtype)
        err = 0.0
        for a in (0.0, 0.37, 0.55, 1.0):
            alpha = torch.tensor([a], device=dev)
            got = ops.meta_update(w, wh, alpha)
            want = ref.meta_update(w, wh, alpha)
            check(got.dtype == dtype, f"meta_update {tag}: {got.dtype}")
            check(torch.equal(got, want),
                  f"meta_update {tag} alpha {a}: not bit-exact")
            err = max(err, (got.float() - want.float()).abs().max().item())
        alpha = torch.tensor([0.37], device=dev)
        iters = 200 if n < 1e6 else 20
        moved = 3 * n * w.element_size()
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, 3 * n / FP32_OPS_PER_S
        row = {"n": n, "dtype": str(dtype).split(".")[1], "tol": "exact",
               "alphas": [0.0, 0.37, 0.55, 1.0], "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.meta_update(w, wh, alpha),
                             iters),
               **device_ms(torch, lambda: ops.meta_update(w, wh, alpha)),
               "plain_ms": cuda_ms(
                   torch, lambda: ref.meta_update(w, wh, alpha), iters),
               "library_ms": cuda_ms(
                   torch, lambda: torch.lerp(w, wh, 0.37), iters),
               **device_ms(torch, lambda: torch.lerp(w, wh, 0.37),
                           "library_device_ms"),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows[f"meta_update/{tag}"] = row
        emit({"phase": "kernel", "kernel": "meta_update", "case": tag,
              **row})

    # online_sgd and meta_update at the conv nets' shapes: phi of KWS and
    # of Omniglot (a TinyReptile client's step, the server update), and
    # the (4, P) cohort of KWS Reptile c4 (its clients' step); bit for bit,
    # meta_update at alpha 0, 0.37 and 1
    lr, alpha = 0.01, torch.tensor([0.37], device=dev)
    for tag, shape in (("kws_20612_fp32", (PAPER_PARAMS["kws_conv"],)),
                       ("omniglot_112709_fp32",
                        (PAPER_PARAMS["omniglot_conv"],)),
                       ("kws_c4_4x20612_fp32",
                        (FIG4_CLIENTS, PAPER_PARAMS["kws_conv"]))):
        a = torch.randn(shape, generator=g).to(dev)
        b = torch.randn(shape, generator=g).to(dev)
        n = a.numel()
        for kernel, fn, plain, library, nops in (
                ("online_sgd", lambda: ops.online_sgd(a, b, lr),
                 lambda: ref.online_sgd(a, b, lr),
                 lambda: torch.add(a, b, alpha=-lr), 2 * n),
                ("meta_update", lambda: ops.meta_update(a, b, alpha),
                 lambda: ref.meta_update(a, b, alpha),
                 lambda: torch.lerp(a, b, 0.37), 3 * n)):
            if kernel == "meta_update":
                for x in (0.0, 1.0):
                    at = torch.tensor([x], device=dev)
                    check(torch.equal(ops.meta_update(a, b, at),
                                      ref.meta_update(a, b, at)),
                          f"meta_update {tag} alpha {x}: not bit-exact")
            got, want = fn(), plain()
            check(torch.equal(got, want), f"{kernel} {tag}: not bit-exact")
            moved = 3 * n * 4
            t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
            row = {"shape": list(shape), "dtype": "float32", "tol": "exact",
                   "max_abs_err": 0.0,
                   "ms": cuda_ms(torch, fn, 200),
                   **device_ms(torch, fn),
                   "plain_ms": cuda_ms(torch, plain, 200),
                   "library_ms": cuda_ms(torch, library, 200),
                   **device_ms(torch, library, "library_device_ms"),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": moved}
            rows[f"{kernel}/{tag}"] = row
            emit({"phase": "kernel", "kernel": kernel, "case": tag, **row})

    # online_sgd_momentum: the same sizes; m is fp32 whatever p's dtype;
    # bit for bit
    lr, mu = 0.05, 0.9
    for tag, shape, dtype in (
            ("train_1153_fp32", (1153,), torch.float32),
            ("serve_64x1153_fp32", (SLOTS, 1153), torch.float32),
            ("flat_2^24_fp32", (1 << 24,), torch.float32),
            ("flat_2^24_bf16", (1 << 24,), torch.bfloat16)):
        p = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn(shape, generator=g).to(dev, dtype)
        m = torch.randn(shape, generator=g).to(dev)
        gp, gm = ops.online_sgd_momentum(p, gr, m, lr, mu)
        wp, wm = ref.online_sgd(p, gr, lr, m=m, momentum=mu)
        check(torch.equal(gm, wm) and torch.equal(gp, wp),
              f"online_sgd_momentum {tag}: not bit-exact")
        err = max((gp.float() - wp.float()).abs().max().item(),
                  (gm - wm).abs().max().item())
        n = p.numel()
        iters = 200 if n < 1e6 else 20
        moved = n * (3 * p.element_size() + 2 * 4)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, 4 * n / FP32_OPS_PER_S
        if dtype == torch.float32 and hasattr(torch, "_fused_sgd_"):
            # torch.optim.SGD(momentum=mu, fused=True)'s one call, in
            # place on copies
            lp, lg, lm = p.clone(), gr.clone(), m.clone()

            def fused():
                torch._fused_sgd_(
                    [lp], [lg], [lm], weight_decay=0.0, momentum=mu, lr=lr,
                    dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False)
            library = {"library_ms": cuda_ms(torch, fused, iters),
                       **device_ms(torch, fused, "library_device_ms")}
        else:
            # no one call keeps m fp32 beside bf16 p
            library = {"library_ms": None, "library_device_ms": None}
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
               "tol": "exact", "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.online_sgd_momentum(
                   p, gr, m, lr, mu), iters),
               **device_ms(torch, lambda: ops.online_sgd_momentum(
                   p, gr, m, lr, mu)),
               "plain_ms": cuda_ms(torch, lambda: ref.online_sgd(
                   p, gr, lr, m=m, momentum=mu), iters),
               **library,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved}
        rows[f"online_sgd_momentum/{tag}"] = row
        emit({"phase": "kernel", "kernel": "online_sgd_momentum",
              "case": tag, **row})
    return rows


def ssd_inputs(torch, np, shape, seed, dev):
    """The JAX package's test inputs for the scan, from a NumPy seed."""
    B, H, nc, Q, P, N = shape
    r = np.random.default_rng(seed)
    arrays = (r.standard_normal((B, H, nc, Q, P)),
              -np.abs(r.standard_normal((B, H, nc, Q))) * 0.1,
              r.standard_normal((B, nc, Q, N)) * 0.3,
              r.standard_normal((B, nc, Q, N)) * 0.3)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in arrays)


def ssd_bytes_ops(shape):
    """fp32 operations the scan needs and the bytes it must move (xd, dA,
    Bm, Cm read once, y written once). L is zero above the diagonal, so
    the two in-chunk products count only the Q (Q + 1) / 2 causal pairs:
    C B^T once per (b, c), as the heads share it, and the masked product
    per (b, h, c); the two state products are dense, per (b, h, c)."""
    B, H, nc, Q, P, N = shape
    causal = Q * (Q + 1)                # 2 ops for each of Q (Q + 1) / 2 pairs
    ops = B * nc * causal * N + B * H * nc * (causal * P + 4 * Q * N * P)
    moved = 4 * (2 * B * H * nc * Q * P + B * H * nc * Q + 2 * B * nc * Q * N)
    return ops, moved


def ssd_phases(torch, ref, ssd_module, args):
    """ssd_scan's three kernels, each on its plain phase's inputs, held
    to that phase (2e-4; the cumsum 1e-5) and timed on the device (its
    own kernel only: state_pass also copies its input first); then
    chunk_outputs at every setting of SSD_HEAD_GROUPS, held and timed
    the same way."""
    xd, dA, Bm, Cm = args
    st, cs = ref.ssd_chunk_states(xd, dA, Bm)
    s_in = ref.ssd_state_pass(st, cs)[0]
    out = {}
    for name, fn, want, kernel in (
            ("chunk_states", lambda: ssd_module.chunk_states(xd, dA, Bm),
             (st, cs), "ssd_scan_states"),
            ("state_pass", lambda: (ssd_module.state_pass(st, cs),), (s_in,),
             "ssd_scan_pass"),
            ("chunk_outputs",
             lambda: (ssd_module.chunk_outputs(xd, cs, Bm, Cm, s_in),),
             (ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in),),
             "ssd_scan_outputs")):
        got = fn()
        torch.cuda.synchronize()
        errs = []
        for g, w in zip(got, want):
            tol = 1e-5 if g.shape == cs.shape else SSD_TOL
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            errs.append((g - w).abs().max().item())
        out[name] = {"max_abs_err": max(errs),
                     **device_ms(torch, fn, calls=5, match=kernel)}
    want = ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in)
    by_heads = {}
    for hg in SSD_HEAD_GROUPS:
        fn = lambda: ssd_module.chunk_outputs(xd, cs, Bm, Cm, s_in, hg=hg)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
        by_heads[hg] = {"max_abs_err": (got - want).abs().max().item(),
                        **device_ms(torch, fn, calls=5,
                                    match="ssd_scan_outputs")}
    out["chunk_outputs_by_heads_per_block"] = by_heads
    return out


def phase_kernels_lm(torch, np, ops, ref, rows):
    """ssd_scan at the test shapes, the path's and a 16-chunk sequence
    (with its device kernels a call, heads a block and dynamic shared
    memory per block; at the two large shapes also its three kernels,
    each held to its plain phase and timed); online_sgd and meta_update
    at the LM shape (mamba2-130m's two flat buffers)."""
    from repro_torch.kernels import ssd_scan as ssd_module

    smem_bytes = ssd_module._bind()["smem"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    for i, (tag, shape) in enumerate(SSD_SHAPES):
        args = ssd_inputs(torch, np, shape, 40 + i, dev)
        got = ops.ssd_scan(*args)
        want = ref.ssd_scan(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
        err = (got - want).abs().max().item()
        # every fp32 product is three TF32 tensor-core products (3xTF32)
        nops, moved = ssd_bytes_ops(shape)
        t_ops, t_bytes = 3 * nops / TF32_OPS_PER_S, moved / HBM_BYTES_PER_S
        big = shape[3] >= 256
        row = {"shape_BHncQPN": list(shape), "tol": SSD_TOL,
               "max_abs_err": err, "y_max_abs": want.abs().max().item(),
               "heads_per_block": ssd_module.heads_per_block(*shape[:4], sms),
               "ms": cuda_ms(torch, lambda: ops.ssd_scan(*args),
                             5 if big else 50),
               **device_ms(torch, lambda: ops.ssd_scan(*args),
                           calls=5 if big else 20, match="ssd_scan"),
               "plain_ms": cuda_ms(torch, lambda: ref.ssd_scan(*args),
                                   3 if big else 20),
               "library_ms": None,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops_type": "3xtf32", "fp32_ops": nops, "tf32_ops": 3 * nops,
               "bytes": moved, "smem_bytes": smem_bytes(*shape[3:]),
               "tf32_bound_ms": 1e3 * max(nops / TF32_OPS_PER_S, t_bytes),
               "fp32_ffma_bound_ms": 1e3 * max(nops / FP32_OPS_PER_S,
                                               t_bytes)}
        check(row["kernels_per_call"] == ssd_module.KERNELS_PER_CALL,
              f"ssd_scan {tag}: the profiler reckons "
              f"{row['kernels_per_call']} kernels a call, not "
              f"{ssd_module.KERNELS_PER_CALL}")
        if big:
            row["phases"] = ssd_phases(torch, ref, ssd_module, args)
        rows[f"ssd_scan/{tag}"] = row
        emit({"phase": "kernel", "kernel": "ssd_scan", "case": tag, **row})

    gen = torch.Generator(device="cuda").manual_seed(1)
    alpha = torch.tensor([0.37], device=dev)
    for tag, n, dtype in (("lm_bf16_128981760", LM_BF16, torch.bfloat16),
                          ("lm_fp32_1728", LM_FP32, torch.float32)):
        a, b = (torch.randn(n, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        iters = 20 if n > 1e6 else 200
        moved = 3 * n * a.element_size()
        for kernel, fn, plain, library, nops in (
                ("online_sgd", lambda: ops.online_sgd(a, b, 0.02),
                 lambda: ref.online_sgd(a, b, 0.02),
                 lambda: torch.add(a, b, alpha=-0.02), 2 * n),
                ("meta_update", lambda: ops.meta_update(a, b, alpha),
                 lambda: ref.meta_update(a, b, alpha),
                 lambda: torch.lerp(a, b, 0.37), 3 * n)):
            got, want = fn(), plain()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{kernel} {tag}: not bit-exact")
            t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
            row = {"n": n, "dtype": str(dtype).split(".")[1], "tol": "exact",
                   "max_abs_err": (got.float() - want.float()).abs().max()
                   .item(),
                   "ms": cuda_ms(torch, fn, iters),
                   **device_ms(torch, fn),
                   "plain_ms": cuda_ms(torch, plain, iters),
                   "library_ms": cuda_ms(torch, library, iters),
                   **device_ms(torch, library, "library_device_ms"),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows[f"{kernel}/{tag}"] = row
            emit({"phase": "kernel", "kernel": kernel, "case": tag, **row})
        del a, b
    return rows


def make_requests(np, n, support, query, k_max, seed):
    """Seeded sine requests, drawn as ``launch/serve.py`` draws them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 5.0, n)
    b = rng.uniform(0.0, np.pi, n)
    reqs = []
    for i in range(n):
        sx = rng.uniform(-5, 5, (support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (query, 1)).astype(np.float32)
        k = int(rng.integers(1, k_max + 1))
        reqs.append({"sx": sx, "sy": np.float32(a[i] * np.sin(sx + b[i])),
                     "qx": qx, "qy": np.float32(a[i] * np.sin(qx + b[i])),
                     "k": k})
    return reqs


def serve(server, reqs):
    """Submit ``reqs``, drain, and return the results in request order."""
    rids = [server.submit(r["sx"], r["sy"], r["qx"], r["qy"], r["k"])
            for r in reqs]
    done = {res.rid: res for res in server.drain()}
    check(len(done) == len(rids), f"{len(done)} of {len(rids)} retired")
    return [done[rid] for rid in rids]


def phase_serve(torch, np, mods, name, adapter, phi, reqs, k_max, kernel,
                exact_params):
    MetricsTracker, AdaptationServer, ops = mods
    tracker = MetricsTracker()
    server = AdaptationServer(phi, adapter, slots=SLOTS, k_max=k_max,
                              steps_per_tick=STEPS_PER_TICK, metrics=tracker,
                              device="cuda")
    serve(server, reqs[:1])                 # warm-up
    server.reset()
    tracker = server.metrics = MetricsTracker()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = serve(server, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rid, res in enumerate(got):
        check(res.steps == reqs[rid]["k"],
              f"{name}: request {rid} ran {res.steps} of {reqs[rid]['k']}")
        check(math.isfinite(res.query_loss),
              f"{name}: request {rid} query loss {res.query_loss}")
    check(counts[kernel] >= server.ticks * STEPS_PER_TICK,
          f"{name}: {counts[kernel]} {kernel} launches for {server.ticks} "
          f"ticks x {STEPS_PER_TICK}")
    check(server.trace_count == 1 and server._tick_step.graph is not None,
          f"{name}: the tick was built {server.trace_count} times")

    # the first N_HELD requests, on the card and on the CPU port
    held = reqs[:N_HELD]
    on = {}
    for dev in ("cuda", "cpu"):
        s = AdaptationServer(phi, adapter, slots=SLOTS, k_max=k_max,
                             steps_per_tick=STEPS_PER_TICK,
                             return_params=True, device=dev)
        on[dev] = serve(s, held)
    worst = 0.0
    for rid in range(N_HELD):
        g, c = on["cuda"][rid], on["cpu"][rid]
        check(g.steps == c.steps, f"{name}: request {rid} steps differ")
        for leaf in c.params:
            if exact_params:
                check(np.array_equal(g.params[leaf], c.params[leaf]),
                      f"{name}: request {rid} {leaf} not exact vs CPU")
            else:
                np.testing.assert_allclose(g.params[leaf], c.params[leaf],
                                           rtol=1e-5, atol=1e-5)
            worst = max(worst, float(np.abs(g.params[leaf]
                                            - c.params[leaf]).max()))
        for q in (g.query_loss, got[rid].query_loss):
            np.testing.assert_allclose(q, c.query_loss, rtol=1e-5, atol=1e-5)
    lat = tracker.percentiles("serve.latency_ms")
    row = {"phase": f"serve_{name}", "requests": len(got),
           "slots": SLOTS, "k_max": k_max,
           "steps_per_tick": STEPS_PER_TICK, "ticks": server.ticks,
           "wall_s": wall, "req_per_s": len(got) / wall,
           "latency_ms": lat, "launches": counts,
           "trace_count": server.trace_count,
           "capture_s": server._tick_step.capture_s,
           "graph_nodes": server._tick_step.nodes,
           "mean_query_loss": float(np.mean([r.query_loss
                                             for r in got])),
           "held_vs_cpu": {"requests": N_HELD,
                           "params_max_abs_diff": worst,
                           "params": "exact" if exact_params else "1e-5"}}
    emit(row)
    return row


def phase_profile(torch, np, mods, adapter, phi, reqs):
    """Share of one fp32 drain's wall time the device spends in
    kernels (sum of CUDA kernel self time over the profiled window)."""
    MetricsTracker, AdaptationServer, ops = mods
    server = AdaptationServer(phi, adapter, slots=SLOTS, k_max=K_MAX,
                              steps_per_tick=STEPS_PER_TICK, device="cuda")
    serve(server, reqs[:SLOTS])
    server.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve(server, reqs[:4 * SLOTS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(torch, prof)
    by_name = {k: t for k, t, _ in rows if t > 0}
    dev_us = sum(by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile_fp32", "requests": 4 * SLOTS,
          "wall_ms": 1e3 * wall,
          "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_launched": sum(c for _, _, c in rows),
          "top_device_ms": [[k[:80], v / 1e3] for k, v in top]})


def compare_runs(np, got, want, tol=1e-4):
    """A card run against the same run on the CPU: params and history
    floats within ``tol``, bytes and history keys exact. Returns the
    largest param difference."""
    worst = 0.0
    for k, v in want["params"].items():
        a, b = got["params"][k].cpu().numpy(), v.numpy()
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)
        worst = max(worst, float(np.abs(a - b).max()))
    for key in ("comm_bytes", "per_client_bytes"):
        check(got.get(key) == want.get(key), f"{key} differs from the CPU")
    check(len(got["history"]) == len(want["history"]), "history length")
    for ge, we in zip(got["history"], want["history"]):
        check(set(ge) == set(we), f"history keys {set(ge)} vs {set(we)}")
        for k, v in we.items():
            if isinstance(v, int):
                check(ge[k] == v, f"history {k}: {ge[k]} vs {v}")
            else:
                np.testing.assert_allclose(ge[k], v, rtol=tol, atol=tol,
                                           err_msg=k)
    return worst


def timed_run(torch, ops, fn):
    """``fn()`` on the card with the launch counters set to 0 just
    before and read just after; returns (result, wall seconds, counts)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def built_round(engine):
    """The timed run's round: built (captured) once. The runner cache is
    cleared before a timed run, so its runner is the cache's one entry
    and its one program holds the capture."""
    (runner,) = engine._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1,
          f"the round was built {runner.trace_count} times")
    (prog,) = runner._programs.values()
    check(prog.step.graph is not None, "the round was not captured")
    return {"trace_count": runner.trace_count,
            "capture_s": prog.step.capture_s, "graph_nodes": prog.step.nodes}


def phase_train_tinyreptile(torch, np, tm):
    core, ops, loss, phi = tm["core"], tm["ops"], tm["loss"], tm["phi"]
    base = core.evaluate_init(loss, {k: v.cuda() for k, v in phi.items()},
                              tm["SineTasks"](), np.random.default_rng(7),
                              **TR_EVAL)["query_loss"]
    kw = dict(alpha=1.0, beta=0.02, support=TR_SUPPORT, seed=1,
              eval_kwargs=TR_EVAL)

    def run(rounds, device):
        return core.tinyreptile_train(loss, phi, tm["SineTasks"](),
                                      rounds=rounds, eval_every=rounds,
                                      device=device, **kw)

    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, ops,
                                  lambda: run(TR_ROUNDS, "cuda"))
    graph = built_round(tm["engine"])
    q = out["history"][-1]["query_loss"]
    check(math.isfinite(q) and q < base / 2,
          f"trained query MSE {q} is not below half the random init's "
          f"{base}")
    check(counts["meta_update"] == TR_ROUNDS,
          f"{counts['meta_update']} meta_update launches, {TR_ROUNDS} rounds")
    want_sgd = TR_ROUNDS * TR_SUPPORT + TR_EVAL["k_steps"]
    check(counts["online_sgd"] == want_sgd,
          f"{counts['online_sgd']} online_sgd launches, expected {want_sgd}")
    check(out["comm_bytes"] == TR_ROUNDS * 2 * PHI_BYTES, "comm_bytes")
    worst = compare_runs(np, run(TR_CHECK_ROUNDS, "cuda"),
                         run(TR_CHECK_ROUNDS, "cpu"))
    row = {"phase": "train_tinyreptile", "rounds": TR_ROUNDS,
           "support": TR_SUPPORT, "wall_s": wall,
           "rounds_per_s": TR_ROUNDS / wall, "launches": counts, **graph,
           "query_loss": q, "random_init_query_loss": base,
           "comm_bytes": out["comm_bytes"],
           "vs_cpu": {"rounds": TR_CHECK_ROUNDS, "tol": 1e-4,
                      "params_max_abs_diff": worst}}
    emit(row)
    return row


def launcher_run(torch, np, tm, argv, name):
    """The train launcher in-process on the card (its row is printed),
    then on the CPU; returns this phase's row."""
    tl, ops = tm["train"], tm["ops"]
    tm["core"].clear_runner_cache()
    (row, out), wall, counts = timed_run(
        torch, ops, lambda: tl.run_engine_strategy(tl.parse_args(argv)))
    graph = built_round(tm["engine"])
    _, want = tl.run_engine_strategy(tl.parse_args(argv + ["--device",
                                                           "cpu"]))
    worst = compare_runs(np, out, want)
    q = out["history"][-1]["query_loss"]
    check(math.isfinite(q), f"{name}: query loss {q}")
    return {"run": name, "argv": argv, "rounds": row["rounds"],
            "clients": row["clients"], "wall_s": wall,
            "rounds_per_s": row["rounds"] / wall, "launches": counts,
            **graph, "query_loss": q, "comm_bytes": out.get("comm_bytes"),
            "vs_cpu_params_max_abs_diff": worst}


def phase_train_reptile(torch, np, tm):
    row = launcher_run(torch, np, tm, ["--strategy", "reptile"],
                       "reptile_c64")
    rounds, clients = row["rounds"], row["clients"]
    check(row["comm_bytes"] == rounds * clients * 2 * PHI_BYTES,
          f"comm_bytes {row['comm_bytes']}")
    check(row["launches"]["meta_update"] == rounds, "meta_update launches")
    want_sgd = rounds * tm["train"].EPOCHS + \
        tm["train"].EVAL_KWARGS["k_steps"]
    check(row["launches"]["online_sgd"] == want_sgd,
          f"{row['launches']['online_sgd']} online_sgd launches, "
          f"expected {want_sgd}")
    emit({"phase": "train_reptile_c64", **row})
    return row


def phase_train_baselines(torch, np, tm):
    runs = [launcher_run(torch, np, tm, ["--strategy", s], s)
            for s in ("fedavg", "fedsgd", "transfer")]
    core, loss, phi = tm["core"], tm["loss"], tm["phi"]
    ev = tm["train"].EVAL_KWARGS

    def straggle(device):
        return core.tinyreptile_train(
            loss, phi, tm["SineTasks"](), rounds=20, beta=0.02,
            support=TR_SUPPORT, clients_per_round=8,
            sampling=core.StragglerSampling(0.5), eval_every=20,
            eval_kwargs=ev, device=device)

    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, tm["ops"],
                                  lambda: straggle("cuda"))
    check(counts["meta_update"] == 20, "meta_update launches")
    check(counts["client_mean"] == 20, "client_mean launches")
    runs.append({"run": "tinyreptile_c8_straggler0.5", "rounds": 20,
                 "clients": 8, "wall_s": wall, "rounds_per_s": 20 / wall,
                 "launches": counts, **built_round(tm["engine"]),
                 "query_loss": out["history"][-1]["query_loss"],
                 "comm_bytes": out["comm_bytes"],
                 "vs_cpu_params_max_abs_diff": compare_runs(
                     np, out, straggle("cpu"))})
    for r in runs:
        check(r["launches"]["online_sgd"] > 0,
              f"{r['run']}: no online_sgd launch")
    emit({"phase": "train_baselines", "runs": runs})
    return runs


def phase_profile_train(torch, tm):
    """Device busy share of TR_CHECK_ROUNDS TinyReptile rounds, after a
    run of the same config has built (captured) its round."""
    core, loss, phi = tm["core"], tm["loss"], tm["phi"]

    def run():
        return core.tinyreptile_train(loss, phi, tm["SineTasks"](),
                                      rounds=TR_CHECK_ROUNDS, beta=0.02,
                                      support=TR_SUPPORT, seed=1,
                                      device="cuda")

    run()
    # the device's activity only: the host-side op events of some 50k
    # launches would take longer to summarise than the run itself
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_train", "rounds": TR_CHECK_ROUNDS,
          "wall_ms": 1e3 * wall, "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_launched": sum(c for _, c in by_name.values()),
          "top_device_ms": [[k[:80], t / 1e3, c] for k, (t, c) in top]})


def phase_fleet_tifed(torch, np, tm):
    """The train launcher's ``--strategy tifed`` at its defaults on the
    card and on the CPU: integer params exact, bytes exact, the int8
    loss within 1e-6, the eval within 1e-4; one build; every epoch of
    the cohort one ``dfa_epoch_int8`` launch."""
    tl, ops = tm["train"], tm["ops"]
    argv = ["--strategy", "tifed"]
    tm["core"].clear_runner_cache()
    (row, out), wall, counts = timed_run(
        torch, ops, lambda: tl.run_engine_strategy(tl.parse_args(argv)))
    graph = built_round(tm["engine"])
    _, want = tl.run_engine_strategy(tl.parse_args(argv + ["--device",
                                                           "cpu"]))
    rounds, clients = row["rounds"], row["clients"]
    check((rounds, clients) == (20, TIFED_CLIENTS),
          f"tifed launcher defaults: {rounds} rounds, {clients} clients")
    for k, v in want["params"].items():
        check(torch.equal(out["params"][k].cpu(), v),
              f"fleet_tifed: integer param {k} differs from the CPU")
    for key in ("comm_bytes", "per_client_bytes"):
        check(out[key] == want[key], f"fleet_tifed: {key}")
    check(out["comm_bytes"] == rounds * clients * 2 * PAPER_PARAMS[
        "sine_mlp"], f"fleet_tifed: comm_bytes {out['comm_bytes']}")
    (ge,), (we,) = out["history"], want["history"]
    loss_rel = abs(ge["inner_loss"] - we["inner_loss"]) / abs(
        we["inner_loss"])
    check(loss_rel <= 1e-6, f"fleet_tifed: inner loss {ge['inner_loss']} "
          f"vs {we['inner_loss']}")
    check(abs(ge["query_loss"] - we["query_loss"]) <= 1e-4 * max(
        1.0, abs(we["query_loss"])), "fleet_tifed: query loss")
    want_counts = {"dfa_epoch_int8": rounds * TIFED_EPOCHS,
                   "meta_update": rounds,
                   "online_sgd": tl.EVAL_KWARGS["k_steps"]}
    check_launches("fleet_tifed", counts, want_counts)
    emit({"phase": "fleet_tifed", "argv": argv, "rounds": rounds,
          "clients": clients, "support": tl.SUPPORT, "epochs": TIFED_EPOCHS,
          "wall_s": wall, "rounds_per_s": rounds / wall, "launches": counts,
          **graph, "query_loss": ge["query_loss"],
          "inner_loss": ge["inner_loss"], "inner_loss_rel_vs_cpu": loss_rel,
          "comm_bytes": out["comm_bytes"], "params_vs_cpu": "exact"})
    return {"fleet_tifed": counts}


def phase_fleet_partial(torch, np, tm):
    """TinyReptile at 64 clients on PartialCommChannel(0.25), the mask
    fixed and rotating: PARTIAL_ROUNDS rounds each on the card (bills
    exact, launches as reckoned), and the same config's first
    FLEET_CHECK_ROUNDS on the card and on the CPU (params within 1e-4,
    bills exact)."""
    core, phi = tm["core"], tm["phi"]
    rows, paths = [], {}
    for rotate in (False, True):
        channel = core.PartialCommChannel(fraction=PARTIAL_FRACTION,
                                          rotate=rotate)
        run = functools.partial(partial_run, tm, rotate)
        name = f"fleet_partial_{'rotating' if rotate else 'fixed'}"
        core.clear_runner_cache()
        out, wall, counts = timed_run(
            torch, tm["ops"], lambda: run(PARTIAL_ROUNDS, "cuda"))
        graph = built_round(tm["engine"])
        want_bytes = sum(2 * PARTIAL_CLIENTS * channel.payload_bytes_at(
            phi, r) for r in range(PARTIAL_ROUNDS))
        check(out["comm_bytes"] == want_bytes == sum(
            out["per_client_bytes"]),
            f"{name}: comm_bytes {out['comm_bytes']} vs {want_bytes}")
        check_launches(name, counts, {
            "online_sgd": PARTIAL_ROUNDS * TR_SUPPORT + TR_EVAL["k_steps"],
            "meta_update": PARTIAL_ROUNDS})
        q = out["history"][-1]["query_loss"]
        check(math.isfinite(q), f"{name}: query loss {q}")
        worst = compare_runs(np, run(FLEET_CHECK_ROUNDS, "cuda"),
                             tm["refs"].take("partial", rotate))
        rows.append({"run": name, "fraction": PARTIAL_FRACTION,
                     "rotation_period": (channel.rotation_period if rotate
                                         else None),
                     "rounds": PARTIAL_ROUNDS, "clients": PARTIAL_CLIENTS,
                     "wall_s": wall, "rounds_per_s": PARTIAL_ROUNDS / wall,
                     "launches": counts, **graph, "query_loss": q,
                     "comm_bytes": out["comm_bytes"],
                     "full_wire_bytes": PARTIAL_ROUNDS * PARTIAL_CLIENTS * 2
                     * PHI_BYTES,
                     "vs_cpu": {"rounds": FLEET_CHECK_ROUNDS, "tol": 1e-4,
                                "params_max_abs_diff": worst}})
        paths[name] = counts
    emit({"phase": "fleet_partial", "runs": rows})
    return paths


def partial_run(tm, rotate, rounds, device):
    """fleet_partial's run: TinyReptile at PARTIAL_CLIENTS clients on
    PartialCommChannel(PARTIAL_FRACTION), the mask fixed or rotating."""
    core = tm["core"]
    return core.tinyreptile_train(
        tm["loss"], tm["phi"], tm["SineTasks"](), rounds=rounds, beta=0.02,
        support=TR_SUPPORT, clients_per_round=PARTIAL_CLIENTS, seed=5,
        channel=core.PartialCommChannel(fraction=PARTIAL_FRACTION,
                                        rotate=rotate),
        eval_every=rounds, eval_kwargs=TR_EVAL, device=device)


def pool_run(tm, size, rounds, residency, device):
    """The sine MLP's TinyReptile over a fresh vectorized pool of ``size``
    devices: a cohort of POOL_COHORT under diurnal check-ins, a FedBuff
    buffer with a staleness deadline, one eval at the end."""
    core = tm["core"]
    pool = core.ClientPool(tm["SineTasks"](), size, seed=2,
                           sampler="vectorized", residency=residency)
    return core.tinyreptile_train(
        tm["loss"], tm["phi"], tm["SineTasks"](), rounds=rounds, beta=0.02,
        support=TR_SUPPORT, clients_per_round=POOL_COHORT, seed=2,
        sampling=core.DiurnalAvailability(period=POOL_PERIOD,
                                          sampler="vectorized"),
        pool=pool, buffered=core.BufferedAggregation(
            POOL_BUFFER, flush_staleness=POOL_DEADLINE),
        eval_every=rounds, eval_kwargs=TR_EVAL, device=device)


def sine_tm():
    """What ``pool_run`` and ``pool_drift`` take from ``tm``, built from the
    ``repro_torch`` on sys.path: the port's modules and the seeded sine
    MLP init of ``main``. On the CPU, with a checkout's ``src`` first on
    PYTHONPATH:
    python -c "import chip_smoke as s, torch; s.pool_drift(torch, s.sine_tm(), 'cpu')"
    """
    import torch

    from repro_torch import core
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.data import SineTasks
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)
    return {"core": core, "SineTasks": SineTasks,
            "loss": functools.partial(paper_model_loss, SINE_MLP),
            "phi": init_paper_model(SINE_MLP,
                                    torch.Generator().manual_seed(0), "cpu")}


def run_drift(a, b):
    """The largest param and history-float differences of two runs."""
    return {"params_max_abs_diff": max(
                float((a["params"][k].cpu() - b["params"][k].cpu()).abs()
                      .max()) for k in a["params"]),
            "history_max_abs_diff": max(
                abs(x[k] - y[k]) for x, y in zip(a["history"], b["history"])
                for k in x if isinstance(x[k], float))}


def pool_drift(torch, tm, device):
    """How far a last-bit difference grows in fleet_pool's runs: each run
    from the seeded init and from it with one ulp added to every weight,
    on ``device`` (POOL_SIZE devices for each of POOL_DRIFT_ROUNDS,
    POOL_BIG in host slabs for POOL_BIG_ROUNDS), and on the card each
    POOL_SIZE run against the CPU's too (the worker's run, from
    ``tm["refs"]``). Reported, not gated: emits and returns the rows."""
    bumped = dict(tm, phi={k: torch.nextafter(v, torch.full_like(v, math.inf))
                           for k, v in tm["phi"].items()})
    cases = [(POOL_SIZE, r, "device") for r in POOL_DRIFT_ROUNDS]
    rows = []
    for size, rounds, residency in cases + [(POOL_BIG, POOL_BIG_ROUNDS,
                                             "host")]:
        a = pool_run(tm, size, rounds, residency, device)
        row = {"pool_size": size, "rounds": rounds, "residency": residency,
               "device": device, "one_ulp": run_drift(
                   a, pool_run(bumped, size, rounds, residency, device))}
        if device != "cpu" and residency == "device":
            row["vs_cpu"] = run_drift(
                a, tm["refs"].take("pool", size, rounds, residency))
        rows.append(row)
        emit({"phase": "fleet_pool_drift", **row})
    return rows


def replay_pool_state(np, tm, size, rounds):
    """``pool_run``'s identity state replayed on the host from its plan
    alone (the pool draws its data from its own streams, so the run's
    generator serves the plan only): last_seen, staleness, checkins."""
    core = tm["core"]
    policy = core.DiurnalAvailability(period=POOL_PERIOD,
                                      sampler="vectorized")
    rng = np.random.default_rng(2)
    last = np.full(size, -1, np.int64)
    stale = np.zeros(size, np.int64)
    seen = np.zeros(size, np.int64)
    for start, end in core.plan_blocks(rounds, rounds, 512)[0]:
        plan = policy.plan_pool_schedule(rng, start, end, POOL_COHORT,
                                         TR_SUPPORT, size)
        for j, r in enumerate(range(start, end)):
            m = plan["cohort"][j][plan["participation"][j]]
            stale[m] = r - last[m]
            last[m] = r
            seen[m] += 1
    return {"last_seen": last, "staleness": stale, "checkins": seen}


def phase_fleet_pool(torch, np, tm):
    """The persistent pool on the card: POOL_SIZE devices resident on the
    card for POOL_ROUNDS rounds (the pool state equal to a host replay of
    the plan, bills exact, one build, launches as reckoned: every round,
    no-show or not, replays the whole round, its 32 online_sgd and the
    FedBuff flush's meta_update), its first POOL_CHECK_ROUNDS against
    the CPU, then POOL_BIG devices with their state in host slabs for
    POOL_BIG_ROUNDS against the CPU (pool state exact, params within
    1e-4); then FLEET_PROFILE_ROUNDS replayed rounds under the profiler,
    and pool_drift on the card."""
    core = tm["core"]
    rows, paths = [], {}
    for name, size, rounds, residency, check_rounds in (
            ("fleet_pool", POOL_SIZE, POOL_ROUNDS, "device",
             POOL_CHECK_ROUNDS),
            ("fleet_pool_host", POOL_BIG, POOL_BIG_ROUNDS, "host",
             POOL_BIG_ROUNDS)):
        core.clear_runner_cache()
        out, wall, counts = timed_run(
            torch, tm["ops"],
            lambda: pool_run(tm, size, rounds, residency, "cuda"))
        graph = built_round(tm["engine"])
        ps = out["pool_state"]
        for k, v in replay_pool_state(np, tm, size, rounds).items():
            check(np.array_equal(ps[k], v),
                  f"{name}: pool state {k} differs from the plan's replay")
        checkins = int(ps["checkins"].sum())
        check(out["comm_bytes"] == 2 * PHI_BYTES * checkins,
              f"{name}: comm_bytes against {checkins} check-ins")
        check_launches(name, counts, {
            "online_sgd": rounds * TR_SUPPORT + TR_EVAL["k_steps"],
            "meta_update": rounds, "client_mean": rounds})
        got = (out if check_rounds == rounds else
               pool_run(tm, size, check_rounds, residency, "cuda"))
        want = tm["refs"].take("pool", size, check_rounds, residency)
        worst = compare_runs(np, got, want)
        for k, v in want["pool_state"].items():
            check(np.array_equal(np.asarray(got["pool_state"][k]),
                                 np.asarray(v)),
                  f"{name}: pool state {k} differs from the CPU")
        seen = ps["checkins"] > 0
        rows.append({"run": name, "pool_size": size, "residency": residency,
                     "rounds": rounds, "cohort": POOL_COHORT,
                     "wall_s": wall, "rounds_per_s": rounds / wall,
                     "launches": counts, **graph,
                     "query_loss": out["history"][-1]["query_loss"],
                     "checkins": checkins,
                     "devices_seen": int(seen.sum()),
                     "staleness_max": int(ps["staleness"].max()),
                     "flushes": ps["flushes"],
                     "buffered_pending": ps["buffered_pending"],
                     "comm_bytes": out["comm_bytes"],
                     "pool_state_vs_replay": "exact",
                     "vs_cpu": {"rounds": check_rounds, "tol": 1e-4,
                                "params_max_abs_diff": worst,
                                "pool_state": "exact"}})
        paths[name] = counts
    rows.append(profile_fleet(torch, tm))
    emit({"phase": "fleet_pool", "runs": rows})
    pool_drift(torch, tm, "cuda")
    return paths


def profile_fleet(torch, tm):
    """FLEET_PROFILE_ROUNDS pooled, buffered rounds (POOL_SIZE devices),
    after a run of the same config has built (captured) the round, under
    torch.profiler (device activity only): idle share, kernels a round,
    top kernels."""
    run = functools.partial(pool_run, tm, POOL_SIZE, FLEET_PROFILE_ROUNDS,
                            "device", "cuda")
    tm["core"].clear_runner_cache()
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (runner,) = tm["engine"]._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1, "the profiled pooled round was built "
          "again")
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n = sum(c for _, c in by_name.values())
    return {"run": "profile_fleet", "rounds": FLEET_PROFILE_ROUNDS,
            "replayed": True, "wall_ms": 1e3 * wall,
            "round_ms": 1e3 * wall / FLEET_PROFILE_ROUNDS,
            "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e6 / wall,
            "kernels_per_round": n / FLEET_PROFILE_ROUNDS,
            "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                           for k, (t, c) in top]}


def phase_fleet_kws(torch, np, tm):
    """The port's KWS example with its persistent fleet (KWS_FLEET) on
    the card and on the CPU, its printout kept out of this script's:
    each run's accuracy within one query sample of the CPU's, the pool
    state and bills exact."""
    kws = tm["kws"]
    tm["core"].clear_runner_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        got, wall, counts = timed_run(
            torch, tm["ops"], lambda: kws.main(KWS_FLEET + ["--device",
                                                            "cuda"]))
        out = {"cuda": got, "cpu": tm["refs"].take("kws")}
    one = 1.0 / (kws.EVAL["num_tasks"] * kws.EVAL["query"])
    accs = {}
    for run in ("tinyreptile", "fleet"):
        g, w = (out[d][run]["history"][-1]["query_metric"]
                for d in ("cuda", "cpu"))
        check(abs(g - w) <= one + 1e-9,
              f"fleet_kws {run}: accuracy {g} on the card, {w} on the CPU")
        accs[run] = {"cuda": g, "cpu": w}
    fleet, ref = out["cuda"]["fleet"], out["cpu"]["fleet"]
    for key in ("comm_bytes", "per_client_bytes"):
        check(fleet[key] == ref[key], f"fleet_kws: {key}")
    for k, v in ref["pool_state"].items():
        check(np.array_equal(np.asarray(fleet["pool_state"][k]),
                             np.asarray(v)), f"fleet_kws: pool state {k}")
    ps = fleet["pool_state"]
    rounds = kws.parse_args(KWS_FLEET).rounds
    check(counts["meta_update"] == 2 * rounds,
          f"fleet_kws: {counts['meta_update']} meta_update launches")
    check(counts["client_mean"] == rounds,
          f"fleet_kws: {counts['client_mean']} client_mean launches")
    emit({"phase": "fleet_kws", "argv": KWS_FLEET, "rounds": rounds,
          "wall_s": wall, "launches": counts, "accuracy": accs,
          "one_sample": one, "random_init": out["cuda"]["random_init"],
          "checkins": int(ps["checkins"].sum()),
          "devices_seen": int((ps["checkins"] > 0).sum()),
          "flushes": ps["flushes"],
          "buffered_pending": ps["buffered_pending"],
          "comm_bytes": fleet["comm_bytes"]})
    return {"fleet_kws": counts}


def same_run(torch, np, got, want, tag):
    """Two runs equal exactly: params, history rows (compared with ==:
    a row that went through a snapshot's JSON keeps its floats), bills
    and the pool state."""
    for k, v in want["params"].items():
        check(torch.equal(got["params"][k], v), f"{tag}: param {k} differs")
    check(got["history"] == want["history"],
          f"{tag}: history {got['history']} vs {want['history']}")
    for key in ("comm_bytes", "per_client_bytes"):
        check(got.get(key) == want.get(key), f"{tag}: {key} differs")
    check(("pool_state" in got) == ("pool_state" in want), f"{tag}: pool")
    for k, v in want.get("pool_state", {}).items():
        a, b = np.asarray(got["pool_state"][k]), np.asarray(v)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"{tag}: pool state {k} differs")


def ckpt_launches(name, rounds, start, tl):
    """The launches a run of ``ckpt_cases`` makes from round ``start``:
    per round ``TR_SUPPORT`` online_sgd (one a step for the cohort) or
    ``TIFED_EPOCHS`` dfa_epoch_int8, and one meta_update (a buffered run
    computes its flush every round, and with it one client_mean); each
    eval past ``start`` adds its finetuning steps."""
    every = CKPT_POOL_ROUNDS // 2 if "pool" in name else CKPT_EVAL_EVERY
    evals = sum(1 for r in range(start + 1, rounds + 1) if r % every == 0)
    n = rounds - start
    if name.startswith("tifed"):
        return {"dfa_epoch_int8": n * TIFED_EPOCHS, "meta_update": n,
                "online_sgd": evals * tl.EVAL_KWARGS["k_steps"]}
    want = {"online_sgd": n * TR_SUPPORT + evals * TR_EVAL["k_steps"],
            "meta_update": n}
    if "pool" in name:
        want["client_mean"] = n
    return want


def ckpt_cases(tm):
    """The crash/resume cases on the card, each ``run(**ckpt)`` one
    run_federated call with fresh pool and policy objects: TinyReptile
    at the launcher's 64 clients, TIFeD at the launcher's defaults
    (alpha 1 annealed), and the pooled fleet on the card and in host
    slabs."""
    core, tl = tm["core"], tm["train"]
    sine = tm["SineTasks"]

    def tinyreptile(rounds=CKPT_ROUNDS, anneal=True, **ckpt):
        return core.run_federated(
            tm["phi"], sine(), core.TinyReptileStrategy(tm["loss"]),
            rounds=rounds, clients_per_round=TIFED_CLIENTS,
            support=TR_SUPPORT, beta=0.02, seed=11, anneal=anneal,
            eval_every=CKPT_EVAL_EVERY, eval_kwargs=TR_EVAL, device="cuda",
            **ckpt)

    def tifed(**ckpt):
        return core.run_federated(
            tm["phi"], sine(), core.TifedStrategy(tm["nets"].relu_mlp_loss,
                                                  epochs=TIFED_EPOCHS),
            rounds=CKPT_ROUNDS, clients_per_round=TIFED_CLIENTS,
            support=TIFED_SUPPORT, beta=0.02, seed=0,
            eval_every=CKPT_EVAL_EVERY,
            eval_kwargs=dict(tl.EVAL_KWARGS, lr=tl.TIFED_EVAL_LR),
            channel=core.CommChannel("int8", quantize=False),
            device="cuda", **ckpt)

    def fleet(residency, markov):
        def run(**ckpt):
            pool = core.ClientPool(sine(), POOL_SIZE, seed=2,
                                   sampler="vectorized", residency=residency)
            sampling = (core.MarkovAvailability(sampler="vectorized")
                        if markov else core.DiurnalAvailability(
                            period=POOL_PERIOD, sampler="vectorized"))
            return core.run_federated(
                tm["phi"], sine(), core.TinyReptileStrategy(tm["loss"]),
                rounds=CKPT_POOL_ROUNDS, clients_per_round=POOL_COHORT,
                support=TR_SUPPORT, beta=0.02, seed=2, sampling=sampling,
                pool=pool, buffered=core.BufferedAggregation(
                    POOL_BUFFER, flush_staleness=POOL_DEADLINE),
                eval_every=CKPT_POOL_ROUNDS // 2, eval_kwargs=TR_EVAL,
                device="cuda", **ckpt)
        return run

    return {"tinyreptile_c64": (tinyreptile, CKPT_ROUNDS),
            "tifed_c64": (tifed, CKPT_ROUNDS),
            "pool_diurnal_fedbuff": (fleet("device", False),
                                     CKPT_POOL_ROUNDS),
            "pool_host_markov_fedbuff": (fleet("host", True),
                                         CKPT_POOL_ROUNDS)}


def snapshot_files(np, d):
    """Each snapshot's arrays by step (``__extra__`` included)."""
    from repro_torch.checkpoint import list_checkpoints
    out = {}
    for path in list_checkpoints(d):
        with np.load(path) as z:
            out[int(Path(path).stem[5:])] = {k: z[k] for k in z.files}
    return out


def phase_ckpt_resume(torch, np, tm):
    """Crash and resume on the card: for each case an uninterrupted run
    (snapshots by the async writer, each block following its snapshot at
    once), a run crashed right after its round-4 snapshot
    (``ckpt_async=False``) and its resume, all with ckpt_every 4 in one
    process: the resumed run equals the uninterrupted one exactly
    (params, history, bills, pool state), and the config's round was
    built once. The async writer's files equal those a synchronous run
    writes, and a run resumed past its horizon (16 -> 24 rounds, no
    annealing) equals a 24-round run."""
    from repro_torch.testing import faults

    core, engine = tm["core"], tm["engine"]
    rows, paths, refs = [], {}, {}
    for name, (run, rounds) in ckpt_cases(tm).items():
        core.clear_runner_cache()
        with tempfile.TemporaryDirectory() as d:
            ck = dict(ckpt_every=CKPT_EVERY)
            ref, ref_wall, _ = timed_run(
                torch, tm["ops"], lambda: run(ckpt_dir=f"{d}/ref", **ck))
            try:
                with faults.crash_at_round(CKPT_EVERY):
                    run(ckpt_dir=f"{d}/ck", ckpt_async=False, **ck)
                check(False, f"ckpt_resume {name}: the crash never fired")
            except faults.SimulatedPreemption:
                pass
            res, wall, counts = timed_run(
                torch, tm["ops"],
                lambda: run(ckpt_dir=f"{d}/ck", resume=True, **ck))
            same_run(torch, np, res, ref, f"ckpt_resume {name}")
            check_launches(f"ckpt_resume {name}", counts, ckpt_launches(
                name, rounds, CKPT_EVERY, tm["train"]))
            row = {"run": name, "rounds": rounds, "ckpt_every": CKPT_EVERY,
                   "crash_after": CKPT_EVERY,
                   "uninterrupted_wall_s": ref_wall, "resume_wall_s": wall,
                   "launches": counts, **built_round(engine),
                   "cache": core.runner_cache_stats(),
                   "vs_uninterrupted": "exact"}
            if name == "tinyreptile_c64":
                run(ckpt_dir=f"{d}/sync", ckpt_async=False, **ck)
                want = snapshot_files(np, f"{d}/sync")
                got = snapshot_files(np, f"{d}/ref")
                check(sorted(got) == sorted(want),
                      f"ckpt_resume: snapshots {sorted(got)} vs "
                      f"{sorted(want)}")
                for step, arrays in want.items():
                    for k, v in arrays.items():
                        check(np.array_equal(got[step][k], v),
                              f"ckpt_resume: async snapshot {step} {k} "
                              f"differs from the synchronous one")
                row["async_snapshots_vs_sync"] = sorted(want)
                refs[name] = ref
            if "pool" in name:
                ps = res["pool_state"]
                row.update(pool_size=POOL_SIZE,
                           checkins=int(ps["checkins"].sum()),
                           flushes=ps["flushes"])
        rows.append(row)
        paths[f"ckpt_resume_{name}"] = counts

    # past the horizon: 16 rounds, resumed to 24, against 24 from round 0
    tiny = ckpt_cases(tm)["tinyreptile_c64"][0]
    core.clear_runner_cache()
    with tempfile.TemporaryDirectory() as d:
        ck = dict(ckpt_every=CKPT_EVERY, anneal=False)
        tiny(ckpt_dir=f"{d}/ck", ckpt_async=False, **ck)
        res, wall, counts = timed_run(torch, tm["ops"], lambda: tiny(
            rounds=CKPT_PAST, ckpt_dir=f"{d}/ck", resume=True, **ck))
        want = tiny(rounds=CKPT_PAST, ckpt_dir=f"{d}/fresh", **ck)
        same_run(torch, np, res, want, "ckpt_resume past_horizon")
        check_launches("ckpt_resume past_horizon", counts, ckpt_launches(
            "tinyreptile", CKPT_PAST, CKPT_ROUNDS, tm["train"]))
        rows.append({"run": "past_horizon", "rounds": [CKPT_ROUNDS,
                                                       CKPT_PAST],
                     "resume_wall_s": wall, "launches": counts,
                     **built_round(engine), "vs_fresh": "exact"})
    paths["ckpt_resume_past_horizon"] = counts
    emit({"phase": "ckpt_resume", "runs": rows})
    return paths, refs["tinyreptile_c64"]


#: the SIGKILL child: the TinyReptile case with the async writer, each
#: durable snapshot announced; the writer then holds (a slow disk), so
#: the kill lands while the run is still going however fast the card is
CKPT_CHILD = """
import functools, sys, time
import torch
sys.path.insert(0, sys.argv[2])
from repro_torch import core
from repro_torch.checkpoint import ckpt
from repro_torch.configs.paper_models import SINE_MLP
from repro_torch.data import SineTasks
from repro_torch.models.paper_nets import init_paper_model, paper_model_loss
from repro_torch.testing import faults
phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
kw = {kw}
with faults.announce_snapshots():
    announce = ckpt._post_save_hook
    def hold(step):
        announce(step)
        time.sleep(600)
    ckpt._post_save_hook = hold
    core.run_federated(phi, SineTasks(), core.TinyReptileStrategy(
        functools.partial(paper_model_loss, SINE_MLP)), ckpt_dir=sys.argv[1],
        device="cuda", **kw)
"""


def phase_ckpt_sigkill(torch, np, tm, ref):
    """A real preemption on the card: a child process (started with
    ``subprocess``, so it shares no CUDA context) runs the TinyReptile
    case with the async writer and is SIGKILLed right after its first
    durable snapshot; its kernels were built by this process, so it
    builds none. This process resumes from whatever is on disk and must
    equal the uninterrupted card run exactly."""
    from repro_torch.kernels import build
    from repro_torch.testing import faults

    kw = dict(rounds=CKPT_ROUNDS, clients_per_round=TIFED_CLIENTS,
              support=TR_SUPPORT, beta=0.02, seed=11,
              eval_every=CKPT_EVAL_EVERY, eval_kwargs=TR_EVAL,
              ckpt_every=CKPT_EVERY)
    libs = sorted(build.BUILD_DIR.glob("*.so"))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rc, out = faults.kill_after_snapshot(
            [sys.executable, "-c", CKPT_CHILD.format(kw=kw), d, str(SRC)],
            n=1, timeout=300)
        child_s = time.perf_counter() - t0
        check(rc is not None and rc != 0,
              f"ckpt_sigkill: the child exited {rc}, not killed:\n{out}")
        check(faults.SNAPSHOT_TAG in out, "ckpt_sigkill: no snapshot line")
        check(sorted(build.BUILD_DIR.glob("*.so")) == libs,
              "ckpt_sigkill: the child built kernels")
        from repro_torch.checkpoint import list_checkpoints
        on_disk = [Path(p).name for p in list_checkpoints(d)]
        tm["core"].clear_runner_cache()
        res, wall, counts = timed_run(
            torch, tm["ops"], lambda: ckpt_cases(tm)["tinyreptile_c64"][0](
                ckpt_dir=d, resume=True, ckpt_every=CKPT_EVERY))
    same_run(torch, np, res, ref, "ckpt_sigkill")
    start = max(int(Path(p).stem[5:]) for p in on_disk)
    check_launches("ckpt_sigkill", counts, ckpt_launches(
        "tinyreptile", CKPT_ROUNDS, start, tm["train"]))
    emit({"phase": "ckpt_sigkill", "child_rc": rc, "child_s": child_s,
          "snapshots_on_disk": on_disk,
          "announced": [ln for ln in out.splitlines()
                        if faults.SNAPSHOT_TAG in ln],
          "resume_wall_s": wall, "launches": counts,
          **built_round(tm["engine"]), "vs_uninterrupted": "exact"})
    return {"ckpt_sigkill_resume": counts}


def phase_ckpt_overhead(torch, np, tm):
    """What snapshots cost: the quickstart-shaped 600-round TinyReptile
    run without and with ckpt_every 10 (the async writer), both built
    first, then timed in turns; rounds/s of each, their ratio, and with
    a tracker attached to one more snapshotting run, the milliseconds of
    a snapshot on the training thread (device copies and the submit) and
    on the writer's. The JAX package's target is under 5% at every 10
    rounds; this is reported, not gated. The two runs' params are equal
    (snapshots change the block cuts, not the rounds)."""
    core = tm["core"]

    def run(d=None, tracker=None):
        return core.run_federated(
            tm["phi"], tm["SineTasks"](),
            core.TinyReptileStrategy(tm["loss"]), rounds=TR_ROUNDS,
            support=TR_SUPPORT, beta=0.02, seed=1, eval_every=TR_ROUNDS,
            eval_kwargs=TR_EVAL, ckpt_dir=d, ckpt_every=OVERHEAD_EVERY,
            tracker=tracker, device="cuda")

    core.clear_runner_cache()
    walls = {"base": [], "ckpt": []}
    with tempfile.TemporaryDirectory() as d:
        base, ckpt = run(), run(f"{d}/warm")           # build both rounds
        same_run(torch, np, ckpt, base, "ckpt_overhead: ckpt vs base")
        for i in range(OVERHEAD_PAIRS):
            for kind in ("base", "ckpt"):
                _, wall, _ = timed_run(torch, tm["ops"], lambda: run(
                    f"{d}/{kind}{i}" if kind == "ckpt" else None))
                walls[kind].append(wall)
        tracker = tm["MetricsTracker"]()
        run(f"{d}/traced", tracker)
    rate = {k: TR_ROUNDS / statistics.median(v) for k, v in walls.items()}
    snap = tracker.observations["ckpt.snapshot_ms"]
    write = tracker.observations["ckpt.write_ms"]
    check(len(snap) == len(write) == TR_ROUNDS // OVERHEAD_EVERY,
          f"ckpt_overhead: {len(snap)} snapshots, {len(write)} writes")
    emit({"phase": "ckpt_overhead", "rounds": TR_ROUNDS,
          "ckpt_every": OVERHEAD_EVERY, "pairs": OVERHEAD_PAIRS,
          "walls_s": walls, "rounds_per_s": rate,
          "ckpt_over_base": rate["ckpt"] / rate["base"],
          "overhead": 1 - rate["ckpt"] / rate["base"],
          "reference_target": "< 0.05 at ckpt_every 10 (not gated)",
          "snapshots": len(snap),
          "snapshot_ms_training_thread": {
              "median": statistics.median(snap), "max": max(snap)},
          "write_ms_writer_thread": {
              "median": statistics.median(write), "max": max(write)},
          "params_vs_base": "exact"})


def phase_paper_models(torch, np, tm):
    """Paper Tables I-IV on the card. Table I: each model's parameters
    from its init and its fp32 size. Table II: ``algorithm_memory_report``
    at S = 32, equal to the JAX package's dicts. Tables III-IV: one
    client's update (``client_update``, as the round engine runs it) of
    TinyReptile against Reptile with 8 epochs at S = 32, on the support
    set ``benchmarks/table34_round_time.py`` draws, timed with CUDA events
    (median of PASSES), eagerly and built once (captured, replayed); the
    built update's result equals the eager one bit for bit."""
    core, graphs, nets = tm["core"], tm["graphs"], tm["nets"]
    from repro_torch.bridge import FlatLayout
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.data import KWSTasks, OmniglotTasks, SineTasks
    from repro_torch.metering import algorithm_memory_report

    dists = {"sine_mlp": SineTasks(), "kws_conv": KWSTasks(),
             "omniglot_conv": OmniglotTasks()}
    rng = np.random.default_rng(0)
    beta = 0.01
    table1, table2, table34 = {}, {}, {}
    for name, cfg in PAPER_MODELS.items():
        params = nets.init_paper_model(cfg, torch.Generator().manual_seed(0),
                                       "cuda")
        n = nets.param_count(params)
        check(n == PAPER_PARAMS[name], f"{name}: {n} parameters")
        table1[name] = {"params": n, "fp32_kb": n * 4 / 1024}
        mem = algorithm_memory_report(cfg, support=32)
        check(mem == TABLE2[name], f"{name}: Table II {mem}")
        table2[name] = {k: mem[k] for k in ("reptile_bytes",
                                            "tinyreptile_bytes",
                                            "reduction_factor")}

        loss = tm["loss_of"](cfg)
        sup = dists[name].sample_task(rng).support_batch(rng, T34_S)
        batch = {k: torch.from_numpy(np.asarray(v)[None]).cuda()
                 for k, v in sup.items()}
        layout = FlatLayout.of(params)
        phi = layout.pack(params)
        row = {}
        for strat, key in ((core.TinyReptileStrategy(loss), "tinyreptile"),
                           (core.ReptileStrategy(loss, epochs=T34_EPOCHS),
                            "reptile")):
            def update():
                return strat.client_update(layout, phi, batch, beta)[0]

            out = torch.empty_like(phi)[None]
            step = graphs.GraphStep(lambda: out.copy_(update()),
                                    torch.device("cuda"))
            step()                                   # run, then capture
            torch.cuda.synchronize()
            check(torch.equal(out, update()),
                  f"{name} {key}: the built update differs from eager")
            row[key] = {"eager_ms": cuda_ms(torch, update, 3),
                        "built_ms": cuda_ms(torch, step, 10),
                        "graph_nodes": step.nodes,
                        "capture_s": step.capture_s}
        for how in ("eager", "built"):
            row[f"reptile_over_tinyreptile_{how}"] = (
                row["reptile"][f"{how}_ms"] / row["tinyreptile"][f"{how}_ms"])
        table34[name] = row
    emit({"phase": "paper_models", "support_table2": 32,
          "support_table34": T34_S, "epochs_table34": T34_EPOCHS,
          "table1": table1, "table2": table2, "table34": table34})


def fig4_runs(tm, cfg, dist, phi, ev):
    """Fig. 4's three runs of one net, by name: (run, rounds, clients,
    epochs a round, or None for the stream)."""
    core, loss = tm["core"], tm["loss_of"](cfg)
    common = dict(eval_kwargs=ev, **FIG4_KW)
    return {
        "tinyreptile": (lambda dev: core.tinyreptile_train(
            loss, phi, dist, rounds=FIG4_ROUNDS, eval_every=FIG4_ROUNDS,
            device=dev, **common), FIG4_ROUNDS, 1, None),
        "reptile_serial": (lambda dev: core.reptile_train(
            loss, phi, dist, rounds=FIG4_ROUNDS, epochs=8,
            eval_every=FIG4_ROUNDS, device=dev, **common), FIG4_ROUNDS, 1,
            8),
        "reptile_c4": (lambda dev: core.reptile_train(
            loss, phi, dist, rounds=FIG4_C4_ROUNDS, epochs=8,
            clients_per_round=FIG4_CLIENTS, eval_every=FIG4_C4_ROUNDS,
            device=dev, **common), FIG4_C4_ROUNDS, FIG4_CLIENTS, 8)}


def phase_fig4_conv(torch, np, tm):
    """Paper Fig. 4 on the card (``benchmarks/fig4_omniglot_kws.py``'s
    setting): Omniglot 5-way and KWS 4-way, TinyReptile and serial
    Reptile for 120 rounds, batched Reptile for 30 rounds at 4 clients,
    alpha 1, beta 0.01, support 16, seed 4, one eval at the end with the
    accuracy metric. Each run's launch counters are set to 0 just before
    it and read just after, its round built once; beside it the random
    init's accuracy on the same eval clients and chance. Then the JAX
    test's KWS gate, each net's run against the CPU, and a profile of
    Omniglot TinyReptile rounds."""
    core, ops, nets, dists = tm["core"], tm["ops"], tm["nets"], tm["dists"]
    rows, paths = {}, {}
    for tag, name, chance in (("omniglot5", "omniglot_conv", 0.2),
                              ("kws4", "kws_conv", 0.25)):
        cfg = tm["cfgs"][name]
        phi = nets.init_paper_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        ev = dict(FIG4_EVAL, metric_fn=tm["acc_of"](cfg))
        base = core.evaluate_init(
            tm["loss_of"](cfg), {k: v.cuda() for k, v in phi.items()},
            dists[name], np.random.default_rng(10_000 + FIG4_ROUNDS - 1),
            **ev)
        rows[tag] = {"chance": chance, "random_init": base}
        for run_name, (run, rounds, clients, epochs) in fig4_runs(
                tm, cfg, dists[name], phi, ev).items():
            core.clear_runner_cache()
            out, wall, counts = timed_run(torch, ops, lambda: run("cuda"))
            graph = built_round(tm["engine"])
            steps = FIG4_KW["support"] if epochs is None else epochs
            check_launches(f"fig4 {tag} {run_name}", counts, {
                "online_sgd": rounds * steps + FIG4_EVAL["k_steps"],
                "meta_update": rounds})
            last = out["history"][-1]
            check(math.isfinite(last["query_loss"])
                  and 0 <= last["query_metric"] <= 1,
                  f"fig4 {tag} {run_name}: {last}")
            check(out["comm_bytes"] == rounds * clients * 2 * 4
                  * PAPER_PARAMS[name], f"fig4 {tag} {run_name}: comm_bytes")
            rows[tag][run_name] = {
                "rounds": rounds, "clients": clients, "wall_s": wall,
                "rounds_per_s": rounds / wall, **graph, "launches": counts,
                "query_metric": last["query_metric"],
                "query_loss": last["query_loss"],
                "comm_bytes": out["comm_bytes"]}
            paths[f"fig4_{tag}_{run_name}"] = counts

    # the JAX package's own threshold, at its test's setting
    kws = tm["cfgs"]["kws_conv"]
    phi = nets.init_paper_model(kws, torch.Generator().manual_seed(1), "cpu")
    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, ops, lambda: core.tinyreptile_train(
        tm["loss_of"](kws), phi, dists["kws_conv"],
        eval_every=KWS_GATE["rounds"], device="cuda",
        eval_kwargs=dict(KWS_GATE_EVAL, metric_fn=tm["acc_of"](kws)),
        **KWS_GATE))
    acc = out["history"][-1]["query_metric"]
    check(acc > KWS_GATE_MIN, f"KWS TinyReptile accuracy {acc} is not above "
                              f"{KWS_GATE_MIN} at the JAX test's setting")
    check_launches("fig4 kws gate", counts, {
        "online_sgd": KWS_GATE["rounds"] * KWS_GATE["support"]
        + KWS_GATE_EVAL["k_steps"], "meta_update": KWS_GATE["rounds"]})
    rows["kws_gate"] = {**KWS_GATE, "eval": KWS_GATE_EVAL,
                        "query_metric": acc, "min": KWS_GATE_MIN,
                        "wall_s": wall, **built_round(tm["engine"])}
    paths["fig4_kws_gate"] = counts

    # the card against the CPU from the same init, params within 1e-4
    vs_cpu = {}
    for name in ("omniglot_conv", "kws_conv"):
        cfg = tm["cfgs"][name]
        phi = nets.init_paper_model(cfg, torch.Generator().manual_seed(2),
                                    "cpu")
        checks = [("tinyreptile", lambda dev: core.tinyreptile_train(
            tm["loss_of"](cfg), phi, dists[name],
            rounds=CONV_CHECK_ROUNDS, device=dev, **FIG4_KW))]
        if name == "kws_conv":
            checks.append(("reptile_c4", lambda dev: core.reptile_train(
                tm["loss_of"](cfg), phi, dists[name],
                rounds=CONV_CHECK_C4_ROUNDS, epochs=8,
                clients_per_round=FIG4_CLIENTS, device=dev, **FIG4_KW)))
        for run_name, run in checks:
            vs_cpu[f"{name}_{run_name}"] = compare_runs(np, run("cuda"),
                                                        run("cpu"))
    rows["vs_cpu"] = {"tol": 1e-4, "rounds": CONV_CHECK_ROUNDS,
                      "c4_rounds": CONV_CHECK_C4_ROUNDS,
                      "params_max_abs_diff": vs_cpu}
    rows["profile_omniglot_tinyreptile"] = profile_conv(torch, tm)
    emit({"phase": "fig4_conv", **rows})
    return paths


def profile_conv(torch, tm):
    """CONV_PROFILE_ROUNDS Omniglot TinyReptile rounds, after a run of
    the same config has built (captured) its round, under torch.profiler
    (device activity only): the idle share, kernels a round, top kernels
    and the convolutions' share of busy time."""
    core, cfg = tm["core"], tm["cfgs"]["omniglot_conv"]
    phi = tm["nets"].init_paper_model(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    loss = tm["loss_of"](cfg)     # one loss: one cached runner, one build

    def run():
        return core.tinyreptile_train(
            loss, phi, tm["dists"]["omniglot_conv"],
            rounds=CONV_PROFILE_ROUNDS, device="cuda", **FIG4_KW)

    core.clear_runner_cache()
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (runner,) = tm["engine"]._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1, "the profiled conv round was built again")
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    conv_us = sum(t for k, (t, _) in by_name.items()
                  if any(s in k.lower() for s in ("conv", "cudnn", "wgrad",
                                                  "dgrad", "fprop")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n = sum(c for _, c in by_name.values())
    return {"rounds": CONV_PROFILE_ROUNDS, "replayed": True,
            "wall_ms": 1e3 * wall,
            "round_ms": 1e3 * wall / CONV_PROFILE_ROUNDS,
            "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e6 / wall,
            "kernels_per_round": n / CONV_PROFILE_ROUNDS,
            "conv_kernels_share_of_busy": conv_us / dev_us,
            "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                           for k, (t, c) in top]}


@contextlib.contextmanager
def uncaptured(graphs):
    """Every ``GraphStep`` call runs its function eagerly on the card:
    the uncaptured round and tick the graphs are held to."""
    capture = graphs.GraphStep._warm_up_and_capture
    graphs.GraphStep._warm_up_and_capture = lambda self: self.fn()
    try:
        yield
    finally:
        graphs.GraphStep._warm_up_and_capture = capture


def conv_graph_runs(torch, tm):
    """graphs_vs_eager's conv rounds: Omniglot TinyReptile (20 rounds)
    and KWS Reptile at 4 clients (10 rounds), Fig. 4's settings, an eval
    with the accuracy metric every 10 rounds."""
    core, nets, dists = tm["core"], tm["nets"], tm["dists"]
    out = {}
    for key, name, rounds, extra in (
            ("omniglot_tinyreptile", "omniglot_conv", 20, None),
            ("kws_reptile_c4", "kws_conv", 10,
             dict(epochs=8, clients_per_round=FIG4_CLIENTS))):
        cfg = tm["cfgs"][name]
        phi = nets.init_paper_model(cfg, torch.Generator().manual_seed(3),
                                    "cpu")
        kw = dict(rounds=rounds, eval_every=10, device="cuda",
                  eval_kwargs=dict(FIG4_EVAL, metric_fn=tm["acc_of"](cfg)),
                  **FIG4_KW)
        train = core.reptile_train if extra else core.tinyreptile_train
        out[key] = (lambda train=train, cfg=cfg, phi=phi, name=name, kw=kw,
                    extra=extra: train(tm["loss_of"](cfg), phi, dists[name],
                                       **kw, **(extra or {})))
    return out


def phase_graphs(torch, np, tm, serves, conv_runs):
    """The captured round and tick, replayed, against the same round and
    tick run eagerly on the card: params, histories, served results and
    launch counts equal, bit for bit. The round: TinyReptile (the
    quickstart's client, 40 rounds), Reptile and FedAvg at 8 clients,
    TinyReptile on the int8 wire, the pooled and buffered sine round (40
    rounds, its pool state too), TIFeD at 64 clients (20 rounds), and
    the conv nets' ``conv_runs``; the
    tick: 128 fp32 and 128 TIFeD requests at the serve phases' settings.
    Each with its capture time and graph size."""
    core, ops, graphs, loss, phi = (tm["core"], tm["ops"], tm["graphs"],
                                    tm["loss"], tm["phi"])
    ev = tm["train"].EVAL_KWARGS
    common = dict(beta=0.02, support=TR_SUPPORT, seed=4, eval_every=20,
                  device="cuda")
    runs = {
        "tinyreptile": lambda: core.tinyreptile_train(
            loss, phi, tm["SineTasks"](), rounds=40, eval_kwargs=TR_EVAL,
            **common),
        "reptile_c8": lambda: core.reptile_train(
            loss, phi, tm["SineTasks"](), rounds=20, clients_per_round=8,
            eval_kwargs=ev, **common),
        "fedavg_c8": lambda: core.fedavg_train(
            loss, phi, tm["SineTasks"](), rounds=20, clients_per_round=8,
            eval_kwargs=ev, **common),
        "tinyreptile_int8_wire": lambda: core.tinyreptile_train(
            loss, phi, tm["SineTasks"](), rounds=40, eval_kwargs=TR_EVAL,
            channel=core.CommChannel("int8"), **common),
        # the fleet: the pooled, buffered sine round (a fresh pool each
        # run) and TIFeD's integer round at the launcher's cohort
        "pooled_buffered_sine": lambda: pool_run(tm, POOL_SIZE, 40,
                                                 "device", "cuda"),
        "tifed_c64": lambda: core.tifed_train(
            phi, tm["SineTasks"](), rounds=20, support=TIFED_SUPPORT,
            clients_per_round=TIFED_CLIENTS, seed=4, eval_every=20,
            eval_kwargs=dict(ev, lr=tm["train"].TIFED_EVAL_LR),
            device="cuda"), **conv_runs}
    rows = {}
    for name, run in runs.items():
        core.clear_runner_cache()
        got, _, counts = timed_run(torch, ops, run)
        info = built_round(tm["engine"])
        core.clear_runner_cache()
        with uncaptured(graphs):
            want, _, eager = timed_run(torch, ops, run)
        core.clear_runner_cache()
        check(counts == eager, f"graphs {name}: launches {counts} vs {eager}")
        check(all(torch.equal(got["params"][k], v)
                  for k, v in want["params"].items()),
              f"graphs {name}: the captured round's params differ")
        check(got["history"] == want["history"],
              f"graphs {name}: the captured round's history differs")
        for k, v in want.get("pool_state", {}).items():
            check(np.array_equal(np.asarray(got["pool_state"][k]),
                                 np.asarray(v)),
                  f"graphs {name}: the captured round's pool state differs")
        rows[name] = {**info, "launches": counts, "bit_equal": True}
    AdaptationServer = serves["server"]
    for name, (adapter, p, reqs, k_max) in serves["routes"].items():
        def drain():
            server = AdaptationServer(p, adapter, slots=SLOTS, k_max=k_max,
                                      steps_per_tick=STEPS_PER_TICK,
                                      return_params=True, device="cuda")
            return server, serve(server, reqs[:128])

        (server, got), _, counts = timed_run(torch, ops, drain)
        with uncaptured(graphs):
            (_, want), _, eager = timed_run(torch, ops, drain)
        check(server.trace_count == 1, f"graphs {name}: trace_count")
        check(counts == eager, f"graphs {name}: launches {counts} vs {eager}")
        for g, w in zip(got, want):
            check((g.steps, g.query_loss) == (w.steps, w.query_loss)
                  and all(np.array_equal(g.params[k], w.params[k])
                          for k in w.params),
                  f"graphs {name}: request {g.rid} differs from the "
                  f"uncaptured tick")
        rows[name] = {"trace_count": server.trace_count,
                      "capture_s": server._tick_step.capture_s,
                      "graph_nodes": server._tick_step.nodes,
                      "launches": counts, "bit_equal": True}
    emit({"phase": "graphs_vs_eager", **rows})


def lm_launches(args):
    """Launches one LM launcher run must make: one online_sgd per dtype
    group per step, one meta_update per dtype group per round, and for
    the SSM family one ssd_scan per layer per inner step (the backward
    takes the plain gradient and recomputes nothing through the kernel;
    the dense family's attention is plain ops)."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    groups = len({dt for _, (_, dt) in tree_leaves(
        build_model(cfg).param_shapes())})
    want = {"online_sgd": args.rounds * args.k_inner * groups,
            "meta_update": args.rounds * groups}
    if cfg.family == "ssm":
        want["ssd_scan"] = args.rounds * args.k_inner * cfg.num_layers
    return want


def check_launches(name, counts, want):
    for k, v in want.items():
        check(counts[k] == v, f"{name}: {counts[k]} {k} launches, "
                              f"expected {v}")
    check(all(counts[k] == 0 for k in counts if k not in want),
          f"{name}: unexpected launches {counts}")


def lm_rows_vs_cpu(np, bridge, name, rows, phi, want_rows, want_phi):
    """The LM launcher's rows and final params on the card against the
    CPU's, within 1e-4; returns the worst differences."""
    check(len(rows) == len(want_rows), f"{name}: row count")
    worst_row = 0.0
    for got, want in zip(rows, want_rows):
        check(got["comm_mb"] == want["comm_mb"], f"{name}: comm_mb")
        check(got["alpha"] == want["alpha"], f"{name}: alpha")
        for k in ("loss", "inner_first", "inner_last", "client"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {k}")
            worst_row = max(worst_row, abs(got[k] - want[k]))
    worst = 0.0
    got_leaves = bridge.flatten_tree(phi)
    for path, want in bridge.flatten_tree(want_phi).items():
        a, b = got_leaves[path].float().cpu().numpy(), want.float().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {path}")
        worst = max(worst, float(np.abs(a - b).max()))
    return {"tol": 1e-4, "rows_max_abs_diff": worst_row,
            "params_max_abs_diff": worst}


def phase_train_lm_reduced(torch, np, tm):
    """The reduced mamba2 LM launcher on the card, then on the CPU, from
    the same seeded init: rows and final params within 1e-4, comm exact."""
    tl, ops, bridge = tm["train"], tm["ops"], tm["bridge"]
    args = tl.parse_args(LM_REDUCED)
    (rows, summary, phi), wall, counts = timed_run(
        torch, ops, lambda: tl.run_lm(args))
    want_rows, _, want_phi = tl.run_lm(tl.parse_args(LM_REDUCED + [
        "--device", "cpu"]))
    check_launches("train_lm_reduced", counts, lm_launches(args))
    vs_cpu = lm_rows_vs_cpu(np, bridge, "train_lm_reduced", rows, phi,
                            want_rows, want_phi)
    row = {"phase": "train_lm_reduced", "argv": LM_REDUCED, "wall_s": wall,
           "launches": counts, "comm_mb": summary["comm_mb"],
           "rows": rows, "vs_cpu": vs_cpu}
    emit(row)
    return row


def phase_train_lm_full(torch, np, tm):
    """mamba2-130m at full width and depth, bf16, through the launcher."""
    tl, ops = tm["train"], tm["ops"]
    args = tl.parse_args(LM_FULL)
    torch.cuda.reset_peak_memory_stats()
    (rows, summary, phi), wall, counts = timed_run(
        torch, ops, lambda: tl.run_lm(args))
    check_launches("train_lm_mamba2_130m", counts, lm_launches(args))
    for r in rows:
        for k in ("loss", "inner_first", "inner_last"):
            check(math.isfinite(r[k]), f"round {r['round']} {k} = {r[k]}")
    first = statistics.mean(r["inner_first"] for r in rows)
    last = statistics.mean(r["inner_last"] for r in rows)
    check(last < first, f"no client adaptation: mean inner_last {last} >= "
                        f"mean inner_first {first}")
    counts_by_dtype = {}
    for _, leaf in tm["bridge"].tree_leaves(phi):
        key = str(leaf.dtype).split(".")[1]
        counts_by_dtype[key] = counts_by_dtype.get(key, 0) + leaf.numel()
    check(counts_by_dtype == {"bfloat16": LM_BF16, "float32": LM_FP32},
          f"parameter counts {counts_by_dtype}")
    tokens = args.rounds * args.batch * args.seq
    rounds_s = sum(r["dt_s"] for r in rows)
    row = {"phase": "train_lm_mamba2_130m", "argv": LM_FULL,
           "params": counts_by_dtype, "wall_s": wall,
           "rounds_per_s": args.rounds / wall, "tokens_per_s": tokens / wall,
           "rounds_only_s": rounds_s,
           "rounds_only_tokens_per_s": tokens / rounds_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "comm_mb": summary["comm_mb"],
           "mean_inner_first": first, "mean_inner_last": last,
           "rows": rows}
    emit(row)
    return row, phi


def phase_profile_lm(torch, np, tm, phi):
    """LM_PROFILE_ROUNDS full-width rounds of the LM step (the launcher's
    per-round work: K inner steps, one interpolation, one read of the
    losses)
    under torch.profiler, twice. Device activity alone: the device's idle
    share, the top kernels and ssd_scan's share. Host ops too (which slow
    the host, so no idle share is read there): the share of the plain
    backward of ssd_chunked, the device time of the kernels launched
    inside its profiler range."""
    tl, mamba2 = tm["train"], tm["mamba2"]
    from repro_torch.configs import get_arch
    from repro_torch.data import LMClientStream
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.steps import make_meta_train_step, microbatch

    args = tl.parse_args(LM_FULL)
    model = build_model(get_arch(args.arch))
    step = make_meta_train_step(model, beta=args.beta)
    rng = np.random.default_rng(123)
    batches = []
    for cid in range(LM_PROFILE_ROUNDS):
        raw = microbatch(LMClientStream(model.cfg.vocab_size, cid).batch(
            rng, args.batch, args.seq), args.k_inner)
        batches.append({k: torch.from_numpy(v).cuda() for k, v in raw.items()})
    alpha = torch.tensor([0.5], device="cuda")
    bwd_range = mamba2.SSD_BACKWARD_RANGE
    cuda = torch.autograd.DeviceType.CUDA

    def profiled(activities):
        nonlocal phi
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                phi, m = step(phi, batch, alpha)
                m["loss"].item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device rows: kernels and copies (the range's own span on the GPU
        # timeline, where the profiler adds one, is no work of its own)
        by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
                   if t > 0 and k != bwd_range}
        dev_us = sum(t for t, _ in by_name.values())
        check(dev_us > 0, "the profiler saw no device time")
        return prof, wall, by_name, dev_us

    act = torch.profiler.ProfilerActivity
    _, wall, by_name, dev_us = profiled([act.CUDA])
    ssd_by = {k: t for k, (t, _) in by_name.items() if "ssd_scan" in k}
    ssd_us = sum(ssd_by.values())
    check(ssd_us > 0, "the profiler saw no ssd_scan kernel")

    def kernel_us(ev):      # device time of the kernels launched under ev
        return (sum(k.duration for k in ev.kernels if k.name != bwd_range)
                + sum(kernel_us(child) for child in ev.cpu_children))

    prof, traced_wall, _, traced_dev_us = profiled([act.CPU, act.CUDA])
    check_device_rows(torch, prof, "profile_lm traced")
    bwd = [ev for ev in prof.events()
           if ev.name == bwd_range and ev.device_type != cuda]
    bwd_us, bwd_count = sum(kernel_us(ev) for ev in bwd), len(bwd)
    layers_steps = model.cfg.num_layers * LM_PROFILE_ROUNDS * args.k_inner
    check(bwd_count == layers_steps and 0 < bwd_us < traced_dev_us - ssd_us,
          f"the ssd_chunked backward ranges: {bwd_count} seen, "
          f"{bwd_us} us of device time against {traced_dev_us} us busy")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_lm", "rounds": LM_PROFILE_ROUNDS,
          "wall_ms": 1e3 * wall, "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_launched": sum(c for _, c in by_name.values()),
          "ssd_scan_ms": ssd_us / 1e3,
          "ssd_scan_share_of_busy": ssd_us / dev_us,
          "ssd_scan_ms_by_kernel": {k[:80]: t / 1e3
                                    for k, t in ssd_by.items()},
          "host_traced_wall_ms": 1e3 * traced_wall,
          "host_traced_device_busy_ms": traced_dev_us / 1e3,
          "ssd_backward_ms": bwd_us / 1e3, "ssd_backward_count": bwd_count,
          "ssd_backward_share_of_busy": bwd_us / traced_dev_us,
          "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                         for k, (t, c) in top]})


def fd_inputs(torch, np, shape, dtype, seed, dev):
    """q (B, H, hd) and the two caches (B, S, Kv, hd), standard normal from
    a NumPy seed, in ``dtype`` on ``dev``."""
    B, H, Kv, hd, S = shape
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 .to(dev, dtype)
                 for s in ((B, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))


def fd_bytes_ops(shape, L, window, elem):
    """Bytes the call must move (q read, the n attended K and V rows read,
    the output written) and its operations (q.k and p v: 4 B H n hd)."""
    B, H, Kv, hd, S = shape
    n = min(L, window) if window else L
    return 2 * B * n * Kv * hd * elem + 2 * B * H * hd * elem, \
        4 * B * H * n * hd


def phase_kernels_decode(torch, np, ops, ref, rows):
    """flash_decode against its plain version at each case, timed beside
    its bound and one scaled_dot_product_attention call on the same
    inputs (the attended slice of each cache, as views, enable_gqa)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    cases = [(f"test_{'x'.join(map(str, shape))}_{dt}_L{L}_w{w}", shape, dt,
              L, w)
             for shape in FD_TEST_SHAPES for dt in ("float32", "bfloat16")
             for L, w in ((shape[-1] // 2, 0), (shape[-1], 0), (1, 0),
                          (shape[-1] // 2, 128))]
    cases += [(f"path_8x32x4x64x2048_bfloat16_L{L}_w{w}", FD_PATH,
               "bfloat16", L, w)
              for L, w in PATH_CASES]
    cases.append(("32k_4x8x4x64x32768_float32_L32768_w0", FD_32K, "float32",
                  32768, 0))
    inputs = {}
    for i, (tag, shape, dt, L, w) in enumerate(cases):
        if (shape, dt) not in inputs:
            q, k, v = fd_inputs(torch, np, shape, getattr(torch, dt), 60 + i,
                                dev)
            # the decode path reads a different layer's cache at every
            # call (22 x 16.8 MB at this shape), so its rows time calls
            # that cycle over 8 copies, 134 MB, past the 50 MB L2
            n = 8 if shape == FD_PATH else 1
            inputs = {(shape, dt): (q, [(k, v)] + [(k.clone(), v.clone())
                                                   for _ in range(n - 1)])}
        q, kvs = inputs[(shape, dt)]
        k, v = kvs[0]
        got = ops.flash_decode(q, k, v, L, window=w)
        want = ref.flash_decode(q, k, v, L, window=w)
        lo = max(0, L - w) if w else 0
        B, H, Kv, hd, S = shape
        views = itertools.cycle([(q.view(B, H, 1, hd),
                                  kc[:, lo:L].transpose(1, 2),
                                  vc[:, lo:L].transpose(1, 2))
                                 for kc, vc in kvs])
        caches = itertools.cycle(kvs)
        lib = F.scaled_dot_product_attention(*next(views), enable_gqa=True)
        torch.cuda.synchronize()
        tol = FD_TOL[dt]
        check(got.dtype == q.dtype and got.shape == q.shape,
              f"flash_decode {tag}: {got.dtype} {tuple(got.shape)}")
        atol = tol * min(1.0, want.abs().max().item())
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=atol)
        torch.testing.assert_close(lib.reshape(B, H, hd).float(), want,
                                   rtol=tol, atol=tol)
        moved, nops = fd_bytes_ops(shape, L, w, q.element_size())
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = nops / (FP32_OPS_PER_S if dt == "float32"
                        else BF16_OPS_PER_S)
        big = moved > 1e8
        iters = 20 if big else 100
        row = {"shape_BHKvhdS": list(shape), "dtype": dt, "L": L,
               "window": w, "rtol": tol, "atol": atol,
               "max_abs_err": (got.float() - want).abs().max().item(),
               "ms": cuda_ms(torch, lambda: ops.flash_decode(
                   q, *next(caches), L, window=w), iters),
               **device_ms(torch, lambda: ops.flash_decode(
                   q, *next(caches), L, window=w)),
               "plain_ms": cuda_ms(torch, lambda: ref.flash_decode(
                   q, *next(caches), L, window=w), 5 if big else 20),
               "library_ms": cuda_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       *next(views), enable_gqa=True), iters),
               **device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       *next(views), enable_gqa=True), "library_device_ms"),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "flop": nops}
        rows[f"flash_decode/{tag}"] = row
        emit({"phase": "kernel", "kernel": "flash_decode", "case": tag,
              **row})
        if shape not in (FD_PATH, FD_32K):
            continue
        # the device-L route, as the decode graph launches it: L an int32
        # on the card, one grid for every L; bit-equal to the host-int call
        length = torch.tensor([L], dtype=torch.int32, device=dev)
        got_d = ops.flash_decode(q, k, v, length, window=w)
        torch.cuda.synchronize()
        check(torch.equal(got_d, got),
              f"flash_decode {tag}: the device-L route differs from the "
              f"host-int call")
        row_d = {**row, "route": "device_L", "bit_equal_to_host_int": True,
                 "ms": cuda_ms(torch, lambda: ops.flash_decode(
                     q, *next(caches), length, window=w), iters),
                 **device_ms(torch, lambda: ops.flash_decode(
                     q, *next(caches), length, window=w))}
        rows[f"flash_decode/{tag}_devL"] = row_d
        emit({"phase": "kernel", "kernel": "flash_decode",
              "case": f"{tag}_devL", **row_d})

    # what a decode wave pays per call: every L in PATH_RUN once per layer,
    # each time linear between the path rows at L <= PATH_RUN[1]; for the
    # host-int route and the device-L route the decode graph launches
    grid = np.arange(PATH_RUN[0], PATH_RUN[1] + 1)
    for suffix in ("", "_devL"):
        path = sorted((r["L"], r) for key, r in rows.items()
                      if key.startswith("flash_decode/path_")
                      and key.endswith(f"_w0{suffix}")
                      and r["L"] <= PATH_RUN[1])
        Ls = [L for L, _ in path]
        row = {"shape_BHKvhdS": list(FD_PATH), "dtype": "bfloat16",
               "route": "device_L" if suffix else "host_int",
               "L_range": list(PATH_RUN), "from_L": Ls,
               **{k: float(np.interp(grid, Ls, [r[k] for _, r in path])
                           .mean())
                  for k in ("ms", "device_ms", "library_ms",
                            "library_device_ms", "bound_ms")}}
        rows[f"flash_decode/path_run_mean{suffix}"] = row
        emit({"phase": "kernel", "kernel": "flash_decode",
              "case": f"path_run_mean{suffix}", **row})
    return rows


def decode_steps(args):
    """Decode steps of one decode run: prompt_len + max_new per wave."""
    return -(-args.requests // args.batch) * (args.prompt_len + args.max_new)


def decode_launches(args):
    """flash_decode launches of one decode run: one per attention layer
    per decode step."""
    from repro_torch.configs import get_arch
    cfg = get_arch(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    return {"flash_decode": decode_steps(args) * cfg.num_layers}


def phase_serve_decode_reduced(torch, np, tm):
    """The reduced decode launcher on the card, then on the CPU, from the
    same seeded init: every step's logits within 1e-4, the same tokens."""
    serve, ops = tm["serve"], tm["ops"]
    args = serve.parse_args(DECODE_REDUCED)
    got, want, built = [], [], []
    (row, out), wall, counts = timed_run(torch, ops, lambda: serve.run_decode(
        args, on_logits=lambda lg: got.append(lg.cpu()),
        on_build=built.append))
    build = decode_build("serve_decode_reduced", built)
    cpu_row, cpu_out = serve.run_decode(
        serve.parse_args(DECODE_REDUCED + ["--device", "cpu"]),
        on_logits=lambda lg: want.append(lg.clone()))
    check_launches("serve_decode_reduced", counts, decode_launches(args))
    check(counts == row["kernel_launches"], "launch counts")
    check(len(got) == len(want) == decode_steps(args),
          f"{len(got)} and {len(want)} steps")
    worst = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(worst <= 1e-4, f"logits differ from the CPU by {worst}")
    check(out == cpu_out, "generated tokens differ from the CPU")
    check(row["sample_output"] == cpu_row["sample_output"], "sample_output")
    for key in ("tokens_generated", "requests", "arch"):
        check(row[key] == cpu_row[key], key)
    res = {"phase": "serve_decode_reduced", "argv": DECODE_REDUCED,
           "wall_s": wall, "launches": counts, "row": row, "build": build,
           "vs_cpu": {"steps": len(got), "tol": 1e-4,
                      "logits_max_abs_diff": worst, "tokens": "equal"}}
    emit(res)
    return res


def decode_build(run, built):
    """The decode run's one build: a step captured once as a CUDA graph
    and replayed for every step of every wave. Printed on its own line
    before the run's; returns it."""
    check(len(built) == 1, f"{run}: {len(built)} decode runners")
    (runner,) = built
    check(runner.trace_count == 1 and runner.step.graph is not None,
          f"{run}: the decode step was built {runner.trace_count} times "
          f"or not captured")
    build = {"trace_count": runner.trace_count,
             "capture_s": runner.capture_s, "graph_nodes": runner.nodes}
    emit({"phase": "decode_build", "run": run, **build})
    return build


def teacher_forced(torch, model, params, tokens, dev, at=None):
    """Logits (fp32, on the CPU) of decoding ``tokens`` (B, T) one at a
    time from an empty cache of T, through a decode runner (its step
    built once: on the card captured and replayed): (B, T, V), or only
    the positions in ``at``, (B, len(at), V)."""
    from repro_torch.runtime.steps import DecodeRunner
    B, T = tokens.shape
    at = range(T) if at is None else at
    runner = DecodeRunner(model, params, batch=B, prompt_len=T, cache_len=T,
                          max_new=0, device=dev)
    kept, seen = {}, []

    def keep(logits):
        if len(seen) in at:
            kept[len(seen)] = logits[:, 0].float().cpu()
        seen.append(1)
    runner.wave(torch.from_numpy(tokens), on_logits=keep)
    check(len(seen) == T and set(kept) == set(at), "teacher_forced")
    return torch.stack([kept[t] for t in at], dim=1)


def phase_serve_decode_full(torch, np, tm):
    """tinyllama-1.1b at full width and depth, bf16, through the decode
    launcher; then its weights in fp32 on the card against the CPU, and
    the bf16 model's greedy choices against the fp32 logits."""
    import dataclasses

    from repro_torch.models.transformer import build_model

    serve, ops, bridge = tm["serve"], tm["ops"], tm["bridge"]
    args = serve.parse_args(DECODE_FULL)
    cfg = tm["get_arch"](args.arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    # drawn on the card: the host draw of 1.1 B weights took some 8 s
    params = draw_on_card(torch, model, args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in bridge.tree_leaves(params))
    check(n_params == TINYLLAMA_PARAMS, f"{n_params} parameters")
    finite, built, marks = [], [], []
    torch.cuda.reset_peak_memory_stats()
    (row, out), wall, counts = timed_run(torch, ops, lambda: serve.run_decode(
        args, params=params,
        on_logits=lambda lg: finite.append(torch.isfinite(lg).all()),
        on_build=lambda r: (built.append(r),
                            marks.append(time.perf_counter()))))
    # the launcher's clocked part: from the built step to the last sync
    decode_s = time.perf_counter() - marks[0]
    peak = torch.cuda.max_memory_allocated()
    build = decode_build("serve_decode_tinyllama_1_1b", built)
    del built
    check_launches("serve_decode_tinyllama_1_1b", counts,
                   decode_launches(args))
    steps = decode_steps(args)
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          "a logit is not finite")
    check(len(out) == args.requests
          and all(len(o) == args.max_new for o in out), "outputs")

    # the same weights in fp32: the card against the CPU, teacher-forced
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (CHECK_BATCH, CHECK_STEPS))
    p32 = bridge.unflatten_tree({path: t.float() for path, t in
                                 bridge.tree_leaves(params)})
    card = teacher_forced(torch, m32, p32, tokens, "cuda")
    p32 = bridge.unflatten_tree({path: t.cpu() for path, t in
                                 bridge.tree_leaves(p32)})
    t1 = time.perf_counter()
    cpu = teacher_forced(torch, m32, p32, tokens, "cpu")
    cpu_s = time.perf_counter() - t1
    del p32
    scale = cpu.abs().max().item()
    diff = (card - cpu).abs().max().item()
    check(diff <= CHECK_TOL * scale,
          f"fp32 card vs CPU: {diff} > {CHECK_TOL} x {scale}")
    # the bf16 model on the same tokens: each greedy choice's fp32 logit
    bf16 = teacher_forced(torch, model, params, tokens, "cuda")
    chosen = bf16.argmax(dim=-1, keepdim=True)
    gap = (cpu.max(dim=-1, keepdim=True).values
           - cpu.gather(-1, chosen)).max().item()
    check(gap <= BF16_CHOICE_TOL * scale,
          f"a bf16 choice is {gap} below the fp32 max ({scale} largest)")
    agree = (chosen[..., 0] == cpu.argmax(dim=-1)).float().mean().item()
    res = {"phase": "serve_decode_tinyllama_1_1b", "argv": DECODE_FULL,
           "params": n_params, "init_s": init_s, "wall_s": wall,
           "tok_per_s": row["tokens_generated"] / wall,
           "processed_tok_per_s": steps * args.batch / wall,
           "decode_steps": steps, "step_ms": 1e3 * wall / steps,
           "after_build": {"wall_s": decode_s,
                           "tok_per_s": row["tokens_generated"] / decode_s,
                           "step_ms": 1e3 * decode_s / steps},
           "max_memory_allocated_gb": peak / 1e9, "launches": counts,
           "row": row, "build": build,
           "fp32_vs_cpu": {"steps": CHECK_STEPS, "batch": CHECK_BATCH,
                           "tol_of_max": CHECK_TOL, "max_abs_logit": scale,
                           "logits_max_abs_diff": diff, "cpu_s": cpu_s},
           "bf16_choices": {"tol_of_max": BF16_CHOICE_TOL,
                            "worst_gap_to_fp32_max": gap,
                            "same_as_fp32_argmax": agree,
                            "bf16_vs_fp32_max_abs_diff": (bf16 - cpu).abs()
                            .max().item()}}
    emit(res)
    return res, model, params


def phase_profile_decode(torch, np, model, params):
    """DECODE_PROFILE_STEPS full-width decode steps at batch 8 from
    position DECODE_PROFILE_AT under torch.profiler, device activity
    only, each a replay of the decode runner's one captured step: the
    idle share, kernels per step, the top kernels and flash_decode's
    share of busy time; beside them the wrapper's launches and the
    flash_decode kernels the tracer recorded: one a launch, as a call is
    one kernel launch whether or not the KV axis is split, or fewer, since
    the tracer may lose device events (never more)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import DecodeRunner
    cfg = model.cfg
    B = 8
    runner = DecodeRunner(model, params, batch=B,
                          prompt_len=DECODE_PROFILE_AT
                          + DECODE_PROFILE_STEPS + 1,
                          cache_len=2048, max_new=0, device="cuda")
    runner.prompts.copy_(torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, tuple(runner.prompts.shape))))
    runner.build()
    runner.cursor.fill_(DECODE_PROFILE_AT)
    runner.step()                               # a replay before the window
    torch.cuda.synchronize()
    before = ops.launch_counts()["flash_decode"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            runner.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()["flash_decode"] - before
    check(launches == DECODE_PROFILE_STEPS * cfg.num_layers,
          f"{launches} flash_decode launches in {DECODE_PROFILE_STEPS} "
          f"replayed steps")
    check(runner.trace_count == 1, "the profiled step was built again")
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    fd_us = sum(t for k, (t, _) in by_name.items() if "flash_decode" in k)
    check(fd_us > 0, "the profiler saw no flash_decode kernel")
    fd_traced = sum(c for k, (_, c) in by_name.items() if "flash_decode" in k)
    check(fd_traced <= launches,
          f"{fd_traced} flash_decode kernels traced for {launches} launches: "
          f"a call must be one kernel launch")
    n_kernels = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_decode", "steps": DECODE_PROFILE_STEPS,
          "batch": B, "from_position": DECODE_PROFILE_AT, "replayed": True,
          "graph_nodes": runner.nodes,
          "wall_ms": 1e3 * wall, "step_ms": 1e3 * wall / DECODE_PROFILE_STEPS,
          "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_per_step": n_kernels / DECODE_PROFILE_STEPS,
          "flash_decode_ms": fd_us / 1e3,
          "flash_decode_share_of_busy": fd_us / dev_us,
          "flash_decode_launches": launches,
          "flash_decode_kernels_traced": fd_traced,
          "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                         for k, (t, c) in top]})


def graphs_vs_eager_decode(torch, np, graphs, model, params):
    """A DECODE_GRAPH wave of the model through the decode runner,
    its step captured and replayed, against the same step run eagerly on
    the card: every step's logits and the tokens bit for bit, launch
    counts equal. Returns the graphs_vs_eager row."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import DecodeRunner
    prompts = torch.from_numpy(np.random.default_rng(11).integers(
        0, model.cfg.vocab_size,
        (DECODE_GRAPH["batch"], DECODE_GRAPH["prompt_len"])))

    def wave():
        runner = DecodeRunner(model, params, device="cuda", **DECODE_GRAPH)
        runner.build()
        logits = []
        (tokens, wall, counts) = timed_run(
            torch, ops, lambda: runner.wave(prompts, on_logits=logits.append))
        return runner, logits, tokens, wall, counts

    runner, got, got_tokens, wall, counts = wave()
    info = {"trace_count": runner.trace_count, "capture_s": runner.capture_s,
            "graph_nodes": runner.nodes}
    check(runner.trace_count == 1 and runner.step.graph is not None,
          "graphs decode: the step was not built once")
    del runner
    with uncaptured(graphs):
        _, want, want_tokens, eager_wall, eager = wave()
    steps = DECODE_GRAPH["prompt_len"] + DECODE_GRAPH["max_new"]
    check(counts == eager and counts["flash_decode"]
          == steps * attn_applications(model),
          f"graphs decode: launches {counts} vs {eager}")
    check(got_tokens == want_tokens,
          "graphs decode: the replayed wave's tokens differ from eager")
    check(len(got) == len(want) == steps
          and all(torch.equal(a, b) for a, b in zip(got, want)),
          "graphs decode: the replayed wave's logits differ from eager")
    return {**info, **DECODE_GRAPH, "launches": counts, "bit_equal": True,
            "wall_s": wall, "eager_wall_s": eager_wall}


# -- the weighted client mean, the dense LM's train and prefill paths, the
# -- joint step, and the Mamba2 decode -----------------------------------------

def phase_kernels_client_mean(torch, np, ops, ref, rows):
    """client_mean against its plain version, bit for bit, at every
    (C, P) of CM_CLIENTS x CM_SIZES (the FMA chain up to 32 clients, the
    windows above), timed beside torch.sum(w q, 0) and its bytes bound;
    on the device at the engine's shapes (CM_TIMED)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(17)
    for C in CM_CLIENTS:
        for P in CM_SIZES:
            q = (torch.randn((C, P), generator=g) * 3).to(dev)
            w = torch.rand(C, generator=g)
            w[torch.rand(C, generator=g) < 0.2] = 0.0
            w = (w / w.sum().clamp_min(1e-6)).to(dev)
            got, want = ops.client_mean(q, w), ref.client_mean(q, w)
            check(torch.equal(got, want),
                  f"client_mean C {C} P {P}: not bit-exact")

            def fn():
                return ops.client_mean(q, w)

            def library():
                return torch.sum(w[:, None] * q, 0)
            # the kernel never reads the q row of a client whose weight
            # is 0, and the function needs no product for it
            live = int((w > 0).sum())
            moved = 4 * (live * P + C + P)
            t_bytes = moved / HBM_BYTES_PER_S
            t_ops = 2 * live * P / FP32_OPS_PER_S
            iters = 200 if C * P < 1e6 else 20
            row = {"C": C, "P": P, "tol": "exact", "max_abs_err": 0.0,
                   "order": ("fma_chain" if C <= ref.CLIENT_MEAN_CHAIN
                             else "windows_of_32"),
                   "ms": cuda_ms(torch, fn, iters),
                   "plain_ms": cuda_ms(torch, lambda: ref.client_mean(q, w),
                                       max(iters // 20, 2)),
                   "library_ms": cuda_ms(torch, library, iters),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": moved, "clients_read": live}
            if (C, P) in CM_TIMED:
                row.update(device_ms(torch, fn))
                row.update(device_ms(torch, library, "library_device_ms"))
            rows[f"client_mean/C{C}_P{P}"] = row
            emit({"phase": "kernel", "kernel": "client_mean",
                  "case": f"C{C}_P{P}", **row})
    return rows


def phase_client_mean_queue_c(torch, np, tm):
    """ROADMAP queue C's launcher case (QUEUE_C_TIFED: TIFeD on a Markov
    pool of 30 with a FedBuff buffer of 4, where the weighted mean runs
    every round, six client_mean launches a round, one a leaf) on the
    card and on the CPU: params and pool state exact, launches as
    reckoned."""
    tl, ops = tm["train"], tm["ops"]
    tm["core"].clear_runner_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        (row, out), wall, counts = timed_run(
            torch, ops, lambda: tl.run_engine_strategy(
                tl.parse_args(QUEUE_C_TIFED)))
        _, want = tl.run_engine_strategy(tl.parse_args(
            QUEUE_C_TIFED + ["--device", "cpu"]))
    for k, v in want["params"].items():
        check(torch.equal(out["params"][k].cpu(), v),
              f"client_mean queue C: param {k} differs from the CPU")
    for k, v in want["pool_state"].items():
        check(np.array_equal(np.asarray(out["pool_state"][k]),
                             np.asarray(v)),
              f"client_mean queue C: pool state {k} differs from the CPU")
    for key in ("comm_bytes", "per_client_bytes"):
        check(out[key] == want[key], f"client_mean queue C: {key}")
    args = tl.parse_args(QUEUE_C_TIFED)
    check_launches("client_mean_queue_c", counts, {
        "client_mean": 6 * args.rounds,
        "dfa_epoch_int8": args.rounds * TIFED_EPOCHS,
        "meta_update": args.rounds,
        "online_sgd": tl.EVAL_KWARGS["k_steps"]})
    emit({"phase": "client_mean_queue_c", "argv": QUEUE_C_TIFED,
          "wall_s": wall, "launches": counts,
          "query_loss": row.get("query_loss"),
          "cpu_query_loss": want["history"][-1]["query_loss"],
          "params_vs_cpu": "exact", "pool_state_vs_cpu": "exact"})
    return {"client_mean_queue_c": counts}


def phase_kernels_tinyllama(torch, np, ops, ref, rows):
    """online_sgd and meta_update at tinyllama-1.1b's one flat bf16 buffer
    (TINYLLAMA_PARAMS), bit for bit against their plain versions (taken
    in TL_CHUNK pieces: meta_update's plain version works in float64),
    beside torch.add and torch.lerp and the bytes bound."""
    dev = torch.device("cuda")
    n = TINYLLAMA_PARAMS
    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = (torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    alpha = torch.tensor([0.37], device=dev)

    def chunked(fn):
        return lambda: torch.cat([fn(a[i:i + TL_CHUNK], b[i:i + TL_CHUNK])
                                  for i in range(0, n, TL_CHUNK)])
    moved = 3 * n * 2
    for kernel, fn, plain, library, nops in (
            ("online_sgd", lambda: ops.online_sgd(a, b, 0.02),
             chunked(lambda x, y: ref.online_sgd(x, y, 0.02)),
             lambda: torch.add(a, b, alpha=-0.02), 2 * n),
            ("meta_update", lambda: ops.meta_update(a, b, alpha),
             chunked(lambda x, y: ref.meta_update(x, y, alpha)),
             lambda: torch.lerp(a, b, 0.37), 3 * n)):
        check(torch.equal(fn(), plain()), f"{kernel} tinyllama: not "
                                          f"bit-exact")
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
        row = {"n": n, "dtype": "bfloat16", "tol": "exact",
               "max_abs_err": 0.0,
               "ms": cuda_ms(torch, fn, 5), **device_ms(torch, fn, calls=5),
               "plain_ms": cuda_ms(torch, plain, 2),
               "plain_chunk": TL_CHUNK,
               "library_ms": cuda_ms(torch, library, 5),
               **device_ms(torch, library, "library_device_ms", calls=5),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved}
        rows[f"{kernel}/tinyllama_bf16_{n}"] = row
        emit({"phase": "kernel", "kernel": kernel,
              "case": f"tinyllama_bf16_{n}", **row})
    del a, b
    torch.cuda.empty_cache()
    return rows


def phase_train_dense_reduced(torch, np, tm):
    """The reduced tinyllama and starcoder2 (window 64, at 256 tokens, so
    the window masks) through the LM launcher on the card and on the CPU
    from the same seeded init: rows and params within 1e-4, launches as
    reckoned (no ssd_scan: the dense family's attention is plain ops)."""
    tl, ops, bridge = tm["train"], tm["ops"], tm["bridge"]
    runs, paths = [], {}
    for name, argv in DENSE_REDUCED.items():
        args = tl.parse_args(argv)
        (rows, summary, phi), wall, counts = timed_run(
            torch, ops, lambda: tl.run_lm(args))
        want_rows, _, want_phi = tl.run_lm(tl.parse_args(argv + [
            "--device", "cpu"]))
        check_launches(f"train_dense_reduced {name}", counts,
                       lm_launches(args))
        runs.append({"run": name, "argv": argv, "wall_s": wall,
                     "launches": counts, "comm_mb": summary["comm_mb"],
                     "rows": rows,
                     "vs_cpu": lm_rows_vs_cpu(np, bridge, name, rows, phi,
                                              want_rows, want_phi)})
        paths[f"train_dense_reduced_{name}"] = counts
    emit({"phase": "train_dense_reduced", "runs": runs})
    return paths


def phase_train_dense_full(torch, np, tm):
    """tinyllama-1.1b at full width and depth, bf16, through the LM
    launcher (DENSE_FULL): finite losses, the client adapts in most
    rounds, launches as reckoned, rounds/s, tokens/s and peak memory;
    then one more round of the same step under the profiler (device
    activity only): its device time and idle share; then one launcher
    round at the launcher's own beta (DENSE_DEFAULT_BETA), its inner
    losses reported."""
    tl, ops = tm["train"], tm["ops"]
    args = tl.parse_args(DENSE_FULL)
    model = tm["build_model"](tm["get_arch"](args.arch))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the weights drawn on the card (the launcher's host draw of 1.1 B
    # weights took some 8 s a run)
    (rows, summary, phi), wall, counts = timed_run(
        torch, ops, lambda: tl.run_lm(
            args, init_params=draw_on_card(torch, model, args.seed)))
    peak = torch.cuda.max_memory_allocated()
    check_launches("train_dense_tinyllama_1_1b", counts, lm_launches(args))
    for r in rows:
        for k in ("loss", "inner_first", "inner_last"):
            check(math.isfinite(r[k]), f"round {r['round']} {k} = {r[k]}")
    adapted = sum(r["inner_last"] < r["inner_first"] for r in rows)
    check(adapted >= len(rows) - 1,
          f"the client adapted in only {adapted} of {len(rows)} rounds")
    n = sum(t.numel() for _, t in tm["bridge"].tree_leaves(phi))
    check(n == TINYLLAMA_PARAMS, f"{n} parameters")
    tokens = args.rounds * args.batch * args.seq
    rounds_s = sum(r["dt_s"] for r in rows)
    profile = profile_dense_round(torch, np, tm, args, phi)
    del phi
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        default, _, phi = tl.run_lm(tl.parse_args(DENSE_DEFAULT_BETA),
                                    init_params=draw_on_card(torch, model,
                                                             0))
    del phi
    torch.cuda.empty_cache()
    row = {"phase": "train_dense_tinyllama_1_1b", "argv": DENSE_FULL,
           "params": n, "wall_s": wall, "rounds_per_s": args.rounds / wall,
           "tokens_per_s": tokens / wall, "rounds_only_s": rounds_s,
           "rounds_only_tokens_per_s": tokens / rounds_s,
           "max_memory_allocated_gb": peak / 1e9, "launches": counts,
           "comm_mb": summary["comm_mb"], "rounds_adapted": adapted,
           "rows": rows, "profile_one_round": profile,
           "default_beta_round": {
               "argv": DENSE_DEFAULT_BETA,
               **{k: default[0][k] for k in ("inner_first", "inner_last",
                                             "loss")}}}
    emit(row)
    return {"train_dense_tinyllama_1_1b": counts}


def profile_dense_round(torch, np, tm, args, phi):
    """One round of the launcher's step at ``args``' shape on ``phi``
    under torch.profiler, device activity only: wall, device busy time,
    idle share, kernels and the top ones."""
    from repro_torch.data import LMClientStream
    from repro_torch.runtime.steps import make_meta_train_step, microbatch

    model = tm["build_model"](tm["get_arch"](args.arch))
    step = make_meta_train_step(model, beta=args.beta)
    raw = microbatch(LMClientStream(model.cfg.vocab_size, 0).batch(
        np.random.default_rng(321), args.batch, args.seq), args.k_inner)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    alpha = torch.tensor([0.5], device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, m = step(phi, batch, alpha)
        m["loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del new
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": 1e3 * wall, "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e6 / wall,
            "kernels_launched": sum(c for _, c in by_name.values()),
            "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                           for k, (t, c) in top]}


def joint_steps(torch, opt, step, params, batch):
    """JOINT_STEPS steps of ``step`` from ``params``: the losses, lrs and
    step times, the peak memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p, state, n = params, opt.init(params), 0
    losses, lrs, times = [], [], []
    for _ in range(JOINT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, n, met = step(p, state, n, batch)
        losses.append(met["loss"].item())
        times.append(time.perf_counter() - t0)
        lrs.append(float(met["lr"]))
    peak = torch.cuda.max_memory_allocated()
    del p, state
    torch.cuda.empty_cache()
    return losses, lrs, times, peak


def phase_joint_step_full(torch, np, tm, model, params):
    """JOINT_STEPS steps of make_joint_train_step on tinyllama-1.1b at
    full width and depth (the decode phases' bf16 weights) with adamw()
    and cosine(JOINT_LR, JOINT_STEPS, warmup=1), on one fixed batch of
    JOINT_BATCH x JOINT_SEQ tokens: the loss after the last step below
    the first step's, every loss finite, peak memory and step times;
    then the same steps at JOINT_LR_HIGH, their losses reported."""
    from repro_torch import optim
    from repro_torch.data import LMClientStream
    from repro_torch.runtime.steps import make_joint_train_step

    raw = LMClientStream(model.cfg.vocab_size, 0).batch(
        np.random.default_rng(7), JOINT_BATCH, JOINT_SEQ)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    opt = optim.adamw()

    def step_at(lr):
        return make_joint_train_step(model, opt, optim.cosine(
            lr, JOINT_STEPS, warmup=1))
    ops = tm["ops"]
    ops.reset_launch_counts()
    losses, lrs, times, peak = joint_steps(torch, opt, step_at(JOINT_LR),
                                           params, batch)
    counts = ops.launch_counts()
    check(all(math.isfinite(x) for x in losses), f"joint losses {losses}")
    check(losses[-1] < losses[0],
          f"joint step: loss {losses[-1]} after {JOINT_STEPS} steps, "
          f"{losses[0]} at the first")
    check_launches("joint_step_full", counts, {})
    high = joint_steps(torch, opt, step_at(JOINT_LR_HIGH), params, batch)[0]
    emit({"phase": "joint_step_full", "arch": model.cfg.name,
          "batch": JOINT_BATCH, "seq": JOINT_SEQ, "optimizer": "adamw",
          "schedule": f"cosine({JOINT_LR}, {JOINT_STEPS}, warmup=1)",
          "losses": losses, "lrs": lrs, "step_s": times,
          "tokens_per_s_after_first": JOINT_BATCH * JOINT_SEQ * (
              JOINT_STEPS - 1) / sum(times[1:]),
          "max_memory_allocated_gb": peak / 1e9, "launches": counts,
          "losses_at_lr_high": {"lr": JOINT_LR_HIGH, "losses": high}})


def prefill_vs_decode(torch, np, model, params, tokens, at, tag, tol):
    """``prefill_fn`` of the first t + 1 tokens against the teacher-forced
    decode logits at position t, for each t of ``at``: within ``tol`` of
    the largest decode logit (reported only where ``tol`` is None).
    Returns the rows."""
    from repro_torch.runtime.steps import make_prefill_step
    decoded = teacher_forced(torch, model, params, tokens, "cuda", at)
    prefill = make_prefill_step(model)
    rows = []
    for i, t in enumerate(at):
        got = prefill(params, {"tokens": torch.from_numpy(
            tokens[:, :t + 1]).cuda()})[:, 0].float().cpu()
        want = decoded[:, i]
        scale = want.abs().max().item()
        diff = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{tag}: prefill at {t}")
        check(tol is None or diff <= tol * scale,
              f"{tag}: prefill vs decode at {t}: {diff} > {tol} x {scale}")
        rows.append({"t": t, "max_abs_logit": scale,
                     "max_abs_diff": diff, "diff_of_max": diff / scale,
                     "tol_of_max": tol,
                     "same_argmax": (got.argmax(-1) == want.argmax(-1))
                     .float().mean().item()})
    return rows


def phase_prefill_dense_full(torch, np, tm, model, params):
    """prefill_fn of tinyllama-1.1b (the decode phases' bf16 weights) at
    PREFILL_BATCH x PREFILL_LEN tokens against the teacher-forced decode
    path's logits at the last position; prefill's own time."""
    from repro_torch.runtime.steps import make_prefill_step
    tokens = np.random.default_rng(13).integers(
        0, model.cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
    last = PREFILL_LEN - 1
    tm["ops"].reset_launch_counts()
    rows = prefill_vs_decode(torch, np, model, params, tokens, (last,),
                             "prefill_dense_full", PREFILL_TOL)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    prefill = make_prefill_step(model)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: prefill(params, batch), 2)
    emit({"phase": "prefill_dense_full", "arch": model.cfg.name,
          "batch": PREFILL_BATCH, "seq": PREFILL_LEN, "vs_decode": rows,
          "prefill_ms": ms,
          "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / ms * 1e3,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "decode_launches": tm["ops"].launch_counts()})


def bf16_layers_vs_cpu(torch, bridge, model, params, tokens):
    """The bf16 decode step layer by layer, the card against the CPU:
    ``tokens`` decoded eagerly on the card, and at each position of
    MAMBA_AT every block, then the head, run on the card and on the CPU
    (the same weights moved there) from the card's own input and cache
    entry: the block's output and its new conv and ssm states, and the
    logits, each within PREFILL_TOL of its largest entry. Whole-model
    bf16 logits cannot be held so: each op's last bit is amplified over
    the layers (the card at another batch size parts as far). Returns
    the worst share of the largest entry for each kind of tensor."""
    from repro_torch.models.layers import rms_norm
    host = bridge.unflatten_tree({path: t.cpu() for path, t in
                                  bridge.tree_leaves(params)})
    B, T = tokens.shape
    tok = torch.from_numpy(tokens).cuda()
    cache = model.init_cache(B, T, device="cuda")
    eps = model.cfg.norm_eps
    worst = {"block_out": 0.0, "conv": 0.0, "ssm": 0.0, "logits": 0.0}

    def hold(kind, got, want, where):
        got, want = got.float().cpu(), want.float()
        share = ((got - want).abs().max() / want.abs().max()).item()
        check(share <= PREFILL_TOL,
              f"mamba2 bf16 decode {where}: {kind} card vs CPU {share} of "
              f"the largest > {PREFILL_TOL}")
        worst[kind] = max(worst[kind], share)

    with torch.no_grad():
        for t in range(T):
            batch = {"tokens": tok[:, t:t + 1], "cache": cache,
                     "cache_len": t}
            if t not in MAMBA_AT:
                model.decode_fn(params, batch)
                continue
            x = params["embed"][tok[:, t:t + 1].long()]
            for i, (bp, hp, entry, (kind, window)) in enumerate(zip(
                    params["layers"], host["layers"], cache["layers"],
                    model.specs)):
                e_cpu = {k: v.to("cpu", copy=True) for k, v in entry.items()}
                x_cpu = x.cpu()
                x = model._decode_block(kind, window, bp, x, entry, t, None)
                want = model._decode_block(kind, window, hp, x_cpu, e_cpu,
                                           t, None)
                where = f"at {t}, layer {i}"
                hold("block_out", x, want, where)
                for k in ("conv", "ssm"):
                    hold(k, entry[k], e_cpu[k], where)
            x_cpu = x.cpu()
            logits = rms_norm(x, params["final_norm"], eps) @ \
                model._lm_head(params)
            want = rms_norm(x_cpu, host["final_norm"], eps) @ \
                model._lm_head(host)
            hold("logits", logits, want, f"at {t}")
    return {"rows": B, "at": list(MAMBA_AT), "tol_of_max": PREFILL_TOL,
            "worst_of_max": worst}


def phase_decode_mamba_full(torch, np, tm):
    """mamba2-130m at full width and depth, bf16, through the decode
    launcher (DECODE_MAMBA): the step built once and replayed, finite
    logits, no kernel launch (the SSM decode step is plain tensor ops, as
    in the JAX package), tokens/s and step time; a DECODE_GRAPH wave
    replayed against the same step run eagerly, bit for bit; then the
    teacher-forced decode logits against prefill_fn (the ssd_scan route)
    at MAMBA_AT, gated in fp32 (the weights cast), reported in bf16; the
    bf16 step at MAMBA_AT against the CPU's, layer by layer, at
    PREFILL_TOL."""
    serve, ops, bridge = tm["serve"], tm["ops"], tm["bridge"]
    args = serve.parse_args(DECODE_MAMBA)
    model = tm["build_model"](tm["get_arch"](args.arch))
    params = model.init(torch.Generator().manual_seed(args.seed), "cuda")
    n = sum(t.numel() for _, t in bridge.tree_leaves(params))
    finite, built = [], []
    torch.cuda.reset_peak_memory_stats()
    (row, out), wall, counts = timed_run(torch, ops, lambda: serve.run_decode(
        args, params=params,
        on_logits=lambda lg: finite.append(torch.isfinite(lg).all()),
        on_build=built.append))
    peak = torch.cuda.max_memory_allocated()
    build = decode_build("decode_mamba2_130m", built)
    del built
    check_launches("decode_mamba2_130m", counts, {})
    steps = decode_steps(args)
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          "a logit is not finite")
    check(len(out) == args.requests
          and all(len(o) == args.max_new for o in out), "outputs")
    graph = graphs_vs_eager_decode(torch, np, tm["graphs"], model, params)
    tokens = np.random.default_rng(17).integers(
        0, model.cfg.vocab_size, (PREFILL_BATCH, max(MAMBA_AT) + 1))
    ops.reset_launch_counts()
    bf16 = prefill_vs_decode(torch, np, model, params, tokens, MAMBA_AT,
                             "decode_mamba2_130m bf16", None)
    cross = ops.launch_counts()
    vs_cpu = bf16_layers_vs_cpu(torch, bridge, model, params, tokens)
    check(cross["ssd_scan"] == len(MAMBA_AT) * model.cfg.num_layers,
          f"the prefill cross-check's ssd_scan launches: {cross}")
    m32 = tm["build_model"](dataclasses.replace(model.cfg, dtype="float32"))
    p32 = bridge.unflatten_tree({path: t.float() for path, t in
                                 bridge.tree_leaves(params)})
    del params
    fp32 = prefill_vs_decode(torch, np, m32, p32, tokens, MAMBA_AT,
                             "decode_mamba2_130m fp32", CHECK_TOL)
    del p32
    vs_prefill = {"fp32": fp32, "bf16": bf16}
    emit({"phase": "decode_mamba2_130m", "argv": DECODE_MAMBA, "params": n,
          "wall_s": wall, "tok_per_s": row["tokens_generated"] / wall,
          "processed_tok_per_s": steps * args.batch / wall,
          "decode_steps": steps, "step_ms": 1e3 * wall / steps,
          "max_memory_allocated_gb": peak / 1e9, "launches": counts,
          "row": row, "build": build, "graphs_vs_eager": graph,
          "vs_prefill": vs_prefill, "prefill_launches": cross,
          "bf16_vs_cpu": vs_cpu})
    return {"decode_mamba2_130m": counts}


# -- the engine's LM route (--strategy ... --arch) ---------------------------

def engine_lm_launches(strategy, arch, rounds, clients, support,
                       pooled=False):
    """Launches one engine LM run must make, eval included (2 tasks, 4
    fine-tune steps, then the query loss): online_sgd per inner step of
    the cohort, meta_update per Reptile interpolation, client_mean per
    weighted aggregation (the pooled round computes its FedBuff flush
    every round), and for the SSM family ssd_scan once per layer per
    client forward (Transfer's server step is one forward of the pooled
    batch)."""
    ev = LM_EVAL
    epochs = 8
    steps, forwards = {"reptile": (epochs, epochs * clients),
                       "fedavg": (epochs, epochs * clients),
                       "fedsgd": (0, clients), "transfer": (0, 1),
                       "tinyreptile": (support, support * clients)}[strategy]
    want = {"online_sgd": rounds * steps + ev["k_steps"]}
    if strategy in ("reptile", "tinyreptile"):
        want["meta_update"] = rounds
    if pooled:
        want["client_mean"] = rounds
        want["meta_update"] = rounds
    if arch == "mamba2":
        want["ssd_scan"] = 2 * (rounds * forwards + ev["num_tasks"]
                                * (ev["k_steps"] + 1))
    return want


def lm_params_diff(np, bridge, got, want):
    """The largest difference between two param trees (card and CPU)."""
    g, w = bridge.flatten_tree(got), bridge.flatten_tree(want)
    check(set(g) == set(w), "param trees differ in their leaves")
    return max(float(np.abs(g[k].float().cpu().numpy()
                            - w[k].float().cpu().numpy()).max()) for k in w)


def first_round_vs_cpu(np, bridge, name, run, cpu=None):
    """``run(rounds, device)`` for one round on the card and on the CPU
    (or ``cpu``, that run's result from the worker): params and the eval
    within LM_ENGINE_TOL, bills and the pool state (where the run keeps
    one) exact."""
    a = run(1, "cuda")
    b = run(1, "cpu") if cpu is None else cpu
    diff = lm_params_diff(np, bridge, a["params"], b["params"])
    check(diff <= LM_ENGINE_TOL, f"{name}: first round card vs CPU {diff}")
    q, wq = (o["history"][-1]["query_loss"] for o in (a, b))
    check(abs(q - wq) <= LM_ENGINE_TOL, f"{name}: first round query loss "
                                        f"{q} vs the CPU's {wq}")
    check(a.get("comm_bytes") == b.get("comm_bytes"), f"{name}: comm")
    for k, v in b.get("pool_state", {}).items():
        check(np.array_equal(np.asarray(a["pool_state"][k]), np.asarray(v)),
              f"{name}: pool state {k}")
    return {"first_round_max_abs_diff": diff, "tol": LM_ENGINE_TOL,
            "first_round_query_loss_diff": abs(q - wq)}


def lm_engine_run(torch, np, tm, name, argv):
    """The launcher's engine LM route on the card from the seeded init
    (its row printed, launches counted from 0, the round built once,
    the bills as reckoned), and its first round on the card and on the
    CPU (``first_round_vs_cpu``)."""
    tl, ops, bridge = tm["train"], tm["ops"], tm["bridge"]
    args = tl.parse_args(argv)
    model = tm["build_model"](tm["get_arch"](
        tl.ARCH_FAMILIES[args.arch]).reduced())
    init = model.init(torch.Generator().manual_seed(args.seed), "cuda")
    tm["core"].clear_runner_cache()
    (row, out), wall, counts = timed_run(
        torch, ops, lambda: tl.run_engine_strategy(args, init_params=init))
    graph = built_round(tm["engine"])
    check_launches(name, counts, engine_lm_launches(
        args.strategy, args.arch, args.rounds, args.clients, args.batch,
        pooled=args.pool_size is not None))
    q = out["history"][-1]["query_loss"]
    check(math.isfinite(q), f"{name}: query loss {q}")
    if args.strategy != "transfer" and args.pool_size is None:
        bill = 2 * args.rounds * args.clients * tm["core"].CommChannel(
        ).payload_bytes(init)
        check(out["comm_bytes"] == bill, f"{name}: comm {out['comm_bytes']}")
    t0 = time.perf_counter()
    vs_cpu = first_round_vs_cpu(
        np, bridge, name, lambda r, dev: tl.run_engine_strategy(
            tl.parse_args(argv + ["--rounds", str(r), "--device", dev]))[1],
        cpu=tm["refs"].take("engine_lm", tuple(argv)))
    return {"run": name, "argv": argv, "rounds": args.rounds,
            "clients": args.clients, "wall_s": wall,
            "rounds_per_s": args.rounds / wall,
            "vs_cpu_s": time.perf_counter() - t0, "launches": counts,
            **graph, "query_loss": q, "comm_mb": row.get("comm_mb"),
            "vs_cpu": vs_cpu,
            **({"pool_state": {k: (int(v) if np.ndim(v) == 0 else
                                   int(np.asarray(v).sum()))
                               for k, v in out["pool_state"].items()}}
               if "pool_state" in out else {})}


def phase_engine_lm_reduced(torch, np, tm):
    """The engine's LM route on the reduced families (phase 27): the
    launcher's runs against the CPU, TinyReptile through run_federated,
    a crash after round 3 of 6 and its resume, and the launcher's
    default size on the card alone for its rate."""
    core, ops, bridge, tl = tm["core"], tm["ops"], tm["bridge"], tm["train"]
    from repro_torch.data import LmTaskDistribution, lm_loss
    from repro_torch.testing import faults

    runs = [lm_engine_run(torch, np, tm, name, argv + ENGINE_LM)
            for name, argv in ENGINE_LM_RUNS]
    paths = {f"engine_lm_{r['run']}": r["launches"] for r in runs}

    # TinyReptile's stream through the API, at the same size
    model = tm["build_model"](tm["get_arch"]("mamba2-130m").reduced())
    init = model.init(torch.Generator().manual_seed(0), "cuda")
    dist = LmTaskDistribution(model.cfg.vocab_size, 64)
    strategy = core.TinyReptileStrategy(lm_loss(model))
    kw = dict(rounds=6, clients_per_round=8, support=8, alpha=1.0,
              beta=0.02, seed=4, eval_every=6, eval_kwargs=LM_EVAL)
    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, ops, lambda: core.run_federated(
        init, dist, strategy, device="cuda", **kw))
    graph = built_round(tm["engine"])
    check_launches("engine_lm_tinyreptile", counts, engine_lm_launches(
        "tinyreptile", "mamba2", 6, 8, 8))
    q = out["history"][-1]["query_loss"]
    check(math.isfinite(q), f"engine_lm_tinyreptile: query loss {q}")
    runs.append({"run": "tinyreptile_mamba2_api", "rounds": 6, "clients": 8,
                 "wall_s": wall, "rounds_per_s": 6 / wall,
                 "launches": counts, **graph, "query_loss": q,
                 "vs_cpu": first_round_vs_cpu(
                     np, bridge, "engine_lm_tinyreptile",
                     lambda r, dev: core.run_federated(
                         init, dist, strategy, device=dev,
                         **dict(kw, rounds=r, eval_every=r)))})
    paths["engine_lm_tinyreptile_api"] = counts

    # crash after the round-3 snapshot, resume: equal to the uninterrupted
    # card run exactly, one build across the three runs
    strategy = core.ReptileStrategy(lm_loss(model), epochs=8)
    kw = dict(kw, seed=0)

    def ckpt_run(d, **extra):
        return core.run_federated(init, dist, strategy, device="cuda",
                                  ckpt_dir=d, ckpt_every=ENGINE_LM_CKPT,
                                  **kw, **extra)

    core.clear_runner_cache()
    with tempfile.TemporaryDirectory() as d:
        ref = ckpt_run(f"{d}/ref")
        try:
            with faults.crash_at_round(ENGINE_LM_CKPT):
                ckpt_run(f"{d}/run", ckpt_async=False)
            check(False, "engine_lm ckpt: the crash did not happen")
        except faults.SimulatedPreemption:
            pass
        ops.reset_launch_counts()
        res = ckpt_run(f"{d}/run", resume=True)
        torch.cuda.synchronize()
        resumed_counts = ops.launch_counts()
    (runner,) = tm["engine"]._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1, f"ckpt: {runner.trace_count} builds")
    for (path, a), (_, b) in zip(bridge.tree_leaves(res["params"]),
                                 bridge.tree_leaves(ref["params"])):
        check(torch.equal(a, b), f"engine_lm ckpt: {path} differs")
    check(res["history"] == ref["history"]
          and res["comm_bytes"] == ref["comm_bytes"],
          "engine_lm ckpt: history or bills differ")
    paths["engine_lm_ckpt_resumed"] = resumed_counts

    # a larger cohort (ENGINE_LM_RATE: 32 clients, 20 rounds) on the card
    # alone
    args = tl.parse_args(ENGINE_LM_RATE)
    base = core.evaluate_init(
        lm_loss(model), init, LmTaskDistribution(model.cfg.vocab_size,
                                                 args.seq),
        np.random.default_rng(10_000 + args.rounds - 1),
        **LM_EVAL)["query_loss"]
    core.clear_runner_cache()
    torch.cuda.reset_peak_memory_stats()
    (row, out), wall, counts = timed_run(
        torch, ops, lambda: tl.run_engine_strategy(args))
    graph = built_round(tm["engine"])
    check_launches("engine_lm_rate", counts, engine_lm_launches(
        "reptile", "mamba2", args.rounds, args.clients, args.batch))
    q = out["history"][-1]["query_loss"]
    tokens = args.rounds * args.clients * tl.EPOCHS * args.batch * args.seq
    rate = {"run": "reptile_mamba2_c32", "argv": ENGINE_LM_RATE,
            "rounds": args.rounds, "clients": args.clients, "wall_s": wall,
            "rounds_per_s": args.rounds / wall,
            "tokens_per_s": tokens / wall, "launches": counts, **graph,
            "query_loss": q, "random_init_query_loss": base,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}
    paths["engine_lm_rate"] = counts
    emit({"phase": "engine_lm_reduced", "runs": runs,
          "ckpt": {"crash_after": ENGINE_LM_CKPT, "rounds": 6,
                   "exact": True, "trace_count": runner.trace_count},
          "rate": rate})
    check(math.isfinite(q) and q < base,
          f"engine_lm_rate: query loss {q} not below the init's {base}")
    return paths


class EpochLosses:
    """A loss that keeps a detached view of each call's (C,) losses. In a
    captured round those tensors are the graph's own outputs, which every
    replay rewrites: read after a round, the warm-up's (round 0) or the
    capture's (every later round) are that round's losses by epoch."""

    def __init__(self, loss):
        self.loss = loss
        self.calls = []

    def __call__(self, params, batch):
        out = self.loss(params, batch)
        self.calls.append(out.detach())
        return out


def grad_vs_cpu(torch, np, loss, init, dist, tol):
    """One inner SGD step of the engine at full width, the card against
    the CPU: ``cohort_grad`` of a cohort of 2 clients at ``init`` (CPU
    tensors), on 2 sequences each, leaf by leaf within ``tol`` of each
    leaf's largest entry on the CPU, the losses within 1e-5 relative
    (``check_grad_vs_cpu``). Returns the losses, the five worst leaves
    (relative and absolute distance, and the leaf's largest gradient
    entry) and the leaf of the largest absolute distance."""
    from repro_torch.bridge import FlatLayout
    from repro_torch.core.meta import cohort_grad

    layout = FlatLayout.of_tree(init)
    flat = layout.pack(layout.named(init)).expand(2, -1)
    block = dist.sample_support_block(np.random.default_rng(1), 1, 2, 2)
    t0 = time.perf_counter()
    out = {}
    for dev in ("cuda", "cpu"):
        lo, g = cohort_grad(loss, layout, flat.to(dev).contiguous(),
                            {k: torch.from_numpy(v[0]).to(dev)
                             for k, v in block.items()})
        out[dev] = (lo.cpu().numpy(), {
            k: v.cpu().numpy() for k, v in layout.views(g).items()})
        del g
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    leaves = []
    for k, want in gp.items():
        top = float(np.abs(want).max())
        diff = float(np.abs(gc[k] - want).max())
        leaves.append({"leaf": "/".join(map(str, k)), "rel": diff / top,
                       "abs": diff, "max_abs_grad": top})
    leaves.sort(key=lambda r: -r["rel"])
    return {"clients": 2, "support": 2, "tol": tol,
            "losses": {"card": lc.tolist(), "cpu": lp.tolist()},
            "max_abs_grad": max(r["max_abs_grad"] for r in leaves),
            "worst_leaves": leaves[:5],
            "worst_abs_leaf": max(leaves, key=lambda r: r["abs"]),
            "leaves_over_tol": sum(r["rel"] > tol for r in leaves),
            "leaves": len(leaves), "s": time.perf_counter() - t0}


def check_grad_vs_cpu(np, name, row):
    """``grad_vs_cpu``'s gates, once its row is printed."""
    lc, lp = (np.asarray(row["losses"][d]) for d in ("card", "cpu"))
    check(abs(lc - lp).max() <= 1e-5 * abs(lp).max(),
          f"{name}: losses {lc} vs the CPU's {lp}")
    check(row["leaves_over_tol"] == 0,
          f"{name}: {row['leaves_over_tol']} leaves' gradients past "
          f"{row['tol']} of their largest entry, the worst "
          f"{row['worst_leaves'][0]}")


def phase_engine_lm_full(torch, np, tm):
    """mamba2-130m at full width in fp32 on the engine (phase 28), cut to
    FULL_LM_RUN_LAYERS: ReptileStrategy(epochs=8) at the launcher's
    --batch 8 --seq 64, a cohort of FULL_LM_CLIENTS, FULL_LM_ROUNDS rounds, one eval; every
    round's inner loss by epoch read from the captured round's own
    tensors (one round a block); one inner SGD step at cohort 2, support
    2 against the CPU (``grad_vs_cpu``); a profile of one replayed round
    and of one eager client update (for the plain ssd_chunked backward's
    share)."""
    core, ops, bridge, mamba2 = tm["core"], tm["ops"], tm["bridge"], \
        tm["mamba2"]
    from repro_torch.data import LmTaskDistribution, lm_loss

    cfg = dataclasses.replace(tm["get_arch"]("mamba2-130m"), dtype="float32")
    model = tm["build_model"](cfg)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    n_params = sum(v.numel() for _, v in bridge.tree_leaves(init))
    check(n_params == FULL_LM_PARAMS, f"mamba2-130m: {n_params} params")
    dist = LmTaskDistribution(cfg.vocab_size, 64)
    loss = lm_loss(model)
    epochs, clients, rounds = 8, FULL_LM_CLIENTS, FULL_LM_ROUNDS

    # one inner SGD step at cohort 2, support 2, the card against the
    # CPU: the widths cut to 2 layers, then the whole depth
    one_step = {}
    for depth, tol in FULL_LM_GRAD_TOL.items():
        cut = tm["build_model"](dataclasses.replace(cfg, num_layers=depth))
        one_step[f"layers_{depth}"] = grad_vs_cpu(
            torch, np, lm_loss(cut), init if depth == cfg.num_layers else
            cut.init(torch.Generator().manual_seed(0), "cpu"), dist, tol)
    # the engine run at FULL_LM_RUN_LAYERS: the init's first layers
    cfg = dataclasses.replace(cfg, num_layers=FULL_LM_RUN_LAYERS)
    model = tm["build_model"](cfg)
    loss = lm_loss(model)
    init = bridge.unflatten_tree({k: v.cuda() for k, v in
                                  bridge.flatten_tree(cut_params(
                                      model, init)).items()})
    n_params = sum(v.numel() for _, v in bridge.tree_leaves(init))
    base = core.evaluate_init(loss, init, dist,
                              np.random.default_rng(10_000 + rounds - 1),
                              **LM_EVAL)["query_loss"]

    probe = EpochLosses(loss)
    by_round = []

    class Rounds(tm["MetricsTracker"]):
        def on_block(self, start, end, losses):
            super().on_block(start, end, losses)
            src = probe.calls[:epochs] if start == 0 else \
                probe.calls[epochs:2 * epochs]
            by_round.append((time.perf_counter(),
                             torch.stack(src, 1).cpu().numpy()))

    strategy = core.ReptileStrategy(probe, epochs=epochs)
    core.clear_runner_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, wall, counts = timed_run(torch, ops, lambda: core.run_federated(
        init, dist, strategy, rounds=rounds, clients_per_round=clients,
        support=8, alpha=1.0, beta=FULL_LM_BETA, seed=0,
        eval_every=rounds, eval_kwargs=LM_EVAL, max_block=1,
        tracker=Rounds(),
        device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    graph = built_round(tm["engine"])
    check_launches("engine_lm_mamba2_130m", counts, {
        "online_sgd": rounds * epochs + LM_EVAL["k_steps"],
        "meta_update": rounds,
        "ssd_scan": cfg.num_layers * (rounds * epochs * clients
                                      + LM_EVAL["num_tasks"]
                                      * (LM_EVAL["k_steps"] + 1))})
    check(len(by_round) == rounds, f"{len(by_round)} rounds read")
    # the clients' mean loss by epoch, each round
    inner = [per_epoch.mean(axis=0).tolist() for _, per_epoch in by_round]
    q = out["history"][-1]["query_loss"]
    steady = (by_round[-1][0] - by_round[0][0]) / (rounds - 1)
    tokens = rounds * clients * epochs * 8 * 64
    row = {"phase": "engine_lm_mamba2_130m", "arch": cfg.name,
           "dtype": "float32", "params": n_params, "layers": cfg.num_layers,
           "strategy": "reptile", "epochs": epochs, "beta": FULL_LM_BETA,
           "batch": 8, "seq": 64,
           "clients": clients, "rounds": rounds,
           "reduced": {"clients": f"{clients}, not the launcher's 64: one "
                                  f"(C, P) fp32 buffer is "
                                  f"{64 * FULL_LM_PARAMS * 4 / 1e9:.1f} GB "
                                  f"at 64 and at least three are live",
                       "rounds": f"{rounds}, not 4, and {cfg.num_layers} "
                                 f"of 24 layers, for the script's time"},
           "wall_s": wall, "rounds_per_s": rounds / wall,
           "tokens_per_s": tokens / wall,
           "steady_round_s": steady,
           "steady_tokens_per_s": clients * epochs * 8 * 64 / steady,
           "max_memory_allocated_gb": peak, "launches": counts, **graph,
           "inner_loss_by_epoch": inner, "query_loss": q,
           "random_init_query_loss": base,
           "vs_cpu_one_step": one_step}

    # one replayed round under the profiler (device activity only)
    (runner,) = tm["engine"]._RUNNER_CACHE._entries.values()
    (prog,) = runner._programs.values()
    cuda = torch.autograd.DeviceType.CUDA
    act = torch.profiler.ProfilerActivity
    prog.cursor.zero_()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        t0 = time.perf_counter()
        prog.step()
        torch.cuda.synchronize()
        round_wall = time.perf_counter() - t0
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time in the round")
    ssd_us = sum(t for k, (t, _) in by_name.items() if "ssd_scan" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # one eager epoch of one client of the same round, host ranges
    # traced: the share of the plain ssd_chunked backward's kernels
    layout = prog.layout
    batch = {k: v[0, :1] for k, v in prog.batch.items()}  # a staged client
    bwd_range = mamba2.SSD_BACKWARD_RANGE

    def kernel_us(ev):
        return (sum(k.duration for k in ev.kernels if k.name != bwd_range)
                + sum(kernel_us(child) for child in ev.cpu_children))

    plain = core.ReptileStrategy(loss, epochs=1)      # one epoch's share
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        plain.client_update(layout, prog.phi, batch, FULL_LM_BETA)
        torch.cuda.synchronize()
    check_device_rows(torch, prof, "engine_lm_mamba2_130m eager epoch")
    eager = {k: t for k, t, _ in device_rows(torch, prof)
             if t > 0 and k != bwd_range}
    eager_us = sum(eager.values())
    bwd_us = sum(kernel_us(ev) for ev in prof.events()
                 if ev.name == bwd_range and ev.device_type != cuda)
    row["profile_round"] = {
        "wall_ms": 1e3 * round_wall, "device_busy_ms": dev_us / 1e3,
        "device_idle_share": 1 - dev_us / 1e6 / round_wall,
        "kernels": sum(c for _, c in by_name.values()),
        "ssd_scan_ms": ssd_us / 1e3, "ssd_scan_share_of_busy": ssd_us / dev_us,
        "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                       for k, (t, c) in top],
        "eager_epoch_device_ms": eager_us / 1e3,
        "ssd_backward_ms": bwd_us / 1e3,
        "ssd_backward_share_of_busy": bwd_us / eager_us if eager_us else None}
    emit(row)
    for depth, row_ in one_step.items():
        check_grad_vs_cpu(np, f"engine_lm_mamba2_130m one step, {depth}",
                          row_)
    for r, (_, per_epoch) in enumerate(by_round):
        check(np.isfinite(per_epoch).all(), f"round {r}: inner losses")
        check(inner[r][-1] < inner[r][0], f"round {r}: the inner loss did "
                                          f"not fall: {inner[r]}")
    check(math.isfinite(q) and q < base,
          f"engine_lm_mamba2_130m: query loss {q} not below the init's "
          f"{base}")
    del prog, runner, out, init
    core.clear_runner_cache()
    torch.cuda.empty_cache()
    return {"engine_lm_mamba2_130m": counts}


def phase_examples(torch, np, tm):
    """The port's examples on the card (phase 29): the LM meta-training
    example on both families and the quickstart at its 600 rounds, their
    own asserts held, their printed lines in this phase's row."""
    from repro_torch.examples import llm_meta_training, quickstart

    def printed(fn):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        return out, buf.getvalue().splitlines()

    paths, rows = {}, []
    for arch, kernel in (("tinyllama-1.1b", "flash_decode"),
                         ("mamba2-130m", "ssd_scan")):
        (out, lines), wall, counts = timed_run(
            torch, tm["ops"], lambda: printed(lambda: llm_meta_training.main(
                [arch, "--device", "cuda"])))
        check(all(math.isfinite(x) for x in out["losses"]),
              f"example {arch}: losses {out['losses']}")
        check(len(out["greedy"]) == llm_meta_training.NEW_TOKENS,
              f"example {arch}: greedy {out['greedy']}")
        check(all(counts[k] > 0 for k in ("online_sgd", "meta_update",
                                          kernel)),
              f"example {arch}: launches {counts}")
        rows.append({"example": "llm_meta_training", "arch": arch,
                     "wall_s": wall, "launches": counts,
                     "first_loss": out["losses"][0],
                     "last_loss": out["losses"][-1],
                     "greedy": out["greedy"], "output": lines})
        paths[f"example_llm_meta_training_{arch}"] = counts
    (out, lines), wall, counts = timed_run(
        torch, tm["ops"], lambda: printed(lambda: quickstart.main(
            ["--device", "cuda"])))
    check(out["tinyreptile"] < out["random_init"] / 2,
          f"quickstart: TinyReptile {out['tinyreptile']} against the "
          f"random init's {out['random_init']}")
    check(out["comm_bytes"] == 4 * out["comm_bytes_int8"],
          "quickstart: the int8 wire is not a quarter of fp32")
    check(counts["online_sgd"] > 0 and counts["meta_update"] > 0,
          f"quickstart: launches {counts}")
    rows.append({"example": "quickstart", "wall_s": wall,
                 "launches": counts, **out, "output": lines})
    paths["example_quickstart"] = counts
    emit({"phase": "examples", "runs": rows})
    return paths


def phase_kernels_engine_lm(torch, np, ops, ref, rows):
    """online_sgd at the engine's full-width cohort ((FULL_LM_CLIENTS,
    FULL_LM_PARAMS) fp32, 1.03e9 elements: the kernel indexes in 64 bits)
    and meta_update at its phi (FULL_LM_PARAMS fp32), bit for bit against
    their plain versions, beside torch.add and torch.lerp and the bytes
    bound (ssd_scan's engine shapes are among SSD_SHAPES)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    alpha = torch.tensor([0.37], device=dev)
    for kernel, shape in (("online_sgd", (FULL_LM_CLIENTS, FULL_LM_PARAMS)),
                          ("meta_update", (FULL_LM_PARAMS,))):
        a, b = (torch.randn(shape, generator=gen, device=dev)
                for _ in range(2))
        n = a.numel()
        if kernel == "online_sgd":
            fn, plain = (lambda: ops.online_sgd(a, b, 0.02),
                         lambda: ref.online_sgd(a, b, 0.02))
            library, nops = lambda: torch.add(a, b, alpha=-0.02), 2 * n
        else:
            fn, plain = (lambda: ops.meta_update(a, b, alpha),
                         lambda: ref.meta_update(a, b, alpha))
            library, nops = lambda: torch.lerp(a, b, 0.37), 3 * n
        check(torch.equal(fn(), plain()), f"{kernel} engine: not bit-exact")
        moved = 3 * n * 4
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
        tag = "engine_" + "x".join(map(str, shape)) + "_fp32"
        row = {"shape": list(shape), "n": n, "dtype": "float32",
               "tol": "exact", "max_abs_err": 0.0,
               "ms": cuda_ms(torch, fn, 5), **device_ms(torch, fn, calls=5),
               "plain_ms": cuda_ms(torch, plain, 2),
               "library_ms": cuda_ms(torch, library, 5),
               **device_ms(torch, library, "library_device_ms", calls=5),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved}
        rows[f"{kernel}/{tag}"] = row
        emit({"phase": "kernel", "kernel": kernel, "case": tag, **row})
        del a, b
        torch.cuda.empty_cache()
    return rows


# -- the decoder-only families of slice 15: the MoE family (mixtral-8x22b,
# -- llama4-maverick), the hybrid zamba2-1.2b, and glm4-9b and minicpm-2b ----

def phase_kernels_families(torch, np, ops, ref, rows):
    """flash_decode at the new families' shapes (head_dim 128 with 6, 5
    and 16 query heads a KV head, head_dim 64 as MHA), through the
    device-L route at FD_FAMILY_L, each against its plain version (and
    the host-int call, bit for bit), beside its bound and one
    scaled_dot_product_attention call, and their mean over a wave's L = 1
    ... 640; online_sgd in place (out = p, as the LM inner loop runs it)
    bit-equal to the out-of-place call at INPLACE_SGD_N bf16 elements.
    ssd_scan's zamba2 shape is among SSD_SHAPES."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    for i, (name, shape) in enumerate(FD_FAMILY_SHAPES):
        tag = f"family_{name}_{'x'.join(map(str, shape))}"
        q, k, v = fd_inputs(torch, np, shape, torch.bfloat16, 80 + i, dev)
        kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(7)]
        by_L = []
        for L in FD_FAMILY_L:
            length = torch.tensor([L], dtype=torch.int32, device=dev)
            row = fd_row(torch, F, ops, ref, q, kvs, L, length, shape,
                         FD_TOL["bfloat16"])
            rows[f"flash_decode/{tag}_L{L}_devL"] = row
            emit({"phase": "kernel", "kernel": "flash_decode",
                  "case": f"{tag}_L{L}_devL", **row})
            by_L.append((L, row))
        rows[f"flash_decode/{tag}_run_mean"] = run_mean(np, shape, by_L)
        emit({"phase": "kernel", "kernel": "flash_decode",
              "case": f"{tag}_run_mean",
              **rows[f"flash_decode/{tag}_run_mean"]})
        del q, k, v, kvs

    gen = torch.Generator(device="cuda").manual_seed(6)
    p, g = (torch.randn(INPLACE_SGD_N, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    want = ops.online_sgd(p, g, 0.002)
    before = ops.launch_counts()["online_sgd"]
    got = ops.online_sgd(p, g, 0.002, p)
    torch.cuda.synchronize()
    check(got.data_ptr() == p.data_ptr() and torch.equal(p, want),
          "online_sgd in place differs from the out-of-place call")
    check(ops.launch_counts()["online_sgd"] == before + 1,
          "online_sgd in place: one launch")
    n = p.numel()
    t_bytes = 3 * n * 2 / HBM_BYTES_PER_S
    row = {"n": n, "dtype": "bfloat16", "tol": "exact", "in_place": True,
           "max_abs_err": 0.0,
           "ms": cuda_ms(torch, lambda: ops.online_sgd(p, g, 0.002, p), 5),
           **device_ms(torch, lambda: ops.online_sgd(p, g, 0.002, p),
                       calls=5),
           "plain_ms": cuda_ms(torch, lambda: ref.online_sgd(p, g, 0.002),
                               2),
           "library_ms": cuda_ms(torch, lambda: p.add_(g, alpha=-0.002), 5),
           "bound_ms": 1e3 * max(t_bytes, 2 * n / FP32_OPS_PER_S),
           "bound_by": "bytes"}
    rows["online_sgd/in_place_2p28_bf16"] = row
    emit({"phase": "kernel", "kernel": "online_sgd",
          "case": "in_place_2p28_bf16", **row})
    del p, g, want
    torch.cuda.empty_cache()
    return rows


def fd_row(torch, F, ops, ref, q, kvs, L, length, shape, tol):
    """One flash_decode case: the call at L (``length``, an int32 on the
    card, for the device-L route, or None for the host int) against the
    host-int call (bit for bit) and the plain version (``tol`` relative,
    and that times min(1, max |want|) absolute), timed beside its bound
    and one scaled_dot_product_attention call on the attended slices."""
    B, H, Kv, hd, S = shape
    k, v = kvs[0]
    caches = itertools.cycle(kvs)
    arg = L if length is None else length
    got = ops.flash_decode(q, k, v, arg)
    host = ops.flash_decode(q, k, v, L)
    want = ref.flash_decode(q, k, v, L)
    torch.cuda.synchronize()
    check(torch.equal(got, host), f"flash_decode {tuple(shape)} L{L}: the "
                                  f"device-L route differs from the "
                                  f"host-int call")
    atol = tol * min(1.0, want.abs().max().item())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=atol)
    views = itertools.cycle([(q.view(B, H, 1, hd), kc[:, :L].transpose(1, 2),
                              vc[:, :L].transpose(1, 2)) for kc, vc in kvs])
    moved, nops = fd_bytes_ops(shape, L, 0, q.element_size())
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / peak
    return {"shape_BHKvhdS": list(shape), "dtype": str(q.dtype)[6:],
            "L": L, "window": 0,
            "route": "host_int" if length is None else "device_L",
            "R": H // Kv, "rtol": tol, "atol": atol,
            "max_abs_err": (got.float() - want).abs().max().item(),
            "ms": cuda_ms(torch, lambda: ops.flash_decode(
                q, *next(caches), arg), 100),
            **device_ms(torch, lambda: ops.flash_decode(
                q, *next(caches), arg)),
            "plain_ms": cuda_ms(torch, lambda: ref.flash_decode(
                q, *next(caches), L), 20),
            "library_ms": cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *next(views), enable_gqa=True), 100),
            **device_ms(torch, lambda: F.scaled_dot_product_attention(
                *next(views), enable_gqa=True), "library_device_ms"),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "flop": nops}


def run_mean(np, shape, by_L):
    """``(L, row)`` pairs of the bf16 device-L route as their mean over a
    decode wave's L = 1 ... 640 (PATH_RUN), linear between the rows."""
    grid = np.arange(PATH_RUN[0], PATH_RUN[1] + 1)
    inside = [(L, r) for L, r in by_L if L <= PATH_RUN[1]]
    Ls = [L for L, _ in inside]
    return {"shape_BHKvhdS": list(shape), "dtype": "bfloat16",
            "route": "device_L", "L_range": list(PATH_RUN), "from_L": Ls,
            **{key: float(np.interp(grid, Ls, [r[key] for _, r in inside])
                          .mean())
               for key in ("ms", "device_ms", "library_ms",
                           "library_device_ms", "bound_ms")}}


def phase_kernels_encdec_vlm(torch, np, ops, ref, rows, ptxas):
    """flash_decode at slice 16's shapes (phase 33's kernels):
    paligemma-3b's head dim 256 (FD_PALIGEMMA) through the device-L route
    at FD_FAMILY_L in bf16, with its mean over a wave's L = 1 ... 640,
    and at FD_PALIGEMMA_FP32_L in fp32; whisper-tiny's cross decode
    (FD_WHISPER_CROSS) over L = 1,500 through the host-int route, in bf16
    and fp32, and through the device-L route bit for bit. Each against
    its plain version at FD_TOL, beside its bound and
    scaled_dot_product_attention; the head-dim-256 rows carry ptxas's
    register and spill report of their instantiation."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    lines = ptxas.get("flash_decode", [])
    report = {}
    for i, ln in enumerate(lines):        # an entry line, then its report
        for dt in ("bf16", "f32"):
            if "Compiling entry" in ln and f"flash_decode_{dt}ILi256E" in ln:
                report[dt] = list(itertools.takewhile(
                    lambda x: "Compiling entry" not in x, lines[i + 1:]))

    def cases(shape, dtype, Ls, seed, device_len):
        q, k, v = fd_inputs(torch, np, shape, dtype, seed, dev)
        kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(7)]
        out = []
        for L in Ls:
            length = (torch.tensor([L], dtype=torch.int32, device=dev)
                      if device_len else None)
            row = fd_row(torch, F, ops, ref, q, kvs, L, length, shape,
                         FD_TOL[str(dtype)[6:]])
            tag = (f"encdec_vlm_{'x'.join(map(str, shape))}_"
                   f"{str(dtype)[6:]}_L{L}_{row['route']}")
            if shape[3] == 256:
                row["ptxas"] = report.get("bf16" if dtype == torch.bfloat16
                                          else "f32")
            rows[f"flash_decode/{tag}"] = row
            emit({"phase": "kernel", "kernel": "flash_decode", "case": tag,
                  **row})
            out.append((L, row))
        del q, k, v, kvs
        return out

    by_L = cases(FD_PALIGEMMA, torch.bfloat16, FD_FAMILY_L, 90, True)
    mean = run_mean(np, FD_PALIGEMMA, by_L)
    rows["flash_decode/encdec_vlm_paligemma_run_mean"] = mean
    emit({"phase": "kernel", "kernel": "flash_decode",
          "case": "encdec_vlm_paligemma_run_mean", **mean})
    cases(FD_PALIGEMMA, torch.float32, FD_PALIGEMMA_FP32_L, 91, True)
    L = FD_WHISPER_CROSS[-1]
    for seed, dtype in ((92, torch.bfloat16), (93, torch.float32)):
        cases(FD_WHISPER_CROSS, dtype, (L,), seed, False)
        cases(FD_WHISPER_CROSS, dtype, (L,), seed, True)
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def routes_seen(moe):
    """Every ``moe.route`` call while open, in call order: its chosen
    experts and probabilities, on the host (a captured step's replays
    call no Python: run the step eagerly to see each one)."""
    real, seen = moe.route, []

    def tap(params, xf, k):
        probs, gate, idx = real(params, xf, k)
        seen.append((idx.cpu(), probs.detach().float().cpu()))
        return probs, gate, idx
    moe.route = tap
    try:
        yield seen
    finally:
        moe.route = real


def routing_agreement(torch, name, card, cpu):
    """The card's chosen experts against the CPU's, route call by route
    call: the tokens routed alike, and the smallest gap between the k-th
    and (k+1)-th largest probability on the CPU (where a choice can flip
    by rounding). A token routed otherwise fails unless its gap is below
    ROUTE_FLIP_GAP (a rounding place, reported)."""
    check(len(card) == len(cpu), f"{name}: {len(card)} route calls on the "
                                 f"card, {len(cpu)} on the CPU")
    if not cpu:
        return None
    tokens = agree = 0
    gap, flips = math.inf, []
    for (ia, _), (ib, pb) in zip(card, cpu):
        k = ib.shape[-1]
        top = pb.sort(dim=-1, descending=True).values
        g = (top[:, k - 1] - top[:, k] if top.shape[-1] > k
             else torch.full((top.shape[0],), math.inf))
        same = (ia == ib).all(dim=-1)
        tokens += same.numel()
        agree += int(same.sum())
        gap = min(gap, g.min().item())
        flips += g[~same].tolist()
    check(all(f < ROUTE_FLIP_GAP for f in flips),
          f"{name}: {len(flips)} tokens routed otherwise than on the CPU, "
          f"at gaps {sorted(flips)[:5]}")
    return {"route_calls": len(cpu), "tokens": tokens,
            "agree_share": agree / tokens, "min_gap": gap,
            "flip_gaps": flips}


@contextlib.contextmanager
def gc_off():
    """Python's cyclic collector off while open: what a dropped object
    holds on the card is freed with its last reference or not until
    ``free_card`` collects (and then counted there)."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def free_card(torch, after):
    """What Python's cyclic collector frees on the card once a config is
    done: ``memory_allocated`` before and after a collection, and the
    runners (decode runners, engine runners, serving servers) that only
    the collection freed, which fails the phase: a dropped runner must go
    with its last reference (ROADMAP queue C item 1). Then the cache's
    free blocks go back to the card."""
    from repro_torch.core.engine import _BlockRunner
    from repro_torch.runtime.steps import DecodeRunner
    from repro_torch.serving import AdaptationServer
    torch.cuda.synchronize()
    alive = [weakref.ref(o) for o in gc.get_objects() if isinstance(
        o, (DecodeRunner, _BlockRunner, AdaptationServer))]
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    runners = sum(r() is None for r in alive)
    emit({"phase": "free_card", "after": after, "allocated_gb": held / 1e9,
          "gc_freed_bytes": freed, "gc_freed_runners": runners,
          "runners_alive": len(alive) - runners})
    check(runners == 0, f"free_card after {after}: the cyclic collector "
                        f"freed {runners} dropped runners ({freed} bytes)")
    torch.cuda.empty_cache()


def to_device(bridge, tree, dev, dtype=None):
    """A copy of a params tree on ``dev`` (its floats cast to ``dtype``
    where given; the fp32 router stays fp32 either way)."""
    return bridge.unflatten_tree({
        path: t.to(dev, dtype if dtype is not None and t.is_floating_point()
                   else t.dtype)
        for path, t in bridge.tree_leaves(tree)})


def draw_on_card(torch, model, seed):
    """``model``'s params drawn on the card from ``seed`` (a CUDA
    generator: torch's numbers, not the CPU draw's), with the JAX init's
    constants (zeros for norms and biases, A_log = log(linspace(1, 16)),
    D = 1) and ``normal_init``'s scale, 1 / sqrt(fan_in) with fan_in the
    first axis; laid out as one flat buffer per leaf dtype whose views
    are the leaves (sorted paths, ``bridge.FlatLayout``'s order), so the
    update kernels read them without a copy. A host draw runs at some
    140 M params/s; this takes seconds for 20 B."""
    from repro_torch.bridge import tree_leaves, unflatten_tree
    gen = torch.Generator(device="cuda").manual_seed(seed)
    groups = {}
    for path, (shape, dtype) in tree_leaves(model.param_shapes()):
        groups.setdefault(dtype, []).append((path, tuple(shape)))
    leaves = {}
    for dtype, items in groups.items():
        buf = torch.empty(sum(math.prod(s) for _, s in items), dtype=dtype,
                          device="cuda")
        at = 0
        for path, shape in items:
            n = math.prod(shape)
            view = buf[at:at + n].view(shape)
            at += n
            draw_leaf(torch, gen, path[-1], view)
            leaves[path] = view
    return unflatten_tree(leaves)


def draw_leaf(torch, gen, name, view):
    """One leaf of ``draw_on_card`` written into ``view`` (on the card),
    by its name, from ``gen``."""
    from repro_torch.models.transformer import _ZERO_LEAVES
    shape = tuple(view.shape)
    if name == "A_log":
        view.copy_(torch.log(torch.linspace(1.0, 16.0, shape[0],
                                            device="cuda")))
    elif name == "D":
        view.fill_(1.0)
    elif name in _ZERO_LEAVES:
        view.zero_()
    else:
        fan_in = shape[0] if len(shape) >= 2 else math.prod(shape)
        rows = view.view(shape[0], -1)
        step = max(1, (1 << 28) // rows.shape[1])
        for r in range(0, shape[0], step):
            part = rows[r:r + step]
            part.copy_(torch.randn(part.shape, generator=gen,
                                   device="cuda") / math.sqrt(fan_in))


def lm_batch(torch, np, cfg, shape, seed, dev):
    """Next-token tokens and labels (-1 at the end) of ``shape`` from a
    NumPy seed, on ``dev``, then the frontend's float32 patch embeddings
    or frames from the same rng (``train.frontend_inputs``)."""
    from repro_torch.launch.train import frontend_inputs
    r = np.random.default_rng(seed)
    tok = r.integers(0, cfg.vocab_size, shape)
    lab = np.concatenate([tok[:, 1:], np.full((shape[0], 1), -1)], axis=1)
    out = {"tokens": tok, "labels": lab,
           **frontend_inputs(cfg, r, shape[0])}
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def loss_grads(torch, bridge, moe, model, params, batch):
    """``model.loss_fn`` and each leaf's gradient (on the host), with the
    route calls the forward made."""
    leaves = {k: v.detach().requires_grad_()
              for k, v in bridge.tree_leaves(params)}
    with routes_seen(moe) as seen:
        loss = model.loss_fn(bridge.unflatten_tree(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), {k: g.float().cpu() for k, g in zip(leaves, grads)}, \
        seen


def leaves_vs_cpu(name, card, cpu, tol):
    """Leaf by leaf: the card's gradient within ``tol`` of the leaf's
    largest entry on the CPU. Returns the worst leaves."""
    leaves = []
    for k, want in cpu.items():
        top = want.abs().max().item()
        diff = (card[k] - want).abs().max().item()
        leaves.append({"leaf": "/".join(map(str, k)),
                       "rel": diff / top if top else diff, "abs": diff,
                       "max_abs_grad": top})
    leaves.sort(key=lambda r: -r["rel"])
    check(leaves[0]["rel"] <= tol,
          f"{name}: gradient {leaves[0]} past {tol} of its largest entry")
    return {"tol": tol, "leaves": len(leaves),
            "leaves_over_1e-4": sum(r["rel"] > 1e-4 for r in leaves),
            "worst_leaves": leaves[:3]}


def grad_tol(model):
    """A config's gradient tolerance: FAMILY_SSM_GRAD_TOL with Mamba2
    layers, else FAMILY_TOL."""
    return (FAMILY_SSM_GRAD_TOL if any(k == "mamba" for k, _ in model.specs)
            else FAMILY_TOL)


def family_wave(torch, model, params, prompts, dev):
    """One decode wave (FAMILY_WAVE) through a decode runner built once:
    (runner, every step's logits on the host, the tokens, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import DecodeRunner
    runner = DecodeRunner(model, params, device=dev, **FAMILY_WAVE)
    runner.build()
    logits = []
    if dev == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = runner.wave(prompts, on_logits=lambda lg: logits.append(
        lg.cpu()))
    return runner, logits, tokens, ops.launch_counts()


def attn_applications(model):
    """Attention applications of one decode step: flash_decode launches
    (the encoder-decoder's cross step too)."""
    n = sum(kind != "mamba" for kind, _ in model.specs)
    return 2 * n if model.is_encdec else n


def phase_families_reduced(torch, np, fm):
    """Each FAMILY_REDUCED config (phase 30), from one seeded CPU init:
    the loss and every leaf's gradient on the card against the CPU (the
    loss within FAMILY_TOL relative, each leaf within ``grad_tol`` of its
    largest entry, the routing alike), then one decode wave through the
    decode runner (its step captured and replayed) against the CPU
    (every step's logits within CHECK_TOL of the largest, the same
    tokens) and against the same wave run eagerly on the card (bit for
    bit, launches equal: one flash_decode per attention application per
    step); then the train launcher's engine route on the reduced mixtral
    (ENGINE_MOE), its first round against the CPU at 1e-4."""
    bridge, moe, graphs = fm["bridge"], fm["moe"], fm["graphs"]
    runs, paths = [], {}
    for i, (name, arch, over) in enumerate(FAMILY_REDUCED):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(fm["get_arch"](arch).reduced(), **over)
        model = fm["build_model"](cfg)
        p_cpu = model.init(torch.Generator().manual_seed(7 + i), "cpu")
        p_card = to_device(bridge, p_cpu, "cuda")
        out = {dev: loss_grads(torch, bridge, moe, model, p, lm_batch(
            torch, np, cfg, FAMILY_TOKENS, 20 + i, dev))
            for dev, p in (("cuda", p_card), ("cpu", p_cpu))}
        (lc, gc, rc), (lp, gp, rp) = out["cuda"], out["cpu"]
        check(abs(lc - lp) <= FAMILY_TOL * abs(lp),
              f"{name}: loss {lc} vs the CPU's {lp}")
        grads = leaves_vs_cpu(name, gc, gp, grad_tol(model))
        routing = routing_agreement(torch, name, rc, rp)
        with torch.no_grad():
            pre = {dev: model.prefill_fn(p, lm_batch(
                torch, np, cfg, FAMILY_TOKENS, 20 + i, dev)).cpu()
                for dev, p in (("cuda", p_card), ("cpu", p_cpu))}
        pre_scale = pre["cpu"].abs().max().item()
        pre_diff = (pre["cuda"] - pre["cpu"]).abs().max().item()
        check(pre_diff <= CHECK_TOL * pre_scale,
              f"{name}: prefill logits {pre_diff} from the CPU's "
              f"({pre_scale} largest)")

        prompts = torch.from_numpy(np.random.default_rng(30 + i).integers(
            0, cfg.vocab_size, (FAMILY_WAVE["batch"],
                                FAMILY_WAVE["prompt_len"])))
        runner, got, got_tok, counts = family_wave(torch, model, p_card,
                                                   prompts, "cuda")
        check(runner.trace_count == 1 and runner.step.graph is not None,
              f"{name}: the decode step was not captured once")
        info = {"trace_count": runner.trace_count,
                "capture_s": runner.capture_s, "graph_nodes": runner.nodes}
        del runner
        _, want, want_tok, _ = family_wave(torch, model, p_cpu, prompts,
                                           "cpu")
        with uncaptured(graphs):
            _, eager, eager_tok, eager_counts = family_wave(
                torch, model, p_card, prompts, "cuda")
        steps = FAMILY_WAVE["prompt_len"] + FAMILY_WAVE["max_new"]
        check(counts == eager_counts and counts["flash_decode"]
              == steps * attn_applications(model),
              f"{name}: wave launches {counts} vs eager {eager_counts}")
        scale = max(w.abs().max().item() for w in want)
        diff = max((a - b).abs().max().item() for a, b in zip(got, want))
        check(diff <= CHECK_TOL * scale,
              f"{name}: wave logits {diff} from the CPU's ({scale} largest)")
        check(got_tok == want_tok, f"{name}: wave tokens differ from the CPU")
        check(got_tok == eager_tok and all(
            torch.equal(a, b) for a, b in zip(got, eager)),
            f"{name}: the replayed wave differs from the eager one")
        runs.append({"phase": "families_reduced", "config": name,
                     "arch": cfg.name,
                     "layers": cfg.num_layers,
                     "specs": [list(s) for s in model.specs],
                     "loss": {"card": lc, "cpu": lp,
                              "rel_diff": abs(lc - lp) / abs(lp)},
                     "grads": grads, "routing": routing,
                     "prefill": {"logits_max_abs_diff": pre_diff,
                                 "max_abs_logit": pre_scale,
                                 "tol_of_max": CHECK_TOL},
                     "wave": {**FAMILY_WAVE, **info, "launches": counts,
                              "logits_max_abs_diff": diff,
                              "max_abs_logit": scale, "tol_of_max": CHECK_TOL,
                              "tokens": "equal", "replay_vs_eager":
                              "bit_equal"},
                     "s": time.perf_counter() - t0})
        emit(runs[-1])
        paths[f"family_wave_{name}"] = counts
    engine = lm_engine_run(torch, np, fm, "reptile_moe", ENGINE_MOE)
    paths["engine_lm_reptile_moe"] = engine["launches"]
    emit({"phase": "families_reduced_engine", **engine})
    return paths


def cut_params(model, params):
    """``params`` (a deeper config of the same family) cut to ``model``'s
    layers: the first ones, the rest of the tree whole."""
    out = dict(params)
    out["layers"] = params["layers"][:len(model.param_shapes()["layers"])]
    return out


def teacher_forced_routes(torch, fm, model, params, tokens, dev):
    """``teacher_forced`` run eagerly (the step not captured, so every
    route call is seen): (logits, route calls)."""
    with uncaptured(fm["graphs"]), routes_seen(fm["moe"]) as seen:
        logits = teacher_forced(torch, model, params, tokens, dev)
    return logits, seen


def phase_families_decode(torch, np, fm):
    """Each FAMILY_DECODE config at full width (phase 31), bf16, cut to
    the layers that fit (None: full depth), weights drawn on the card:
    ``serve.run_decode`` with the cut model at DECODE_FULL's traffic (8
    requests at batch 8, 512 + 128 tokens, cache 2,048), the step built
    once and replayed: flash_decode launches as reckoned, finite logits,
    tokens/s, step time, peak memory. Then the same weights in fp32, cut
    to the check's layers, CHECK_BATCH x FAMILY_CHECK_STEPS
    teacher-forced steps on the card and on the CPU: the logits within
    CHECK_TOL of the largest, the routing alike. For maverick also its
    MoE block alone (layer 1, 128 experts at full width, bf16) on one
    step's 8 tokens, the card against the CPU within 4 bf16 steps of the
    largest output. mixtral's replayed step is profiled
    (``profile_moe_decode``)."""
    import dataclasses as dc

    bridge, serve, ops, moe = fm["bridge"], fm["serve"], fm["ops"], fm["moe"]
    paths = {}
    for arch, layers, check_layers in FAMILY_DECODE:
        tag = arch.split("-")[0]
        cfg = fm["get_arch"](arch)
        if layers:
            cfg = dc.replace(cfg, num_layers=layers)
        model = fm["build_model"](cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = draw_on_card(torch, model, 0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for _, t in bridge.tree_leaves(params))
        args = serve.parse_args(["--mode", "decode", "--arch", arch]
                                + DECODE_FULL[4:])
        finite, built, marks = [], [], []
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            (row, out), wall, counts = timed_run(
                torch, ops, lambda: serve.run_decode(
                    args, params=params, model=model,
                    on_logits=lambda lg: finite.append(
                        torch.isfinite(lg).all()),
                    on_build=lambda r: (built.append(r),
                                        marks.append(time.perf_counter()))))
        decode_s = time.perf_counter() - marks[0]
        peak = torch.cuda.max_memory_allocated()
        build = decode_build(f"decode_{tag}", built)
        del built
        steps = decode_steps(args)
        check_launches(f"decode_{tag}", counts,
                       {"flash_decode": steps * attn_applications(model)})
        check(len(finite) == steps and bool(torch.stack(finite).all()),
              f"decode_{tag}: a logit is not finite")
        check(len(out) == args.requests
              and all(len(o) == args.max_new for o in out),
              f"decode_{tag}: outputs")
        del finite
        if arch == "mixtral-8x22b":
            profile = profile_moe_decode(torch, np, fm, model, params)
        if arch in FAMILY_REPLAY_CHECK:
            replay = graphs_vs_eager_decode(torch, np, fm["graphs"], model,
                                            params)

        cut = cfg if check_layers is None else dc.replace(
            cfg, num_layers=check_layers)
        m32 = fm["build_model"](dc.replace(cut, dtype="float32"))
        tokens = np.random.default_rng(5).integers(
            0, cfg.vocab_size, (CHECK_BATCH, FAMILY_CHECK_STEPS))
        p32 = to_device(bridge, cut_params(m32, params), "cuda",
                        torch.float32)
        card, r_card = teacher_forced_routes(torch, fm, m32, p32, tokens,
                                             "cuda")
        p32 = to_device(bridge, p32, "cpu")
        free_card(torch, f"decode_{tag} fp32 on the card")
        t1 = time.perf_counter()
        cpu, r_cpu = teacher_forced_routes(torch, fm, m32, p32, tokens, "cpu")
        cpu_s = time.perf_counter() - t1
        del p32
        scale = cpu.abs().max().item()
        diff = (card - cpu).abs().max().item()
        check(diff <= CHECK_TOL * scale,
              f"decode_{tag} fp32 vs CPU: {diff} > {CHECK_TOL} x {scale}")
        res = {"phase": f"decode_{tag}_full", "arch": arch,
               "layers": cfg.num_layers, "params": n_params,
               "init_on_card_s": init_s,
               "argv": {k: getattr(args, k) for k in (
                   "arch", "requests", "batch", "prompt_len", "max_new",
                   "cache_len")},
               "wall_s": wall, "tok_per_s": row["tokens_generated"] / wall,
               "decode_steps": steps, "step_ms": 1e3 * wall / steps,
               "after_build": {"wall_s": decode_s,
                               "tok_per_s": row["tokens_generated"]
                               / decode_s,
                               "step_ms": 1e3 * decode_s / steps},
               "max_memory_allocated_gb": peak / 1e9, "launches": counts,
               "build": build, "sample_output": row["sample_output"],
               "fp32_vs_cpu": {"layers": m32.cfg.num_layers,
                               "steps": FAMILY_CHECK_STEPS,
                               "batch": CHECK_BATCH, "tol_of_max": CHECK_TOL,
                               "max_abs_logit": scale,
                               "logits_max_abs_diff": diff, "cpu_s": cpu_s,
                               "routing": routing_agreement(
                                   torch, f"decode_{tag} fp32", r_card,
                                   r_cpu)}}
        if arch == "mixtral-8x22b":
            res["profile"] = profile
        if arch in FAMILY_REPLAY_CHECK:
            res["replay_vs_eager"] = replay
        if arch == "llama4-maverick-400b-a17b":
            res["moe_block_bf16_vs_cpu"] = moe_block_vs_cpu(
                torch, np, fm, model, params["layers"][1]["moe"])
        emit(res)
        paths[f"decode_{tag}_full"] = counts
        del params, out
        free_card(torch, f"decode_{tag}_full")
    return paths


def moe_block_vs_cpu(torch, np, fm, model, mp):
    """One MoE block at full width in bf16 on a decode step's 8 tokens
    (seeded, rms-scale inputs), the card against the CPU: the output
    within 4 bf16 steps of its largest entry, the aux loss within 1e-5,
    the routing alike."""
    moe, bridge = fm["moe"], fm["bridge"]
    cfg = model.cfg
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 1, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    out = {}
    for dev, p in (("cuda", mp), ("cpu", None)):
        if p is None:
            p = to_device(bridge, mp, "cpu")
        t0 = time.perf_counter()
        with torch.no_grad(), routes_seen(moe) as seen:
            y, aux = moe.moe_block(p, x.to(dev),
                                   experts_per_token=cfg.experts_per_token)
        out[dev] = (y.float().cpu(), aux.item(), seen,
                    time.perf_counter() - t0)
        del p
    (yc, ac, rc, _), (yp, ap, rp, cpu_s) = out["cuda"], out["cpu"]
    scale = yp.abs().max().item()
    diff = (yc - yp).abs().max().item()
    check(diff <= BF16_RTOL_4 * scale,
          f"maverick MoE block bf16: {diff} > 4 bf16 steps of {scale}")
    check(abs(ac - ap) <= 1e-5 * abs(ap), f"maverick aux {ac} vs {ap}")
    return {"tokens": 8, "experts": cfg.num_experts,
            "k": cfg.experts_per_token, "max_abs_out": scale,
            "max_abs_diff": diff, "tol_of_max": BF16_RTOL_4,
            "aux": {"card": ac, "cpu": ap}, "cpu_s": cpu_s,
            "routing": routing_agreement(torch, "maverick MoE block", rc,
                                         rp)}


def profile_moe_decode(torch, np, fm, model, params):
    """One replayed full-width MoE decode step at batch 8 from position
    DECODE_PROFILE_AT under torch.profiler (device activity only): idle
    share, kernels, the top ones; then the same step run eagerly with the
    host traced too, for the share of the experts' three batched
    products (the kernels under moe.EXPERTS_RANGE)."""
    from repro_torch.runtime.steps import DecodeRunner
    B = 8
    runner = DecodeRunner(model, params, batch=B,
                          prompt_len=DECODE_PROFILE_AT + 2, cache_len=2048,
                          max_new=0, device="cuda")
    runner.prompts.copy_(torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, tuple(runner.prompts.shape))))
    runner.build()
    runner.cursor.fill_(DECODE_PROFILE_AT)
    runner.step()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    cuda = torch.autograd.DeviceType.CUDA
    rng_name = fm["moe"].EXPERTS_RANGE
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {k: (t, c) for k, t, c in device_rows(torch, prof)
               if t > 0 and k != rng_name}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "profile_moe_decode: the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    del runner
    free_card(torch, "profile_moe_decode replayed")

    def kernel_us(ev):
        return (sum(k.duration for k in ev.kernels if k.name != rng_name)
                + sum(kernel_us(child) for child in ev.cpu_children))

    with uncaptured(fm["graphs"]):
        eager = DecodeRunner(model, params, batch=B,
                             prompt_len=DECODE_PROFILE_AT + 2,
                             cache_len=2048, max_new=0, device="cuda")
        eager.build()
        eager.cursor.fill_(DECODE_PROFILE_AT)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            eager.step()
            torch.cuda.synchronize()
    check_device_rows(torch, prof, "profile_moe_decode eager")
    eager_us = sum(t for k, t, _ in device_rows(torch, prof)
                   if k != rng_name)
    experts_us = sum(kernel_us(ev) for ev in prof.events()
                     if ev.name == rng_name and ev.device_type != cuda)
    check(experts_us > 0, "profile_moe_decode: no expert kernel traced")
    del eager
    free_card(torch, "profile_moe_decode eager")
    return {"batch": B, "from_position": DECODE_PROFILE_AT,
            "replayed": True, "wall_ms": 1e3 * wall,
            "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e6 / wall,
            "kernels": sum(c for _, c in by_name.values()),
            "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                           for k, (t, c) in top],
            "eager_step_device_ms": eager_us / 1e3,
            "experts_ms": experts_us / 1e3,
            "experts_share_of_busy": experts_us / eager_us}


def family_grad_vs_cpu(torch, np, fm, cfg, layers, tag):
    """One gradient of ``cfg`` at full width in fp32, cut to ``layers``:
    the card against the CPU leaf by leaf within ``grad_tol`` of each
    leaf's largest entry, the loss within 1e-5, the routing alike."""
    import dataclasses as dc
    bridge, moe = fm["bridge"], fm["moe"]
    gcfg = dc.replace(cfg, num_layers=layers, dtype="float32")
    gmodel = fm["build_model"](gcfg)
    t1 = time.perf_counter()
    p_card = draw_on_card(torch, gmodel, 3)
    batch = lm_batch(torch, np, gcfg, FAMILY_GRAD_TOKENS, 4, "cuda")
    lc, gc, rc = loss_grads(torch, bridge, moe, gmodel, p_card, batch)
    p_cpu = to_device(bridge, p_card, "cpu")
    del p_card
    free_card(torch, f"train_{tag}_full grad on the card")
    lp, gp, rp = loss_grads(torch, bridge, moe, gmodel, p_cpu,
                            {k: v.cpu() for k, v in batch.items()})
    del p_cpu
    check(abs(lc - lp) <= 1e-5 * abs(lp),
          f"train_{tag} grad: loss {lc} vs the CPU's {lp}")
    return {"layers": layers, "tokens": list(FAMILY_GRAD_TOKENS),
            "loss": {"card": lc, "cpu": lp},
            **leaves_vs_cpu(f"train_{tag} grad", gc, gp, grad_tol(gmodel)),
            "routing": routing_agreement(torch, f"train_{tag} grad", rc, rp),
            "s": time.perf_counter() - t1}


def check_inner_losses(tag, rows):
    for r in rows:
        for key in ("loss", "inner_first", "inner_last"):
            check(math.isfinite(r[key]),
                  f"train_{tag}: round {r['round']} {key} = {r[key]}")
        check(r["inner_last"] < r["inner_first"],
              f"train_{tag}: round {r['round']}'s inner loss did not "
              f"fall ({r['inner_first']} -> {r['inner_last']})")


def phase_families_train(torch, np, fm):
    """TinyReptile LM meta-training at full width (phase 32), bf16, each
    FAMILY_TRAIN config cut to its layers (None: full depth), weights
    drawn on the card: ``make_meta_train_step`` (the LM launcher's step)
    on one LMClientStream client batch a round at FAMILY_TRAIN_SHAPE and
    beta FAMILY_TRAIN_BETA, alpha annealed from 1 as the launcher does:
    launches as reckoned (online_sgd per dtype group per inner step,
    meta_update per group per round, ssd_scan once per Mamba2 layer per
    inner forward), finite losses, the inner loss by round, tokens/s,
    peak memory. Then ``family_grad_vs_cpu`` at FAMILY_TRAIN's grad
    layers."""
    import dataclasses as dc

    from repro_torch.data import LMClientStream
    from repro_torch.optim.schedules import linear_anneal
    from repro_torch.runtime.steps import make_meta_train_step, microbatch

    bridge, ops = fm["bridge"], fm["ops"]
    shape = FAMILY_TRAIN_SHAPE
    paths = {}
    for arch, layers, rounds, grad_layers in FAMILY_TRAIN:
        tag = arch.split("-")[0]
        cfg = fm["get_arch"](arch)
        if layers:
            cfg = dc.replace(cfg, num_layers=layers)
        model = fm["build_model"](cfg)
        free_card(torch, f"before train_{tag}_full")
        torch.cuda.reset_peak_memory_stats()
        phi = draw_on_card(torch, model, 1)
        n_params = sum(t.numel() for _, t in bridge.tree_leaves(phi))
        groups = len({t.dtype for _, t in bridge.tree_leaves(phi)})
        step = make_meta_train_step(model, beta=FAMILY_TRAIN_BETA)
        sched = linear_anneal(1.0, rounds, floor=0.1)
        rng = np.random.default_rng(2)
        batches = []
        for r in range(rounds):
            raw = microbatch(LMClientStream(cfg.vocab_size, r).batch(
                rng, shape["batch"], shape["seq"]), shape["k_inner"])
            batches.append(({k: torch.from_numpy(v).cuda()
                             for k, v in raw.items()},
                            torch.tensor([sched(r)], device="cuda")))
        rows = []

        def run():
            nonlocal phi
            for r, (batch, alpha) in enumerate(batches):
                t0 = time.perf_counter()
                phi, m = step(phi, batch, alpha)
                loss, first, last = torch.stack(
                    [m["loss"], m["inner_first"], m["inner_last"]]).tolist()
                rows.append({"round": r, "loss": loss, "inner_first": first,
                             "inner_last": last, "alpha": float(alpha),
                             "dt_s": time.perf_counter() - t0})
        _, wall, counts = timed_run(torch, ops, run)
        peak = torch.cuda.max_memory_allocated()
        k = shape["k_inner"]
        mamba = sum(kind == "mamba" for kind, _ in model.specs)
        want = {"online_sgd": rounds * k * groups,
                "meta_update": rounds * groups}
        if mamba:
            want["ssd_scan"] = rounds * k * mamba
        check_launches(f"train_{tag}_full", counts, want)
        check_inner_losses(tag, rows)
        del phi, batches
        free_card(torch, f"train_{tag}_full")
        tokens = rounds * shape["batch"] * shape["seq"]
        rounds_s = sum(r["dt_s"] for r in rows)
        grad = family_grad_vs_cpu(torch, np, fm, cfg, grad_layers, tag)
        emit({"phase": f"train_{tag}_full", "arch": arch,
              "layers": cfg.num_layers, "params": n_params,
              "dtype_groups": groups, **shape, "rounds": rounds,
              "beta": FAMILY_TRAIN_BETA, "wall_s": wall,
              "tokens_per_s": tokens / wall, "rounds_only_s": rounds_s,
              "max_memory_allocated_gb": peak / 1e9, "launches": counts,
              "rows": rows, "grad_vs_cpu": grad})
        paths[f"train_{tag}_full"] = counts
    return paths


def phase_encdec_vlm_train(torch, np, fm):
    """whisper-tiny and paligemma-3b meta-trained at full width and depth
    in bf16 (phase 33) through the LM launcher itself,
    ``train.run_lm(train.parse_args(ENCDEC_VLM_ARGV + [--arch, --rounds]))``:
    the launcher's host init from ``--seed`` (paligemma-3b's weights drawn
    on the card instead, ``run_lm(init_params=)``: the host draw of 2.9 B
    took some 21 s), its per-round draws of the tokens and the float32
    frames or patch embeddings and their copy to the card on its
    prefetch thread. Launches as ``lm_launches`` reckons,
    finite losses, the inner loss falls in every round, tokens/s over the
    launcher's wall (its init included) and over its rounds, peak memory.
    Then ``family_grad_vs_cpu`` at ENCDEC_VLM_TRAIN's grad layers."""
    tl, bridge, ops = fm["train"], fm["bridge"], fm["ops"]
    paths = {}
    for arch, rounds, grad_layers in ENCDEC_VLM_TRAIN:
        tag = arch.split("-")[0]
        argv = ["--arch", arch, "--rounds", str(rounds)] + ENCDEC_VLM_ARGV
        args = tl.parse_args(argv)
        free_card(torch, f"before train_{tag}_full")
        torch.cuda.reset_peak_memory_stats()
        card = arch == "paligemma-3b"
        (rows, summary, phi), wall, counts = timed_run(
            torch, ops, lambda: tl.run_lm(args, init_params=draw_on_card(
                torch, fm["build_model"](fm["get_arch"](arch)), args.seed)
                if card else None))
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"train_{tag}_full", counts, lm_launches(args))
        check_inner_losses(tag, rows)
        n_params = sum(t.numel() for _, t in bridge.tree_leaves(phi))
        del phi
        free_card(torch, f"train_{tag}_full")
        tokens = rounds * args.batch * args.seq
        rounds_s = sum(r["dt_s"] for r in rows)
        grad = family_grad_vs_cpu(torch, np, fm, fm["get_arch"](arch),
                                  grad_layers, tag)
        emit({"phase": f"train_{tag}_full", "arch": arch, "argv": argv,
              "params": n_params, "wall_s": wall,
              "tokens_per_s": tokens / wall, "rounds_only_s": rounds_s,
              "rounds_only_tokens_per_s": tokens / rounds_s,
              "max_memory_allocated_gb": peak / 1e9, "launches": counts,
              "comm_mb": summary["comm_mb"], "rows": rows,
              "grad_vs_cpu": grad})
        paths[f"train_{tag}_full"] = counts
    return paths


# -- slice 17: the engine over mixed-dtype trees, the LM launcher's fleet --

# the bf16 client_mean and the mixed meta_update (a bf16 w with an fp32
# w_hat, the engine's fp32 client mean of a bf16 group): bit for bit
# against their plain versions at these (C, P) and sizes
CM_BF16 = ((8, 1 << 20), (64, 1_153))
MU_MIXED_SIZES = (1_153, LM_BF16)
# the engine on the reduced mamba2 in its own dtypes (bf16 weights, fp32
# SSM scalars): 8 clients x 6 rounds as ENGINE_LM, 2 epochs (the CPU
# tests' count: 8 epochs of bf16 SGD part the two frameworks by more than
# the bf16 tolerance, tests/test_torch_mixed_engine.py), sequences of 32
# tokens, not 64 (the CPU side's time: this phase took 43.1 s at 64 on an
# H100 host), each run's first
# round against the CPU port at the repo's 4 bf16 steps (rtol 2^-6, atol
# 2^-8, every leaf: the fp32 ones get their gradients through bf16
# activations), each captured run against the same run eager on the card
# bit for bit, and the pooled run's crash after round 3 and resume exact
MIXED_CLIENTS, MIXED_ROUNDS, MIXED_EPOCHS, MIXED_SEQ = 8, 6, 2, 32
MIXED_TOL = dict(rtol=2 ** -6, atol=2 ** -8)
MIXED_RUNS = ("reptile", "fedavg", "fedsgd", "pooled_fedbuff", "partial")
# mamba2-130m in its own dtypes on the engine at full width, cut to 4 of
# its 24 layers for the script's time (the fp32 run of
# engine_lm_mamba2_130m keeps 16); Reptile(epochs=8), --batch 8 --seq 64,
# a cohort of 8, 2 rounds; one round of the same run in fp32 at the same
# depth for its peak memory (reached in the first, built, round); the
# first round against the CPU at 1 client and 1 epoch (the CPU takes
# minutes for a cohort of 8 at 8 epochs, 23.4 s at 2 clients and 2
# epochs and 12.6 s at 2 and 1, beside an H100)
MIXED_FULL_LAYERS = 4
MIXED_FULL_CHECK = dict(clients=1, epochs=1)
# the LM launcher's fleet and checkpoint flags: the reduced fp32 mamba2
# against the CPU, and mamba2-130m at full width and depth SIGKILLed right
# after its round-4 snapshot, then resumed
LM_FLEET = ["--pool-size", "1000", "--availability", "diurnal",
            "--buffer-size", "2", "--ckpt-every", "2"]
LM_FLEET_FULL = ["--arch", "mamba2-130m", "--rounds", "6", "--batch", "8",
                 "--seq", "2048", "--k-inner", "4"] + LM_FLEET
LM_FLEET_KILL_AT = 4


def phase_kernels_mixed(torch, np, ops, ref, rows):
    """``client_mean``'s bf16 instantiation at CM_BF16 and
    ``meta_update``'s mixed one at MU_MIXED_SIZES (the sine MLP and
    mamba2-130m's bf16 group), bit for bit against their plain versions,
    timed beside their bytes bounds; the client mean also beside
    torch.sum(w q.float(), 0), on the device too."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(27)
    for C, P in CM_BF16:
        q = (torch.randn((C, P), generator=g, device=dev) * 3).to(
            torch.bfloat16)
        w = torch.rand(C, generator=g, device=dev)
        w[1] = 0.0
        w = w / w.sum()
        got = ops.client_mean(q, w)
        check(torch.equal(got, ref.client_mean(q, w))
              and torch.equal(got, ops.client_mean(q.float(), w)),
              f"client_mean bf16 C {C} P {P}: not bit-exact")

        def fn():
            return ops.client_mean(q, w)

        def library():
            return torch.sum(w[:, None] * q.float(), 0)
        live = int((w > 0).sum())
        moved = 2 * live * P + 4 * C + 4 * P
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = 2 * live * P / FP32_OPS_PER_S
        iters = 200 if C * P < 1e6 else 20
        row = {"C": C, "P": P, "dtype": "bfloat16", "tol": "exact",
               "max_abs_err": 0.0,
               "order": ("fma_chain" if C <= ref.CLIENT_MEAN_CHAIN
                         else "windows_of_32"),
               "ms": cuda_ms(torch, fn, iters),
               "plain_ms": cuda_ms(torch, lambda: ref.client_mean(q, w),
                                   max(iters // 20, 2)),
               "library_ms": cuda_ms(torch, library, iters),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "clients_read": live,
               **device_ms(torch, fn, windows=2),
               **device_ms(torch, library, "library_device_ms",
                           windows=2)}
        rows[f"client_mean/bf16_C{C}_P{P}"] = row
        emit({"phase": "kernel", "kernel": "client_mean",
              "case": f"bf16_C{C}_P{P}", **row})
    for n in MU_MIXED_SIZES:
        w = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
        wh = w.float() + torch.randn(n, generator=g, device=dev) * 1e-2
        alpha = torch.tensor([0.37], device=dev)
        got = ops.meta_update(w, wh, alpha)
        check(got.dtype == torch.bfloat16
              and torch.equal(got, ref.meta_update(w, wh, alpha)),
              f"meta_update bf16 w, fp32 w_hat, n {n}: not bit-exact")

        def fn():
            return ops.meta_update(w, wh, alpha)
        moved = 8 * n
        iters = 200 if n < 1e6 else 10
        row = {"n": n, "dtype": "bfloat16_w_float32_w_hat", "tol": "exact",
               "max_abs_err": 0.0, "ms": cuda_ms(torch, fn, iters),
               "plain_ms": cuda_ms(torch, lambda: ref.meta_update(
                   w, wh, alpha), 2),
               "library_ms": None,
               "bound_ms": 1e3 * max(moved / HBM_BYTES_PER_S,
                                     3 * n / FP32_OPS_PER_S),
               "bound_by": "bytes", "bytes": moved,
               **(device_ms(torch, fn, windows=2) if n > 1e6 else {})}
        rows[f"meta_update/mixed_{n}"] = row
        emit({"phase": "kernel", "kernel": "meta_update",
              "case": f"mixed_{n}", **row})
    emit({"phase": "kernels_mixed", "phase_s": time.perf_counter() - t0})
    return rows


def mamba2_bf16_model(tm, layers=None, full=False):
    """mamba2-130m in bf16 by config (bf16 weights, fp32 SSM scalars):
    the reduced config, or the canonical one cut to ``layers``."""
    cfg = tm["get_arch"]("mamba2-130m")
    cfg = cfg if full else dataclasses.replace(cfg.reduced(),
                                               dtype="bfloat16")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return tm["build_model"](cfg)


def mixed_groups(torch, bridge, tree):
    return {str(dt).split(".")[1]: sum(
        t.numel() for _, t in bridge.tree_leaves(tree) if t.dtype == dt)
        for dt in (torch.bfloat16, torch.float32)}


def mixed_vs_cpu(np, bridge, name, card, cpu):
    """Two runs' params leaf by leaf within MIXED_TOL (each leaf in its
    own dtype on both), bills and pool state exact; the worst share of
    the tolerance."""
    g, w = bridge.flatten_tree(card["params"]), bridge.flatten_tree(
        cpu["params"])
    check(set(g) == set(w), f"{name}: leaves differ")
    worst = 0.0
    for k, want in w.items():
        check(g[k].dtype == want.dtype, f"{name}: {k} dtype {g[k].dtype}")
        a = g[k].float().cpu().numpy()
        b = want.float().cpu().numpy()
        share = float(np.max(np.abs(a - b) / (MIXED_TOL["atol"]
                                              + MIXED_TOL["rtol"]
                                              * np.abs(b))))
        check(share <= 1.0, f"{name}: {k} card vs CPU at {share:.2f} of "
                            f"the bf16 tolerance")
        worst = max(worst, share)
    check(card.get("comm_bytes") == cpu.get("comm_bytes"), f"{name}: comm")
    for k, v in cpu.get("pool_state", {}).items():
        check(np.array_equal(np.asarray(card["pool_state"][k]),
                             np.asarray(v)), f"{name}: pool state {k}")
    return {"tol": "rtol 2^-6, atol 2^-8", "worst_share_of_tol": worst}


def mixed_launches(run, layers, rounds, epochs, clients, groups=2):
    """Launches of one grouped engine run (no eval): per dtype group one
    online_sgd an inner step, one meta_update a Reptile interpolation,
    one client_mean a weighted aggregation (the pooled round computes
    its FedBuff flush every round); ssd_scan once a layer a client
    forward."""
    steps = 0 if run == "fedsgd" else epochs
    want = {"online_sgd": rounds * steps * groups,
            "ssd_scan": layers * rounds * clients * max(steps, 1)}
    if run in ("reptile", "partial", "pooled_fedbuff"):
        want["meta_update"] = rounds * groups
    if run == "pooled_fedbuff":
        want["client_mean"] = rounds * groups
    return want


def phase_engine_lm_mixed_reduced(torch, np, tm):
    """The engine over the reduced mamba2 in its own dtypes (MIXED_RUNS):
    each on the card (one capture), eager on the card (bit-equal), its
    first round on the CPU (MIXED_TOL); the pooled run crashed after
    round 3 and resumed, exact."""
    core, ops, bridge = tm["core"], tm["ops"], tm["bridge"]
    from repro_torch.data import LmTaskDistribution, lm_loss
    from repro_torch.testing import faults

    t_phase = time.perf_counter()
    model = mamba2_bf16_model(tm)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    groups = mixed_groups(torch, bridge, init)
    loss = lm_loss(model)
    vocab = model.cfg.vocab_size

    def plugins(run):
        if run == "pooled_fedbuff":
            return dict(pool=core.ClientPool(LmTaskDistribution(
                vocab, MIXED_SEQ), 1000, seed=0, sampler="vectorized"),
                buffered=core.BufferedAggregation(4),
                sampling=core.DiurnalAvailability(period=24,
                                                  sampler="vectorized"))
        if run == "partial":
            return dict(channel=core.PartialCommChannel(fraction=0.25,
                                                        rotate=True))
        return {}

    def strategy(run):
        if run == "fedsgd":
            return core.FedSGDStrategy(loss)
        cls = core.FedAvgStrategy if run == "fedavg" else \
            core.ReptileStrategy
        return cls(loss, epochs=MIXED_EPOCHS)

    def run_of(run, rounds, device, **extra):
        return core.run_federated(
            init, LmTaskDistribution(vocab, MIXED_SEQ), strategy(run),
            rounds=rounds, clients_per_round=MIXED_CLIENTS,
            support=8, alpha=1.0, beta=0.02, seed=1, device=device,
            **plugins(run), **extra)

    runs, paths = [], {}
    for run in MIXED_RUNS:
        core.clear_runner_cache()
        out, wall, counts = timed_run(
            torch, ops, lambda: run_of(run, MIXED_ROUNDS, "cuda"))
        graph = built_round(tm["engine"])
        check_launches(f"engine_lm_mixed_{run}", counts, mixed_launches(
            run, model.cfg.num_layers, MIXED_ROUNDS, MIXED_EPOCHS,
            MIXED_CLIENTS))
        leaves = bridge.flatten_tree(out["params"])
        check(all(torch.isfinite(v.float()).all() for v in leaves.values()),
              f"engine_lm_mixed_{run}: non-finite params")
        check(mixed_groups(torch, bridge, out["params"]) == groups,
              f"engine_lm_mixed_{run}: leaf dtypes changed")
        core.clear_runner_cache()
        # eager on the card (no capture): the whole run, held to the
        # captured one bit for bit, and its first round, held to the CPU
        with uncaptured(tm["graphs"]):
            eager = run_of(run, MIXED_ROUNDS, "cuda")
            first = run_of(run, 1, "cuda")
        for k, v in bridge.flatten_tree(eager["params"]).items():
            check(torch.equal(v, leaves[k]),
                  f"engine_lm_mixed_{run}: the captured run differs from "
                  f"eager at {k}")
        t0 = time.perf_counter()
        vs_cpu = mixed_vs_cpu(np, bridge, f"engine_lm_mixed_{run}", first,
                              run_of(run, 1, "cpu"))
        runs.append({"run": run, "wall_s": wall,
                     "rounds_per_s": MIXED_ROUNDS / wall,
                     "vs_cpu_s": time.perf_counter() - t0,
                     "launches": counts, **graph, "graph_vs_eager": "exact",
                     "vs_cpu_first_round": vs_cpu,
                     **({"pool_state": {
                         k: (int(v) if np.ndim(v) == 0 else
                             int(np.asarray(v).sum()))
                         for k, v in out["pool_state"].items()}}
                        if "pool_state" in out else {})})
        paths[f"engine_lm_mixed_{run}"] = counts

    # the pooled run crashed right after its round-3 snapshot, resumed:
    # equal to the uninterrupted run (snapshotting at the same rounds)
    core.clear_runner_cache()
    with tempfile.TemporaryDirectory() as d:
        ck = dict(ckpt_every=ENGINE_LM_CKPT)
        ref = run_of("pooled_fedbuff", MIXED_ROUNDS, "cuda",
                     ckpt_dir=f"{d}/ref", **ck)
        try:
            with faults.crash_at_round(ENGINE_LM_CKPT):
                run_of("pooled_fedbuff", MIXED_ROUNDS, "cuda",
                       ckpt_dir=f"{d}/run", ckpt_async=False, **ck)
            check(False, "engine_lm_mixed ckpt: the crash did not happen")
        except faults.SimulatedPreemption:
            pass
        res = run_of("pooled_fedbuff", MIXED_ROUNDS, "cuda",
                     ckpt_dir=f"{d}/run", resume=True, **ck)
    for path, v in bridge.flatten_tree(ref["params"]).items():
        got = bridge.flatten_tree(res["params"])[path]
        check(got.dtype == v.dtype and torch.equal(got, v),
              f"engine_lm_mixed ckpt: {path} differs")
    check(res["per_client_bytes"] == ref["per_client_bytes"],
          "engine_lm_mixed ckpt: bills differ")
    for k, v in ref["pool_state"].items():
        check(np.array_equal(np.asarray(res["pool_state"][k]),
                             np.asarray(v)), f"engine_lm_mixed ckpt: {k}")
    emit({"phase": "engine_lm_mixed_reduced", "arch": model.cfg.name,
          "params_by_dtype": groups, "clients": MIXED_CLIENTS,
          "rounds": MIXED_ROUNDS, "epochs": MIXED_EPOCHS, "seq": MIXED_SEQ,
          "runs": runs, "ckpt": {"crash_after": ENGINE_LM_CKPT,
                                 "exact": True},
          "phase_s": time.perf_counter() - t_phase})
    core.clear_runner_cache()
    return paths


def phase_engine_lm_full_mixed(torch, np, tm):
    """mamba2-130m in its own dtypes (bf16 weights, fp32 SSM scalars) at
    full width on the engine, MIXED_FULL_LAYERS deep: Reptile(epochs=8)
    at --batch 8 --seq 64, a cohort of FULL_LM_CLIENTS, FULL_LM_ROUNDS
    rounds, its per-group launches and peak memory beside the same run in
    fp32 at the same depth; its first round against the CPU at
    MIXED_FULL_CHECK."""
    core, ops, bridge = tm["core"], tm["ops"], tm["bridge"]
    from repro_torch.data import LmTaskDistribution, lm_loss

    t_phase = time.perf_counter()
    model = mamba2_bf16_model(tm, MIXED_FULL_LAYERS, full=True)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    groups = mixed_groups(torch, bridge, init)
    dist = LmTaskDistribution(model.cfg.vocab_size, 64)
    loss = lm_loss(model)
    epochs, clients, rounds = 8, FULL_LM_CLIENTS, FULL_LM_ROUNDS

    def run_of(params, n_clients, n_epochs, n_rounds, device):
        return core.run_federated(
            params, dist, core.ReptileStrategy(loss, epochs=n_epochs),
            rounds=n_rounds, clients_per_round=n_clients, support=8,
            alpha=1.0, beta=FULL_LM_BETA, seed=0, device=device)

    peaks, out_rows = {}, {}
    for dtype, n_rounds in (("mixed", rounds), ("float32", 1)):
        params = to_device(bridge, init, "cuda",
                           torch.float32 if dtype == "float32" else None)
        core.clear_runner_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, wall, counts = timed_run(torch, ops, lambda: run_of(
            params, clients, epochs, n_rounds, "cuda"))
        peaks[dtype] = torch.cuda.max_memory_allocated() / 1e9
        graph = built_round(tm["engine"])
        check_launches(f"engine_lm_mamba2_130m_{dtype}", counts,
                       mixed_launches("reptile", MIXED_FULL_LAYERS, n_rounds,
                                      epochs, clients,
                                      groups=2 if dtype == "mixed" else 1))
        leaves = bridge.flatten_tree(out["params"])
        check(all(torch.isfinite(v.float()).all() for v in leaves.values()),
              f"engine_lm_mamba2_130m_{dtype}: non-finite params")
        out_rows[dtype] = {"rounds": n_rounds, "wall_s": wall,
                           "rounds_per_s": n_rounds / wall,
                           # the rounds after the first (built) one
                           "after_capture_s": wall - graph["capture_s"],
                           "launches": counts, **graph,
                           "max_memory_allocated_gb": peaks[dtype]}
        if dtype == "mixed":
            mixed_counts = counts
            check(mixed_groups(torch, bridge, out["params"]) == groups,
                  "engine_lm_mamba2_130m_mixed: leaf dtypes changed")
        del out, params, leaves
    core.clear_runner_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_kw = dict(n_clients=MIXED_FULL_CHECK["clients"],
                    n_epochs=MIXED_FULL_CHECK["epochs"], n_rounds=1)
    vs_cpu = mixed_vs_cpu(
        np, bridge, "engine_lm_mamba2_130m_mixed",
        run_of(to_device(bridge, init, "cuda"), device="cuda", **check_kw),
        run_of(init, device="cpu", **check_kw))
    core.clear_runner_cache()
    torch.cuda.empty_cache()
    emit({"phase": "engine_lm_mamba2_130m_mixed", "arch": model.cfg.name,
          "params_by_dtype": groups, "layers": MIXED_FULL_LAYERS,
          "strategy": "reptile", "epochs": epochs, "beta": FULL_LM_BETA,
          "batch": 8, "seq": 64, "clients": clients, "rounds": rounds,
          "reduced": {"layers": f"{MIXED_FULL_LAYERS} of 24, for the "
                                f"script's time",
                      "clients": f"{clients}, not the launcher's 64"},
          "cohort_buffer_gb_at_64": {
              "mixed": 64 * (2 * LM_BF16 + 4 * LM_FP32) / 1e9,
              "float32": 64 * 4 * FULL_LM_PARAMS / 1e9},
          "runs": out_rows,
          "peak_gb": peaks, "peak_ratio_mixed_to_fp32":
              peaks["mixed"] / peaks["float32"],
          "vs_cpu_first_round": {**MIXED_FULL_CHECK, **vs_cpu,
                                 "s": time.perf_counter() - t0},
          "phase_s": time.perf_counter() - t_phase})
    return {"engine_lm_mamba2_130m_mixed": mixed_counts}


LM_FLEET_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train
from repro_torch.testing import faults

def hold(step):
    # announce the snapshot at the kill round, then wait for the kill
    if step >= {kill_at}:
        print(faults.SNAPSHOT_TAG, step, flush=True)
        import time
        time.sleep(600)

ckpt._post_save_hook = hold
train.run_lm(train.parse_args(sys.argv[2:]))
"""


def phase_train_lm_fleet(torch, np, tm):
    """The LM launcher's fleet and checkpoint flags (LM_FLEET): the
    reduced fp32 mamba2 on the card against the CPU, row by row; then
    mamba2-130m at full width and depth in its own dtypes (LM_FLEET_FULL)
    in a child process SIGKILLed right after its round-4 snapshot and
    resumed here, equal row by row and leaf by leaf, bit for bit, to a
    run stopped cleanly after the same snapshot and resumed."""
    tl, ops, bridge = tm["train"], tm["ops"], tm["bridge"]
    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.kernels import build
    from repro_torch.testing import faults

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        argv = LM_REDUCED + LM_FLEET + ["--ckpt-dir", f"{d}/card"]
        args = tl.parse_args(argv)
        (rows, summary, phi), wall, counts = timed_run(
            torch, ops, lambda: tl.run_lm(args))
        want_rows, want_sum, want_phi = tl.run_lm(tl.parse_args(
            LM_REDUCED + LM_FLEET + ["--ckpt-dir", f"{d}/cpu", "--device",
                                     "cpu"]))
        snaps = [Path(p).name for p in list_checkpoints(f"{d}/card")]
    billed = [r for r in rows if not r.get("idle")]
    check_launches("train_lm_fleet_reduced", counts, {
        "online_sgd": len(billed) * args.k_inner,
        "meta_update": summary["flushes"],
        "ssd_scan": len(billed) * args.k_inner * 2})
    for got, want in zip(rows, want_rows):
        for k in ("idle", "buffered", "flushes"):
            check(got.get(k) == want.get(k), f"train_lm_fleet: {k}")
    vs_cpu = lm_rows_vs_cpu(np, bridge, "train_lm_fleet_reduced", billed,
                            phi, [r for r in want_rows if not r.get("idle")],
                            want_phi)
    check(summary["flushes"] == want_sum["flushes"], "flushes vs CPU")
    reduced = {"argv": argv[:-2], "wall_s": wall, "launches": counts,
               "rows": rows, "snapshots": snaps, "vs_cpu": vs_cpu,
               "flushes": summary["flushes"]}
    paths = {"train_lm_fleet_reduced": counts}

    torch.cuda.empty_cache()
    libs = sorted(build.BUILD_DIR.glob("*.so"))
    with tempfile.TemporaryDirectory() as d:
        # the child runs (and is killed) on a thread of its own while this
        # process stops its own run cleanly after the same snapshot
        child = {}

        def kill():
            t0 = time.perf_counter()
            child["rc"], child["out"] = faults.kill_after_snapshot(
                [sys.executable, "-c",
                 LM_FLEET_CHILD.replace("{kill_at}", str(LM_FLEET_KILL_AT)),
                 str(SRC)] + LM_FLEET_FULL + ["--ckpt-dir", f"{d}/killed"],
                n=1, timeout=600)
            child["s"] = time.perf_counter() - t0

        killer = threading.Thread(target=kill)
        t0 = time.perf_counter()
        killer.start()
        try:
            with faults.crash_at_round(LM_FLEET_KILL_AT):
                tl.run_lm(tl.parse_args(LM_FLEET_FULL + [
                    "--ckpt-dir", f"{d}/clean"]))
            check(False, "train_lm_fleet: the clean stop did not happen")
        except faults.SimulatedPreemption:
            pass
        killer.join()
        both_s = time.perf_counter() - t0
        rc, out, child_s = child["rc"], child["out"], child["s"]
        check(rc is not None and rc != 0,
              f"train_lm_fleet: the child exited {rc}, not killed:\n{out}")
        check(sorted(build.BUILD_DIR.glob("*.so")) == libs,
              "train_lm_fleet: the child built kernels")
        on_disk = [Path(p).name for p in list_checkpoints(f"{d}/killed")]
        check(on_disk[-1] == f"ckpt_{LM_FLEET_KILL_AT:08d}.npz",
              f"train_lm_fleet: snapshots {on_disk}")
        (got_rows, got_sum, got_phi), resume_wall, counts = timed_run(
            torch, ops, lambda: tl.run_lm(tl.parse_args(
                LM_FLEET_FULL + ["--ckpt-dir", f"{d}/killed", "--resume"])))
        t0 = time.perf_counter()
        want_rows, _, want_phi = tl.run_lm(tl.parse_args(
            LM_FLEET_FULL + ["--ckpt-dir", f"{d}/clean", "--resume"]))
        clean_s = time.perf_counter() - t0
    check([r["round"] for r in got_rows] == list(range(LM_FLEET_KILL_AT, 6)),
          f"train_lm_fleet: resumed rounds {got_rows}")
    for g, w in zip(got_rows, want_rows):
        check({k: v for k, v in g.items() if k != "dt_s"}
              == {k: v for k, v in w.items() if k != "dt_s"},
              f"train_lm_fleet: resumed rows differ: {g} {w}")
    gl, wl = bridge.flatten_tree(got_phi), bridge.flatten_tree(want_phi)
    for k, v in wl.items():
        check(gl[k].dtype == v.dtype and torch.equal(gl[k], v),
              f"train_lm_fleet: resumed {k} differs")
    by_dtype = mixed_groups(torch, bridge, got_phi)
    check(by_dtype == {"bfloat16": LM_BF16, "float32": LM_FP32},
          f"train_lm_fleet: parameter counts {by_dtype}")
    emit({"phase": "train_lm_fleet", "reduced": reduced,
          "full": {"argv": LM_FLEET_FULL, "killed_after": LM_FLEET_KILL_AT,
                   "child_rc": rc, "child_s": child_s,
                   "snapshots_on_disk": on_disk,
                   "resume_wall_s": resume_wall, "launches": counts,
                   "rows": got_rows, "flushes": got_sum["flushes"],
                   "child_and_clean_stop_s": both_s,
                   "clean_resume_s": clean_s,
                   "vs_clean_resume": "exact"},
          "phase_s": time.perf_counter() - t_phase})
    paths["train_lm_fleet_full_resumed"] = counts
    return paths


# -- runtime/flags.py's levers on one card ------------------------------------

# starcoder2-15b: a window of 4,096 in all 40 layers, 48 query heads over
# 4 KV heads of 128. flash_decode as the ringkv route launches it at
# batch 8: window 0 over a ring of the window's 4,096 rows, L = min(c + 1,
# S) computed on the card from a cursor past the wrap (L = S)
STARCODER2 = "starcoder2-15b"
STARCODER2_PARAMS = 15_956_858_880
FD_RINGKV = (8, 48, 4, 128, 4096)
FD_RINGKV_AT = 4159
# the reduced starcoder2 cut to window 16 (as tests/test_perf_levers.py
# cuts mixtral), fp32: 24 + 24 tokens, a logical cache of 48, so the ring
# of 16 rows wraps in the prompt and again while decoding
RINGKV_REDUCED_WINDOW = 16
RINGKV_REDUCED = dict(batch=2, prompt_len=24, max_new=24, cache_len=48)
# starcoder2-15b at full width cut to 4 of its 40 layers (2.14 B params,
# 4.3 GB in bf16, drawn on the card): 8 prompts of 4,160 tokens and 64 new,
# a ring of 4,096 rows against a full cache of 4,224 rows. Past the
# window the ring holds the same rows in another order, so the kernel
# sums them in another split and its bf16 output may round one step
# otherwise; through 4 bf16 layers that is held, as the other bf16 decode
# gates are, at 4 bf16 steps of the largest logit (fixed before the first
# reading)
RINGKV_CUT_LAYERS = 4
RINGKV_CUT = dict(batch=8, prompt_len=4160, max_new=64, cache_len=4224)
RINGKV_TOL = BF16_RTOL_4
# full depth (31.9 GB in bf16), batch 8, the launcher's --cache-len 16384
# (a KV cache of 10.7 GB, a ring of 2.68 GB), one wave of 64 + 64 tokens:
# no step passes the window, so the two routes attend the same rows in
# the same split and their logits are held bit for bit
STARCODER2_FULL = ["--mode", "decode", "--arch", STARCODER2, "--requests",
                   "8", "--batch", "8", "--prompt-len", "64", "--max-new",
                   "64", "--cache-len", "16384"]
# the banded prefill on the 4-layer cut: one sequence of 8,192 tokens, its
# last-token logits against the masked route's (the band's one softmax
# against 512-key blocks: other sums, bf16 outputs) at 4 bf16 steps of the
# largest, fixed before the first reading; each timed PREFILL_REPEATS
# times after a warm-up
BANDED_PREFILL_SEQ = 8192
PREFILL_REPEATS = 3


def phase_kernels_ringkv(torch, np, ops, ref, rows):
    """flash_decode as the ringkv route launches it (phase 35):
    FD_RINGKV, bf16, window 0 over the ring, L = min(c + 1, S) an int32
    computed on the card from the cursor FD_RINGKV_AT, against the
    host-int call (bit for bit) and the plain version (FD_TOL), beside
    its bound and one scaled_dot_product_attention call. starcoder2's 12
    query heads a KV head are two row groups of the kernel's 8: each
    reads the same K and V."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    S = FD_RINGKV[-1]
    q, k, v = fd_inputs(torch, np, FD_RINGKV, torch.bfloat16, 90, dev)
    kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(7)]
    cursor = torch.tensor([FD_RINGKV_AT], dtype=torch.int32, device=dev)
    length = torch.clamp(cursor + 1, max=S)
    check(length.item() == S, f"ringkv: L = {length.item()}, not {S}")
    row = fd_row(torch, F, ops, ref, q, kvs, S, length, FD_RINGKV,
                 FD_TOL["bfloat16"])
    row.update(cursor=FD_RINGKV_AT, ring_rows=S,
               row_groups_per_kv_head=-(-FD_RINGKV[1] // FD_RINGKV[2]
                                        // 8))
    key = "ringkv_" + "x".join(map(str, FD_RINGKV)) + "_bfloat16_devL"
    rows[f"flash_decode/{key}"] = row
    emit({"phase": "kernels_ringkv", "kernel": "flash_decode", "case": key,
          **row})
    del q, k, v, kvs
    torch.cuda.empty_cache()


def cache_bytes(bridge, cache):
    return sum(t.numel() * t.element_size()
               for _, t in bridge.tree_leaves(cache))


def ring_wave(torch, sm, model, params, prompts, dev, ring, shape,
              keep_from=0, eager=False):
    """One wave through a DecodeRunner whose cache was made with the
    ringkv lever ``ring``, its step captured and replayed (or run eagerly,
    ``eager``), launches counted from 0 after the build: (runner, the
    logits of the steps from ``keep_from``, the tokens, wall seconds,
    launches)."""
    from repro_torch.runtime.steps import DecodeRunner
    with sm["flags"].feature_scope(ringkv=ring):
        runner = DecodeRunner(model, params, device=dev, **shape)
    with (uncaptured(sm["graphs"]) if eager else contextlib.nullcontext()):
        runner.build()
        seen, kept = [0], []

        def keep(logits):
            if seen[0] >= keep_from:
                kept.append(logits)
            seen[0] += 1
        if dev == "cuda":
            torch.cuda.synchronize()
        sm["ops"].reset_launch_counts()
        t0 = time.perf_counter()
        tokens = runner.wave(prompts, on_logits=keep)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return runner, kept, tokens, wall, sm["ops"].launch_counts()


def phase_ringkv_reduced(torch, np, sm):
    """The reduced starcoder2 at window RINGKV_REDUCED_WINDOW, fp32, one
    seeded CPU init (phase 35): a RINGKV_REDUCED wave through the decode
    runner with the ring and without, on the card (captured, replayed)
    and on the CPU: every step's logits within CHECK_TOL of the CPU's
    largest, the same tokens, one flash_decode per layer per step; each
    route's replayed wave bit-equal to its step run eagerly on the card;
    the ring's cache the window's rows."""
    bridge = sm["bridge"]
    cfg = dataclasses.replace(sm["get_arch"](STARCODER2).reduced(),
                              sliding_window=RINGKV_REDUCED_WINDOW)
    model = sm["build_model"](cfg)
    p_cpu = model.init(torch.Generator().manual_seed(12), "cpu")
    p_card = to_device(bridge, p_cpu, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (RINGKV_REDUCED["batch"],
                            RINGKV_REDUCED["prompt_len"])))
    steps = RINGKV_REDUCED["prompt_len"] + RINGKV_REDUCED["max_new"]
    runs, paths = {}, {}
    for ring in (True, False):
        tag = "ring" if ring else "full"
        runner, got, got_tok, wall, counts = ring_wave(
            torch, sm, model, p_card, prompts, "cuda", ring, RINGKV_REDUCED)
        rows_kv = sorted({e["k"].shape[1] for e in runner.cache["layers"]})
        check(runner.ring is ring and rows_kv == [
            RINGKV_REDUCED_WINDOW if ring else RINGKV_REDUCED["cache_len"]],
            f"ringkv_reduced {tag}: cache rows {rows_kv}")
        check(runner.trace_count == 1 and runner.step.graph is not None,
              f"ringkv_reduced {tag}: the step was not captured once")
        info = {"trace_count": runner.trace_count,
                "capture_s": runner.capture_s, "graph_nodes": runner.nodes,
                "cache_rows": rows_kv[0],
                "cache_bytes": cache_bytes(bridge, runner.cache)}
        del runner
        _, eager, eager_tok, _, eager_counts = ring_wave(
            torch, sm, model, p_card, prompts, "cuda", ring, RINGKV_REDUCED,
            eager=True)
        _, want, want_tok, cpu_s, _ = ring_wave(
            torch, sm, model, p_cpu, prompts, "cpu", ring, RINGKV_REDUCED)
        check(counts == eager_counts and counts["flash_decode"]
              == steps * cfg.num_layers,
              f"ringkv_reduced {tag}: launches {counts} vs {eager_counts}")
        check(got_tok == eager_tok and all(
            torch.equal(a, b) for a, b in zip(got, eager)),
            f"ringkv_reduced {tag}: the replayed wave differs from eager")
        scale = max(w.abs().max().item() for w in want)
        diff = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(got, want))
        check(diff <= CHECK_TOL * scale,
              f"ringkv_reduced {tag}: logits {diff} from the CPU's "
              f"({scale} largest)")
        check(got_tok == want_tok,
              f"ringkv_reduced {tag}: tokens differ from the CPU")
        runs[tag] = {**info, "wall_s": wall, "launches": counts,
                     "cpu_wall_s": cpu_s, "logits_max_abs_diff": diff,
                     "max_abs_logit": scale, "tol_of_max": CHECK_TOL,
                     "tokens": got_tok[0][:8], "replay_vs_eager":
                     "bit_equal", "logits": got}
        paths[f"ringkv_reduced_{tag}"] = counts
    ring_vs_full = max((a - b).abs().max().item() for a, b in zip(
        runs["ring"].pop("logits"), runs["full"].pop("logits")))
    emit({"phase": "ringkv_reduced", "arch": cfg.name,
          "window": RINGKV_REDUCED_WINDOW, **RINGKV_REDUCED,
          "steps": steps, "runs": runs,
          "ring_vs_full_logits_max_abs_diff": ring_vs_full})
    return paths


def phase_decode_starcoder2_ringkv(torch, np, sm):
    """starcoder2-15b at full width cut to RINGKV_CUT_LAYERS layers, bf16,
    weights drawn on the card (phase 35): a RINGKV_CUT wave through the
    decode runner with a ring of the window's rows and with the full
    cache, each step captured once and replayed. Every step past the
    window whose inputs the two runs share (the teacher-forced prompt
    from position 4,096, then the decode steps up to a choice the gap
    lets differ) holds the ring's logits within RINGKV_TOL of the
    largest; the greedy tokens equal wherever the full cache's top-two
    gap clears BF16_CHOICE_TOL of the largest logit; one flash_decode per
    layer per step; step ms and each run's cache bytes. Returns (paths,
    the model and its params, for the banded prefill)."""
    bridge = sm["bridge"]
    cfg = dataclasses.replace(sm["get_arch"](STARCODER2),
                              num_layers=RINGKV_CUT_LAYERS)
    model = sm["build_model"](cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = draw_on_card(torch, model, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    W, P = cfg.sliding_window, RINGKV_CUT["prompt_len"]
    steps = P + RINGKV_CUT["max_new"]
    prompts = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (RINGKV_CUT["batch"], P)))
    runs, out = {}, {}
    for ring in (True, False):
        tag = "ring" if ring else "full"
        runner, logits, tokens, wall, counts = ring_wave(
            torch, sm, model, params, prompts, "cuda", ring, RINGKV_CUT,
            keep_from=W)
        build = decode_build(f"decode_starcoder2_ringkv_{tag}", [runner])
        rows_kv = sorted({e["k"].shape[1] for e in runner.cache["layers"]})
        check(rows_kv == [W if ring else RINGKV_CUT["cache_len"]],
              f"decode_starcoder2_ringkv {tag}: cache rows {rows_kv}")
        check_launches(f"decode_starcoder2_ringkv_{tag}", counts,
                       {"flash_decode": steps * cfg.num_layers})
        runs[tag] = {"cache_rows": rows_kv[0],
                     "cache_bytes": cache_bytes(bridge, runner.cache),
                     "build": build, "wall_s": wall,
                     "step_ms": 1e3 * wall / steps,
                     "tok_per_s": RINGKV_CUT["batch"]
                     * RINGKV_CUT["max_new"] / wall,
                     "launches": counts}
        out[tag] = (torch.stack(logits)[:, :, 0], np.asarray(tokens))
        del runner, logits
    (ring_l, ring_t), (full_l, full_t) = out["ring"], out["full"]
    check(bool(torch.isfinite(ring_l).all() and torch.isfinite(full_l)
               .all()), "decode_starcoder2_ringkv: a logit is not finite")
    scale = full_l.abs().max().item()
    top2 = full_l.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()    # (steps - W, B)
    worst, compared, flip, clear, equal = 0.0, 0, None, 0, 0
    for i, t in enumerate(range(W, steps)):
        if flip is not None:
            break                     # the runs' inputs differ from here
        diff = (ring_l[i] - full_l[i]).abs().max().item()
        check(diff <= RINGKV_TOL * scale,
              f"decode_starcoder2_ringkv: step {t} logits {diff} past "
              f"{RINGKV_TOL} x {scale}")
        worst, compared = max(worst, diff), compared + 1
        if P - 1 <= t < steps - 1:            # a greedy choice at step t
            j = t - (P - 1)
            same = ring_t[:, j] == full_t[:, j]
            cleared = gaps[i] > BF16_CHOICE_TOL * scale
            check(bool(same[cleared].all()),
                  f"decode_starcoder2_ringkv: step {t}: a token differs "
                  f"where the top-two gap clears {BF16_CHOICE_TOL}")
            clear += int(cleared.sum())
            equal += int(same.sum())
            if not same.all():
                flip = t
    emit({"phase": "decode_starcoder2_ringkv", "arch": STARCODER2,
          "layers": cfg.num_layers, "cut_from": 40, "window": W,
          "params": sum(t.numel() for _, t in bridge.tree_leaves(params)),
          "init_on_card_s": init_s, **RINGKV_CUT, "steps": steps,
          "runs": runs,
          "ring_vs_full": {"steps_compared": compared,
                           "first_compared_step": W, "tol_of_max": RINGKV_TOL,
                           "max_abs_logit": scale,
                           "logits_max_abs_diff": worst,
                           "choices_clearing_gap": clear,
                           "choices_equal": equal, "first_flip_step": flip,
                           "choice_gap_tol_of_max": BF16_CHOICE_TOL}})
    return ({f"decode_starcoder2_ringkv_{tag}": r["launches"]
             for tag, r in runs.items()}, model, params)


def phase_prefill_starcoder2_banded(torch, np, sm, model, params):
    """The banded lever on the 4-layer cut (phase 35): ``prefill_fn`` of
    one sequence of BANDED_PREFILL_SEQ tokens with the masked route and
    under ``banded`` (each query block of 512 against its band of 5,120
    keys, not all 8,192), the last-token logits within RINGKV_TOL of the
    masked route's largest; each route's seconds (the median of
    PREFILL_REPEATS after a warm-up)."""
    from repro_torch.runtime.steps import make_prefill_step
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, model.cfg.vocab_size, (1, BANDED_PREFILL_SEQ))).cuda()
    step = make_prefill_step(model)
    res = {}
    for banded in (False, True):
        with sm["flags"].feature_scope(banded=banded):
            logits = step(params, {"tokens": tokens})
            times = []
            for _ in range(PREFILL_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(params, {"tokens": tokens})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        res["banded" if banded else "masked"] = (
            logits[:, -1].float(), statistics.median(times))
    (masked, t_masked), (band, t_band) = res["masked"], res["banded"]
    check(bool(torch.isfinite(band).all()), "banded prefill: not finite")
    scale = masked.abs().max().item()
    diff = (band - masked).abs().max().item()
    check(diff <= RINGKV_TOL * scale,
          f"banded prefill: logits {diff} past {RINGKV_TOL} x {scale}")
    qb = 512
    emit({"phase": "prefill_starcoder2_banded",
          "layers": model.cfg.num_layers, "seq": BANDED_PREFILL_SEQ,
          "window": model.cfg.sliding_window, "q_block": qb,
          "band_keys": min((model.cfg.sliding_window // qb + 2) * qb,
                           BANDED_PREFILL_SEQ),
          "masked_s": t_masked, "banded_s": t_band,
          "tokens_per_s": {"masked": BANDED_PREFILL_SEQ / t_masked,
                           "banded": BANDED_PREFILL_SEQ / t_band},
          "tol_of_max": RINGKV_TOL, "max_abs_logit": scale,
          "logits_max_abs_diff": diff})


def phase_decode_starcoder2_full(torch, np, sm):
    """starcoder2-15b at full width and depth, bf16, weights drawn on the
    card (phase 35): ``serve.run_decode`` at STARCODER2_FULL with the
    ringkv lever and without, each step captured once and replayed:
    flash_decode launches as reckoned, finite logits, the two routes'
    logits and tokens bit for bit (no step passes the window), decode
    tokens/s and step ms beside the bound of reading every weight once a
    step (the embedding's 8 rows only), each route's peak memory and
    graph nodes."""
    bridge, serve, ops = sm["bridge"], sm["serve"], sm["ops"]
    model = sm["build_model"](sm["get_arch"](STARCODER2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = draw_on_card(torch, model, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in bridge.tree_leaves(params))
    check(n_params == STARCODER2_PARAMS, f"starcoder2-15b: {n_params} "
                                         f"params")
    weights = torch.cuda.memory_allocated()
    args = serve.parse_args(STARCODER2_FULL)
    steps = decode_steps(args)
    embed = params["embed"]
    read = 2 * (n_params - embed.numel()) + 2 * args.batch * embed.shape[1]
    runs, out, paths = {}, {}, {}
    for ring in (True, False):
        tag = "ring" if ring else "full"
        logits, built, marks = [], [], []
        torch.cuda.reset_peak_memory_stats()
        with sm["flags"].feature_scope(ringkv=ring), \
                contextlib.redirect_stdout(io.StringIO()):
            (row, toks), wall, counts = timed_run(
                torch, ops, lambda: serve.run_decode(
                    args, params=params, model=model,
                    on_logits=logits.append,
                    on_build=lambda r: (built.append(r),
                                        marks.append(time.perf_counter()))))
        decode_s = time.perf_counter() - marks[0]
        peak = torch.cuda.max_memory_allocated()
        (runner,) = built
        check(runner.ring is ring, f"decode_starcoder2_full {tag}: ring "
                                   f"{runner.ring}")
        kv = cache_bytes(bridge, runner.cache)
        build = decode_build(f"decode_starcoder2_full_{tag}", built)
        del built, runner
        check_launches(f"decode_starcoder2_full_{tag}", counts,
                       {"flash_decode": steps * model.cfg.num_layers})
        check(len(logits) == steps and all(
            bool(torch.isfinite(lg).all()) for lg in logits),
            f"decode_starcoder2_full {tag}: a logit is not finite")
        runs[tag] = {"cache_bytes": kv, "build": build, "wall_s": wall,
                     "tok_per_s": row["tokens_generated"] / wall,
                     "step_ms": 1e3 * wall / steps,
                     "after_build": {"wall_s": decode_s,
                                     "tok_per_s": row["tokens_generated"]
                                     / decode_s,
                                     "step_ms": 1e3 * decode_s / steps},
                     "max_memory_allocated_gb": peak / 1e9,
                     "above_weights_gb": (peak - weights) / 1e9,
                     "launches": counts,
                     "sample_output": row["sample_output"]}
        out[tag] = (logits, toks)
        paths[f"decode_starcoder2_full_{tag}"] = counts
        torch.cuda.empty_cache()
    check(out["ring"][1] == out["full"][1] and all(
        torch.equal(a, b) for a, b in zip(out["ring"][0], out["full"][0])),
        "decode_starcoder2_full: the ring's logits differ from the full "
        "cache's")
    emit({"phase": "decode_starcoder2_full", "arch": STARCODER2,
          "layers": model.cfg.num_layers, "params": n_params,
          "init_on_card_s": init_s, "weights_gb": weights / 1e9,
          "argv": {k: getattr(args, k) for k in (
              "requests", "batch", "prompt_len", "max_new", "cache_len")},
          "decode_steps": steps, "runs": runs,
          "weights_read_bytes": read,
          "weights_bound_ms": 1e3 * read / HBM_BYTES_PER_S,
          "ring_vs_full": "bit_equal"})
    del out, params
    free_card(torch, "decode_starcoder2_full")
    return paths


# -- slice 19: the engine across processes -------------------------------------

# The multi-rank phases run in one set of MESH_RANKS ranks started with
# the script (``runtime/ranks.py::run_ranks``: spawned, joined through a
# file store), which share the one card through gloo (NCCL refuses two
# ranks on one device). They wait for a ``go`` file, so their start and
# CUDA set-up hide behind the build and the kernel phases.
MESH_RANKS = 2
# the CPU test's cases (tests/test_torch_mesh_engine.py), at the sine
# MLP's full width; phi is held to the card's mesh=None run within the
# tolerances that test measured between the port's mesh=2 and mesh=None
MESH_EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.02, query=8)
MESH_RUN = dict(rounds=6, beta=0.02, support=4, seed=1, eval_every=3,
                eval_kwargs=MESH_EVAL)
MESH_CASES = {
    "reptile": ("ReptileStrategy", dict(epochs=2),
                dict(clients_per_round=5), None, None, None),
    "tinyreptile": ("TinyReptileStrategy", {},
                    dict(clients_per_round=5), None, None, None),
    "fedavg": ("FedAvgStrategy", dict(epochs=2),
               dict(clients_per_round=6), None, None, None),
    "fedsgd": ("FedSGDStrategy", {}, dict(clients_per_round=4),
               None, None, None),
    "transfer": ("TransferStrategy", {}, dict(clients_per_round=3),
                 None, None, None),
    "tifed": ("TifedStrategy", dict(epochs=2),
              dict(clients_per_round=3, support=8), None, None, None),
    "pooled_fedbuff": ("ReptileStrategy", dict(epochs=2),
                       dict(clients_per_round=3), dict(size=7, seed=3),
                       dict(buffer_size=4, flush_staleness=3),
                       ("DiurnalAvailability", dict(period=6))),
}
MESH_VS_ONE_TOL = {"tifed": 2.0 ** -6}
MESH_VS_ONE_FP32 = 1e-5
# the kernels each case launches on every rank
MESH_KERNELS = {"reptile": ("online_sgd", "meta_update", "client_mean"),
                "tinyreptile": ("online_sgd", "meta_update", "client_mean"),
                "fedavg": ("online_sgd", "client_mean"),
                "fedsgd": ("client_mean",), "transfer": ("client_mean",),
                "tifed": ("dfa_epoch_int8", "meta_update", "client_mean"),
                "pooled_fedbuff": ("online_sgd", "meta_update",
                                   "client_mean")}
# the round timed on every topology: Reptile at the launcher's defaults
# (64 clients, support 32, 8 epochs, beta 0.02), no eval
MESH_TIMED = dict(rounds=20, clients_per_round=64, beta=0.02, support=32,
                  seed=0)
# the collective alone: the sine MLP's fp32 phi, and mamba2-130m's two
# dtype groups as the pod round sums them (each group's fp32 client mean)
ALLREDUCE_SIZES = (("sine_mlp_1153", (1_153,), 10),
                   ("mamba2_130m_groups", (LM_BF16, LM_FP32), 3))
# pod-client mode at mamba2-130m's full width and depth, bf16, through the
# LM launcher at its defaults (batch 8, seq 64, k-inner 4: each pod one
# row of each microbatch) but beta 0.002, the full-width families' rate
# (at the launcher's 0.02 the loss climbs from 11 to 221 in 3 rounds); its
# first round also computed in one rank
POD_ARGV = ["--arch", "mamba2-130m", "--mesh", "pod", "--devices",
            str(MESH_RANKS), "--beta", str(FAMILY_TRAIN_BETA)]
POD_ROUNDS = 3
POD_TOL = dict(rtol=2 ** -6, atol=2 ** -8)     # 4 bf16 steps
# the train launcher's two-process route, against its --devices route
LAUNCH_2P = ["--strategy", "reptile"]
EPOCHS_SINE = 8                # the launcher's local epochs
CHILDREN: list = []            # subprocesses main() stops if a phase fails
STREAM_PROCS: list = []        # the streams' processes, likewise


def mesh_case(core, loss, relu_loss, dist, name):
    """One MESH_CASES entry's strategy and ``run_federated`` arguments."""
    strat, skw, kw, pool, buf, avail = MESH_CASES[name]
    kw = dict(MESH_RUN, **kw)
    if strat == "TifedStrategy":
        strategy = core.TifedStrategy(relu_loss, **skw)
        kw["channel"] = core.CommChannel("int8", quantize=False)
    else:
        strategy = getattr(core, strat)(loss, **skw)
    if pool is not None:
        kw["pool"] = core.ClientPool(dist, **pool)
    if buf is not None:
        kw["buffered"] = core.BufferedAggregation(**buf)
    if avail is not None:
        kw["sampling"] = getattr(core, avail[0])(**avail[1])
    return strategy, kw


def run_numpy(np, out):
    """A run's result as NumPy: params, history losses, bills, pool."""
    res = {"params": {k: v.cpu().numpy() for k, v in out["params"].items()},
           "query_loss": [float(h["query_loss"]) for h in out["history"]],
           "per_client_bytes": out.get("per_client_bytes"),
           "comm_bytes": out.get("comm_bytes")}
    if "pool_state" in out:
        res["pool_state"] = {k: np.asarray(v)
                             for k, v in out["pool_state"].items()}
    return res


def sine_mods():
    """The port's modules and the seeded sine MLP init the mesh phases
    take (the same in every rank)."""
    import torch

    from repro_torch import core
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core import engine
    from repro_torch.data import SineTasks
    from repro_torch.kernels import ops
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss,
                                               relu_mlp_loss)
    return {"core": core, "engine": engine, "ops": ops, "dist": SineTasks(),
            "loss": functools.partial(paper_model_loss, SINE_MLP),
            "relu": relu_mlp_loss,
            "phi": init_paper_model(SINE_MLP,
                                    torch.Generator().manual_seed(0), "cpu")}


def timed_round(torch, run):
    """``run()`` (MESH_TIMED's rounds) on the card: host and device (CUDA
    events) milliseconds a round, from the second run (the first
    builds)."""
    run()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    rounds = MESH_TIMED["rounds"]
    return {"host_ms_per_round": 1e3 * (time.perf_counter() - t0) / rounds,
            "event_ms_per_round": start.elapsed_time(end) / rounds}


def mesh_worker(rank, workdir):
    """Every multi-rank phase, in one rank of the MESH_RANKS: the sine
    MLP's cases on ``mesh=2``, the timed round, the collective alone, and
    pod-client mode through the LM launcher. Sets up CUDA and imports,
    writes ``workdir/ready<rank>``, then sleeps until ``workdir/go``.
    Returns NumPy results, each run's launches and timings."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    # the CUDA context and the imports, then ready: idle until the go
    torch.zeros(1, device="cuda")
    from repro_torch.runtime.sharding import all_reduce
    sm = sine_mods()
    core, ops = sm["core"], sm["ops"]
    torch.cuda.synchronize()
    (Path(workdir) / f"ready{rank}").touch()
    go = Path(workdir) / "go"
    while not go.exists():
        time.sleep(0.05)
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": str(torch.cuda.current_device()), "cases": {},
           "launches": {}, "t_go": time.time()}
    for name in MESH_CASES:
        strategy, kw = mesh_case(core, sm["loss"], sm["relu"], sm["dist"],
                                 name)
        core.clear_runner_cache()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        run = core.run_federated(sm["phi"], sm["dist"], strategy, mesh=2,
                                 device="cuda", **kw)
        torch.cuda.synchronize()
        out["launches"][f"mesh_engine_sine_{name}"] = ops.launch_counts()
        (runner,) = sm["engine"]._RUNNER_CACHE._entries.values()
        (prog,) = runner._programs.values()
        out["cases"][name] = dict(run_numpy(np, run),
                                  trace_count=runner.trace_count,
                                  captured=prog.step.graph is not None)
    strategy = core.ReptileStrategy(sm["loss"], epochs=EPOCHS_SINE)
    core.clear_runner_cache()
    out["timed_mesh2"] = timed_round(torch, lambda: core.run_federated(
        sm["phi"], sm["dist"], strategy, mesh=2, device="cuda",
        **MESH_TIMED))
    # the collective alone, on the card's tensors as the rounds give it
    group = dist.group.WORLD
    timings = {}
    for key, sizes, calls in ALLREDUCE_SIZES:
        bufs = [torch.ones(n, dtype=torch.float32, device="cuda")
                for n in sizes]
        for b in bufs:
            all_reduce(b, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            for b in bufs:
                all_reduce(b, group)
        torch.cuda.synchronize()
        timings[key] = {"bytes": 4 * sum(sizes), "calls": calls,
                        "host_ms": 1e3 * (time.perf_counter() - t0) / calls}
        del bufs
    out["allreduce"] = timings
    out["pod"] = pod_rank(torch, np, hashlib, dist, rank)
    return out


def pod_rank(torch, np, hashlib, dist, rank):
    """Pod-client mode through the LM launcher: one round, held on rank 0
    against the same round computed there alone (each pod's inner loop in
    turn, the weighted mean of the two, the interpolation); then
    POD_ROUNDS rounds, timed, their launches counted."""
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import streaming_sgd
    from repro_torch.core.strategies import reptile_aggregate_weighted
    from repro_torch.data import LMClientStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.schedules import linear_anneal
    from repro_torch.runtime.steps import microbatch

    res = {}
    args = train.parse_args(POD_ARGV + ["--rounds", "1"])
    with contextlib.redirect_stdout(io.StringIO()):
        rows, _, phi = train.run_lm(args)
    torch.cuda.synchronize()
    layout = bridge.GroupedLayout.of_tree(phi)
    flat = layout.pack(layout.named(phi))
    res["phi_sha256"] = [hashlib.sha256(t.view(torch.uint8).cpu().numpy()
                                        .tobytes()).hexdigest()
                         for t in flat]
    res["round0"] = rows[0]
    del phi
    if rank == 0:
        # the same round in this rank alone: the launcher's init and
        # draws, each pod's rows in turn
        cfg = get_arch(args.arch)
        model = build_model(cfg.reduced() if args.reduced else cfg)
        phi0 = model.init(torch.Generator().manual_seed(args.seed), "cuda")
        rng = np.random.default_rng(args.seed)
        cid = int(rng.integers(args.clients))
        raw = LMClientStream(model.cfg.vocab_size, cid).batch(
            rng, args.batch, args.seq)
        batch = {k: torch.from_numpy(np.asarray(v)).cuda()
                 for k, v in microbatch(raw, args.k_inner).items()}
        rows_per_pod = batch["tokens"].shape[1] // MESH_RANKS
        hats, losses = [], []
        for p in range(MESH_RANKS):
            part = {k: v[:, p * rows_per_pod:(p + 1) * rows_per_pod]
                    for k, v in batch.items()}
            hat, loss = streaming_sgd(model.loss_fn, phi0, part, args.beta)
            hats.append(layout.pack(layout.named(hat)))
            losses.append(loss)
            del hat
        cohort = tuple(torch.stack(g) for g in zip(*hats))
        del hats
        alpha = float(linear_anneal(args.alpha, args.rounds,
                                    floor=args.alpha * 0.1)(0))
        want = reptile_aggregate_weighted(
            layout.pack(layout.named(phi0)), cohort,
            torch.tensor([alpha], dtype=torch.float32, device="cuda"),
            torch.full((MESH_RANKS,), 1.0 / MESH_RANKS, device="cuda"))
        worst = []
        for g, w in zip(flat, want):
            diff = (g.float() - w.float()).abs()
            bound = POD_TOL["atol"] + POD_TOL["rtol"] * w.float().abs()
            worst.append({"dtype": str(g.dtype), "max_abs_diff":
                          diff.max().item(), "within": bool(
                              (diff <= bound).all().item()),
                          "bit_equal": bool(torch.equal(g, w))})
        res["vs_one_rank"] = worst
        res["loss_one_rank"] = torch.stack(losses).mean().item()
        del want, cohort, phi0
    del flat
    dist.barrier()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args(POD_ARGV + ["--rounds", str(POD_ROUNDS)])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows, summary, _ = train.run_lm(args)
    torch.cuda.synchronize()
    res.update(wall_s=time.perf_counter() - t0, rows=rows,
               launches=ops.launch_counts(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               comm_mb=summary["comm_mb"])
    return res


def start_mesh_workers(workdir):
    """The MESH_RANKS ranks, started now in the background; they wait for
    ``go_mesh_workers``. Returns the thread that collects their results
    (``.result``: the ranks' return values, or the error)."""
    from repro_torch.runtime.ranks import run_ranks

    def collect():
        try:
            thread.result = run_ranks(mesh_worker, MESH_RANKS, workdir,
                                      workdir, device="cuda", threads=2,
                                      timeout=600)
        except BaseException as e:              # raised in the phase
            thread.result = e

    thread = threading.Thread(target=collect, daemon=True)
    thread.start()
    return thread


def wait_mesh_workers_ready(thread, workdir):
    """Block until every rank of ``start_mesh_workers`` is set up and idle,
    so that no timed phase shares the host with their start."""
    t0 = time.perf_counter()
    ready = [Path(workdir) / f"ready{r}" for r in range(MESH_RANKS)]
    while not all(p.exists() for p in ready):
        if not thread.is_alive():
            raise RuntimeError(f"mesh ranks ended before they were ready: "
                               f"{thread.result}")
        time.sleep(0.05)
    emit({"phase": "mesh_ranks_ready",
          "waited_after_build_s": time.perf_counter() - t0})


def phase_mesh_engine_sine(torch, np, thread, workdir, t_start):
    """Give the ranks their go, wait, and hold their runs to the card's
    mesh=None runs: every case bit for bit across the ranks, the bills
    and the pool's identity state exactly, phi within the CPU test's
    tolerance; then the round timed on mesh=2 against mesh=None."""
    sm = sine_mods()
    core, ops = sm["core"], sm["ops"]
    t0 = time.perf_counter()
    (Path(workdir) / "go").touch()
    thread.join()
    outs = thread.result
    if isinstance(outs, BaseException):
        raise outs
    wait_s = time.perf_counter() - t0
    r0, r1 = outs
    rows = {}
    paths = {}
    for name in MESH_CASES:
        a, b = r0["cases"][name], r1["cases"][name]
        for k in a["params"]:
            check(np.array_equal(a["params"][k], b["params"][k]),
                  f"mesh_engine_sine {name}: the ranks' {k} differ")
        check(a["query_loss"] == b["query_loss"],
              f"mesh_engine_sine {name}: the ranks' histories differ")
        strategy, kw = mesh_case(core, sm["loss"], sm["relu"], sm["dist"],
                                 name)
        one = run_numpy(np, core.run_federated(sm["phi"], sm["dist"],
                                               strategy, device="cuda",
                                               **kw))
        check(a["per_client_bytes"] == one["per_client_bytes"]
              and a["comm_bytes"] == one["comm_bytes"],
              f"mesh_engine_sine {name}: bills differ from mesh=None's")
        for f, v in one.get("pool_state", {}).items():
            check(np.array_equal(a["pool_state"][f], v),
                  f"mesh_engine_sine {name}: pool {f} differs")
        tol = MESH_VS_ONE_TOL.get(name, MESH_VS_ONE_FP32)
        diff = max(float(np.abs(a["params"][k] - v).max())
                   for k, v in one["params"].items())
        check(diff <= tol, f"mesh_engine_sine {name}: phi {diff} from "
                           f"mesh=None's, tolerance {tol}")
        for r in (r0, r1):
            c = r["cases"][name]
            check(c["trace_count"] == 1 and not c["captured"],
                  f"mesh_engine_sine {name}: rank {r['rank']} built "
                  f"{c['trace_count']} times (captured: {c['captured']})")
        for r in (r0, r1):
            counts = r["launches"][f"mesh_engine_sine_{name}"]
            for kernel in MESH_KERNELS[name]:
                check(counts[kernel] > 0, f"mesh_engine_sine {name}: rank "
                      f"{r['rank']} launched no {kernel}")
        paths[f"mesh_engine_sine_{name}"] = {
            k: r0["launches"][f"mesh_engine_sine_{name}"][k]
            + r1["launches"][f"mesh_engine_sine_{name}"][k]
            for k in ops.KERNELS}
        rows[name] = {"params_vs_mesh_none": diff, "tol": tol,
                      "trace_count": [r0["cases"][name]["trace_count"],
                                      r1["cases"][name]["trace_count"]],
                      "launches_rank0": r0["launches"][
                          f"mesh_engine_sine_{name}"]}
    strategy = core.ReptileStrategy(sm["loss"], epochs=EPOCHS_SINE)
    core.clear_runner_cache()
    one = timed_round(torch, lambda: core.run_federated(
        sm["phi"], sm["dist"], strategy, device="cuda", **MESH_TIMED))
    emit({"phase": "mesh_engine_sine", "ranks": MESH_RANKS,
          "backend": r0["backend"], "round_form": "eager (gloo stages "
          "through the host; not capturable)",
          "cases": rows, "timed_config": MESH_TIMED,
          "round_mesh2": [r0["timed_mesh2"], r1["timed_mesh2"]],
          "round_mesh_none_captured": one,
          "allreduce_gloo_cuda": r0["allreduce"],
          "ranks_waited_s": wait_s,
          "script_s_so_far": time.perf_counter() - t_start})
    return outs, paths


def phase_pod_client(torch, np, outs):
    """Pod-client mode's checks from the ranks' results."""
    r0, r1 = (o["pod"] for o in outs)
    check(r0["phi_sha256"] == r1["phi_sha256"],
          "pod_client: the ranks' phi differ")
    for g in r0["vs_one_rank"]:
        check(g["within"], f"pod_client: round 0 against one rank: {g}")
    check(abs(r0["round0"]["loss"] - r0["loss_one_rank"])
          <= 1e-3 * abs(r0["loss_one_rank"]),
          f"pod_client: loss {r0['round0']['loss']} vs one rank "
          f"{r0['loss_one_rank']}")
    paths = {}
    for r, o in ((r0, outs[0]), (r1, outs[1])):
        for kernel in ("ssd_scan", "online_sgd", "meta_update",
                       "client_mean"):
            check(r["launches"][kernel] > 0,
                  f"pod_client: rank {o['rank']} launched no {kernel}")
        for row in r["rows"]:
            check(all(math.isfinite(row[k]) for k in
                      ("loss", "inner_first", "inner_last")),
                  f"pod_client: round {row['round']} not finite")
    paths["pod_client_mamba2_130m"] = {
        k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    tokens = POD_ROUNDS * 8 * 64
    emit({"phase": "pod_client_mamba2_130m", "argv": POD_ARGV,
          "rounds": POD_ROUNDS, "backend": outs[0]["backend"],
          "wall_s": [r0["wall_s"], r1["wall_s"]],
          "round_s": [row["dt_s"] for row in r0["rows"]],
          "tokens_per_s": tokens / r0["wall_s"],
          "peak_gb": [r0["peak_gb"], r1["peak_gb"]],
          "launches": [r0["launches"], r1["launches"]],
          "round0_vs_one_rank": r0["vs_one_rank"], "tol": POD_TOL,
          "rows": r0["rows"], "comm_mb": r0["comm_mb"]})
    return paths


def phase_mesh_engine_nccl1(torch, np):
    """A one-rank NCCL group: run_federated(mesh=1) with its collective
    inside the captured round, bit for bit mesh=None, built once; then
    the timed round on it."""
    import torch.distributed as dist

    from repro_torch.runtime import sharding
    from repro_torch.runtime.sharding import init_distributed
    sm = sine_mods()
    core, ops = sm["core"], sm["ops"]
    backend, dev = init_distributed(None, 1, 0, device="cuda:0")
    check(backend == "nccl", f"mesh_engine_nccl1: a rank with its own card "
                             f"took {backend}")
    rows, paths = {}, {}
    try:
        for name in ("reptile_partial", "pooled_fedbuff"):
            runs, calls = {}, {}
            for mesh in (None, 1):
                # a weighted round (partial participation, a pooled
                # FedBuff fleet): its hook sums through the group
                if name == "pooled_fedbuff":
                    strategy, kw = mesh_case(core, sm["loss"], sm["relu"],
                                             sm["dist"], name)
                else:
                    strategy = core.ReptileStrategy(sm["loss"], epochs=2)
                    kw = dict(MESH_RUN, clients_per_round=8,
                              sampling=core.PartialParticipation(0.5))
                core.clear_runner_cache()
                before = sharding.CALLS["all_reduce"]
                (out, wall, counts) = timed_run(
                    torch, ops, lambda: core.run_federated(
                        sm["phi"], sm["dist"], strategy, mesh=mesh,
                        device="cuda", **kw))
                calls[mesh] = sharding.CALLS["all_reduce"] - before
                runs[mesh] = (run_numpy(np, out), built_round(sm["engine"]),
                              counts)
            (a, ga, ca), (b, gb, cb) = runs[None], runs[1]
            for k in a["params"]:
                check(np.array_equal(a["params"][k], b["params"][k]),
                      f"mesh_engine_nccl1 {name}: {k} differs from "
                      f"mesh=None's")
            check(a["per_client_bytes"] == b["per_client_bytes"],
                  f"mesh_engine_nccl1 {name}: bills")
            check(ca == cb, f"mesh_engine_nccl1 {name}: launches {cb} vs "
                            f"{ca}")
            # the round's one all-reduce (the weighted mean), made by the
            # first round's warm-up and by its capture, by no replay
            check(calls[None] == 0 and calls[1] == 2,
                  f"mesh_engine_nccl1 {name}: all_reduce calls {calls}: "
                  f"the collective was not inside the captured round")
            paths[f"mesh_engine_nccl1_{name}"] = cb
            rows[name] = {"bit_equal": True, "mesh_none": ga, "mesh1": gb,
                          "all_reduce_calls": calls[1], "launches": cb}
        strategy = core.ReptileStrategy(sm["loss"], epochs=EPOCHS_SINE)
        core.clear_runner_cache()
        timed = timed_round(torch, lambda: core.run_federated(
            sm["phi"], sm["dist"], strategy, mesh=1, device="cuda",
            **MESH_TIMED))
    finally:
        core.clear_runner_cache()
        dist.destroy_process_group()
    emit({"phase": "mesh_engine_nccl1", "backend": backend,
          "device": str(dev), "round_form": "captured (NCCL)",
          "note": "a one-rank NCCL all_reduce launches no kernel (the "
                  "profiler sees none, the graph no node): the call is "
                  "made inside the capture; NCCL across ranks not run",
          "runs": rows, "timed_config": MESH_TIMED,
          "round_mesh1_nccl_captured": timed})
    return paths


def start_launchers_two_process():
    """The train launcher's two-process route (two processes the script
    starts, ``--num-processes 2 --coordinator 127.0.0.1:<port>
    --process-id 0|1``) and its ``--devices 2`` route (ranks the launcher
    starts), all at once, in the background; returns the processes."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train"] + LAUNCH_2P
    cmds = {"process_1": base + ["--num-processes", "2", "--coordinator",
                                 f"127.0.0.1:{port}", "--process-id", "1"],
            "process_0": base + ["--num-processes", "2", "--coordinator",
                                 f"127.0.0.1:{port}", "--process-id", "0"],
            "devices_2": base + ["--devices", "2"]}
    procs = {k: (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True,
                                       cwd=str(ROOT), env=env))
             for k, cmd in cmds.items()}
    CHILDREN.extend(p for _, p in procs.values())
    return procs


def phase_launcher_two_process(procs):
    """The two-process run's summary row equals the --devices 2 run's
    (every key but its seconds)."""
    rows = {}
    for k, (cmd, p) in procs.items():
        out, err = p.communicate(timeout=300)
        check(p.returncode == 0, f"launcher_two_process {k}: exit "
                                 f"{p.returncode}: {err[-2000:]}")
        lines = [json.loads(line) for line in out.splitlines()
                 if line.startswith("{")]
        rows[k] = lines[-1] if lines else None
    check(rows["process_1"] is None, "launcher_two_process: rank 1 printed")
    a, b = rows["process_0"], rows["devices_2"]
    check({k: v for k, v in a.items() if k != "dt_s"}
          == {k: v for k, v in b.items() if k != "dt_s"},
          f"launcher_two_process: {a} vs {b}")
    for kernel in ("online_sgd", "meta_update", "client_mean"):
        check(a["kernel_launches"][kernel] > 0,
              f"launcher_two_process: no {kernel}")
    emit({"phase": "launcher_two_process", "argv": LAUNCH_2P,
          "row_two_process": a, "row_devices_2": b,
          "nccl_across_cards": "not run: one card"})
    return {"launcher_two_process_rank0": a["kernel_launches"],
            "launcher_devices_2_rank0": b["kernel_launches"]}


# -- slice 20: the 2-D ("clients", "model") route -----------------------------

# Four ranks on a 2 x 2 (clients, model) mesh, sharing the card through
# gloo, started when the streams start (their set-up hidden behind the
# streams) and idle until their go, which comes once the streams are
# done: the card then has room for the tinyllama-1.1b reference beside
# them, and no stream shares the host with the timed 2-D rounds. They run
# before the families.
MESH2D_RANKS = 4
MESH2D_TOL = 1e-4              # the reduced cases against mesh=None's run
# the CPU test's (tests/test_torch_mesh2d_engine.py) runs and tiny configs
MESH2D_LM_EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.01, query=4)
MESH2D_RUNS = {
    "transformer": dict(rounds=5, beta=0.02, support=3, seed=3,
                        eval_every=2, eval_kwargs=MESH2D_LM_EVAL,
                        clients_per_round=3),
    "sine_plain": dict(rounds=11, beta=0.02, support=4, seed=6,
                       eval_every=4, eval_kwargs=MESH_EVAL,
                       clients_per_round=3),
    "mamba2": dict(rounds=3, beta=0.02, support=2, seed=4,
                   clients_per_round=2),
}
MESH2D_RUNS["sine_partial"] = MESH2D_RUNS["sine_plain"]
MESH2D_RUNS["sine_fedbuff"] = MESH2D_RUNS["sine_plain"]
MESH2D_KERNELS = ("online_sgd", "meta_update", "client_mean")
# tinyllama-1.1b at its published width and depth, bf16, drawn on the card
# from TL2D_SEED: Reptile (2 epochs) on LmTaskDistribution(32000, 128), 4
# clients a round, support 2, 2 rounds (one block a round, so each round's
# end is read), one eval at the end; beta 0.002, the full-width rate
TL2D_RUN = dict(rounds=2, clients_per_round=4, support=2, beta=0.002,
                seed=0, eval_every=2, max_block=1,
                eval_kwargs=dict(num_tasks=2, support=2, k_steps=2,
                                 lr=0.002, query=2))
TL2D_SEED = 20
TL2D_SEQ = 128
TL2D_TOL = POD_TOL             # its first round: 4 bf16 steps of mesh=None's
TL2D_BYTES_MAX = 0.6           # a rank's parameter bytes over the whole's
# the train launcher's 2-D row, against its mesh=None row on the card
LAUNCH_2D = ["--strategy", "reptile", "--arch", "transformer", "--rounds",
             "2", "--clients", "4"]
LAUNCH_2D_MESH = ["--mesh", "clients:2,model:2"]


def tiny_lm(get_arch, family):
    """``tests/test_mesh2d_engine.py``'s tiny configs."""
    base = {"transformer": "tinyllama-1.1b", "mamba2": "mamba2-130m"}[family]
    small = dict(name="tiny-" + family, vocab_size=128, d_model=64)
    if family == "transformer":
        small.update(d_ff=128, num_heads=2, num_kv_heads=2, head_dim=32)
    else:
        small.update(ssm_state=16, ssm_chunk=8)
    return dataclasses.replace(get_arch(base).reduced(), **small)


def mesh2d_case(torch, mods, name):
    """One reduced case: (init, task distribution, strategy, run_federated
    keyword arguments), the same in every process."""
    core = mods["core"]
    kw = dict(MESH2D_RUNS[name])
    if name.startswith("sine"):
        sm = mods["sine"]
        if name == "sine_partial":
            kw["sampling"] = core.PartialParticipation(0.5)
        if name == "sine_fedbuff":
            kw["buffered"] = core.BufferedAggregation(4)
        if name != "sine_plain":
            kw["pool"] = core.ClientPool(sm["dist"], 7)
        return (sm["phi"], sm["dist"], core.TinyReptileStrategy(sm["loss"]),
                kw)
    model = mods["build_model"](tiny_lm(mods["get_arch"], name))
    seed = 1 if name == "transformer" else 2
    phi = model.init(torch.Generator().manual_seed(seed), "cpu")
    return (phi, mods["LmTaskDistribution"](128, 16),
            core.ReptileStrategy(mods["lm_loss"](model), epochs=2), kw)


def mesh2d_mods():
    """The port's modules the 2-D phases take."""
    from repro_torch import bridge, core
    from repro_torch.configs import get_arch
    from repro_torch.core import engine
    from repro_torch.data import LmTaskDistribution, lm_loss
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime import sharding
    return {"core": core, "engine": engine, "ops": ops, "sh": sharding,
            "bridge": bridge, "train": train, "get_arch": get_arch,
            "build_model": build_model, "lm_loss": lm_loss,
            "LmTaskDistribution": LmTaskDistribution, "sine": sine_mods()}


def whole_numpy(np, mods, out, init, mesh, partitioner=None):
    """A 2-D run's params gathered whole over the model group, as NumPy
    by leaf name (every rank of the mesh calls it)."""
    sh, bridge = mods["sh"], mods["bridge"]
    whole = bridge.FlatLayout.of_tree(init)
    shards = sh.ModelShards.of(partitioner or sh.DEFAULT_PARTITIONER,
                               dict(zip(whole.names, whole.shapes)), mesh)
    local = bridge.FlatLayout.of_tree(out["params"]).named(out["params"])
    return {str(k): shards.gather_exact(k, v).float().cpu().numpy()
            for k, v in local.items()}


class RoundClock:
    """A ``run_federated`` tracker that reads the time at each block's
    end (one round a block under ``max_block=1``) and keeps a copy of phi
    after the first round: the program's flat buffers, read from the
    engine's one cached runner (clear the cache before the run)."""

    def __init__(self, torch, engine):
        from repro_torch.metering import MetricsTracker
        self.torch, self.engine = torch, engine
        self.inner = MetricsTracker()
        self.times, self.first = [], None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def on_run_start(self):
        self.times.append(time.perf_counter())
        self.inner.on_run_start()

    def on_block(self, start, end, losses):
        self.times.append(time.perf_counter())
        if start == 0:
            (runner,) = self.engine._RUNNER_CACHE._entries.values()
            (prog,) = runner._programs.values()
            self.first = tuple(t.clone() for t in prog.phi)
        self.inner.on_block(start, end, losses)

    def round_s(self):
        return [b - a for a, b in zip(self.times, self.times[1:])]


def draw_shards_on_card(torch, model, seed, shards):
    """``draw_on_card``'s weights, each leaf drawn whole in its order
    (the same generator's numbers), only this rank's shard kept: the
    whole model never exists on the rank. Returns the shards' tree."""
    from repro_torch.bridge import tree_leaves, unflatten_tree
    gen = torch.Generator(device="cuda").manual_seed(seed)
    groups = {}
    for path, (shape, dtype) in tree_leaves(model.param_shapes()):
        groups.setdefault(dtype, []).append((path, tuple(shape)))
    leaves = {}
    for dtype, items in groups.items():
        for path, shape in items:
            full = torch.empty(shape, dtype=dtype, device="cuda")
            draw_leaf(torch, gen, path[-1], full)
            leaves[path] = shards.local(path, full).contiguous().clone()
            del full
    return unflatten_tree(leaves)


def tinyllama_setup(mods):
    """tinyllama-1.1b's model, task distribution, Reptile strategy and
    leaf shapes, the same in every process."""
    model = mods["build_model"](mods["get_arch"]("tinyllama-1.1b"))
    lm = mods["LmTaskDistribution"](model.cfg.vocab_size, TL2D_SEQ)
    S = mods["core"].ReptileStrategy(mods["lm_loss"](model), epochs=2)
    shapes = {path: tuple(shape) for path, (shape, _) in
              mods["bridge"].tree_leaves(model.param_shapes())}
    return model, lm, S, shapes


def tinyllama_reference(torch, mods, workdir):
    """The mesh=None run of ``mesh2d_tinyllama_1_1b`` in this process
    (the whole model drawn on the card), run eagerly as the 2-D ranks'
    is (gloo): captured, its warm-up's blocks and the graph's pool
    together pass the card's 80 GB, and a replay is the eager round bit
    for bit. Its first round's leaves go to ``workdir/tl_first.pt`` for
    rank 0 to hold the 2-D run's against; returns its readings."""
    core, engine, ops, sh, bridge = (mods["core"], mods["engine"],
                                     mods["ops"], mods["sh"],
                                     mods["bridge"])
    model, lm, S, _ = tinyllama_setup(mods)
    phi = draw_on_card(torch, model, TL2D_SEED)
    core.clear_runner_cache()
    engine._block_runner(S, TL2D_RUN["beta"], core.CommChannel(), False,
                         masked=False).capture = False
    clock = RoundClock(torch, engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ref = core.run_federated(phi, lm, S, device="cuda", tracker=clock,
                             **TL2D_RUN)
    torch.cuda.synchronize()
    res = {"round_s": clock.round_s(),
           "query_loss": [h["query_loss"] for h in ref["history"]],
           "comm_bytes": ref["comm_bytes"],
           "param_bytes": sh.per_device_param_bytes(phi),
           "launches": ops.launch_counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    layout = bridge.GroupedLayout.of_tree(phi)
    torch.save({k: v.cpu() for k, v in layout.views(clock.first).items()},
               Path(workdir) / "tl_first.pt")
    del phi, ref, clock
    core.clear_runner_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tinyllama_2d_rank(torch, np, hashlib, rank, mods, workdir):
    """tinyllama-1.1b on the 2 x 2 mesh, once this process's mesh=None
    reference is done (``workdir/go_tinyllama``): every rank draws its
    shards, runs the 2-D route timed a round, and holds its first round:
    the ranks of clients coordinate 0 gather it leaf by leaf for rank 0
    to hold against the reference's. Then one client's inner step on the
    shards, its model-group all-reduces counted."""
    core, engine, ops, sh, bridge = (mods["core"], mods["engine"],
                                     mods["ops"], mods["sh"],
                                     mods["bridge"])
    from repro_torch.runtime.shardctx import model_shards_scope
    model, lm, S, shapes = tinyllama_setup(mods)
    mesh = sh.client_model_mesh(2, 2, "cuda")
    shards = sh.ModelShards.of(sh.DEFAULT_PARTITIONER, shapes, mesh)
    res = {"whole_bytes": 2 * sum(math.prod(s) for s in shapes.values())}
    go = Path(workdir) / "go_tinyllama"
    while not go.exists():
        time.sleep(0.05)
    local = draw_shards_on_card(torch, model, TL2D_SEED, shards)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    core.clear_runner_cache()
    clock = RoundClock(torch, engine)
    calls0 = dict(sh.MODEL_CALLS)
    reduces0 = sh.CALLS["all_reduce"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = core.run_federated(sh.LocalShards(local, shapes), lm, S,
                             mesh=mesh, device="cuda", tracker=clock,
                             **TL2D_RUN)
    torch.cuda.synchronize()
    res.update(wall_s=time.perf_counter() - t0, round_s=clock.round_s(),
               launches=ops.launch_counts(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               param_bytes=sh.per_device_param_bytes(out["params"]),
               query_loss=[h["query_loss"] for h in out["history"]],
               comm_bytes=out["comm_bytes"],
               all_reduce_calls=sh.CALLS["all_reduce"] - reduces0,
               model_calls_run={k: v - calls0[k]
                                for k, v in sh.MODEL_CALLS.items()})
    (runner,) = engine._RUNNER_CACHE._entries.values()
    res["trace_count"] = runner.trace_count
    layout = bridge.GroupedLayout.of_tree(out["params"])
    # the round's one clients-group all-reduce: each dtype group's fp32
    # client mean of this rank's shards
    res["clients_all_reduce_bytes"] = 4 * sum(
        math.prod(s) for s in layout.shapes)
    first = layout.views(clock.first)
    res["first_sha256"] = hashlib.sha256(b"".join(
        t.view(torch.uint8).cpu().numpy().tobytes()
        for t in clock.first)).hexdigest()
    del clock
    # the first round, whole, on rank 0 against the reference's
    if mesh.coordinate("clients") == 0:
        want = (torch.load(Path(workdir) / "tl_first.pt") if rank == 0
                else None)
        worst = {"max_abs_diff": 0.0, "within": True, "leaves": 0}
        for k, v in first.items():
            got = shards.gather_exact(k, v)
            if rank == 0:
                w = want[k].to(got.device).float()
                diff = (got.float() - w).abs()
                worst["max_abs_diff"] = max(worst["max_abs_diff"],
                                            diff.max().item())
                worst["within"] &= bool((diff <= TL2D_TOL["atol"]
                                         + TL2D_TOL["rtol"] * w.abs())
                                        .all().item())
                worst["leaves"] += 1
            del got
        res["first_round_vs_mesh_none"] = worst if rank == 0 else None
        del want
    del first
    # one client's inner step on the shards (support 2 x 128 tokens): the
    # model group's all-reduces it makes
    batch = lm.sample_support_block(np.random.default_rng(0), 1, 1,
                                    TL2D_RUN["support"])
    tokens = torch.from_numpy(batch["x"][0, 0]).to(mesh.device)
    labels = torch.from_numpy(batch["y"][0, 0]).to(mesh.device)
    params = bridge.unflatten_tree({
        k: v.detach().requires_grad_() for k, v in
        bridge.flatten_tree(out["params"]).items()})
    before = dict(sh.MODEL_CALLS)
    with model_shards_scope(shards):
        model.loss_fn(params, {"tokens": tokens,
                               "labels": labels}).backward()
    torch.cuda.synchronize()
    res["model_all_reduces_per_client_step"] = {
        k: v - before[k] for k, v in sh.MODEL_CALLS.items()}
    del params, out, local
    core.clear_runner_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh2d_worker(rank, workdir):
    """Every 2-D phase, in one rank of the MESH2D_RANKS: the reduced
    cases, the launcher's row, then (after the mesh=None reference)
    tinyllama-1.1b. Sets up CUDA and imports, writes
    ``workdir/ready<rank>``, sleeps until ``workdir/go``. Returns NumPy
    results, each run's launches and timings."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.zeros(1, device="cuda")
    mods = mesh2d_mods()
    core, ops, sh = mods["core"], mods["ops"], mods["sh"]
    torch.cuda.synchronize()
    (Path(workdir) / f"ready{rank}").touch()
    go = Path(workdir) / "go"
    while not go.exists():
        time.sleep(0.05)
    mesh = sh.client_model_mesh(2, 2, "cuda")
    out = {"rank": rank, "backend": dist.get_backend(), "cases": {},
           "launches": {}, "coords": (mesh.coordinate("clients"),
                                      mesh.coordinate("model"))}
    t0 = time.perf_counter()
    for name in MESH2D_RUNS:
        init, task_dist, strategy, kw = mesh2d_case(torch, mods, name)
        core.clear_runner_cache()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        run = core.run_federated(init, task_dist, strategy, mesh=mesh,
                                 device="cuda", **kw)
        torch.cuda.synchronize()
        out["launches"][name] = ops.launch_counts()
        (runner,) = mods["engine"]._RUNNER_CACHE._entries.values()
        out["cases"][name] = dict(
            run_numpy(np, {**run, "params": {}}),
            params=whole_numpy(np, mods, run, init, mesh),
            local_bytes=sh.per_device_param_bytes(run["params"]),
            trace_count=runner.trace_count)
    out["reduced_s"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        row, _ = mods["train"].run_engine_strategy(mods["train"].parse_args(
            LAUNCH_2D + LAUNCH_2D_MESH + [
                "--num-processes", str(MESH2D_RANKS), "--coordinator",
                "127.0.0.1:1", "--process-id", str(rank)]))
    out["launcher"] = dict(row, wall_s=time.perf_counter() - t0)
    core.clear_runner_cache()
    out["tinyllama"] = tinyllama_2d_rank(torch, np, hashlib, rank, mods,
                                         workdir)
    return out


def start_mesh2d_workers(workdir):
    """The MESH2D_RANKS ranks, started now in the background; they wait
    for their go. Returns the thread that collects their results."""
    from repro_torch.runtime.ranks import run_ranks

    def collect():
        try:
            thread.result = run_ranks(mesh2d_worker, MESH2D_RANKS, workdir,
                                      workdir, device="cuda", threads=2,
                                      timeout=STREAM_TIMEOUT + 600)
        except BaseException as e:              # raised in the phase
            thread.result = e

    thread = threading.Thread(target=collect, daemon=True)
    thread.start()
    return thread


def phase_mesh2d(torch, np, thread, workdir, t_start):
    """Give the 2-D ranks their go; meanwhile compute the reduced cases',
    the launcher's and tinyllama-1.1b's mesh=None references on the card
    (then the ranks' tinyllama go); then hold the ranks' runs to them
    (``mesh2d_engine_reduced``, ``launcher_mesh2d``,
    ``mesh2d_tinyllama_1_1b``)."""
    mods = mesh2d_mods()
    core, ops = mods["core"], mods["ops"]
    # the card's room for rank 0's mesh=None reference (some 53 GB): what
    # this process's allocator still holds goes back first
    gc.collect()
    torch.cuda.empty_cache()
    ready = [Path(workdir) / f"ready{r}" for r in range(MESH2D_RANKS)]
    t0 = time.perf_counter()
    while not all(p.exists() for p in ready):
        if not thread.is_alive():
            raise RuntimeError(f"2-D ranks ended before they were ready: "
                               f"{thread.result}")
        time.sleep(0.05)
    waited_ready = time.perf_counter() - t0
    (Path(workdir) / "go").touch()
    refs = {}
    for name in MESH2D_RUNS:
        init, task_dist, strategy, kw = mesh2d_case(torch, mods, name)
        core.clear_runner_cache()
        run = core.run_federated(init, task_dist, strategy, device="cuda",
                                 **kw)
        refs[name] = dict(run_numpy(np, {**run, "params": {}}), params={
            str(k): v.float().cpu().numpy() for k, v in
            mods["bridge"].FlatLayout.of_tree(run["params"]).named(
                run["params"]).items()})
    core.clear_runner_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        want_row, _ = mods["train"].run_engine_strategy(
            mods["train"].parse_args(LAUNCH_2D))
    core.clear_runner_cache()
    ref = tinyllama_reference(torch, mods, workdir)
    (Path(workdir) / "go_tinyllama").touch()
    thread.join()
    outs = thread.result
    if isinstance(outs, BaseException):
        raise outs
    wait_s = time.perf_counter() - t0
    r0 = outs[0]
    rows, paths = {}, {}
    for name in MESH2D_RUNS:
        a, want = r0["cases"][name], refs[name]
        for r in outs[1:]:
            b = r["cases"][name]
            check(all(np.array_equal(a["params"][k], b["params"][k])
                      for k in a["params"]) and
                  a["query_loss"] == b["query_loss"],
                  f"mesh2d_engine_reduced {name}: the ranks differ")
        check(a["per_client_bytes"] == want["per_client_bytes"]
              and a["comm_bytes"] == want["comm_bytes"],
              f"mesh2d_engine_reduced {name}: bills differ from mesh=None's")
        for f, v in want.get("pool_state", {}).items():
            check(np.array_equal(a["pool_state"][f], v),
                  f"mesh2d_engine_reduced {name}: pool {f} differs")
        diff = max(float(np.abs(a["params"][k] - v).max())
                   for k, v in want["params"].items())
        check(diff <= MESH2D_TOL, f"mesh2d_engine_reduced {name}: phi "
                                  f"{diff} from mesh=None's, tolerance "
                                  f"{MESH2D_TOL}")
        check(np.allclose(a["query_loss"], want["query_loss"],
                          rtol=MESH2D_TOL, atol=MESH2D_TOL),
              f"mesh2d_engine_reduced {name}: history {a['query_loss']} vs "
              f"{want['query_loss']}")
        kernels = MESH2D_KERNELS + (("ssd_scan",) if name == "mamba2" else ())
        for r in outs:
            check(r["cases"][name]["trace_count"] == 1,
                  f"mesh2d_engine_reduced {name}: rank {r['rank']} built "
                  f"{r['cases'][name]['trace_count']} times")
            for kernel in kernels:
                check(r["launches"][name][kernel] > 0,
                      f"mesh2d_engine_reduced {name}: rank {r['rank']} "
                      f"launched no {kernel}")
        paths[f"mesh2d_engine_reduced_{name}"] = {
            k: sum(r["launches"][name][k] for r in outs) for k in ops.KERNELS}
        rows[name] = {"params_vs_mesh_none": diff, "tol": MESH2D_TOL,
                      "local_bytes": [r["cases"][name]["local_bytes"]
                                      for r in outs],
                      "launches_rank0": r0["launches"][name]}
    emit({"phase": "mesh2d_engine_reduced", "ranks": MESH2D_RANKS,
          "mesh": {"clients": 2, "model": 2}, "backend": r0["backend"],
          "round_form": "eager (gloo stages through the host)",
          "cases": rows, "ranks_s": r0["reduced_s"],
          "ranks_waited_ready_s": waited_ready})

    got = r0["launcher"]
    for r in outs[1:]:
        check({k: v for k, v in r["launcher"].items()
               if k not in ("dt_s", "wall_s")}
              == {k: v for k, v in got.items() if k not in ("dt_s", "wall_s")},
              "launcher_mesh2d: the ranks' rows differ")
    check(got["comm_mb"] == want_row["comm_mb"]
          and got["mesh"] == "clients:2,model:2",
          f"launcher_mesh2d: {got} vs {want_row}")
    check(abs(got["query_loss"] - want_row["query_loss"]) <= 1e-4 + 1e-12,
          f"launcher_mesh2d: query_loss {got['query_loss']} vs "
          f"{want_row['query_loss']}")
    for kernel in MESH2D_KERNELS:
        check(got["kernel_launches"][kernel] > 0,
              f"launcher_mesh2d: no {kernel}")
    paths["launcher_mesh2d"] = {
        k: sum(r["launcher"]["kernel_launches"][k] for r in outs)
        for k in ops.KERNELS}
    emit({"phase": "launcher_mesh2d", "argv": LAUNCH_2D + LAUNCH_2D_MESH,
          "row_mesh2d_rank0": got, "row_mesh_none": want_row})

    tls = [r["tinyllama"] for r in outs]
    t0r = tls[0]
    first = t0r["first_round_vs_mesh_none"]
    check(first["within"], f"mesh2d_tinyllama_1_1b: first round against "
                           f"mesh=None's: {first}")
    for r, t in zip(outs, tls):
        check(t["param_bytes"] <= TL2D_BYTES_MAX * t["whole_bytes"],
              f"mesh2d_tinyllama_1_1b: rank {r['rank']} holds "
              f"{t['param_bytes']} of {t['whole_bytes']} bytes")
        check(t["comm_bytes"] == ref["comm_bytes"],
              "mesh2d_tinyllama_1_1b: bills differ from mesh=None's")
        check(t["trace_count"] == 1, f"mesh2d_tinyllama_1_1b: rank "
                                     f"{r['rank']} built {t['trace_count']}")
        check(all(math.isfinite(q) for q in t["query_loss"]),
              "mesh2d_tinyllama_1_1b: eval not finite")
        for kernel in MESH2D_KERNELS:
            check(t["launches"][kernel] > 0, f"mesh2d_tinyllama_1_1b: rank "
                                             f"{r['rank']} launched no "
                                             f"{kernel}")
    by_model = {}
    for r, t in zip(outs, tls):
        by_model.setdefault(r["coords"][1], set()).add(t["first_sha256"])
    check(all(len(v) == 1 for v in by_model.values()),
          "mesh2d_tinyllama_1_1b: the clients shards' first rounds differ")
    check(abs(t0r["query_loss"][-1] - ref["query_loss"][-1])
          <= 1e-2 * abs(ref["query_loss"][-1]),
          f"mesh2d_tinyllama_1_1b: eval {t0r['query_loss']} vs "
          f"{ref['query_loss']}")
    paths["mesh2d_tinyllama_1_1b"] = {
        k: sum(t["launches"][k] for t in tls) for k in ops.KERNELS}
    step = t0r["model_all_reduces_per_client_step"]
    emit({"phase": "mesh2d_tinyllama_1_1b", "mesh": {"clients": 2,
                                                      "model": 2},
          "config": "tinyllama-1.1b, 22 layers, d_model 2,048, bf16, drawn "
                    "on the card", "run": {k: v for k, v in TL2D_RUN.items()
                                            if k != "eval_kwargs"},
          "seq": TL2D_SEQ,
          "param_bytes_per_rank": [t["param_bytes"] for t in tls],
          "param_bytes_mesh_none": ref["param_bytes"],
          "param_bytes_ratio": [t["param_bytes"] / ref["param_bytes"]
                                for t in tls],
          "peak_gb_per_rank": [t["peak_gb"] for t in tls],
          "peak_gb_mesh_none": ref["peak_gb"],
          "round_s_rank0": t0r["round_s"], "round_s_mesh_none":
          ref["round_s"], "wall_s": [t["wall_s"] for t in tls],
          "model_all_reduces_per_client_step": step,
          "model_all_reduces_per_inner_step_rank":
          {k: 2 * v for k, v in step.items()},
          "model_calls_run_rank0": t0r["model_calls_run"],
          "clients_all_reduce_bytes_per_round":
          t0r["clients_all_reduce_bytes"],
          # every all-reduce of rank 0's run but the model group's
          "clients_all_reduce_calls_run_rank0": t0r["all_reduce_calls"]
          - t0r["model_calls_run"]["activation"]
          - t0r["model_calls_run"]["gather"],
          "first_round_vs_mesh_none": first, "tol": TL2D_TOL,
          "query_loss": t0r["query_loss"],
          "query_loss_mesh_none": ref["query_loss"],
          "launches_rank0": t0r["launches"],
          "launches_mesh_none": ref["launches"], "waited_s": wait_s})
    return paths


# -- streams: groups of phases in processes of their own ------------------------

# After slice 19 three streams of phases run at once on the one card,
# each in a process of its own: the script's process takes slice 17's
# engine phases and the engine's LM route, STREAMS the rest but the
# families, which run alone once all three are done (train_mixtral_full
# holds 75.6 GB of the card's 80). A stream's peak is at most 33.5 GB
# (joint_step_full), the script's own 22.8 GB (engine_lm_mamba2_130m), so
# the three fit beside each other. The phases are the serial script's,
# unchanged, each with its launch counters set to 0 just before it and
# read just after in its own process; what a phase times, it times beside
# the other streams (the host's 8 cores and the card shared; the kernel
# phases, the levers and slice 19 run before, with nothing beside them).
# A stream's lines are printed after it ends, each with its "stream".
STREAM_THREADS = 3             # torch's CPU threads in a stream's process
STREAM_TIMEOUT = 600           # seconds from the streams' start


def port_modules(refs):
    """The port's modules and the seeded sine MLP init every phase after
    slice 19 takes (``tm``), with ``refs``, this process's CPU
    references."""
    import torch

    from repro_torch import bridge, core, graphs
    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_models import PAPER_MODELS, SINE_MLP
    from repro_torch.core import engine
    from repro_torch.data import KWSTasks, OmniglotTasks, SineTasks
    from repro_torch.examples import federated_keyword_spotting as kws
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train
    from repro_torch.metering import MetricsTracker
    from repro_torch.models import mamba2, moe, paper_nets
    from repro_torch.models.transformer import build_model
    return {"core": core, "ops": ops, "train": train, "SineTasks": SineTasks,
            "loss": functools.partial(paper_nets.paper_model_loss, SINE_MLP),
            "phi": paper_nets.init_paper_model(
                SINE_MLP, torch.Generator().manual_seed(0), "cpu"),
            "bridge": bridge, "mamba2": mamba2, "engine": engine,
            "build_model": build_model, "get_arch": get_arch,
            "graphs": graphs, "nets": paper_nets, "cfgs": PAPER_MODELS,
            "kws": kws, "MetricsTracker": MetricsTracker,
            "serve": serve_launcher, "moe": moe,
            "dists": {"kws_conv": KWSTasks(),
                      "omniglot_conv": OmniglotTasks()},
            "loss_of": lambda cfg: functools.partial(
                paper_nets.paper_model_loss, cfg),
            "acc_of": lambda cfg: functools.partial(
                paper_nets.paper_model_accuracy, cfg),
            "refs": refs}


def stream_decode_lm(torch, np, tm):
    """The decode slice (tinyllama-1.1b, then mamba2-130m), the LM
    launcher's fleet and checkpoint flags (slice 17), and the dense
    family through the LM launcher. Returns the launches by path."""
    s_dec_red = phase_serve_decode_reduced(torch, np, tm)
    s_dec, dec_model, dec_params = phase_serve_decode_full(torch, np, tm)
    phase_profile_decode(torch, np, dec_model, dec_params)
    emit({"phase": "graphs_vs_eager_decode",
          "decode_tinyllama_1_1b": graphs_vs_eager_decode(
              torch, np, tm["graphs"], dec_model, dec_params)})
    # the dense family's prefill and joint step on the same weights
    phase_prefill_dense_full(torch, np, tm, dec_model, dec_params)
    phase_joint_step_full(torch, np, tm, dec_model, dec_params)
    del dec_params
    torch.cuda.empty_cache()
    paths = {"serve_decode_reduced": s_dec_red["launches"],
             "serve_decode_tinyllama_1_1b": s_dec["launches"],
             **phase_decode_mamba_full(torch, np, tm),
             **phase_train_lm_fleet(torch, np, tm)}
    torch.cuda.empty_cache()
    return {**paths, **phase_train_dense_reduced(torch, np, tm),
            **phase_train_dense_full(torch, np, tm)}


def stream_sine(torch, np, tm):
    """The paper's models: serving, the train launcher's strategies, the
    checkpoints, Tables I-IV, Fig. 4, the captured rounds against eager,
    the port's examples, then the fleet (whose CPU references this
    process's worker computes meanwhile); last the LM launcher on
    mamba2 (reduced, then mamba2-130m, profiled). Returns the launches
    by path."""
    from repro_torch.core.strategies import tifed_requantize
    from repro_torch.serving import (AdaptationServer, Fp32Adapter,
                                     TifedAdapter)
    submit_cpu_refs(tm["refs"], "sine")
    ops, phi = tm["ops"], tm["phi"]
    mods = (tm["MetricsTracker"], AdaptationServer, ops)
    fp32 = Fp32Adapter(loss_fn=tm["loss"])
    reqs = make_requests(np, N_REQUESTS, SUPPORT, QUERY, K_MAX, seed=0)
    s_fp32 = phase_serve(torch, np, mods, "fp32", fp32, phi, reqs, K_MAX,
                         "online_sgd", exact_params=False)
    phi_q = tifed_requantize(phi)
    tifed = TifedAdapter(support=T_SUPPORT, k_max=T_K_MAX)
    t_reqs = make_requests(np, N_REQUESTS, T_SUPPORT, QUERY, T_K_MAX, seed=1)
    s_tifed = phase_serve(torch, np, mods, "tifed", tifed, phi_q, t_reqs,
                          T_K_MAX, "dfa_epoch_int8", exact_params=True)
    phase_profile(torch, np, mods, fp32, phi, reqs)

    t_tiny = phase_train_tinyreptile(torch, np, tm)
    t_rep = phase_train_reptile(torch, np, tm)
    t_base = phase_train_baselines(torch, np, tm)
    phase_profile_train(torch, tm)
    queue_c = phase_client_mean_queue_c(torch, np, tm)
    ckpt_paths, ckpt_ref = phase_ckpt_resume(torch, np, tm)
    ckpt_paths.update(phase_ckpt_sigkill(torch, np, tm, ckpt_ref))
    phase_ckpt_overhead(torch, np, tm)
    phase_paper_models(torch, np, tm)
    fig4_paths = phase_fig4_conv(torch, np, tm)
    phase_graphs(torch, np, tm, {
        "server": AdaptationServer,
        "routes": {"serve_fp32": (fp32, phi, reqs, K_MAX),
                   "serve_tifed": (tifed, phi_q, t_reqs, T_K_MAX)}},
                 conv_graph_runs(torch, tm))
    examples = phase_examples(torch, np, tm)
    fleet_paths = {**phase_fleet_tifed(torch, np, tm),
                   **phase_fleet_partial(torch, np, tm),
                   **phase_fleet_pool(torch, np, tm),
                   **phase_fleet_kws(torch, np, tm)}
    t_lm_red = phase_train_lm_reduced(torch, np, tm)
    t_lm, lm_phi = phase_train_lm_full(torch, np, tm)
    phase_profile_lm(torch, np, tm, lm_phi)
    del lm_phi
    torch.cuda.empty_cache()
    return {"train_lm_reduced": t_lm_red["launches"],
            "train_lm_mamba2_130m": t_lm["launches"],
            "serve_fp32": s_fp32["launches"],
            "serve_tifed": s_tifed["launches"],
            "train_tinyreptile": t_tiny["launches"],
            "train_reptile_c64": t_rep["launches"],
            **{f"train_{r['run']}": r["launches"] for r in t_base},
            **fig4_paths, **fleet_paths, **ckpt_paths, **queue_c,
            **examples}


STREAMS = {"decode_lm": stream_decode_lm, "sine": stream_sine}


def stream_main(name, out_dir):
    """One of STREAMS in a process of its own (spawned): its lines to
    ``out_dir/<name>.jsonl``, then its launches by path, its seconds by
    phase and its CPU references' log to ``out_dir/<name>.json``. A
    failed phase ends the process with its message (exit code 1)."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.kernels import build
    torch.set_num_threads(STREAM_THREADS)
    STREAM[0] = name
    for lib in BUILD_SOURCES:
        build.load(lib)
    refs = CpuRefs()
    try:
        with open(Path(out_dir) / f"{name}.jsonl", "w") as f, \
                contextlib.redirect_stdout(f):
            paths = STREAMS[name](torch, np, port_modules(refs))
    finally:
        refs.close()
        for p in CHILDREN:
            if p.poll() is None:
                p.kill()
    with open(Path(out_dir) / f"{name}.json", "w") as f:
        json.dump({"paths": paths, "phase_seconds": PHASE_S,
                   "cpu_refs": refs.log,
                   "stream_s": time.perf_counter() - T0}, f)


def start_streams(out_dir):
    """Every stream of STREAMS started now (spawned); returns the
    processes by name and when they started."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = {name: ctx.Process(target=stream_main, args=(name, out_dir))
             for name in STREAMS}
    for p in procs.values():
        p.start()
    STREAM_PROCS.extend(procs.values())
    return procs, time.monotonic()


def join_streams(started, out_dir):
    """Wait for every stream of ``start_streams``, print its lines, and
    fail if one failed. Returns their launches by path and, for the
    phase_seconds line, each stream's seconds by phase, its own seconds
    and its CPU references."""
    procs, at = started
    t0 = time.perf_counter()
    deadline = at + STREAM_TIMEOUT
    for p in procs.values():
        p.join(max(deadline - time.monotonic(), 0.0))
    waited = time.perf_counter() - t0
    paths, log = {}, {}
    for name, p in procs.items():
        lines = Path(out_dir) / f"{name}.jsonl"
        if lines.exists():
            sys.stdout.write(lines.read_text())
            sys.stdout.flush()
        if p.is_alive():
            p.kill()
            p.join()
            check(False, f"stream {name} still ran after {STREAM_TIMEOUT} s")
        check(p.exitcode == 0, f"stream {name} failed (exit code "
                               f"{p.exitcode}); its message is on stderr")
        with open(Path(out_dir) / f"{name}.json") as f:
            out = json.load(f)
        paths.update(out["paths"])
        log[name] = {k: out[k] for k in ("phase_seconds", "cpu_refs",
                                         "stream_s")}
    emit({"phase": "streams_joined", "waited_s": waited,
          "streams_s": {k: v["stream_s"] for k, v in log.items()}})
    return paths, {"streams": log}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on the GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not under "
                         f"{SRC}; run this script from a checkout")
    sys.path.insert(0, str(SRC))

    t_start = time.perf_counter()
    refs = CpuRefs()
    try:
        run_phases(torch, np, refs, t_start)
    finally:
        refs.close()
        for p in CHILDREN:               # stop what a failed phase left
            if p.poll() is None:
                p.kill()
        for p in STREAM_PROCS:
            if p.is_alive():
                p.kill()


def run_phases(torch, np, refs, t_start):
    """Every phase in order (those of STREAMS in their own processes),
    then the kernels line, the card's line and the ok line."""
    from repro_torch.kernels import build, ops, ref

    # the compilers and slice 19's ranks start first, beside the device
    # phase; the kernel phases wait until the ranks are set up and idle,
    # and the ranks run after the levers
    build_thread = start_build(build)
    mesh_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    mesh_thread = start_mesh_workers(mesh_dir)
    phase_device(torch, np)
    ptxas = phase_build(build, build_thread)
    wait_mesh_workers_ready(mesh_thread, mesh_dir)
    rows = phase_kernels(torch, np, ops, ref)
    phase_kernels_lm(torch, np, ops, ref, rows)
    phase_kernels_decode(torch, np, ops, ref, rows)
    phase_kernels_client_mean(torch, np, ops, ref, rows)
    phase_kernels_tinyllama(torch, np, ops, ref, rows)
    phase_kernels_engine_lm(torch, np, ops, ref, rows)
    phase_kernels_families(torch, np, ops, ref, rows)
    phase_kernels_encdec_vlm(torch, np, ops, ref, rows, ptxas)
    phase_kernels_mixed(torch, np, ops, ref, rows)
    phase_kernels_ringkv(torch, np, ops, ref, rows)

    from repro_torch import bridge, graphs
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime import flags

    # runtime/flags.py's levers first, on starcoder2-15b
    t18 = time.perf_counter()
    sm = {"ops": ops, "bridge": bridge, "serve": serve_launcher,
          "get_arch": get_arch, "build_model": build_model,
          "graphs": graphs, "flags": flags}
    levers_paths = phase_ringkv_reduced(torch, np, sm)
    with gc_off():
        paths_cut, cut_model, cut_params = phase_decode_starcoder2_ringkv(
            torch, np, sm)
        phase_prefill_starcoder2_banded(torch, np, sm, cut_model, cut_params)
        del cut_model, cut_params
        free_card(torch, "decode_starcoder2_ringkv")
        levers_paths.update(paths_cut)
        levers_paths.update(phase_decode_starcoder2_full(torch, np, sm))
    emit({"phase": "levers", "phases_s": time.perf_counter() - t18,
          "script_s_so_far": time.perf_counter() - t_start})
    # slice 19: the engine across processes
    t19 = time.perf_counter()
    mesh_outs, mesh_paths = phase_mesh_engine_sine(torch, np, mesh_thread,
                                                   mesh_dir, t_start)
    mesh_paths.update(phase_pod_client(torch, np, mesh_outs))
    del mesh_outs
    mesh_paths.update(phase_mesh_engine_nccl1(torch, np))
    # alone on the card and the host: no other phase runs beside them
    mesh_paths.update(phase_launcher_two_process(
        start_launchers_two_process()))
    emit({"phase": "slice_19", "phases_s": time.perf_counter() - t19,
          "script_s_so_far": time.perf_counter() - t_start})
    # from here on three streams of phases run at once, each in a process
    # of its own on the card (STREAMS): this process takes slice 17 and
    # the engine's LM route; the families run after them, alone
    stream_dir = tempfile.mkdtemp(prefix="chip_smoke_streams_")
    streams = start_streams(stream_dir)
    # slice 20's four ranks set up beside the streams and wait for them
    mesh2d_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh2d_")
    mesh2d_thread = start_mesh2d_workers(mesh2d_dir)
    # the CPU references from here on: no later phase times a kernel or a
    # collective with nothing beside it
    submit_cpu_refs(refs)
    tm = port_modules(refs)

    # slice 17's first: the engine in the LMs' own dtypes
    t_mixed = time.perf_counter()
    mixed_paths = {**phase_engine_lm_mixed_reduced(torch, np, tm),
                   **phase_engine_lm_full_mixed(torch, np, tm)}
    emit({"phase": "slice_17", "phases_s": time.perf_counter() - t_mixed,
          "script_s_so_far": time.perf_counter() - t_start})
    engine_lm_paths = {**phase_engine_lm_reduced(torch, np, tm),
                       **phase_engine_lm_full(torch, np, tm)}
    stream_paths, stream_log = join_streams(streams, stream_dir)

    # slice 20: the 2-D (clients, model) route, once the streams are done
    t20 = time.perf_counter()
    mesh2d_paths = phase_mesh2d(torch, np, mesh2d_thread, mesh2d_dir,
                                t_start)
    emit({"phase": "slice_20", "phases_s": time.perf_counter() - t20,
          "script_s_so_far": time.perf_counter() - t_start})

    # the decoder-only families of slice 15 and the encoder-decoder and
    # VLM of slice 16, alone on the card; the decode runners dropped with
    # the cyclic collector off, so that free_card sees what they leave
    family_paths = phase_families_reduced(torch, np, tm)
    with gc_off():
        family_paths.update(phase_families_decode(torch, np, tm))
    family_paths.update(phase_families_train(torch, np, tm))
    family_paths.update(phase_encdec_vlm_train(torch, np, tm))

    # every main path's launches, each counted from 0 just before it (in
    # the process that drove it)
    paths = {**stream_paths, **engine_lm_paths, **family_paths,
             **mixed_paths, **levers_paths, **mesh_paths, **mesh2d_paths}
    kernels = []
    for kernel, route, source, replaces, row in (
            ("online_sgd", "cuda", "src/repro_torch/kernels/csrc/online_sgd.cu",
             "src/repro/kernels/online_sgd.py:36",
             rows["online_sgd/serve_64x1153_fp32"]),
            ("dfa_epoch_int8", "cuda",
             "src/repro_torch/kernels/csrc/dfa_epoch_int8.cu",
             "src/repro/kernels/online_sgd_int8.py:120",
             rows["dfa_epoch_int8/serve_B64_S8_mixed"]),
            ("meta_update", "cuda",
             "src/repro_torch/kernels/csrc/meta_update.cu",
             "src/repro/kernels/meta_update.py:31",
             rows["meta_update/train_1153_fp32"]),
            ("online_sgd_momentum", "cuda",
             "src/repro_torch/kernels/csrc/online_sgd.cu",
             "src/repro/kernels/online_sgd.py:52",
             rows["online_sgd_momentum/train_1153_fp32"]),
            ("ssd_scan", "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:61",
             rows["ssd_scan/path_2x24x8x256x64x128"]),
            ("flash_decode", "cuda",
             "src/repro_torch/kernels/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:68",
             # the route the decode graph launches: L read on the device
             rows["flash_decode/path_8x32x4x64x2048_bfloat16_L2048_w0_devL"]
             ),
            # no Pallas function computes the weighted client mean
            ("client_mean", "cuda",
             "src/repro_torch/kernels/csrc/client_mean.cu", None,
             rows["client_mean/C64_P1153"])):
        by_path = {p: c[kernel] for p, c in paths.items() if c[kernel]}
        kernels.append(
            {"name": kernel, "route": route, "source": source,
             "replaces": replaces, "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             **{k: row[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
             "library_device_ms": row.get("library_device_ms"),
             **({"route_on_path": row["route"]} if "route" in row else {}),
             **({"slice_16": {
                 name: {k: rows[f"flash_decode/{key}"].get(k) for k in (
                     "shape_BHKvhdS", "dtype", "L", "route", "max_abs_err",
                     "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "library_device_ms", "ptxas")}
                 for name, key in (
                     ("paligemma_hd256_bf16",
                      "encdec_vlm_8x8x1x256x2048_bfloat16_L2048_device_L"),
                     ("paligemma_hd256_fp32",
                      "encdec_vlm_8x8x1x256x2048_float32_L2048_device_L"),
                     ("whisper_cross_bf16",
                      "encdec_vlm_8x6x6x64x1500_bfloat16_L1500_host_int"))},
                 # the ringkv route at starcoder2-15b's ring
                 "ringkv": rows["flash_decode/ringkv_"
                                + "x".join(map(str, FD_RINGKV))
                                + "_bfloat16_devL"]}
                if kernel == "flash_decode" else {}),
             **({"kernels_per_call": row["kernels_per_call"]}
                if "kernels_per_call" in row else {}),
             # slice 17's instantiations: bf16 rows, a bf16 w with an
             # fp32 w_hat
             **({"bf16": {f"C{C}_P{P}": rows[f"client_mean/bf16_C{C}_P{P}"]
                          for C, P in CM_BF16}}
                if kernel == "client_mean" else {}),
             **({"bf16_w_fp32_w_hat": {
                 str(n): rows[f"meta_update/mixed_{n}"]
                 for n in MU_MIXED_SIZES}}
                if kernel == "meta_update" else {}),
             **({"engine_shape": {
                 k: rows[f"dfa_epoch_int8/{ENGINE_DFA}"][k] for k in (
                     "B", "S", "dims", "ms", "device_ms", "generic_ms",
                     "generic_device_ms", "plain_ms", "bound_ms", "bound_by",
                     "max_abs_err", "loss_max_rel_err")}}
                if kernel == "dfa_epoch_int8" else {})})
    emit({"phase_seconds": PHASE_S, "cpu_refs": refs.log, **stream_log})
    emit({"total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
