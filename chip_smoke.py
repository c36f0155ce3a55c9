#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the card.

Run from the repository root, with no arguments, on a host with one CUDA
device:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  env      the card's name and power limit (nvidia-smi), the torch and CUDA
           versions, and the time to build the kernels from src/repro_torch.
  lda      the port's first path: run_lda(backend="runtime", device="cuda")
           with a 50,000 x 1,000 float64 word_topic master on the card, the
           kernels' launch counters set to 0 just before and read just after,
           under torch.profiler for the device's busy time by kernel name
           and ps_apply's own (its kernel, and its grouping's sort kernels,
           by name; each must show whenever ps_apply launched).
           The shape of every kernel call is noted.  Checks: no violations,
           master == x0 + sum(updates) exactly, every token counted once,
           topic == word_topic.sum(0), a finite rising log-likelihood, and
           both kernels launched.
  wire     the lda phase's run on the runtime's wire transports: the same
           corpus, V 50,000 x K 1,000 f64 masters on the card, 4 workers as
           4 forked client processes (threads_per_process=1), 2 shards in
           this process.  Main run: transport="shm" with the zero-copy wire,
           ssp(1), 3 clocks, built from apps/lda.py's _init_states and
           _make_update_fn and PSRuntime directly (run_lda records its
           log-likelihood inside client 0, so none reaches this process);
           the launch counters set to 0 just before start() and read after
           wait(), torch.profiler entered once the clients are forked (the
           fork happens outside it).  Prints wall and clock times, the
           device's busy and idle share, ps_apply's launches and device
           seconds (and its kernel's events in the profile, which must match
           its launches for the device time to be whole), H2D and D2H copy
           seconds, peak device memory, the rings' capacity, /dev/shm's size
           and the host's ISA, and the lda phase's wall beside its own.
           Checks: no violations, parts sent = parts applied, the master and
           every shipped cache exactly x0 + sum(updates), word_topic
           non-negative and summing to the corpus's tokens, topic ==
           word_topic.sum(0), master blocks f64 on the card, ps_apply
           launched and topk_mag not (the clients order their flushes in
           host numpy and never touch the card).  Then the bitwise check:
           bsp with barrier_reads, 2 clocks, same seed, on shm (zero-copy),
           tcp and queue: the three final masters must be bitwise equal
           (counts in f64, each clock reading exactly the earlier clocks).
  durable  the wire phase's main run (shm, zero-copy, 4 forked clients, 2
           shards, ssp(1), 3 clocks, the same 50,000 x 1,000 f64 masters on
           the card) with the runtime's observability and durability tiers
           on: trace={"sample": 1.0} with rings far larger than the run
           records, a write-ahead log with wal_fsync="boundary" and a
           snapshot every 2 clocks, both in a fresh tempfile directory (one
           under build/ if tempfile's is in memory, where fsync is a no-op;
           its filesystem type is printed).  Then recover_to_vc replays the
           log on the card (every part through ps_apply), once from genesis
           and once from the snapshot.  Prints the wall split (start,
           wait, each recovery, the trace dump), the WAL's parts, commits,
           bytes, segments and fsync seconds from rt.metrics() beside the
           bytes on disk, the snapshots' files and bytes, the trace's events
           by kind, its drops and the Chrome JSON's size, the device's busy
           time and idle share, ps_apply's launches in the run and in each
           replay, and the wire phase's wall from the same process.
           Checks: no violations; parts sent = applied; the master and every
           shipped cache x0 + sum(updates) exactly; each recovery bitwise
           equal to the final master, folding exactly the shards'
           applied_parts (none lost, none applied twice); genesis replaying
           every part and the snapshot recovery fewer; the trace's send_part
           points = apply_part points = sum(applied_parts), 0 dropped; the
           metrics' parts_applied and wal_parts equal to it, and wal_bytes
           to the segment files' sizes.
  replicas the serving tier at full width.  Main run: the wire phase's run
           (shm, zero-copy, 4 forked clients, 2 shards, ssp(1), 3 clocks,
           the 50,000 x 1,000 f64 masters on the card) with a ReadGateway
           of 2 replicas over the shm serving transport, built after
           start() (each replica's buffers f64 on the card, every published
           delta batch landed through ps_apply); a reader thread in this
           process cycles SLOs 0, 1, None and fresh over word_topic and
           topic, paced by 1 ms, each read escalating to the master after
           5 s without a qualifying replica (the reference tests' read
           deadline), and a second thread adds a third replica once the
           applied frontier reaches clock 1 (bootstrapped in-stream: one
           state frame a shard through its ring).  The launch counters set to 0
           just before start() and read after the replicas caught up;
           torch.profiler entered once the clients are forked.  Then tcp
           serving on a transport="tcp" runtime, 1 replica, 2 clocks.
           Prints reads by source and SLO, escalations, read latency p50
           and p99 by source, replica bytes ingested and delta messages,
           pub_drops and pub_resyncs, ps_apply's launches split into the
           replicas' ingest and the shards', its kernel's events in the
           profile against its launches in the profiled window, the
           device's busy and idle share, H2D and D2H seconds, peak device
           memory, the serving rings' capacity, and the wire phase's wall
           from the same process.  Checks: every read's measured staleness
           within its SLO (0 for fresh); no violations, no replica errors
           or FIFO violations; the master and every shipped cache x0 +
           sum(updates); at quiesce every replica's raw buffers f64 on the
           card and bitwise the master, and a slo=0 read from every replica
           equal to it; the third replica joined before the frontier
           reached the last clock and ingested deltas published after its
           bootstrap;
           ps_apply launched by replica ingest and by the shards, with its
           profile events equal to its launches in the window; topk_mag
           not launched.
  elastic  elastic shard membership at full width.  Main run: the wire
           phase's run (shm, zero-copy, 4 forked clients, ssp(1), the
           50,000 x 1,000 f64 masters on the card) with n_shards=2,
           max_shards=3, 3 clocks and the plan [(1, "add", 2), (2,
           "remove", 0)], one shm-served replica behind a ReadGateway built
           after start() and the replicas phase's reader cycling the SLOs.
           The workers' last clock waits (60 s at most) until both ops
           installed, so the plan cannot lose a race against the run's end.
           The launch counters set to 0 just before start() and read after
           the replica caught up; torch.profiler entered once the clients
           are forked.  Prints each op's wall from EpochBegin to the last
           install (split into the handoff, the reassembly and install
           enqueue, the install confirms) and the device bytes it copied
           (the handoff clones, the reassembled master, the installed
           blocks); the migration's device time, re-timed with CUDA events
           at the run's shapes, and the profile's kernels of its kinds by
           name (the replica's bootstrap copies share one of them);
           ps_apply's launches by site (the shards, the held next-epoch
           replay "epoch_replay", replica ingest) and the shards' launches
           after the first install; peak device memory,
           the idle share and the wire phase's wall.  Checks: both plan
           results "ok", the active slots (1, 2), epochs 1 and 2 in the
           membership log; no violations, parts sent = applied; the master
           and every shipped cache x0 + sum(updates); every read within its
           SLO; the replica bitwise the master at quiesce; every active
           slot's blocks f64 on the card in the new partition's shape and
           slot 0's (0, C); the shards launched ps_apply after the first
           install; its kernel's events in the profile equal to its
           launches in the window.  Then the autoscaler run: shm, 2
           clocks, 1 of 2 slots active, AutoscalePolicy(split_imbalance=1.0,
           split_min_rows_s=0.0, min_shards=2) polling from start(); the
           last clock waits for its op.  Prints every action.  Checks: an
           add_shard that succeeded, no other failed action but one racing
           the run's end, the master exact, the audit clean.
  lda_spmd the second path: run_lda_spmd(device="cuda") on the same corpus,
           4 replicas of the 50,000 x 1,000 and 1,000 float32 tables stacked
           on the card, 3 clocks under cvap(2, v), the vap_accum launch
           counter set to 0 just before and read just after, under
           torch.profiler.  Per step: synced, which trigger fired, and the
           kernel's max|delta| over every replica.  Checks: vap_accum
           launched once per table per clock, the VAP bound held by every
           replica after every step, at least one step that did not sync
           and one that the value trigger synced, and after a final
           force_sync every replica bitwise equal to x0 + sum(updates),
           every token counted once, topic == word_topic.sum(0), and a
           finite rising log-likelihood.
           Device time, host time and the transient peak of device memory
           are also split by call site (the host view, the Gibbs sweep, the
           update's copy to the card, vap_accum, the update's two norms, the
           replica sum, the smoke's own per-step checks).
  apps     MF on the runtime on the card at the widths of the Netflix Prize
           data set (480,189 users x 17,770 items, rank 100, 1,000,000
           ratings drawn from a seeded rank-100 ground truth), ssp(2), 4
           workers, 2 clocks; then logistic regression (400 x 20, the JAX
           package's convergence-benchmark size) as a correctness and
           launch check only.  Launch counters set to 0 just before each
           and read just after; ps_apply's device seconds as in lda.
           Checks: no violations, a falling loss,
           ps_apply launched (and topk_mag for MF: logreg's one key needs no
           send order).
  serve    LLM serving, as examples/serve_demo.py drives the JAX package:
           make_prefill_step then make_serve_step (greedy decode against
           ring KV caches), for RecurrentGemma-9B, Mamba2-130M, Gemma2-9B,
           DeepSeek-V2-Lite-16B, Pixtral-12B and MusicGen-medium at their
           full published widths and depths in bfloat16, random weights
           drawn on the card from --seed (default 0); 16,384 prompt tokens
           a model (drawn from the seed; 4 requests of 4,096, Gemma2-9B 2
           of 8,192 so that its 4,096-token window masks on the local
           layers), 16 generated tokens each.  The two frontend models'
           stubbed frontends get their embeddings drawn from the seed
           after the prompts (Pixtral 256 patch embeddings a request,
           MusicGen 64 conditioning frames), which replace the prompt's
           first positions in the prefill and in the parity check's full
           forward.  Per model: its
           parameters (the tree without head_f32, the float32 master copy
           of the head, whose bytes are reported apart; param_bytes is the
           tree's memory, head included), prefill ms,
           decode ms a step, tokens a second, peak device memory, and from
           a profiled repeat the device's busy time, idle share, time by
           kernel name, PyTorch's elementwise kernels' total,
           flash_attention's and rglru_scan's own (for Mamba2 ssd_scan's
           own, its three kernels by name, and its share of busy; each
           must show whenever its kernel launched), and the LLM kernels'
           calls by dtype (RecurrentGemma's rglru: bfloat16 in the stacked
           units, float32 in the tail) and flash_attention's by window.
           For DeepSeek's MoE a prefill and 4 decode steps again with
           every layer's routing noted: the pairs dropped past capacity at
           the published capacity factor 1.25 (C 1,920 in the prefill, 1
           in decode, where T is the batch).
           Launch counters (rglru_scan's also by entry) set to 0 just
           before the prefill and read just after it and after the decode.
           Checks: one launch a layer per prefill (RecurrentGemma:
           rglru_scan 26, its entries' counts summing to it, flash_attention
           12; Mamba2: ssd_scan 24; Gemma2: flash_attention 42, 21 with
           the window and 21 without; DeepSeek: flash_attention 27, MLA's
           q / k 192 and v 128 wide; Pixtral: 40, G 4 at d 128; MusicGen:
           48, G 1 at d 64) and none in decode; finite logits;
           every token in the vocabulary; the first decode step's logits
           against a full forward over prompt + that token, within 5e-2 of
           the logits' largest magnitude (bfloat16: the two paths round at
           other places through 24-48 layers).  DeepSeek's check runs at
           capacity factor 8 (tests/test_decode_parity.py's), every MoE
           layer's routes compared between the two paths: a request whose
           chosen or kept experts differ in some layer (a near-tied route
           flipped by bfloat16 rounding, printed with its probability gap)
           is decoded again from the same caches with the full forward's
           routes forced at every MoE layer, and every request whose routes
           then agree is held (all of them, unless the full forward
           dropped a pair); the check fails if none is held.
  train    Mamba2-130M trained at full width and depth (24 layers, d 768,
           vocab 50,280; weights drawn on the card from --seed, float32
           masters, bfloat16 compute): 2 replicas stacked on the card, each
           on 4 SyntheticLM sequences of train_4k's 4,096 tokens a step
           (train_4k's global batch of 256 cut to 8), 6 steps of
           make_train_step with Adam and cvap(2, 1.8e-3), remat on; the
           launch counters set to 0 just before the 6 steps and read just
           after, and ssd_chunked / ssd_scan_bwd of the plain version
           wrapped here to count calls.  Prints each step's wall, the
           median after the first, tokens a second, the host's wait on the
           data iterator, peak device memory, the losses, which steps
           synced and which trigger was due (clock, value: the step's
           max|delta| from vap_accum), then one more step under the
           profiler: the device's busy and idle share, time by kernel name,
           ssd_scan's forward (its three kernels) and backward (its five
           in bfloat16) apart.  Then one reduced float32 Mamba2 step
           (SGD, cvap) on the card against the same step on the CPU.
           Checks: every loss
           finite and the mean of the last two below the first; the VAP
           invariant after every step; a step that synced and one that did
           not; ssd_scan's forward 48 and backward 24 launches a replica
           step (remat runs each unit's forward twice), vap_accum one a
           leaf a step; no call of either plain version; the card's step
           within loss rtol 1e-5 and params / delta rtol 2e-4, atol 2e-5
           of the CPU's.
  train_rg RecurrentGemma-9B trained at full width and reduced depth: d
           4,096, RG-LRU width 4,096, MQA 16 x 256, window 2,048, d_ff
           12,288, vocab 256,000, 5 of its 38 layers (one rec/rec/attn unit
           and the model's own two-layer tail, whose float32 1-D leaves
           promote the residual stream to float32), weights drawn on the
           card from --seed, float32 masters, bfloat16 compute; one replica
           (the reference's mesh=None step: apply_and_sync over no axis) on
           2 SyntheticLM sequences of 4,096 tokens a step, 4 Adam steps
           under cvap(2, 1.8e-3), remat on.  The launch counters set to 0
           just before the 4 steps and read after each; the plain versions
           of rglru_scan, flash_attention and their backwards wrapped here
           to count calls.  Prints each step's wall, tokens a second, peak
           device memory, the losses, which steps synced on which trigger,
           each step's launches by entry, the backwards' first calls'
           shapes, then one more step under the profiler: the device's busy
           and idle share, time by kernel name, each kernel's forward and
           backward apart.  Then two reduced float32 RecurrentGemma steps
           (SGD, cvap) on the card against the same steps on the CPU.
           Checks: every loss finite and the last below the first; the VAP
           invariant after every step; a step that synced; a step's
           launches rglru_bf16 4 and rglru_f32 2 (the unit's two RG-LRU
           layers run twice under remat, the tail's once),
           rglru_bwd_bf16 2, rglru_bwd_f32 2, flash_attention 2 and its
           backward 1, vap_accum one a leaf; no call of a plain version;
           the card's step within the train phase's tolerances of the
           CPU's.  The launch counts a step come from M.group_layers (a
           stacked unit's forward twice under remat, a layer outside the
           units once, each backward once, the flash backward's also by
           window); peak device memory must stay under the card's 80 GB.
  train_gemma2
           Gemma2-9B trained as train_rg is (one function runs the three
           cells): full width (d 3,584, GQA 16 / 8 heads x 256, d_ff
           14,336, vocab 256,000, softcaps 50 and 30), 4 of its 42 layers
           (two local / global units, window 4,096), 2 sequences of 8,192
           SyntheticLM tokens a step (so that the window masks), 4 Adam
           steps under cvap(2, 1.8e-3), remat on.  Checks as train_rg's: a
           step's flash_attention 8 and its backward 4 (2 windowed, 2
           global); two reduced float32 Gemma2 steps on the card against
           the CPU.
  train_deepseek
           DeepSeek-V2-Lite-16B the same way: full width (d 2,048, MLA
           q / k 192, v 128, kv rank 512; 64 routed experts of 1,408, top
           6, 2 shared, vocab 102,400), 3 of its 27 layers (the dense
           first layer, then two MoE layers), 2 x 4,096 tokens a step at
           capacity factor 1.25 (C 960).  Every MoE layer's routing is
           noted as the step's dispatch returns it: the pairs dropped per
           layer on the timed steps, and the pairs whose expert or slot
           differ between a unit's forward and remat's recomputation in
           the backward, which must be 0.  Checks as train_rg's: a step's
           flash_attention 5 (the dense first layer's once) and its
           backward 3; two reduced float32 DeepSeek steps on the card
           against the CPU.  The MoE's gradient is not bit-repeatable run
           to run (its gathers' backward adds atomically); the line says
           so.
  train_pixtral
           Pixtral-12B the same way: full width (d 5,120, GQA 32 / 8 heads
           x 128, d_ff 14,336, vocab 131,072, untied head), 3 of its 40
           layers, 2 x 4,096 tokens a step, each step's 2 x 256 patch
           embeddings drawn as launch/train.py's run draws them, Adam at
           lr 1e-4 under cvap(2, 1.8e-4) (at the other cells' 1e-3 its
           loss rose over the 4 steps; the bound scales with lr).  Checks
           as train_rg's: a step's flash_attention 6 and its backward 3;
           two reduced float32 Pixtral steps on the card against the CPU.
  train_musicgen
           MusicGen-medium at full width and full depth (d 1,536, 24 heads
           x 64, LayerNorm with a bias, a non-gated GELU MLP of 6,144,
           vocab 2,048, 48 layers), 4 x 4,096 tokens and 4 x 64
           conditioning frames a step, Adam at lr 1e-5 under cvap(2,
           1.8e-5) (its loss rose at 1e-3 to 3e-5).  Checks as
           train_rg's: a step's flash_attention 96 and its backward 48;
           two reduced float32 MusicGen steps on the card against the
           CPU.
  kernels  each CUDA kernel against its plain PyTorch version, at the
           shapes the paths gave it (ps_apply's median call per table, no
           sentinel rows, as the shard sends none; MF's too; replica
           ingest's on the full-key buffers, marked site "replica
           ingest", whose time, bound and index_add_ time the kernel
           table's ps_apply row carries as replica_ingest; the serve
           path's first call for the LLM kernels, and for rglru_scan also
           the float32 tail's first call; for flash_attention each served
           model's first call of each window: RecurrentGemma's, Gemma2's
           windowed and global (softcap 50, G 2, d 256), DeepSeek's MLA (G
           1, q / k 192, v 128), Pixtral's (G 4, d 128, causal) and
           MusicGen's (G 1, d 64, causal), the plain version over slices of the
           batch where its float32 logits would pass 5 GB) and at stress
           shapes (tests/test_kernels.py's cases for the LLM kernels, and
           for flash_attention the bfloat16 kernel's edges: every head-dim
           tier, dv != dh, ragged sq / skv, a q suffix, 16 heads at d 256
           with a window and with a cap, one serve-like request, empty key
           slots, and the attention of Qwen3-8B (32 / 8 heads) and
           OLMoE-1B-7B (16 / 16) at 4 x 4,096, d 128, causal; for ps_apply
           a batch 40,000 deep with 2% sentinels in f64 and f32, and 4,096
           entries all on one row; for topk_mag 4,096, 65,536 and 1,048,576
           magnitudes: one block, and tiles with 4 and 8 merge passes).  The
           parameter-server kernels and rglru_scan are held bitwise (for
           vap_accum, NaN meets NaN; its payload is free; rglru_scan's fused
           entries against the plain version on the card, whose exp, log1p
           and sqrt are the same CUDA functions, in bfloat16 and float32;
           its bare recurrence, linear_recurrence, at the same cases and
           the serve shape in float32, on CPU copies; and its branch-free
           sqrt against __fsqrt_rn on every float of [1e-12, 1], the gate's
           domain); flash_attention to
           the bfloat16 output's rounding at the serve path's call (atol
           4e-3, rtol 1e-2; the mean |output| is printed beside the error)
           and to tests/test_kernels.py's tolerance at the stress shapes,
           and ssd_scan, which computes in
           float32 as the TPU kernel does, against the plain version in
           float32 on the same values to the output's rounding (the distance
           to the plain version in bfloat16 is printed).  Per case: its time
           (CUDA events, median of 10 runs after warm-up), the plain
           version's (on the host for the parameter-server kernels, on the
           card for the LLM kernels), one PyTorch library call's on the card
           where one computes the same function (for vap_accum three eager
           ops; for flash_attention scaled_dot_product_attention, is_causal
           for a window-less call over the same positions, else the window
           as a boolean mask, none under a softcap; none for the two
           scans), and the least
           time the card could take (bytes over 3.35 TB/s, or operations
           over the peak rate for the inputs' type, whichever is larger).
           ps_apply's ms is the call as the shard makes it (the grouping,
           torch.sort(rows, stable=True), and the kernel); group_ms is the
           sort alone, apply_ms the kernel alone on its output, and
           group_int32_ms the sort of the rows cast to int32, cast included
           (whether the cast would pay).  Each flash_attention case names
           the entry that ran (bfloat16: wgmma on the tensor cores;
           float32: the float32 pipes), its TFLOP/s and its share of the
           bound; so does each ssd_scan case (bfloat16: three launches on
           the tensor cores, each float32 operand split into two bf16
           products; float32: the float32 pipes).  topk_mag's cases
           carry device_ms (its kernels' own device time per call, from the
           profiler, every launch of every call seen), call_ms (the flush's
           call: H2D, wrapper, D2H), library_device_ms (torch.argsort's
           device time) and launches_per_call; its bound counts bytes only
           (8n read, 8n written).  The topk_mag cases run in one child
           process of this script (--topk-cases N SEED ...), in a fresh
           CUDA context: late in a process that has profiled the paths,
           torch.profiler loses a window's first device events and skews
           the durations of the rest.  The ssd_scan backward at the train
           path's first call (column slices of xBC) and at stress shapes
           (padding, g > 1, an initial state, dfinal, both dtypes) against
           its plain version (autograd through ssd_chunked in float32 on
           the card), per output to 1e-4 of its largest magnitude + 1e-3
           relative, plus 2^-6 relative where the output is bfloat16 (the
           train call also with its device time a call by kernel from the
           train phase's profiled step, every bfloat16 case with its
           kernels' registers and shared memory);
           vap_accum also at the train path's largest leaf, and at
           train_pixtral's (its 131,072 x 5,120 float32 embedding; drawn,
           and its plain version run and timed, on the card).  The
           rglru_scan backward at the train_rg path's first call in each
           dtype (2 x 4,096 x 4,096: the unit's bfloat16, the tail's
           float32; from the path's own saved states, with its kernels'
           registers and shared memory and their device time a call by
           entry from train_rg's profiled step) and at stress shapes (an
           initial state and dh_last, w 50, l 1, the sqrt clamp's region,
           333 steps at w 4,096; both dtypes; each also without states),
           and its bare recurrence's entry, dx, dr, di and dinitial (the
           bare entry's every output) bitwise; the flash_attention
           backward at the path's first call (bfloat16, 2 x 4,096 x 1 x 16
           x 256, window 2,048, with the bfloat16 kernels' registers and
           shared memory) and at stress shapes (softcap, G 1-4, dv != dh,
           empty key slots and rows that see no key, ragged sq / skv, no
           window, the path's heads and width at 700 positions; both
           dtypes): each against its plain version on the card (rglru:
           dΛ to 1e-4 max|plain| + 1e-3 |plain|, + 2^-6 |plain| for a
           bfloat16 output; flash: the same in float32, 1e-2 max|plain| + 2^-6
           |plain| in bfloat16; also at the train_gemma2, train_deepseek,
           train_pixtral and train_musicgen paths' first call of each
           window, the plain
           version over slices of the batch and the kv heads, and at their
           layouts at 512-600 positions), run twice and failing where the two
           differ in bits (every backward check does), with the
           library's time where one call computes it (flash: the backward
           of scaled_dot_product_attention with the window as a boolean
           mask) and its bound.  The flash forward's cases also carry its
           time as training runs it (ms_with_lse): writing the rows'
           log-sum-exp and, in bfloat16, the output's rounding residual,
           which every bfloat16 flash backward takes.

After each phase a line {"phase_wall": name, "s": seconds}; after the
kernels phase one {"phase": "walls", ...} line with every phase's wall and
the script's.  Then the kernel table ({"kernels": [...]}), the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}.  Any failure
raises: the exit code
is non-zero and the last line is not printed.  There is no CPU path.
"""
import argparse
import collections
import contextlib
import ctypes
import dataclasses
import gc
import json
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# H100 SXM data sheet: FP64 and FP32 vector rates (no tensor cores), and the
# dense bf16 tensor-core rate (989 TFLOPS, without sparsity)
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12,
                  torch.bfloat16: 989e12}
REPS = 10
# topk_mag beyond the flush's lengths: one block, and tiles with 4 and 8
# merge passes
TOPK_STRESS_N = (4_096, 65_536, 1_048_576)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median device time of fn() between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps=REPS, warmup=2) -> float:
    """Median host wall time of fn() (CPU work, or work that ends in a
    device-to-host copy)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, nops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def check_ps_apply(dev, R, C, N, dtype, seed, sentinels, one_row=False):
    """At the main path's shapes ``sentinels`` is off, as the shard never
    sends row R; the stress cases plant 2% sentinel no-ops; ``one_row``
    puts every entry on one row (a hot word: one run walked serially)."""
    from repro_torch.kernels.ps_apply import ops, ref

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, size=N).astype(np.int64)   # ~N^2/2R duplicates
    if sentinels:
        rows[rng.random(N) < 0.02] = R
    if one_row:
        rows[:] = rng.integers(0, R)
    dense_c = torch.from_numpy(rng.normal(size=(R, C))).to(dtype)
    delta_c = torch.from_numpy(rng.normal(size=(N, C))).to(dtype)
    rows_c = torch.from_numpy(rows)

    want = ref.scatter_add_(dense_c.clone(), rows_c, delta_c)
    got = dense_c.to(dev)
    rows_d, delta_d = rows_c.to(dev), delta_c.to(dev)
    ops.scatter_add_(got, rows_d, delta_d)
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max()) if want.numel() else 0.0
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"ps_apply {R}x{C} N={N} {dtype}: kernel != "
                             f"plain (max abs err {err})")

    # timed as the shard calls it (rows checked on the host beforehand):
    # the grouping sort and the kernel; then each alone, and the sort of
    # the rows as int32
    ms = cuda_ms(lambda: ops.scatter_add_(got, rows_d, delta_d,
                                          rows_checked=True))
    group_ms = cuda_ms(lambda: torch.sort(rows_d, stable=True))
    keys, perm = torch.sort(rows_d, stable=True)
    apply_ms = cuda_ms(lambda: ops._apply_grouped_(got, keys, perm, delta_d))
    group_int32_ms = cuda_ms(
        lambda: torch.sort(rows_d.to(torch.int32), stable=True))
    plain_c = dense_c.clone()
    plain_ms = host_ms(lambda: ref.scatter_add_(plain_c, rows_c, delta_c))
    # the library call has no sentinel: give it the real rows only
    keep = rows_d < R
    lib_rows, lib_delta = rows_d[keep].contiguous(), delta_d[keep].contiguous()
    library_ms = cuda_ms(lambda: got.index_add_(0, lib_rows, lib_delta))

    real = rows[rows < R]
    esize = dense_c.element_size()
    touched = np.unique(real).size
    # touched rows read and written, delta read for the real rows only (a
    # sentinel's delta row is never read), every row index read
    nbytes = 2 * touched * C * esize + real.size * C * esize + N * 8
    bound_ms, bound_by = bound(nbytes, real.size * C, dtype)
    return {"shape": f"dense {R}x{C} rows {N} {str(dtype)[6:]}"
                     + (" one row" if one_row else ""),
            "max_abs_err": err, "ms": ms, "group_ms": group_ms,
            "apply_ms": apply_ms, "group_int32_ms": group_int32_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "unique_rows": int(touched)}


def profiled_device_ms(fn, count, match=None, reps=REPS,
                       windows=3) -> float:
    """Device time of one fn() call from torch.profiler: the device events
    of ``reps`` calls (those whose name holds ``match``, else all) summed
    and divided by ``reps``.  ``count(n_events)`` says whether the window
    holds every event it should.  A later window in one process now and
    then drops a device event, so an incomplete window is discarded and
    another taken, up to ``windows`` in all; only a complete window is
    measured, and the smoke fails if none is."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (match is None or match in e.name)]
        if count(len(us)):
            return sum(us) / reps / 1e3
        seen.append(len(us))
        print(f"profiler: window of {len(us)} device events matching "
              f"{match!r} in {reps} calls discarded", file=sys.stderr)
    raise AssertionError(f"profiler: {seen} device events matching "
                         f"{match!r} in {reps} calls, window after window")


def check_topk_mags(cases):
    """topk_mag's cases [(n, seed), ...], run by this script in one child
    process: in a process that has profiled much (the paths),
    torch.profiler loses the first device events of a later window and
    skews the durations of the rest, so the device times are taken in a
    fresh CUDA context, which profiles nothing else."""
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--topk-cases"] + [str(x) for case in cases
                                               for x in case],
                           capture_output=True, text=True, timeout=900)
    if child.returncode:
        raise AssertionError(f"topk_mag {cases}: a case failed:\n"
                             f"{child.stderr[-4000:]}")
    return [json.loads(line)
            for line in child.stdout.strip().splitlines()[-len(cases):]]


def topk_case(dev, n, seed):
    """Bitwise against the plain version, then timed: ``ms`` (CUDA events
    around a wrapper call), ``device_ms`` (the kernels' own device time per
    call, from the profiler: every launch of every call must show),
    ``call_ms`` (the flush's call: H2D, wrapper, D2H), the plain version on
    the host and ``torch.argsort`` on the card (events and device time)."""
    from repro_torch.kernels.topk_mag import ops, ref

    rng = np.random.default_rng(seed)
    m = rng.integers(0, max(n // 4, 2), size=n).astype(np.float64)   # ties
    m += rng.integers(0, 2, size=n) * 2.0 ** -40     # below f32 resolution
    m_c = torch.from_numpy(m)
    want = ref.magnitude_order(m_c)
    m_d = m_c.to(dev)
    got = ops.magnitude_order(m_d)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"topk_mag n={n}: kernel != plain")

    per_call = ops.launches_per_call(n)
    ms = cuda_ms(lambda: ops.magnitude_order(m_d))
    device_ms = profiled_device_ms(
        lambda: ops.magnitude_order(m_d),
        lambda c: c == REPS * per_call, match="topk_")
    plain_ms = host_ms(lambda: ref.magnitude_order(m_c))
    library_ms = cuda_ms(lambda: torch.argsort(-m_d, stable=True))
    library_device_ms = profiled_device_ms(
        lambda: torch.argsort(-m_d, stable=True),
        lambda c: c > 0 and c % REPS == 0)
    # what the runtime's flush pays per call: H2D, kernel, D2H
    call_ms = host_ms(lambda: ops.magnitude_order(
        torch.from_numpy(m).to(dev)).cpu().numpy())
    # bytes only: 8 n read, 8 n written; a sort's comparisons are far below
    # the card's integer rate
    bound_ms, bound_by = bound(16 * n, 0, torch.float64)
    return {"shape": f"mags {n} float64", "max_abs_err": 0.0, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "call_ms": call_ms,
            "launches_per_call": per_call}


def _nan_aware_equal(got, want) -> bool:
    """Bitwise equal (so -0.0 is not 0.0), except that NaN meets NaN at the
    same places with any payload: CUDA, torch and XLA canonicalise a NaN
    rounded to bfloat16 differently."""
    if got.device != want.device:
        got, want = got.cpu(), want.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    ints = torch.int16 if got.element_size() == 2 else torch.int32
    return torch.equal(got[~nan].view(ints), want[~nan].view(ints))


def check_vap_accum(dev, shape, delta_dtype, seed, special=False, offset=0,
                    plain_on_card=False):
    """``special`` plants NaN, +-inf and a -0.0 that stays -0.0 in delta;
    ``offset`` 1 starts every tensor one element into its buffer, so no
    pointer is 16-byte aligned and the kernel takes its scalar path.
    ``plain_on_card``: the inputs drawn and the plain version run and timed
    on the card (its element-wise float32 adds and max give the host's
    bits), for a leaf whose host copies would take minutes; else both on
    the host."""
    from repro_torch.kernels.vap_accum import ops, ref

    n = int(np.prod(shape))
    where = dev if plain_on_card else torch.device("cpu")
    g = torch.Generator(device=where).manual_seed(seed)
    p_c = torch.randn(shape, generator=g, device=where)
    d_c = (torch.randn(shape, generator=g, device=where) * 4).to(delta_dtype)
    u_c = torch.randn(shape, generator=g, device=where)
    if special:
        flat_d, flat_u = d_c.view(-1), u_c.view(-1)
        for i, v in zip((n // 7, n // 5, n // 3, n // 2),
                        (float("nan"), float("inf"), float("-inf"), -0.0)):
            flat_d[i] = v
        flat_u[n // 2] = -0.0

    def on_card(x):
        buf = torch.empty(n + offset, dtype=x.dtype, device=dev)
        view = buf[offset:].view(shape)
        view.copy_(x)
        return view

    p_d, d_d, u_d = on_card(p_c), on_card(d_c), on_card(u_c)
    want_p, want_d = p_c.clone(), d_c.clone()
    want_m = ref.vap_accum_(want_p, want_d, u_c)
    m = ops.vap_accum_(p_d, d_d, u_d)
    torch.cuda.synchronize()
    same = (_nan_aware_equal(p_d, want_p) and _nan_aware_equal(d_d, want_d)
            and _nan_aware_equal(m.reshape(1), want_m.reshape(1)))
    err = max(float((p_d.to(where) - want_p).abs().nan_to_num().max()),
              float((d_d.to(where).float() - want_d.float()).abs()
                    .nan_to_num().max())) if n else 0.0
    if not same:
        raise AssertionError(f"vap_accum {shape} delta {delta_dtype}: kernel "
                             f"!= plain (max abs err {err})")

    big = n > 10_000_000
    ms = cuda_ms(lambda: ops.vap_accum_(p_d, d_d, u_d))
    del want_m
    if plain_on_card:          # want_p / want_d are done with: time on them
        plain_ms = cuda_ms(lambda: ref.vap_accum_(want_p, want_d, u_c))
    else:
        plain_p, plain_d = p_c.clone(), d_c.clone()
        plain_ms = host_ms(lambda: ref.vap_accum_(plain_p, plain_d, u_c),
                           reps=5 if big else REPS, warmup=1 if big else 2)

    def library():            # three eager torch ops on the card
        p_d.add_(u_d)
        d_d.add_(u_d)
        return d_d.abs().amax()

    library_ms = cuda_ms(library)
    nbytes = n * (3 * 4 + 2 * d_c.element_size())   # read p u d, write p d
    bound_ms, bound_by = bound(nbytes, 3 * n, torch.float32)
    return {"shape": f"{'x'.join(map(str, shape))} p/u float32 delta "
                     f"{str(delta_dtype)[6:]}"
                     + (" NaN/inf/-0.0" if special else "")
                     + (" misaligned" if offset else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_on": "card" if plain_on_card else "host",
            "library_ms": library_ms, "library": "p.add_(u); d.add_(u); "
            "d.abs().amax() (three torch ops)", "bound_ms": bound_ms,
            "bound_by": bound_by}


# tests/test_kernels.py's tolerances for flash attention (stress cases)
FLASH_TOL = {torch.float32: dict(atol=5e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# at the serve path's call a row of 2,048 keys averages them to outputs of
# a few hundredths, where 2e-2 would let a dropped key tile pass: the gate
# is the bfloat16 output's rounding (2^-9 relative, so 1e-2 covers a unit
# in the last place) plus float32 summation order
FLASH_PATH_TOL = {torch.float32: dict(atol=5e-5, rtol=1e-4),
                  torch.bfloat16: dict(atol=4e-3, rtol=1e-2)}
# ssd_scan against the plain version in float32 on the same values: float32
# summation order, plus the rounding of a bfloat16 output (2^-9 relative)
SSD_TOL = {torch.float32: dict(atol=5e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=1e-3, rtol=4e-3)}
# tests/test_kernels.py's SSD tolerance between an all-float32 kernel and
# the bfloat16 plain version (reported, not a gate)
SSD_SAME_DTYPE_TOL = {torch.float32: dict(atol=5e-5, rtol=1e-4),
                      torch.bfloat16: dict(atol=1e-1, rtol=5e-2)}


# which of the kernel's two entries a dtype runs
FLASH_ENTRY = {torch.bfloat16: "wgmma bf16 (tensor cores, TMA ring)",
               torch.float32: "float32 pipes"}
SSD_ENTRY = {torch.bfloat16: "wgmma bf16, hi/lo split (tensor cores; "
                             "chunk state, state pass, chunk scan)",
             torch.float32: "float32 pipes (one block per (b, h))"}
# the attention of two served architectures that no smoke path runs, at the
# serve shape (4 x 4,096, causal, bfloat16): Qwen3-8B's 32 query / 8 kv
# heads and OLMoE-1B-7B's 16 / 16, both 128 wide
FLASH_MODEL_STRESS = (
    ("qwen3-8b attention (stress)", (4, 4096, 4096, 8, 4, 128, 128, None,
                                     None)),
    ("olmoe-1b-7b attention (stress)", (4, 4096, 4096, 16, 1, 128, 128,
                                        None, None)))
# the bfloat16 kernel's edges beyond tests/test_kernels.py's cases: each
# head-dim tier (16-64, 65-128, 129-256, zero-padded), dv above and below
# dh, sq and skv off the 128-row and 64-key tiles, a q suffix, 16 heads at d
# 256 with a window and with a cap, and a serve-like call (one request);
# then the fifth again with its second half of key slots empty (2**30)
FLASH_BF16_EDGES = ((1, 200, 200, 2, 2, 16, 16, None, None),
                    (1, 130, 130, 1, 2, 48, 80, 50, None),
                    (2, 257, 257, 2, 4, 256, 256, None, None),
                    (1, 128, 1000, 2, 2, 128, 64, None, None),
                    (1, 333, 1000, 1, 16, 256, 256, 300, None),
                    (1, 257, 257, 1, 16, 256, 256, 100, None),
                    (1, 200, 200, 1, 16, 256, 256, None, 30.0),
                    (1, 4096, 4096, 1, 16, 256, 256, 2048, None))


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


# the plain version's float32 logits of one call above this many bytes are
# made over slices of the batch (each slice's its own call of the plain
# version)
FLASH_PLAIN_SLICE_BYTES = 5e9


def flash_plain(q, k, v, q_pos, k_pos, **kw):
    """The plain version (dense float32 attention) of one flash call, over
    slices of the batch where one logits tensor of the whole call would pass
    FLASH_PLAIN_SLICE_BYTES (Gemma2-9B's prefill: 2 x 16 heads x 8,192^2
    float32 is 8.6 GB, and the plain version holds several)."""
    from repro_torch.kernels.flash_attention import ref

    b, sq, kvh, G, _ = q.shape
    per_row = 4 * kvh * G * sq * k.shape[1]
    step = max(1, int(FLASH_PLAIN_SLICE_BYTES // per_row))
    if step >= b:
        return ref.attention(q, k, v, q_pos, k_pos, **kw)
    return torch.cat([ref.attention(q[i:i + step], k[i:i + step],
                                    v[i:i + step], q_pos, k_pos, **kw)
                      for i in range(0, b, step)], 0)


def check_flash(dev, q, k, v, q_pos, k_pos, window=None, cap=None,
                tol=FLASH_TOL):
    """Inputs on the card; the plain version (dense float32 attention) runs
    on the card too (:func:`flash_plain`).  ``tol``: {dtype: allclose's
    atol and rtol}."""
    from repro_torch.kernels.flash_attention import ops

    kw = dict(window=window, cap=cap)
    got = ops.flash_attention(q, k, v, q_pos, k_pos, **kw)
    want = flash_plain(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    mean_abs_want = float(want.float().abs().mean())
    if not torch.allclose(got.float(), want.float(), **tol[q.dtype]):
        raise AssertionError(f"flash_attention {tuple(q.shape)} {q.dtype}: "
                             f"kernel != plain (max abs err {err}, mean "
                             f"|plain| {mean_abs_want}, {tol[q.dtype]})")
    del want
    b, sq, kvh, G, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    big = q.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, q_pos, k_pos, **kw))
    # the forward as training runs it: log-sum-exp and, in bfloat16, the
    # output's rounding residual
    ms_with_lse = cuda_ms(lambda: ops.flash_attention(
        q, k, v, q_pos, k_pos, **kw, return_lse=True))
    plain_ms = cuda_ms(lambda: flash_plain(q, k, v, q_pos, k_pos, **kw),
                       reps=5 if big else REPS, warmup=1 if big else 3)
    mask = k_pos[None, :].long() <= q_pos[:, None].long()
    if window is not None:
        mask &= k_pos[None, :].long() > q_pos[:, None].long() - window
    # a window-less call over the same positions is causal attention, which
    # the library takes as is_causal (its fastest form); others as a mask
    causal = (window is None and sq == skv and torch.equal(
        q_pos.long(), k_pos.long()) and torch.equal(
        k_pos.long().cpu(), torch.arange(skv)))
    library_ms, library = None, ("none: scaled_dot_product_attention "
                                 "takes no softcap")
    if cap is None:
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * G, sq, dh)
        ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        lkw = (dict(is_causal=True) if causal else dict(attn_mask=mask))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True, **lkw))
        library = ("scaled_dot_product_attention(" + (
            "is_causal=True" if causal else "attn_mask=window mask")
            + ", enable_gqa=True)")
    pairs = int(mask.sum()) * b * kvh * G        # (query, key) pairs kept
    esize = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * esize \
        + 4 * (sq + skv)
    flops = 2 * pairs * (dh + dv)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    return {"shape": f"q {'x'.join(map(str, q.shape))} kv {skv}x{dv} "
                     f"{_dname(q.dtype)} window {window} cap {cap}",
            "entry": FLASH_ENTRY[q.dtype],
            "empty_key_slots": int((k_pos == 2**30).sum()),
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
            "max_abs_err": err, "mean_abs_plain": mean_abs_want,
            "tolerance": tol[q.dtype],
            "ms": ms, "ms_with_lse": ms_with_lse,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library": library,
            "bound_ms": bound_ms, "bound_by": bound_by, "pairs": pairs}


def check_ssd(dev, x, dt, A, B, C, chunk, initial_state=None):
    from repro_torch.kernels.ssd_scan import ops, ref

    y, st = ops.ssd_scan(x, dt, A, B, C, chunk, initial_state=initial_state)
    y32, st32 = ref.ssd_chunked(x.float(), dt, A, B.float(), C.float(), chunk,
                                initial_state=initial_state)
    y_same, _ = ref.ssd_chunked(x, dt, A, B, C, chunk,
                                initial_state=initial_state)
    torch.cuda.synchronize()
    err = float((y.float() - y32).abs().max())
    err_state = float((st - st32).abs().max())
    err_same = float((y.float() - y_same.float()).abs().max())
    within_same = bool(torch.allclose(y.float(), y_same.float(),
                                      **SSD_SAME_DTYPE_TOL[x.dtype]))
    if not (torch.allclose(y.float(), y32, **SSD_TOL[x.dtype])
            and torch.allclose(st, st32, atol=1e-4, rtol=1e-4)):
        raise AssertionError(f"ssd_scan {tuple(x.shape)} {x.dtype}: kernel "
                             f"!= plain in float32 (max abs err y {err}, "
                             f"state {err_state})")
    del y32, st32, y_same
    ms = cuda_ms(lambda: ops.ssd_scan(x, dt, A, B, C, chunk,
                                      initial_state=initial_state))
    plain_ms = cuda_ms(lambda: ref.ssd_chunked(
        x, dt, A, B, C, chunk, initial_state=initial_state), reps=5, warmup=1)
    b, l, h, p = x.shape
    n = B.shape[-1]
    cs = min(chunk, l)
    fma = 0
    for c0 in range(0, l, cs):          # the last chunk is padded to cs
        fma += cs * (cs + 1) // 2 * (n + p) + 2 * cs * p * n
    esize = x.element_size()
    nbytes = (2 * x.numel() + B.numel() + C.numel()) * esize \
        + 4 * (dt.numel() + A.numel() + st.numel()) \
        + (4 * initial_state.numel() if initial_state is not None else 0)
    flops = 2 * fma * b * h
    bound_ms, bound_by = bound(nbytes, flops, x.dtype)
    return {"shape": f"x {'x'.join(map(str, x.shape))} B/C "
                     f"{'x'.join(map(str, B.shape))} {_dname(x.dtype)} chunk "
                     f"{chunk}" + (" initial state" if initial_state
                                   is not None else ""),
            "entry": SSD_ENTRY[x.dtype],
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
            "max_abs_err": err, "max_abs_err_state": err_state,
            "tolerance": SSD_TOL[x.dtype],
            "max_abs_err_vs_same_dtype_plain": err_same,
            "within_test_kernels_tolerance_of_same_dtype_plain": within_same,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_rglru(dev, x, r_gate, i_gate, a_param, initial=None, c=8.0):
    """The fused entry (gates, recurrence and h's cast in one launch)
    against the plain version on the card, bitwise: its exp, log1p and sqrt
    are the same CUDA math functions, and every other op rounds once in
    both."""
    from repro_torch.kernels.rglru_scan import ops, ref

    args = (x, r_gate, i_gate, a_param, initial, c)
    h, h_last = ops.rglru(*args)
    want_h, want_last = ref.rglru(*args)
    torch.cuda.synchronize()
    err = float((h.float() - want_h.float()).abs().max())
    err_last = float((h_last - want_last).abs().max())
    if not (torch.equal(h, want_h) and torch.equal(h_last, want_last)):
        raise AssertionError(f"rglru {tuple(x.shape)} {x.dtype}: kernel != "
                             f"plain on the card (max abs err h {err}, "
                             f"h_last {err_last})")
    del want_h, want_last
    big = x.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.rglru(*args))
    plain_ms = cuda_ms(lambda: ref.rglru(*args), reps=3 if big else REPS,
                       warmup=1)
    esize = x.element_size()
    nbytes = esize * (4 * x.numel() + a_param.numel()) + 4 * (
        h_last.numel() + (initial.numel() if initial is not None else 0))
    # per element: two exp, a sqrt and eight other float32 ops
    bound_ms, bound_by = bound(nbytes, 11 * x.numel(), torch.float32)
    return {"shape": f"x/r/i {'x'.join(map(str, x.shape))} {_dname(x.dtype)}"
                     + (" initial state" if initial is not None else ""),
            "entry": ops.RGLRU_ENTRIES[x.dtype],
            "max_abs_err": err, "max_abs_err_h_last": err_last,
            "tolerance": "bitwise (0)", "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


def check_rglru_sqrt(dev):
    """The fused kernel's branch-free sqrt against __fsqrt_rn on every float
    of the gate's domain, [1e-12, 1]: no bit may differ."""
    from repro_torch.kernels import _build

    fn = _build.entry("rglru_sqrt_mismatches", [
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_void_p])
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (1e-12, 1.0))
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    err = fn(torch.cuda.current_device(), lo, hi, count.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    if err or int(count):
        raise AssertionError(f"rglru_scan's sqrt: launch error {err}, "
                             f"{int(count)} floats in [1e-12, 1] differ "
                             f"from __fsqrt_rn")
    return {"domain": "[1e-12, 1]", "floats": hi - lo + 1, "mismatches": 0}


def check_linear_recurrence(dev, a, b, initial=None):
    """The bare recurrence entry against the plain version on CPU copies,
    bitwise."""
    from repro_torch.kernels.rglru_scan import ops, ref

    h, h_last = ops.linear_recurrence(a, b, initial)
    want_h, want_last = ref.linear_recurrence(
        a.cpu(), b.cpu(), None if initial is None else initial.cpu())
    err = float((h.cpu() - want_h).abs().max())
    if not (torch.equal(h.cpu(), want_h) and torch.equal(h_last.cpu(),
                                                         want_last)):
        raise AssertionError(f"linear_recurrence {tuple(a.shape)}: kernel "
                             f"!= plain (max abs err {err})")
    del want_h, want_last
    big = a.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.linear_recurrence(a, b, initial))
    plain_ms = cuda_ms(lambda: ref.linear_recurrence(a, b, initial),
                       reps=3 if big else REPS, warmup=1)
    nbytes = 4 * (3 * a.numel() + h_last.numel()
                  + (initial.numel() if initial is not None else 0))
    bound_ms, bound_by = bound(nbytes, 2 * a.numel(), torch.float32)
    return {"shape": f"a/b {'x'.join(map(str, a.shape))} float32"
                     + (" initial state" if initial is not None else ""),
            "entry": "linear_recurrence_f32",
            "max_abs_err": err, "tolerance": "bitwise (0)", "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def llm_stress_cases(dev):
    """tests/test_kernels.py's cases for the three LLM kernels, on the
    card, inputs drawn from a seed."""
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def flash(case, dtype, sentinels=False):
        b, sq, skv, kvh, G, dh, dv, window, cap = case
        k_pos = torch.arange(skv, dtype=torch.int32, device=dev)
        if sentinels:                       # the ring's empty slots
            k_pos[skv // 2:] = 2**30
        return check_flash(
            dev, randn(b, sq, kvh, G, dh, dtype=dtype),
            randn(b, skv, kvh, dh, dtype=dtype),
            randn(b, skv, kvh, dv, dtype=dtype),
            torch.arange(skv - sq, skv, dtype=torch.int32, device=dev),
            k_pos, window=window, cap=cap)

    out = {"flash_attention": [], "ssd_scan": [], "rglru_scan": [],
           "linear_recurrence": []}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ((2, 256, 256, 2, 2, 64, 64, None, None),
                     (2, 256, 256, 2, 2, 64, 64, 100, None),
                     (1, 300, 300, 1, 4, 32, 32, None, 50.0),
                     (1, 128, 128, 4, 1, 192, 128, None, None),
                     (1, 512, 512, 1, 1, 128, 128, 64, 30.0),
                     (2, 64, 512, 2, 2, 64, 64, None, None)):
            out["flash_attention"].append(flash(case, dtype))
        for b, l, h, p, gr, n, chunk in ((2, 64, 4, 8, 2, 16, 16),
                                         (1, 100, 6, 16, 1, 32, 32),
                                         (2, 256, 4, 64, 2, 128, 64),
                                         (1, 32, 2, 8, 2, 8, 32)):
            out["ssd_scan"].append(check_ssd(
                dev, randn(b, l, h, p, dtype=dtype), uniform(0.01, 0.2, b, l, h),
                -uniform(0.1, 1.0, h), randn(b, l, gr, n, dtype=dtype),
                randn(b, l, gr, n, dtype=dtype), chunk,
                initial_state=randn(b, h, p, n, std=0.5)))
    for b, l, w in ((2, 64, 128), (1, 100, 50), (3, 256, 256), (1, 128, 4096),
                    (4, 333, 4096)):
        for dtype in (torch.bfloat16, torch.float32):
            out["rglru_scan"].append(check_rglru(
                dev, randn(b, l, w, dtype=dtype),
                uniform(0, 1, b, l, w).to(dtype),
                uniform(0, 1, b, l, w).to(dtype), randn(w, dtype=dtype),
                randn(b, w)))
    # the bare recurrence: the same cases, and the serve shape in float32
    for b, l, w in ((2, 64, 128), (1, 100, 50), (3, 256, 256), (1, 128, 4096),
                    (4, 333, 4096), (4, 4096, 4096)):
        out["linear_recurrence"].append(check_linear_recurrence(
            dev, uniform(0.7, 0.999, b, l, w), randn(b, l, w, std=0.1),
            randn(b, w)))
    out["flash_attention"] += [flash(case, torch.bfloat16)
                               for case in FLASH_BF16_EDGES]
    out["flash_attention"].append(flash(FLASH_BF16_EDGES[4], torch.bfloat16,
                                        sentinels=True))
    out["flash_attention"] += [{"call": call, **flash(case, torch.bfloat16)}
                               for call, case in FLASH_MODEL_STRESS]
    return out


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

N_DOCS, VOCAB, TRUE_TOPICS, DOC_LEN = 400, 50_000, 20, 120
N_TOPICS, N_WORKERS, N_SHARDS, N_CLOCKS = 1_000, 4, 2, 3
# the corpus keeps 20News's vocabulary and cuts its depth
REDUCED = {"n_docs": f"{N_DOCS} of ~11,000 (20News)"}


def _short(name: str) -> str:
    """A kernel's name without its namespaces, cut to 200 characters: long
    enough that the elementwise kernels keep the functor that tells them
    apart (a copy's dtypes, the op)."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::", "c10::"):
        name = name.replace(noise, "")
    return name[:200]


# ps_apply's kernels by name: its own, and its grouping's (torch.sort's
# sort kernels; no other sort runs on the lda and apps paths).  The sort's
# index fill and memsets cannot be told from others by name and are not
# counted.
PS_APPLY_KERNEL = re.compile(r"ps_apply_kernel")
SORT_KERNEL = re.compile(r"sort", re.IGNORECASE)


def ps_apply_seconds(device_s: dict, launched: int) -> dict:
    """ps_apply's device seconds, its kernel's and its grouping's.  Fails
    if it launched and either part matched no kernel: a renamed kernel
    must not shrink the number unseen."""
    kernel = sum(v for k, v in device_s.items() if PS_APPLY_KERNEL.match(k))
    group = sum(v for k, v in device_s.items() if SORT_KERNEL.search(k))
    if launched and not (kernel > 0 and group > 0):
        raise AssertionError(f"ps_apply launched {launched} times, but its "
                             f"kernel ({kernel} s) or its sort ({group} s) "
                             f"matched no kernel by name")
    return {"kernel": kernel, "group": group}


# ssd_scan's kernels by name: the bfloat16 entry's three launches
SSD_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
               "ssd_chunk_scan_kernel")


def ssd_scan_seconds(device_s: dict, launched: int) -> dict:
    """ssd_scan's device seconds, by each of its bfloat16 entry's kernels
    and in all.  Fails if it launched and a kernel matched no name."""
    out = {k: sum(v for name, v in device_s.items() if name.startswith(k))
           for k in SSD_KERNELS}
    if launched and not all(out.values()):
        raise AssertionError(f"ssd_scan launched {launched} times, but a "
                             f"kernel matched no name: {out}")
    return {**out, "total": sum(out.values())}


# rglru_scan's kernel by name (both entries, and linear_recurrence, are
# instantiations of one template); PyTorch's elementwise kernels by name
RGLRU_KERNEL = "rglru_kernel"
ELEMENTWISE = re.compile(r"elementwise_kernel")


def rglru_scan_seconds(device_s: dict, launched: int) -> float:
    """rglru_scan's device seconds.  Fails if it launched and its kernel
    matched no name."""
    out = sum(v for k, v in device_s.items() if k.startswith(RGLRU_KERNEL))
    if launched and not out > 0:
        raise AssertionError(f"rglru_scan launched {launched} times, but "
                             f"{RGLRU_KERNEL} matched no kernel by name")
    return out


def device_seconds(prof) -> dict:
    """Device time by kernel / copy name, from the profiler's device
    events."""
    out = {}
    for e in prof.events():
        # a call site's range also shows on the device's timeline: its
        # kernels are counted under their own names
        if e.device_type == DeviceType.CUDA and not e.name.startswith(SITE):
            name = _short(e.name)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e6
    return out


KERNELS = ("ps_apply", "topk_mag", "vap_accum", "flash_attention",
           "ssd_scan", "rglru_scan")
# the backward kernels: (name, the forward's kernel, its wrapper's function)
BACKWARDS = (("ssd_scan_bwd", "ssd_scan", "ssd_scan_bwd"),
             ("rglru_scan_bwd", "rglru_scan", "rglru_bwd"),
             ("flash_attention_bwd", "flash_attention",
              "flash_attention_bwd"))
SITE = "site:"


class Sites:
    """Split a single-threaded path's cost by call site.

    ``patch(obj, attr, name)`` replaces ``obj.attr`` with a wrapper that runs
    it inside ``record_function("site:<name>")`` and notes its host time and
    the peak of device memory it allocated above what was held when it was
    called.  A site called inside another is left to the outer one, so no
    time is counted twice.  ``device_s(prof)`` reads each site's device time
    (its kernels and copies, children included) from the profiler;
    ``peak()`` is the path's peak device memory, which the per-site reading
    would otherwise hide, since it resets the peak counter.
    """

    def __init__(self, dev):
        self.dev, self.depth, self.saved = dev, 0, []
        self.host_s, self.calls, self.site_peak = {}, {}, {}
        self.seen_peak = 0

    def wrap(self, name, fn):
        def inner(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self.depth += 1
            self.seen_peak = max(self.seen_peak,
                                 torch.cuda.max_memory_allocated(self.dev))
            torch.cuda.reset_peak_memory_stats(self.dev)
            base = torch.cuda.memory_allocated(self.dev)
            t = time.perf_counter()
            try:
                with record_function(SITE + name):
                    return fn(*args, **kwargs)
            finally:
                self.host_s[name] = (self.host_s.get(name, 0.0)
                                     + time.perf_counter() - t)
                self.calls[name] = self.calls.get(name, 0) + 1
                top = torch.cuda.max_memory_allocated(self.dev)
                self.site_peak[name] = max(self.site_peak.get(name, 0),
                                           top - base)
                self.seen_peak = max(self.seen_peak, top)
                self.depth -= 1
        return inner

    def patch(self, obj, attr, name):
        self.saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, self.wrap(name, getattr(obj, attr)))

    def restore(self):
        for obj, attr, fn in reversed(self.saved):
            setattr(obj, attr, fn)
        self.saved = []

    def peak(self):
        return max(self.seen_peak, torch.cuda.max_memory_allocated(self.dev))

    def device_s(self, prof):
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith(SITE):
                name = e.name[len(SITE):]
                out[name] = out.get(name, 0.0) + e.device_time_total / 1e6
        return out

    def report(self, prof):
        dev_s = self.device_s(prof)
        return {name: {"calls": self.calls[name], "host_s": self.host_s[name],
                       "device_s": dev_s.get(name, 0.0),
                       "peak_above_held_bytes": self.site_peak[name]}
                for name in self.calls}


def first_key(name, args, kw):
    """The key an LLM kernel's call is kept and counted under: the kernel
    and its dtype."""
    return (name, args[0].dtype)


def window_key(name, args, kw):
    """:func:`first_key` and the call's attention window: a keyword of a
    flash_attention call, or its positional argument (the sixth, as the
    autograd Function passes it; the backward's ninth); None for the other
    kernels and for a layer without one."""
    at = {"flash_attention": 5, "flash_attention_bwd": 8}.get(name)
    window = args[at] if at is not None and len(args) > at \
        else kw.get("window")
    return (name, args[0].dtype, window)


@contextlib.contextmanager
def path_run(dev, keep_first=False, key=first_key):
    """Drive one path inside the block: every kernel's launch counter set to
    0 just before and read just after (into ``run["launches"]``; the
    backwards' under their names in BACKWARDS, rglru_scan's also by entry
    in ``run["rglru_scan_by_entry"]``), the shape
    of every call noted (``run["calls"]``; vap_accum's with the max it
    returned; an LLM kernel's calls also counted by ``key(name, args, kw)``
    in ``run["by_key"]``; with ``keep_first``, the first call under each
    key keeps its inputs in ``run["first"][key]``, a parameter's as a
    copy), peak device memory reset."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ps_apply import ops as apply_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.topk_mag import ops as topk_ops
    from repro_torch.kernels.vap_accum import ops as vap_ops

    mods = dict(zip(KERNELS, (apply_ops, topk_ops, vap_ops, fa_ops, ssd_ops,
                              rg_ops)))
    attrs = {"ps_apply": "scatter_add_", "topk_mag": "magnitude_order",
             "vap_accum": "vap_accum_", "flash_attention": "flash_attention",
             "ssd_scan": "ssd_scan", "rglru_scan": "rglru"}
    orig = {k: getattr(mods[k], attrs[k]) for k in KERNELS}
    # the LLM kernels' first call keeps its inputs (references, no copy)
    run = {"calls": {k: [] for k in KERNELS}, "first": {}, "mods": mods,
           "by_key": collections.Counter()}

    def scatter_add_(dense, rows, delta, **kw):
        run["calls"]["ps_apply"].append((*dense.shape, rows.shape[0]))
        return orig["ps_apply"](dense, rows, delta, **kw)

    def magnitude_order(mags, k=None):
        run["calls"]["topk_mag"].append(mags.shape[0])
        return orig["topk_mag"](mags, k)

    def vap_accum_(params, delta, update):
        m = orig["vap_accum"](params, delta, update)
        run["calls"]["vap_accum"].append((tuple(params.shape), m))
        return m

    def noting(name):
        def call(*args, **kw):
            run["calls"][name].append((_dname(args[0].dtype), tuple(
                tuple(a.shape) for a in args
                if isinstance(a, torch.Tensor))))
            k = key(name, args, kw)
            run["by_key"][k] += 1
            if keep_first and k not in run["first"]:
                # a parameter (a leaf that requires grad) is updated in
                # place by the optimizer later in the run: keep its value
                # at this call, as the activations and the forward's
                # states it is checked with are; an activation is kept
                # detached, so that its autograd graph (the unit's saved
                # tensors) is freed with the step
                run["first"][k] = (tuple(
                    (a.detach().clone() if a.is_leaf and a.requires_grad
                     else a.detach()) if isinstance(a, torch.Tensor) else a
                    for a in args), kw)
            return orig[name](*args, **kw)
        return call

    wrappers = {"ps_apply": scatter_add_, "topk_mag": magnitude_order,
                "vap_accum": vap_accum_}
    for k in KERNELS:
        setattr(mods[k], attrs[k], wrappers.get(k) or noting(k))
    # the backwards: each its own counter, its calls noted as the others'
    for name, mod, attr in BACKWARDS:
        orig[name] = getattr(mods[mod], attr)
        run["calls"][name] = []
        setattr(mods[mod], attr, noting(name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for m in mods.values():
        m.launches = 0
    for _, mod, _ in BACKWARDS:
        mods[mod].bwd_launches = 0
    apply_ops.launches_by_site.clear()
    for by_entry in (rg_ops.launches_by_entry, rg_ops.bwd_launches_by_entry):
        for e in by_entry:
            by_entry[e] = 0
    try:
        yield run
        torch.cuda.synchronize()
    finally:
        for k in KERNELS:
            setattr(mods[k], attrs[k], orig[k])
        for name, mod, attr in BACKWARDS:
            setattr(mods[mod], attr, orig[name])
        run["launches"] = {k: m.launches for k, m in mods.items()}
        for name, mod, _ in BACKWARDS:
            run["launches"][name] = mods[mod].bwd_launches
        run["rglru_scan_by_entry"] = {**rg_ops.launches_by_entry,
                                      **rg_ops.bwd_launches_by_entry}
        run["ps_apply_by_site"] = dict(apply_ops.launches_by_site)


def run_lda_phase(dev, corpus, corpus_s):
    from repro_torch.apps import lda
    from repro_torch.core import policies

    t = time.perf_counter()
    with path_run(dev) as run:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lls, stats, rt = lda.run_lda(
                corpus, n_topics=N_TOPICS, policy=policies.ssp(1),
                n_workers=N_WORKERS, n_clocks=N_CLOCKS, threads_per_process=1,
                n_shards=N_SHARDS, seed=0, backend="runtime",
                collect_stats=True, return_ps=True, device="cuda")
            torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches, calls = run["launches"], run["calls"]
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())
    peak = torch.cuda.max_memory_allocated(dev)

    block = rt.shards[0].dense["word_topic"]
    if not (block.is_cuda and block.dtype == torch.float64
            and tuple(block.shape) == (VOCAB // N_SHARDS, N_TOPICS)):
        raise AssertionError(f"word_topic master block is {block.dtype} "
                             f"{tuple(block.shape)} on {block.device}")
    if stats.violations:
        raise AssertionError(f"violations: {stats.violations[:5]}")
    wt = rt.master_value("word_topic")
    tc = rt.master_value("topic")
    for key, got in (("word_topic", wt), ("topic", tc)):
        if not np.array_equal(got, rt.expected_value(key)):
            raise AssertionError(f"master {key} != x0 + sum(updates)")
    if wt.shape != (VOCAB, N_TOPICS) or wt.sum() != corpus.n_tokens \
            or (wt < 0).any():
        raise AssertionError(f"word_topic {wt.shape} holds {wt.sum()} "
                             f"counts for {corpus.n_tokens} tokens")
    if not np.array_equal(tc, wt.sum(0)):
        raise AssertionError("topic != word_topic.sum(0)")
    if not (np.isfinite(lls).all() and len(lls) == N_CLOCKS
            and lls[-1] > lls[0]):
        raise AssertionError(f"log-likelihood not finite and rising: {lls}")
    for name in ("ps_apply", "topk_mag"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the lda path")

    ct = [0.0] + list(stats.clock_times)
    rows_applied = sum(s.m_rows_applied for s in rt.shards)
    emit({"phase": "lda", "n_docs": N_DOCS, "vocab": VOCAB,
          "n_topics": N_TOPICS, "tokens": corpus.n_tokens,
          "workers": N_WORKERS, "shards": N_SHARDS, "policy": "ssp(1)",
          "clocks": N_CLOCKS, "reduced": REDUCED, "corpus_s": corpus_s,
          "wall_s": wall_s, "clock_s": [b - a for a, b in zip(ct, ct[1:])],
          "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
          "device_s_by_name": dict(sorted(device_s.items(),
                                          key=lambda kv: -kv[1])[:8]),
          "peak_device_bytes": peak, "launches": launches,
          "ps_apply_device_s": ps_apply_seconds(device_s,
                                                launches["ps_apply"]),
          "rows_per_apply": rows_applied / launches["ps_apply"],
          "log_likelihood": lls, "violations": 0, "master_exact": True})
    return launches, calls, wall_s


WIRE_BSP_CLOCKS = 2


def _wire_runtime(dev, corpus, policy, transport, n_shards=N_SHARDS, **kw):
    """The lda phase's configuration as a PSRuntime with its update_fn,
    states drawn afresh from seed 0 (run_lda's defaults: alpha 0.1, beta
    0.01)."""
    from repro_torch.apps import lda
    from repro_torch.runtime import PSRuntime, RuntimeConfig

    _, states, wt0, tc0 = lda._init_states(corpus, N_TOPICS, N_WORKERS, 0)
    fn = lda._make_update_fn(states, corpus.vocab_size, 0.1, 0.01)
    rt = PSRuntime(RuntimeConfig(
        N_WORKERS, policy, {"word_topic": wt0, "topic": tc0},
        n_shards=n_shards, threads_per_process=1, seed=0,
        transport=transport, device=dev, **kw))
    return rt, fn


def _check_lda_master(rt, corpus, what):
    """The final state the lda phase checks, held exactly: master and every
    shipped cache x0 + sum(updates), every token counted once, topic ==
    word_topic.sum(0), blocks f64 on the card.  Returns the two masters."""
    for s in rt.shards:
        for key, block in s.dense.items():
            if not (block.is_cuda and block.dtype == torch.float64):
                raise AssertionError(f"{what}: {key} master block is "
                                     f"{block.dtype} on {block.device}")
    out = {}
    for key in ("word_topic", "topic"):
        out[key] = rt.master_value(key)
        want = rt.expected_value(key)
        if not np.array_equal(out[key], want):
            raise AssertionError(f"{what}: master {key} != x0 + sum(updates)")
        for p in range(rt.n_proc):
            if not np.array_equal(rt.view(p)[key], want):
                raise AssertionError(f"{what}: process {p}'s {key} != "
                                     f"x0 + sum(updates)")
    wt, tc = out["word_topic"], out["topic"]
    if wt.shape != (VOCAB, N_TOPICS) or wt.sum() != corpus.n_tokens \
            or (wt < 0).any():
        raise AssertionError(f"{what}: word_topic {wt.shape} holds "
                             f"{wt.sum()} counts for {corpus.n_tokens} tokens")
    if not np.array_equal(tc, wt.sum(0)):
        raise AssertionError(f"{what}: topic != word_topic.sum(0)")
    return out


def run_wire_phase(dev, corpus, lda_wall_s):
    """The lda phase's run with forked clients over the shm rings (the
    zero-copy wire), then the bitwise bsp check across shm, tcp and queue.
    Nothing here is caught: a failed child or check fails the smoke."""
    from repro_torch.core import policies

    shm = os.statvfs("/dev/shm")
    shm_bytes = {"total": shm.f_frsize * shm.f_blocks,
                 "avail": shm.f_frsize * shm.f_bavail}
    rt, fn = _wire_runtime(dev, corpus, policies.ssp(1), "shm",
                           zero_copy=True)
    with path_run(dev) as run:
        t = time.perf_counter()
        rt.start(fn, N_CLOCKS, timeout=300)
        # the clients are forked by now: profile this process only
        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stats = rt.wait()
            torch.cuda.synchronize()
        end = time.perf_counter()
    wall_s, prof_s = end - t, end - t_prof
    peak = torch.cuda.max_memory_allocated(dev)     # before the bsp runs
    launches = run["launches"]
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())
    if stats.violations:
        raise AssertionError(f"wire: violations {stats.violations[:5]}")
    applied = sum(int(s.applied_parts.sum()) for s in rt.shards)
    sent = int(rt._parts_sent.sum())
    if applied != sent:
        raise AssertionError(f"wire: parts sent {sent} != applied {applied}")
    _check_lda_master(rt, corpus, "wire shm")
    if launches["ps_apply"] <= 0 or launches["topk_mag"] != 0:
        raise AssertionError(f"wire: ps_apply launched {launches['ps_apply']}"
                             f" times, topk_mag {launches['topk_mag']} (the "
                             f"forked clients must order in host numpy)")
    in_profile = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and PS_APPLY_KERNEL.match(_short(e.name)))
    ct = [0.0] + list(stats.clock_times)

    # bitwise: bsp with barrier_reads on the three transports, same seed
    masters, walls = {}, {}
    for transport, kw in (("shm", {"zero_copy": True}), ("tcp", {}),
                          ("queue", {})):
        brt, bfn = _wire_runtime(dev, corpus, policies.bsp(), transport,
                                 barrier_reads=True, **kw)
        t = time.perf_counter()
        bst = brt.run(bfn, WIRE_BSP_CLOCKS, timeout=300)
        walls[transport] = time.perf_counter() - t
        if bst.violations:
            raise AssertionError(f"wire bsp {transport}: violations "
                                 f"{bst.violations[:5]}")
        masters[transport] = _check_lda_master(brt, corpus,
                                               f"wire bsp {transport}")
        del brt
    for transport in ("tcp", "queue"):
        for key in ("word_topic", "topic"):
            if not np.array_equal(masters[transport][key],
                                  masters["shm"][key]):
                raise AssertionError(f"wire bsp: {transport}'s {key} master "
                                     f"differs from shm's")
    emit({"phase": "wire", "transport": "shm", "zero_copy": True,
          "n_docs": N_DOCS, "vocab": VOCAB, "n_topics": N_TOPICS,
          "tokens": corpus.n_tokens, "workers": N_WORKERS,
          "client_processes": rt.n_proc, "shards": N_SHARDS,
          "policy": "ssp(1)", "clocks": N_CLOCKS, "reduced": REDUCED,
          "wall_s": wall_s, "clock_s": [b - a for a, b in zip(ct, ct[1:])],
          "lda_phase_wall_s": lda_wall_s, "profiled_s": prof_s,
          "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / prof_s,
          "device_s_by_name": dict(sorted(device_s.items(),
                                          key=lambda kv: -kv[1])[:8]),
          "h2d_s": sum(v for k, v in device_s.items() if "HtoD" in k),
          "d2h_s": sum(v for k, v in device_s.items() if "DtoH" in k),
          "peak_device_bytes": peak,
          "launches": launches,
          "ps_apply_device_s": ps_apply_seconds(device_s,
                                                launches["ps_apply"]),
          "ps_apply_kernels_in_profile": in_profile,
          "parts_sent": sent, "parts_applied": applied,
          "ring_capacity_bytes": 2 * rt._shm_max_frame,
          "rings": 2 * rt.n_proc * N_SHARDS, "dev_shm_bytes": shm_bytes,
          "machine": platform.machine(), "violations": 0,
          "master_exact": True,
          "bsp_bitwise": {"clocks": WIRE_BSP_CLOCKS, "barrier_reads": True,
                          "transports": list(masters), "wall_s": walls,
                          "equal": True}})
    return launches, wall_s


DURABLE_SNAPSHOT_EVERY = 2
# events a thread ring holds: far above what a 3-clock run records in one
# thread (the shard threads record ~10 events a batch)
DURABLE_TRACE = {"sample": 1.0, "capacity": 1 << 20}
RAM_FS = ("tmpfs", "ramfs")


def fs_type(path: str) -> str:
    """The type of the filesystem ``path`` lives on (/proc/mounts, longest
    mount point that contains it)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mnt = fields[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best):
                best, kind = mnt, fields[2]
    return kind


def durable_dir() -> str:
    """A fresh directory for the WAL and the snapshots on a filesystem
    where fsync reaches a disk: tempfile's, unless that is in memory, then
    one under this checkout's build/ (gitignored)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    if fs_type(root) not in RAM_FS:
        return root
    os.rmdir(root)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_durable_", dir=build)


def run_durable_phase(dev, corpus, wire_wall_s):
    """The wire phase's run with the observability and durability tiers on
    (full tracing, the WAL with an fsync every group commit, a snapshot
    every 2 clocks), then the WAL replayed on the card: from genesis and
    from the snapshot, each bitwise equal to the run's final master.
    Returns the kernels' launches in the run and in each replay."""
    from repro_torch.core import policies
    from repro_torch.runtime import recover_to_vc, wal_segments
    from repro_torch.runtime import trace as trace_mod

    root = durable_dir()
    wal_dir = os.path.join(root, "wal")
    snap_dir = os.path.join(root, "snaps")
    try:
        rt, fn = _wire_runtime(
            dev, corpus, policies.ssp(1), "shm", zero_copy=True,
            trace=DURABLE_TRACE, wal_dir=wal_dir, wal_fsync="boundary",
            snapshot_every=DURABLE_SNAPSHOT_EVERY, snapshot_dir=snap_dir)
        x0 = rt.config.init_params
        # torch.profiler's first session in a process, entered after the
        # fork, recorded none of the shard threads' kernels on the H100
        # machine (only the last copy): one short session before the fork
        # sets CUPTI up, so the phase does not depend on an earlier one
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
        with path_run(dev) as run:
            t = time.perf_counter()
            rt.start(fn, N_CLOCKS, timeout=600)
            t_prof = time.perf_counter()
            # the clients are forked by now: profile this process only
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                stats = rt.wait()
                torch.cuda.synchronize()
            end = time.perf_counter()
        start_s, wait_s = t_prof - t, end - t_prof
        launches = run["launches"]
        device_s = device_seconds(prof)
        busy_s = sum(device_s.values())
        if stats.violations:
            raise AssertionError(f"durable: violations {stats.violations[:5]}")
        applied_by_proc = sum(s.applied_parts for s in rt.shards)
        applied = int(applied_by_proc.sum())
        sent = int(rt._parts_sent.sum())
        if applied != sent:
            raise AssertionError(f"durable: parts sent {sent} != applied "
                                 f"{applied}")
        masters = _check_lda_master(rt, corpus, "durable")
        if launches["ps_apply"] <= 0 or launches["topk_mag"] != 0:
            raise AssertionError(f"durable: ps_apply launched "
                                 f"{launches['ps_apply']} times, topk_mag "
                                 f"{launches['topk_mag']}")

        # the trace reconciles exactly: every part's send and its apply
        hub = rt._trace
        counts = hub.counts()
        n_send = counts.get(trace_mod.EV_SEND, 0)
        n_land = counts.get(trace_mod.EV_APPLY_PART, 0)
        if not (n_send == n_land == applied and hub.dropped() == 0):
            raise AssertionError(f"durable: trace send_part {n_send}, "
                                 f"apply_part {n_land}, applied {applied}, "
                                 f"dropped {hub.dropped()}")

        # the metrics agree with the audit counters and with the disk
        m = rt.metrics()
        seg_paths = [p for segs in wal_segments(wal_dir).values()
                     for _, p in segs]
        seg_bytes = sum(os.path.getsize(p) for p in seg_paths)
        wal = {"parts": sum(x.wal_parts for x in m.shards),
               "commits": sum(x.wal_commits for x in m.shards),
               "bytes": sum(x.wal_bytes for x in m.shards),
               "segments": sum(x.wal_segments for x in m.shards),
               "fsync_s": sum(x.wal_fsync_s for x in m.shards)}
        parts_applied = sum(x.parts_applied for x in m.shards)
        if not (parts_applied == wal["parts"] == applied
                and wal["bytes"] == seg_bytes
                and wal["segments"] == len(seg_paths)):
            raise AssertionError(
                f"durable: metrics parts_applied {parts_applied}, wal_parts "
                f"{wal['parts']}, applied {applied}; wal_bytes "
                f"{wal['bytes']} vs {seg_bytes} on disk in "
                f"{len(seg_paths)} segments")
        snap_files = sorted(os.listdir(snap_dir))
        snap_bytes = sum(os.path.getsize(os.path.join(snap_dir, f))
                         for f in snap_files)

        t = time.perf_counter()
        info = rt.dump_trace(os.path.join(root, "trace.json"))
        dump_s = time.perf_counter() - t
        json_bytes = os.path.getsize(info["path"])

        # WAL recovery on the card: from genesis, then from the snapshot
        recs, rec_s, replay_launches = {}, {}, {}
        for name, kw in (("genesis", {}),
                         ("snapshot", {"snapshot_dir": snap_dir})):
            with path_run(dev) as rrun:
                t = time.perf_counter()
                rec = recover_to_vc(x0, wal_dir, device="cuda", **kw)
                torch.cuda.synchronize()
                rec_s[name] = time.perf_counter() - t
            replay_launches[name] = rrun["launches"]
            for key, want in masters.items():
                if not np.array_equal(rec["params"][key], want):
                    raise AssertionError(f"durable: {name} recovery's {key} "
                                         f"is not bitwise the final master")
            if not np.array_equal(rec["applied_parts"], applied_by_proc):
                raise AssertionError(
                    f"durable: {name} recovery folded "
                    f"{rec['applied_parts'].tolist()} parts, the shards "
                    f"applied {applied_by_proc.tolist()}")
            if rec["n_replayed"] and rrun["launches"]["ps_apply"] <= 0:
                raise AssertionError(f"durable: {name} replay launched no "
                                     f"ps_apply")
            recs[name] = rec
        gen, snap = recs["genesis"], recs["snapshot"]
        if not (gen["from_snapshot"] is None
                and gen["n_replayed"] == applied
                and snap["from_snapshot"] is not None
                and snap["n_replayed"] < gen["n_replayed"]):
            raise AssertionError(
                f"durable: genesis replayed {gen['n_replayed']} of "
                f"{applied}; the snapshot recovery started from clock "
                f"{snap['from_snapshot']} and replayed {snap['n_replayed']}")
        emit({"phase": "durable", "transport": "shm", "zero_copy": True,
              "vocab": VOCAB, "n_topics": N_TOPICS, "workers": N_WORKERS,
              "client_processes": rt.n_proc, "shards": N_SHARDS,
              "policy": "ssp(1)", "clocks": N_CLOCKS, "reduced": REDUCED,
              "trace": DURABLE_TRACE, "wal_fsync": "boundary",
              "snapshot_every": DURABLE_SNAPSHOT_EVERY,
              "dir_fs": fs_type(root),
              "wall_s": {"start": start_s, "wait": wait_s,
                         "run": start_s + wait_s,
                         "recover_genesis": rec_s["genesis"],
                         "recover_snapshot": rec_s["snapshot"],
                         "dump_trace": dump_s},
              "wire_phase_wall_s": wire_wall_s,
              "device_busy_s": busy_s,
              "device_idle_share": 1.0 - busy_s / wait_s,
              "device_s_by_name": dict(sorted(device_s.items(),
                                              key=lambda kv: -kv[1])[:8]),
              "ps_apply_device_s": ps_apply_seconds(device_s,
                                                    launches["ps_apply"]),
              "launches": launches,
              "replay_launches": {k: v["ps_apply"]
                                  for k, v in replay_launches.items()},
              "parts_sent": sent, "parts_applied": applied,
              "wal": {**wal, "bytes_on_disk": seg_bytes},
              "snapshots": {"files": snap_files, "bytes": snap_bytes,
                            "in_memory": [c for c, _ in rt.snapshots]},
              "recovery": {k: {"from_snapshot": v["from_snapshot"],
                               "n_replayed": v["n_replayed"],
                               "n_deduped": v["n_deduped"],
                               "clock": v["clock"], "bitwise": True}
                           for k, v in recs.items()},
              "trace_events": {trace_mod._NAMES[k]: n
                               for k, n in sorted(counts.items())},
              "trace_dropped": hub.dropped(),
              "trace_json_bytes": json_bytes,
              "trace_reconciles": True, "violations": 0,
              "master_exact": True})
        return launches, replay_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the serving tier: the read mix a reader thread cycles through (every SLO
# over both keys), each read's deadline before it escalates (the reference
# tests' 5 s), the replicas of the main run, and the tcp run's depth
SERVE_SLOS = (0, 1, None, "fresh")
SERVE_KEYS = ("word_topic", "topic")
READ_TIMEOUT_S = 5.0
REPLICAS_MAIN = 2
REPLICAS_TCP_CLOCKS = 2
CATCH_UP_S = 120.0


def _percentiles(xs):
    return ({"p50": float(np.percentile(xs, 50)),
             "p99": float(np.percentile(xs, 99)), "n": len(xs)}
            if xs else None)


def _serve_reads(rt, gw, out, stop):
    """The reader thread: cycle every SLO over both keys while the run is
    live, each read's measured staleness held to its SLO."""
    import itertools

    from repro_torch.runtime import FRESH

    mix = itertools.cycle(itertools.product(SERVE_SLOS, SERVE_KEYS))
    try:
        while rt.running and not stop.is_set():
            slo, key = next(mix)
            slo = FRESH if slo == "fresh" else slo
            res = gw.read(key, slo=slo, timeout=READ_TIMEOUT_S)
            bound = (0 if slo == FRESH
                     else float("inf") if slo is None else slo)
            source = res.source.split(":")[0]
            out["reads"].append((source, str(slo), key, res.staleness,
                                 res.waited_s, res.escalated))
            if res.staleness > bound or res.staleness < 0:
                out["violations"].append(
                    f"{key} slo={slo!r} measured {res.staleness} "
                    f"({res.source})")
            time.sleep(1e-3)              # pace the reader, as the tests do
    except BaseException as e:            # re-raised by the phase
        out["error"] = e


def _join_replica(rt, gw, out, stop):
    """Add one replica once the applied frontier reaches clock 1 (polled
    every 10 ms, so the join is not held up behind a slow read)."""
    try:
        while rt.running and not stop.is_set():
            clock = rt.completed_clock()
            if clock >= 1:
                t = time.perf_counter()
                rep = gw.add_replica()
                out["joined"] = {"rid": rep.rid, "applied_clock": clock,
                                 "add_s": time.perf_counter() - t}
                return
            time.sleep(0.01)
    except BaseException as e:            # re-raised by the phase
        out["error"] = e


def _serving_run(dev, corpus, transport, serving, n_replicas, clocks, join,
                 prof_on):
    """One LDA run with forked clients and a read gateway built after
    start(): the reader thread serves the whole run, then the replicas
    catch up and are held bitwise to the master.  Returns what the phase
    prints and checks."""
    import threading

    from repro_torch.core import policies
    from repro_torch.kernels.ps_apply import ops as apply_ops
    from repro_torch.runtime import ReadGateway

    kw = {"zero_copy": True} if transport == "shm" else {}
    rt, fn = _wire_runtime(dev, corpus, policies.ssp(1), transport, **kw)
    out = {"reads": [], "violations": [], "joined": None, "error": None}
    prof = contextlib.nullcontext()
    with path_run(dev) as run:
        t = time.perf_counter()
        rt.start(fn, clocks, timeout=600)
        t_prof = time.perf_counter()
        before = apply_ops.launches        # launched before the profiler
        if prof_on:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        with prof:
            gw = ReadGateway(rt, n_replicas=n_replicas, transport=serving)
            try:
                stop = threading.Event()
                threads = [threading.Thread(target=_serve_reads,
                                            args=(rt, gw, out, stop),
                                            name="smoke-reader", daemon=True)]
                if join:
                    threads.append(threading.Thread(
                        target=_join_replica, args=(rt, gw, out, stop),
                        name="smoke-join", daemon=True))
                for th in threads:
                    th.start()
                stats = rt.wait()
                t_wait = time.perf_counter()
                stop.set()
                for th in threads:
                    th.join(timeout=120)
                if (any(th.is_alive() for th in threads)
                        or out["error"] is not None):
                    raise AssertionError(f"replicas {serving}: reader "
                                         f"failed: {out['error']!r}")
                rset = gw.replicas
                deadline = time.monotonic() + CATCH_UP_S
                while any(rset.staleness(r.vc, rset.master_vc())
                          for r in rset.replicas):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"replicas {serving}: not "
                                             f"caught up in {CATCH_UP_S} s")
                    time.sleep(0.01)
                torch.cuda.synchronize()
                end = time.perf_counter()
                catch_up_s = end - t_wait
                # at quiesce: every replica's raw buffers bitwise the master
                masters = _check_lda_master(rt, corpus,
                                            f"replicas {serving}")
                for rep in rset.replicas:
                    for key, want in masters.items():
                        buf = rep.values[key]
                        if not (buf.is_cuda and buf.dtype == torch.float64):
                            raise AssertionError(
                                f"replica {rep.rid} {key} is {buf.dtype} on "
                                f"{buf.device}")
                        got, _ = rep.serve(key)
                        if got.reshape(want.shape).tobytes() \
                                != want.tobytes():
                            raise AssertionError(
                                f"replicas {serving}: replica {rep.rid}'s "
                                f"{key} is not bitwise the master")
                # a slo=0 read from every replica equals the master
                final_sources = set()
                for key, want in masters.items():
                    seen = set()
                    for _ in range(4 * len(rset.replicas)):
                        res = gw.read(key, slo=0, timeout=60.0)
                        if res.staleness != 0 or not np.array_equal(
                                res.value, want):
                            raise AssertionError(
                                f"replicas {serving}: slo=0 read of {key} "
                                f"from {res.source} != master")
                        seen.add(res.source)
                        if len(seen) == len(rset.replicas):
                            break
                    final_sources |= seen
                want_sources = {f"replica:{r.rid}" for r in rset.replicas}
                if final_sources != want_sources:
                    raise AssertionError(f"replicas {serving}: slo=0 reads "
                                         f"came from {sorted(final_sources)}")
                m = rt.metrics()
                result = {"rt": rt, "stats": stats, "gw": gw, "run": run,
                       "out": out, "metrics": m,
                       "caught_up_s": end - t, "run_s": t_wait - t,
                       "start_s": t_prof - t, "catch_up_s": catch_up_s,
                       "launches_before_profile": before,
                       "ring_bytes": rset.ring_bytes,
                       "replicas": [{"rid": r.rid,
                                     "deltas": r.deltas_applied,
                                     "bytes_ingested": r.bytes_ingested,
                                     "ingest_calls": r.ingest_applies,
                                     "stale_row_drops": r.stale_row_drops,
                                     "reads": r.reads}
                                    for r in rset.replicas],
                       "pub_drops": rset.pub_drops,
                       "pub_resyncs": rset.pub_resyncs,
                       "errors": list(rset.errors),
                       "violations": list(rset.violations)}
            finally:
                gw.close()
    result["prof"] = prof if prof_on else None
    result["prof_s"] = end - t_prof
    result["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return result


def _read_summary(reads):
    by = collections.Counter(f"{src}|slo={slo}" for src, slo, *_ in reads)
    lat = {}
    for src in sorted({r[0] for r in reads}):
        lat[src] = _percentiles([r[4] * 1e3 for r in reads if r[0] == src])
    return {"n": len(reads), "by_source_and_slo": dict(sorted(by.items())),
            "escalated": sum(1 for r in reads if r[5]),
            "latency_ms_by_source": lat,
            "max_staleness_by_slo": {
                slo: max(r[3] for r in reads if r[1] == slo)
                for slo in sorted({r[1] for r in reads})}}


def run_replicas_phase(dev, corpus, wire_wall_s):
    """The serving tier at full width: the wire phase's run (shm, zero-copy,
    4 forked clients, 2 shards, ssp(1), 3 clocks) with a read gateway of 2
    replicas over the shm serving transport built after start(), a reader
    thread cycling SLOs 0, 1, None and fresh over both keys the whole run,
    and a third replica added once the applied frontier reaches clock 1;
    then tcp serving on a tcp runtime (1 replica, 2 clocks).  Returns the
    main run's launches, its ps_apply calls and the tcp run's launches."""
    from repro_torch.runtime.serving.replica import INGEST_SITE

    # a short profiler run before the fork sets CUPTI up, as in durable
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    main = _serving_run(dev, corpus, "shm", "shm", REPLICAS_MAIN, N_CLOCKS,
                        join=True, prof_on=True)
    tcp = _serving_run(dev, corpus, "tcp", "tcp", 1, REPLICAS_TCP_CLOCKS,
                       join=False, prof_on=False)
    shm = os.statvfs("/dev/shm")
    lines = {}
    for name, r in (("shm", main), ("tcp", tcp)):
        stats, out, launches = r["stats"], r["out"], r["run"]["launches"]
        rt = r["rt"]
        if stats.violations or out["violations"] or r["violations"] \
                or r["errors"]:
            raise AssertionError(
                f"replicas {name}: violations {stats.violations[:3]} "
                f"{out['violations'][:3]} {r['violations'][:3]}, errors "
                f"{r['errors'][:3]}")
        applied = sum(int(s.applied_parts.sum()) for s in rt.shards)
        if applied != int(rt._parts_sent.sum()):
            raise AssertionError(f"replicas {name}: parts sent "
                                 f"{int(rt._parts_sent.sum())} != applied "
                                 f"{applied}")
        # counted where the kernel launches, under replica ingest's site
        ingest = r["run"]["ps_apply_by_site"].get(INGEST_SITE, 0)
        ingest_calls = sum(x["ingest_calls"] for x in r["replicas"])
        if not (0 < ingest <= ingest_calls and launches["ps_apply"] > ingest
                and launches["topk_mag"] == 0):
            raise AssertionError(
                f"replicas {name}: ps_apply launched {launches['ps_apply']} "
                f"times, {ingest} by replica ingest in {ingest_calls} calls; "
                f"topk_mag {launches['topk_mag']}")
        if not out["reads"]:
            raise AssertionError(f"replicas {name}: no read was served")
        line = {"serving": name, "transport": name,
                "n_replicas": len(r["replicas"]),
                "clocks": rt.n_clocks, "vocab": VOCAB, "n_topics": N_TOPICS,
                "workers": N_WORKERS, "client_processes": rt.n_proc,
                "shards": N_SHARDS, "policy": "ssp(1)", "reduced": REDUCED,
                "wall_s": {"run": r["run_s"], "start": r["start_s"],
                           "catch_up": r["catch_up_s"],
                           "caught_up": r["caught_up_s"]},
                "reads": _read_summary(out["reads"]),
                "gateway": {"escalations": r["gw"].stats.n_escalations,
                            "master_reads": r["gw"].stats.n_master_reads,
                            "replica_reads": r["gw"].stats.n_replica_reads,
                            "block_s": r["gw"].stats.block_time},
                "replicas": r["replicas"],
                "bytes_ingested": sum(x["bytes_ingested"]
                                      for x in r["replicas"]),
                "delta_msgs": sum(x["deltas"] for x in r["replicas"]),
                "pub_drops": r["pub_drops"], "pub_resyncs": r["pub_resyncs"],
                "launches": launches,
                "ps_apply_launches": {"total": launches["ps_apply"],
                                      "replica_ingest": ingest,
                                      "replica_ingest_calls": ingest_calls,
                                      "shards": launches["ps_apply"]
                                      - ingest},
                "serving_ring_bytes": r["ring_bytes"],
                "peak_device_bytes": r["peak_device_bytes"],
                "violations": 0, "replicas_bitwise_master": True,
                "slo0_read_from_every_replica": True}
        if out["joined"] is not None:
            line["joined"] = out["joined"]
        lines[name] = line
    # joined mid-run: before the frontier reached the last clock, and fed
    # deltas published after its in-stream bootstrap
    joined = main["out"]["joined"]
    if (joined is None or joined["applied_clock"] >= N_CLOCKS
            or main["replicas"][joined["rid"]]["deltas"] == 0):
        raise AssertionError(f"replicas: the third replica did not join "
                             f"mid-run ({joined})")
    prof = main["prof"]
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())
    launches = main["run"]["launches"]
    in_window = launches["ps_apply"] - main["launches_before_profile"]
    in_profile = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and PS_APPLY_KERNEL.match(_short(e.name)))
    if in_profile != in_window:
        raise AssertionError(f"replicas: {in_profile} ps_apply kernels in "
                             f"the profile, {in_window} launched in its "
                             f"window")
    lines["shm"].update({
        "profiled_s": main["prof_s"], "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / main["prof_s"],
        "device_s_by_name": dict(sorted(device_s.items(),
                                        key=lambda kv: -kv[1])[:8]),
        "h2d_s": sum(v for k, v in device_s.items() if "HtoD" in k),
        "d2h_s": sum(v for k, v in device_s.items() if "DtoH" in k),
        "ps_apply_device_s": ps_apply_seconds(device_s, in_window),
        "ps_apply_kernels_in_profile": in_profile,
        "ps_apply_launched_in_profile": in_window,
        "metrics_replicas": [vars(x) for x in main["metrics"].replicas],
        "dev_shm_bytes": {"total": shm.f_frsize * shm.f_blocks,
                          "avail": shm.f_frsize * shm.f_bavail},
        "wire_phase_wall_s": wire_wall_s})
    emit({"phase": "replicas", **lines["shm"], "tcp": lines["tcp"]})
    calls = [c for c in main["run"]["calls"]["ps_apply"]
             if c[0] in (VOCAB, N_TOPICS)]      # full-key replica buffers
    return (launches, calls, tcp["run"]["launches"],
            lines["shm"]["ps_apply_launches"]["replica_ingest"])


SPMD_STALENESS = 2
# elastic membership: the plan of the main run (an add, then the original
# slot 0 retired), its depth, and the autoscaler run's depth.  The workers'
# last clock waits at most ELASTIC_GATE_S for the ops to install.
ELASTIC_PLAN = [(1, "add", 2), (2, "remove", 0)]
ELASTIC_SLOTS = 3
ELASTIC_CLOCKS = 3
AUTOSCALE_CLOCKS = 2
ELASTIC_GATE_S = 60.0
# the migration's kinds of copy kernel by name: the handoff's clones (a
# device to device copy), the reassembly's index_copy_ (the replica's
# in-stream bootstraps share its kernel), the install's index_select (a
# gather)
MIGRATION_KERNEL = re.compile(r"index_copy|DtoD|gather", re.IGNORECASE)


def _gate_last_clock(rt, fn, want, n_clocks):
    """Wrap ``fn`` so that every worker's last clock waits (at most
    ELASTIC_GATE_S) until ``want`` membership ops installed.  The counter
    is shared memory made before the fork, so the forked clients read it;
    a membership listener bumps it."""
    import multiprocessing

    count = multiprocessing.get_context("fork").Value("i", 0)

    def on_epoch(*args):
        with count.get_lock():
            count.value += 1

    rt.membership.add_listener(on_epoch)

    def gated(w, clock, view, rng):
        if clock == n_clocks - 1:
            deadline = time.monotonic() + ELASTIC_GATE_S
            while count.value < want and time.monotonic() < deadline:
                time.sleep(0.005)
        return fn(w, clock, view, rng)
    return gated


def _migration_ms(dev, rt):
    """The migration's device work re-timed at the run's shapes: the
    handoff clones of two slots' blocks, the reassembly, the install's
    gathers for three slots (an add, 2 -> 3 slots), CUDA events around
    each, median of REPS."""
    from repro_torch.runtime.membership import Partition, assemble_on_device

    old = Partition(0, (0, 1), rt._row_counts)
    new = Partition(1, (0, 1, 2), rt._row_counts)
    shapes = {k: (r, rt._x0[k].shape[1]) for k, r in rt._row_counts.items()}
    blocks = {sid: {k: torch.rand((old.rows_of(k, sid).size, c),
                                  dtype=torch.float64, device=dev)
                    for k, (_, c) in shapes.items()} for sid in (0, 1)}

    def handoff():
        return [{k: (old.rows_of(k, sid), b.clone())
                 for k, b in blocks[sid].items()} for sid in (0, 1)]

    hand = handoff()

    def assemble():
        return assemble_on_device(hand, shapes, dev)

    full = assemble()

    def install():
        return [{k: v.index_select(0, torch.from_numpy(
            new.rows_of(k, sid)).to(dev)) for k, v in full.items()}
            for sid in (0, 1, 2)]

    out = {"handoff_clone": cuda_ms(handoff), "assemble": cuda_ms(assemble),
           "install_gather": cuda_ms(install)}
    out["total"] = sum(out.values())
    del blocks, hand, full
    torch.cuda.empty_cache()
    return out


def run_elastic_phase(dev, corpus, wire_wall_s):
    """Elastic membership at full width: the wire phase's run with 3
    slots, an add and a remove mid-run, a replica served over shm; then
    the autoscaler run.  Returns the main run's launches and its ps_apply
    launches by site, and the autoscaler run's launches."""
    import threading

    from repro_torch.core import policies
    from repro_torch.kernels.ps_apply import ops as apply_ops
    from repro_torch.runtime import (Autoscaler, AutoscalePolicy,
                                     MembershipPlan, ReadGateway)
    from repro_torch.runtime.serving.replica import INGEST_SITE
    from repro_torch.runtime.shard import REPLAY_SITE

    # a short profiler run before the fork sets CUPTI up, as in durable
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    plan = MembershipPlan.parse(ELASTIC_PLAN)
    rt, fn = _wire_runtime(dev, corpus, policies.ssp(1), "shm",
                           zero_copy=True, max_shards=ELASTIC_SLOTS,
                           membership_plan=plan)
    fn = _gate_last_clock(rt, fn, len(ELASTIC_PLAN), ELASTIC_CLOCKS)
    at_install = []

    def note_install(epoch, part, added, removed):
        # launches so far, and every slot's blocks against the partition
        layout = {}
        for s in rt.shards:
            with s.lock:
                layout[s.sid] = [(str(b.device), str(b.dtype),
                                  tuple(b.shape), part.rows_of(k, s.sid).size)
                                 for k, b in s.dense.items()]
        at_install.append({
            "epoch": epoch, "launches": apply_ops.launches,
            "by_site": dict(apply_ops.launches_by_site), "layout": layout,
            "peak": torch.cuda.max_memory_allocated(dev)})

    rt.membership.add_listener(note_install)
    out = {"reads": [], "violations": [], "joined": None, "error": None}
    with path_run(dev) as run:
        t = time.perf_counter()
        rt.start(fn, ELASTIC_CLOCKS, timeout=600)
        t_prof = time.perf_counter()
        before = apply_ops.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gw = ReadGateway(rt, n_replicas=1, transport="shm")
            try:
                stop = threading.Event()
                reader = threading.Thread(target=_serve_reads,
                                          args=(rt, gw, out, stop),
                                          name="smoke-reader", daemon=True)
                reader.start()
                stats = rt.wait()
                t_wait = time.perf_counter()
                stop.set()
                reader.join(timeout=120)
                if reader.is_alive() or out["error"] is not None:
                    raise AssertionError(f"elastic: reader failed: "
                                         f"{out['error']!r}")
                rset = gw.replicas
                deadline = time.monotonic() + CATCH_UP_S
                while any(rset.staleness(r.vc, rset.master_vc())
                          for r in rset.replicas):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"elastic: replica not caught "
                                             f"up in {CATCH_UP_S} s")
                    time.sleep(0.01)
                torch.cuda.synchronize()
                end = time.perf_counter()
                masters = _check_lda_master(rt, corpus, "elastic")
                rep = rset.replicas[0]
                for key, want in masters.items():
                    buf = rep.values[key]
                    got, _ = rep.serve(key)
                    if not (buf.is_cuda and buf.dtype == torch.float64) or \
                            got.reshape(want.shape).tobytes() \
                            != want.tobytes():
                        raise AssertionError(f"elastic: the replica's {key} "
                                             f"is not bitwise the master")
                replica = {"deltas": rep.deltas_applied,
                           "bytes_ingested": rep.bytes_ingested,
                           "ingest_calls": rep.ingest_applies,
                           "stale_row_drops": rep.stale_row_drops,
                           "reads": rep.reads, "errors": list(rset.errors),
                           "violations": list(rset.violations),
                           "pub_drops": rset.pub_drops,
                           "pub_resyncs": rset.pub_resyncs}
            finally:
                gw.close()
    walls = {"run": t_wait - t, "start": t_prof - t,
             "catch_up": end - t_wait, "start_to_caught_up": end - t}
    prof_s = end - t_prof
    peak = torch.cuda.max_memory_allocated(dev)
    launches, by_site = run["launches"], run["ps_apply_by_site"]
    if stats.violations or out["violations"] or replica["errors"] \
            or replica["violations"]:
        raise AssertionError(
            f"elastic: violations {stats.violations[:3]} "
            f"{out['violations'][:3]} {replica['violations'][:3]}, errors "
            f"{replica['errors'][:3]}")
    results = [r for _, r in plan.results]
    if results != ["ok", "ok"] or rt.partition.active != (1, 2) \
            or [e for e, _ in rt.membership.log] != [1, 2]:
        raise AssertionError(f"elastic: plan {results}, active "
                             f"{rt.partition.active}, log "
                             f"{rt.membership.log}")
    applied = sum(int(s.applied_parts.sum()) for s in rt.shards)
    sent = int(rt._parts_sent.sum())
    if applied != sent:
        raise AssertionError(f"elastic: parts sent {sent} != applied "
                             f"{applied}")
    for s in rt.shards:
        for key, block in s.dense.items():
            n = rt.partition.rows_of(key, s.sid).size
            if not (block.is_cuda and block.dtype == torch.float64
                    and tuple(block.shape) == (n, rt._x0[key].shape[1])):
                raise AssertionError(f"elastic: slot {s.sid}'s {key} is "
                                     f"{block.dtype} {tuple(block.shape)} on "
                                     f"{block.device}, owning {n} rows")
    if any(b.shape[0] for b in rt.shards[0].dense.values()):
        raise AssertionError("elastic: the retired slot 0 kept rows")
    for note in at_install:
        for sid, blocks in note["layout"].items():
            if not all(d.startswith("cuda") and dt == "torch.float64"
                       and shape[0] == n for d, dt, shape, n in blocks):
                raise AssertionError(f"elastic: at epoch {note['epoch']}'s "
                                     f"install slot {sid} held {blocks}")
    ingest = by_site.get(INGEST_SITE, 0)
    replay = by_site.get(REPLAY_SITE, 0)
    first = at_install[0]
    shards_after = ((launches["ps_apply"] - ingest)
                    - (first["launches"] - first["by_site"].get(
                        INGEST_SITE, 0)))
    if shards_after <= 0 or ingest <= 0 or launches["topk_mag"] != 0:
        raise AssertionError(f"elastic: ps_apply {launches['ps_apply']} "
                             f"launches, {ingest} by replica ingest, "
                             f"{shards_after} by the shards after the first "
                             f"install; topk_mag {launches['topk_mag']}")
    in_window = launches["ps_apply"] - before
    in_profile = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and PS_APPLY_KERNEL.match(_short(e.name)))
    if in_profile != in_window:
        raise AssertionError(f"elastic: {in_profile} ps_apply kernels in "
                             f"the profile, {in_window} launched in its "
                             f"window")
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())
    migration_s = {k: v for k, v in device_s.items()
                   if MIGRATION_KERNEL.search(k)}
    ct = [0.0] + list(stats.clock_times)
    ops = [{**op, "active": list(op["active"])} for op in rt.membership.ops]
    log = [[e, list(a)] for e, a in rt.membership.log]
    migration_ms = _migration_ms(dev, rt)
    del rt

    # the autoscaler run: one slot of two active, a policy that splits at
    # its first poll (one active shard's imbalance is 1.0) and keeps 2
    arun, afn = _wire_runtime(dev, corpus, policies.ssp(1), "shm",
                              n_shards=1, zero_copy=True, max_shards=2)
    afn = _gate_last_clock(arun, afn, 1, AUTOSCALE_CLOCKS)
    with path_run(dev) as arun_run:
        t = time.perf_counter()
        arun.start(afn, AUTOSCALE_CLOCKS, timeout=600)
        asc = Autoscaler(arun, policy=AutoscalePolicy(
            split_imbalance=1.0, split_min_rows_s=0.0, min_shards=2)).start()
        try:
            astats = arun.wait()
        finally:
            asc.stop()
        auto_wall = time.perf_counter() - t
    actions = [vars(a) for a in asc.actions]
    bad = [a for a in asc.actions if not a.ok and not (
        "running runtime" in (a.error or ""))]
    if astats.violations or bad or asc.summary().get("add_shard", 0) < 1:
        raise AssertionError(f"elastic autoscaler: violations "
                             f"{astats.violations[:3]}, actions {actions}")
    a_applied = sum(int(s.applied_parts.sum()) for s in arun.shards)
    if a_applied != int(arun._parts_sent.sum()):
        raise AssertionError(f"elastic autoscaler: parts sent "
                             f"{int(arun._parts_sent.sum())} != applied "
                             f"{a_applied}")
    _check_lda_master(arun, corpus, "elastic autoscaler")
    auto = {"clocks": AUTOSCALE_CLOCKS, "slots": arun.n_slots,
            "active": list(arun.partition.active), "wall_s": auto_wall,
            "actions": actions, "ops": [{**op, "active": list(op["active"])}
                                        for op in arun.membership.ops],
            "launches": arun_run["launches"],
            "ps_apply_by_site": arun_run["ps_apply_by_site"],
            "violations": 0, "master_exact": True}
    del arun

    emit({"phase": "elastic", "transport": "shm", "zero_copy": True,
          "vocab": VOCAB, "n_topics": N_TOPICS, "workers": N_WORKERS,
          "client_processes": N_WORKERS, "shards": N_SHARDS,
          "max_shards": ELASTIC_SLOTS, "plan": ELASTIC_PLAN,
          "policy": "ssp(1)", "clocks": ELASTIC_CLOCKS, "reduced": REDUCED,
          "plan_results": results, "log": log,
          "ops": ops,
          "migration_device_ms_retimed": migration_ms,
          "migration_device_s_by_name": migration_s,
          "wall_s": walls,
          "clock_s": [b - a for a, b in zip(ct, ct[1:])],
          "wire_phase_wall_s": wire_wall_s,
          "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / prof_s,
          "device_s_by_name": dict(sorted(device_s.items(),
                                          key=lambda kv: -kv[1])[:8]),
          "h2d_s": sum(v for k, v in device_s.items() if "HtoD" in k),
          "d2h_s": sum(v for k, v in device_s.items() if "DtoH" in k),
          "peak_device_bytes": peak,
          "at_install": at_install,
          "launches": launches,
          "ps_apply_launches": {"total": launches["ps_apply"],
                                "shards": launches["ps_apply"] - ingest,
                                "epoch_replay": replay,
                                "replica_ingest": ingest,
                                "shards_after_first_install": shards_after},
          "ps_apply_kernels_in_profile": in_profile,
          "ps_apply_launched_in_profile": in_window,
          "ps_apply_device_s": ps_apply_seconds(device_s, in_window),
          "reads": _read_summary(out["reads"]), "replica": replica,
          "parts_sent": sent, "parts_applied": applied,
          "autoscaler": auto, "violations": 0, "master_exact": True,
          "replica_bitwise_master": True})
    return launches, {"total": launches["ps_apply"],
                      "shards": launches["ps_apply"] - ingest,
                      "epoch_replay": replay, "replica_ingest": ingest}, \
        auto["launches"]


# on this corpus and seed max|δ| over the replicas is 21 after step 0 and 38
# after step 1 (counts, so the same on every run): step 1 syncs by value
SPMD_VALUE_BOUND = 25.0


def run_lda_spmd_phase(dev, corpus):
    from repro_torch.apps import lda
    from repro_torch.core import policies, sync

    pol = policies.cvap(SPMD_STALENESS, SPMD_VALUE_BOUND)
    steps, usum, prev = [], {}, [0]

    def on_step(clock, params, state, update, synced):
        # the clock trigger fires when steps since the last sync reach s + 1
        clock_fired = prev[0] + 1 >= SPMD_STALENESS + 1
        prev[0] = int(state.steps_since_sync.max())
        # in float64, one replica at a time, so no float64 copy of u is made
        for k, u in update.items():
            if k not in usum:
                usum[k] = torch.zeros(u.shape[1:], dtype=torch.float64,
                                      device=u.device)
            for r in range(u.shape[0]):
                usum[k].add_(u[r])
        steps.append({"clock": clock, "synced": synced,
                      "clock_fired": clock_fired,
                      "bound_ok": bool(sync.vap_invariant_ok(pol, state)
                                       .all())})

    sites = Sites(dev)
    make_update_fn = lda._make_update_fn
    sites.patch(lda, "_host_view", "host_view")
    sites.patch(lda, "_stack_update", "update_to_card")
    sites.patch(sync.vap_ops, "vap_accum_tree_", "vap_accum")
    sites.patch(sync, "tree_max_abs", "update_max_abs")
    sites.patch(sync, "tree_l2_norm", "update_l2_norm")
    sites.patch(sync, "_sync", "replica_sum")
    sites.patch(lda._Snapshots, "trajectory", "log_likelihood")
    lda._make_update_fn = lambda *a, **kw: sites.wrap(
        "gibbs_sweep", make_update_fn(*a, **kw))
    t = time.perf_counter()
    try:
        with path_run(dev) as run:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                lls, params, state, x0 = lda.run_lda_spmd(
                    corpus, n_topics=N_TOPICS, n_workers=N_WORKERS,
                    n_clocks=N_CLOCKS, policy=pol, seed=0, device="cuda",
                    return_state=True,
                    on_step=sites.wrap("smoke_checks", on_step))
                torch.cuda.synchronize()
    finally:
        lda._make_update_fn = make_update_fn
        sites.restore()
    wall_s = time.perf_counter() - t
    launches, calls = run["launches"]["vap_accum"], run["calls"]["vap_accum"]
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())
    peak = sites.peak()
    by_site = sites.report(prof)

    leaves = len(params)
    for i, st in enumerate(steps):
        ms = [float(m) for _, m in calls[i * leaves:(i + 1) * leaves]]
        st["max_abs_delta"] = max(ms)
        st["value_fired"] = st["max_abs_delta"] > SPMD_VALUE_BOUND
        st["trigger"] = [name for name in ("clock", "value")
                         if st[f"{name}_fired"]]
    shapes = sorted({shape for shape, _ in calls}, key=lambda s: -np.prod(s))

    params, state = sync.force_sync(params, state, ("data",))
    torch.cuda.synchronize()
    for k, p in params.items():
        want = torch.from_numpy(x0[k]).to(dev) + usum[k]
        for r in range(N_WORKERS):
            if not torch.equal(p[r], p[0]):
                raise AssertionError(f"after force_sync replica {r} of {k} "
                                     f"differs from replica 0")
        if not torch.equal(p[0].double(), want):
            raise AssertionError(f"{k} != x0 + sum(updates)")
    wt, tc = params["word_topic"][0], params["topic"][0]
    if tuple(params["word_topic"].shape) != (N_WORKERS, VOCAB, N_TOPICS) \
            or params["word_topic"].dtype != torch.float32:
        raise AssertionError(f"word_topic replicas are "
                             f"{params['word_topic'].dtype} "
                             f"{tuple(params['word_topic'].shape)}")
    n_counted = float(wt.double().sum())
    if n_counted != corpus.n_tokens or bool((wt < 0).any()):
        raise AssertionError(f"word_topic holds {n_counted} counts for "
                             f"{corpus.n_tokens} tokens")
    if not torch.equal(tc, wt.sum(0)):
        raise AssertionError("topic != word_topic.sum(0)")

    emit({"phase": "lda_spmd", "vocab": VOCAB, "n_topics": N_TOPICS,
          "tokens": corpus.n_tokens, "replicas": N_WORKERS,
          "dtype": "float32", "policy": f"cvap({SPMD_STALENESS}, "
          f"{SPMD_VALUE_BOUND})", "value_bound": SPMD_VALUE_BOUND,
          "clocks": N_CLOCKS, "reduced": REDUCED, "wall_s": wall_s,
          "steps": steps, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s,
          "device_s_by_name": dict(sorted(device_s.items(),
                                          key=lambda kv: -kv[1])[:8]),
          "peak_device_bytes": peak, "by_call_site": by_site,
          "launches": {"vap_accum": launches},
          "vap_accum_shapes": shapes, "log_likelihood": lls})
    if launches != N_CLOCKS * leaves:
        raise AssertionError(f"vap_accum launched {launches} times, not "
                             f"{N_CLOCKS} clocks x {leaves} tables")
    if not all(st["bound_ok"] for st in steps):
        raise AssertionError("a replica broke the VAP bound")
    if all(st["synced"] for st in steps) or not any(
            st["synced"] and st["value_fired"] for st in steps):
        raise AssertionError(f"need a step that did not sync and one the "
                             f"value trigger synced: {steps}")
    if not (np.isfinite(lls).all() and len(lls) == N_CLOCKS
            and lls[-1] > lls[0]):
        raise AssertionError(f"log-likelihood not finite and rising: {lls}")
    return {"vap_accum": launches}, shapes


# MF at the widths of the Netflix Prize data set (Bennett & Lanning, "The
# Netflix Prize", KDD Cup and Workshop 2007: 480,189 users, 17,770 movies,
# 100,480,507 ratings).  The rank is assumed (the data set fixes none; 100
# is the top of the ranks used for it), and the ratings are cut to about 1%.
MF_USERS, MF_ITEMS, MF_RATINGS_FULL = 480_189, 17_770, 100_480_507
MF_RANK, MF_RATINGS, MF_CLOCKS = 100, 1_000_000, 2
# run_mf takes each worker's mean gradient, so the step a rating gets is
# lr / (ratings per worker): these give it the per-rating step and the
# per-clock shrink (lr * reg) of the JAX package's convergence benchmark
# (60 x 40 at density 0.3, 180 ratings a worker, lr 1, reg 1e-3)
MF_LR = MF_RATINGS / N_WORKERS / 180
MF_REG = 1e-3 / MF_LR
MF_REDUCED = {"ratings": f"{MF_RATINGS:,} of {MF_RATINGS_FULL:,} "
                         f"(Netflix Prize)"}
MF_ASSUMED = {"rank": MF_RANK, "ratings": "uniform over users and items, "
              "a rank-100 ground truth plus noise 0.1, as "
              "mf.synthetic_ratings draws them"}


def netflix_shaped_ratings(seed: int) -> np.ndarray:
    """(n, 3) rows of (user, item, rating), drawn as mf.synthetic_ratings
    draws them (a low-rank ground truth plus gaussian noise 0.1) but at the
    observed pairs only: its dense users x items matrix would be 68 GB."""
    rng = np.random.default_rng([seed, 0xDA7A])
    ustar = rng.normal(0.0, 1.0, (MF_USERS, MF_RANK)) / np.sqrt(MF_RANK)
    vstar = rng.normal(0.0, 1.0, (MF_ITEMS, MF_RANK)) / np.sqrt(MF_RANK)
    users = rng.integers(0, MF_USERS, MF_RATINGS)
    items = rng.integers(0, MF_ITEMS, MF_RATINGS)
    rating = np.einsum("nr,nr->n", ustar[users], vstar[items])
    rating += rng.normal(0.0, 0.1, MF_RATINGS)
    return np.column_stack([users, items, rating]).astype(float)


def run_apps_phase(dev):
    """MF on the runtime on the card at the Netflix Prize widths, then
    logistic regression at the JAX package's convergence-benchmark size
    (benchmarks/bench_convergence.py: 400 x 20), whose one 20 x 1 key is a
    correctness and launch check only: no deployment holds so small a table,
    so its calls are not timed."""
    from repro_torch.apps import logreg, mf
    from repro_torch.core import policies

    out, launches = {}, {}
    calls = {"ps_apply": [], "topk_mag": []}
    t = time.perf_counter()
    ratings = netflix_shaped_ratings(seed=0)
    ratings_s = time.perf_counter() - t
    X, y = logreg.synthetic_classification(seed=0)
    # (name, run, kernels it must launch, clocks, calls timed later):
    # logreg has one key, and a flush of one key needs no send order
    legs = (("mf", lambda: mf.run_mf(
                ratings, MF_USERS, MF_ITEMS, MF_RANK, policies.ssp(2),
                N_WORKERS, MF_CLOCKS, lr=MF_LR, reg=MF_REG, seed=0,
                collect_stats=True, device="cuda"),
             ("ps_apply", "topk_mag"), MF_CLOCKS, True),
            ("logreg", lambda: logreg.run_logreg(
                X, y, policies.ssp(2), N_WORKERS, 15, seed=0,
                collect_stats=True, device="cuda"), ("ps_apply",), 15, False))
    for name, leg, needs, clocks, timed in legs:
        t = time.perf_counter()
        with path_run(dev) as run:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                losses, stats = leg()
                torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        device_s = device_seconds(prof)
        busy_s = sum(device_s.values())
        if stats.violations or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: violations {stats.violations[:3]}"
                                 f", loss {losses[0]} -> {losses[-1]}")
        for k in ("ps_apply", "topk_mag"):
            if k in needs and run["launches"][k] <= 0:
                raise AssertionError(f"{name}: {k} never launched")
            if timed:
                calls[k] += run["calls"][k]
            launches[k] = launches.get(k, 0) + run["launches"][k]
        out[name] = {"clocks": clocks, "wall_s": wall_s,
                     "device_busy_s": busy_s,
                     "device_idle_share": 1.0 - busy_s / wall_s,
                     "device_s_by_name": dict(sorted(
                         device_s.items(), key=lambda kv: -kv[1])[:6]),
                     "ps_apply_device_s": ps_apply_seconds(
                         device_s, run["launches"]["ps_apply"]),
                     "loss_per_clock": losses,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                     "launches": run["launches"],
                     "ps_apply_blocks": sorted({c[:2] for c in
                                                run["calls"]["ps_apply"]})}
    emit({"phase": "apps", "policy": "ssp(2)", "workers": N_WORKERS,
          "shards": 2, "mf": {"users": MF_USERS, "items": MF_ITEMS,
                              "rank": MF_RANK, "ratings": MF_RATINGS,
                              "lr": MF_LR, "reg": MF_REG,
                              "ratings_s": ratings_s,
                              "reduced": MF_REDUCED, "assumed": MF_ASSUMED,
                              **out["mf"]},
          "logreg": {"n": 400, "d": 20, "timed": False, **out["logreg"]}})
    return launches, calls


# Serving (examples/serve_demo.py's loop) at the full published widths.
# The assigned prefill shape is prefill_32k (32 x 32,768, configs/shapes.py);
# the smoke cuts it to 16,384 prompt tokens a model (4 requests of 4,096;
# Gemma2-9B 2 of 8,192, so that its 4,096-token window masks on the local
# layers) so that the models and the kernels' checks fit the script's time
# limit.
SERVE_MODELS = ("recurrentgemma-9b", "mamba2-130m", "gemma2-9b",
                "deepseek-v2-lite-16b", "pixtral-12b", "musicgen-medium")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4_096, 16
# (requests, prompt tokens) where a model's differ from the default
SERVE_SHAPE = {"gemma2-9b": (2, 8_192)}
SERVE_WEIGHTS = "random, drawn on the card from the seed"
# one launch per layer of the kernel's kind, per prefill
SERVE_LAUNCHES = {"recurrentgemma-9b": {"rglru_scan": 26,
                                        "flash_attention": 12},
                  "mamba2-130m": {"ssd_scan": 24},
                  "gemma2-9b": {"flash_attention": 42},
                  "deepseek-v2-lite-16b": {"flash_attention": 27},
                  "pixtral-12b": {"flash_attention": 40},
                  "musicgen-medium": {"flash_attention": 48}}
# flash_attention's prefill launches by window: Gemma2's 21 local (4,096)
# and 21 global layers
SERVE_FLASH_BY_WINDOW = {"recurrentgemma-9b": {2048: 12},
                         "gemma2-9b": {4096: 21, None: 21},
                         "deepseek-v2-lite-16b": {None: 27},
                         "pixtral-12b": {None: 40},
                         "musicgen-medium": {None: 48}}
# bfloat16 decode against the full forward: the two paths round at other
# places (cuBLAS picks other kernels for 1 and 4,097 rows; decode reads the
# bfloat16 KV cache), and a few bfloat16 ulps carry through 24-48 layers
PARITY_TOL = 5e-2
# the decode-parity check's MoE capacity factor (test_decode_parity.py's),
# so that the full forward's 16,388 tokens drop no pair where decode's four
# would not
PARITY_CAPACITY_FACTOR = 8.0


def serve_shape(name):
    return SERVE_SHAPE.get(name, (SERVE_BATCH, SERVE_PROMPT))


def serve_reduced(name):
    b, s = serve_shape(name)
    return {"shape": f"{b} requests x {s:,} prompt tokens of the assigned "
                     f"prefill_32k (32 x 32,768)",
            "weights": SERVE_WEIGHTS}


def frontend_embeddings(cfg, rng, rows, dev):
    """A request batch's stubbed frontend embeddings (rows, n_embeds,
    d_model), normal(0, 0.02) from ``rng`` in the compute dtype on ``dev``,
    as {"extra_emb": ...}; {} for a model without a frontend."""
    if cfg.frontend is None:
        return {}
    e = rng.normal(0, 0.02, (rows, cfg.frontend.n_embeds, cfg.d_model))
    return {"extra_emb": torch.from_numpy(e).to(dev, getattr(torch,
                                                            cfg.dtype))}


@contextlib.contextmanager
def moe_routes():
    """Inside the block, every MoE layer's routing as ``moe.dispatch``
    returns it to the layer is noted (``routes``: one dict a call, device
    tensors: ``ids`` (T, K) the chosen experts, ``keep`` (T, K) whether
    each pair got a slot, ``gap`` (T,) the K-th largest probability less
    the next one; ``recompute`` whether the call ran inside the backward,
    where remat recomputes a unit)."""
    from repro_torch.models import moe

    orig, routes = moe.dispatch, []

    def dispatch(m, probs):
        out = orig(m, probs)
        top = torch.sort(probs, dim=-1, descending=True, stable=True).values
        routes.append({"ids": out[1].view(-1, m.top_k),
                       "keep": out[2].view(-1, m.top_k),
                       "gap": top[:, m.top_k - 1] - top[:, m.top_k],
                       "recompute":
                           torch._C._current_graph_task_id() != -1})
        return out

    moe.dispatch = dispatch
    try:
        yield routes
    finally:
        moe.dispatch = orig


@contextlib.contextmanager
def forced_routes(ids):
    """Inside the block, the i-th MoE call routes each token to the experts
    that ``ids[i]`` (T, K) names, in that order, weighted by its own router
    probabilities (renormalised as ever), under a capacity that keeps every
    pair."""
    from repro_torch.models import moe

    orig_route, orig_capacity, calls = moe.route, moe.capacity, iter(ids)

    def route(probs, k):
        forced = next(calls).to(probs.device)
        return torch.gather(probs, 1, forced), forced

    moe.route = route
    moe.capacity = lambda m, tokens: tokens * m.top_k
    try:
        yield
    finally:
        moe.route, moe.capacity = orig_route, orig_capacity


def route_agreement(dec, full, rows, at):
    """Compare decode's routes (one MoE call a layer, T = rows) with the
    full forward's at token ``at`` of each row.  Returns (rows whose every
    layer chose and kept the same experts, the flips, the drop
    differences)."""
    flips, drops, held = [], [], set(range(rows))
    for layer, (d, f) in enumerate(zip(dec, full)):
        f_ids = f["ids"].view(rows, -1, f["ids"].shape[-1])[:, at].cpu()
        f_keep = f["keep"].view(rows, -1, f["keep"].shape[-1])[:, at].cpu()
        f_gap = f["gap"].view(rows, -1)[:, at].cpu()
        d_ids, d_keep, d_gap = (d[k].cpu() for k in ("ids", "keep", "gap"))
        for r in range(rows):
            chose = (sorted(d_ids[r].tolist()), sorted(f_ids[r].tolist()))
            kept = (sorted(d_ids[r][d_keep[r]].tolist()),
                    sorted(f_ids[r][f_keep[r]].tolist()))
            if chose[0] != chose[1]:
                flips.append({"layer": layer, "row": r, "decode": chose[0],
                              "full_forward": chose[1],
                              "gap_decode": float(d_gap[r]),
                              "gap_full_forward": float(f_gap[r])})
                held.discard(r)
            elif kept[0] != kept[1]:
                drops.append({"layer": layer, "row": r,
                              "kept_decode": kept[0],
                              "kept_full_forward": kept[1]})
                held.discard(r)
    return sorted(held), flips, drops


def decode_parity(name, cfg, params, prompts, capacity, dev,
                  extra_emb=None):
    """The first decode step's logits against a full forward over the
    prompt and that token, within PARITY_TOL of the full forward's largest
    logit; a frontend's ``extra_emb`` goes to the prefill and the full
    forward alike.  Every MoE layer's routes are compared between the two paths
    (:func:`route_agreement`).  Where a request's routes differ in some
    layer (a near-tie flipped by bfloat16 rounding), decode runs again from
    the same caches (it rewrites the one slot it wrote) with the full
    forward's routes forced at every MoE layer (:func:`forced_routes`), and
    every request whose routes then agree is held; the check fails if none
    is.  Returns the logits, the held rows, the parity and the routes'
    differences before and after the replay."""
    from repro_torch.models import model as M
    from repro_torch.models.common import ShardCtx

    ctx = ShardCtx()
    batch, prompt = prompts.shape
    pos = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
    with torch.inference_mode(), moe_routes() as routes:
        logits_p, caches = M.prefill(cfg, ctx, params, prompts,
                                     capacity=capacity, extra_emb=extra_emb)
        tok0 = M.sample_greedy(ctx, logits_p)
        routes.clear()
        logits_d, _ = M.decode_step(cfg, ctx, params, tok0[:, None].long(),
                                    pos, caches)
        n_dec = len(routes)
        x, _, _ = M.forward(cfg, ctx, params,
                            torch.cat([prompts, tok0[:, None].long()], 1),
                            extra_emb=extra_emb)
        logits_f = M.logits_of(cfg, params, x[:, prompt])
        del x
        full = routes[n_dec:]
        held, flips, drop_diffs = route_agreement(routes[:n_dec], full,
                                                  batch, prompt)
        alike, replay = held, None
        if len(held) < batch:
            del routes[:]
            with forced_routes([f["ids"].view(batch, -1, f["ids"].shape[-1])
                                [:, prompt] for f in full]):
                logits_d, _ = M.decode_step(cfg, ctx, params,
                                            tok0[:, None].long(), pos, caches)
            held, flips_after, drops_after = route_agreement(
                routes[:n_dec], full, batch, prompt)
            replay = {"rows_held": held, "route_flips": len(flips_after),
                      "drop_differences": drops_after}
        del caches, full
    if not held:
        raise AssertionError(f"{name}: every request's routes differ "
                             f"between decode and the full forward: "
                             f"{flips} {drop_diffs} {replay}")
    rows = torch.tensor(held, device=dev)
    scale = float(logits_f[rows].abs().max())
    parity = float((logits_d[rows] - logits_f[rows]).abs().max()) / scale
    return {"logits_p": logits_p, "logits_d": logits_d,
            "logits_f": logits_f, "tok0": tok0, "held": held,
            "parity": parity, "scale": scale, "flips": flips,
            "drop_differences": drop_diffs, "rows_routed_alike": alike,
            "forced_replay": replay}


# the flash kernel's serve calls held against its plain version, by (model,
# window): the first call of each window in each model's prefill
FLASH_PATH_CALLS = (("recurrentgemma-9b", 2048), ("gemma2-9b", 4096),
                    ("gemma2-9b", None), ("deepseek-v2-lite-16b", None),
                    ("pixtral-12b", None), ("musicgen-medium", None))


def run_serve_phase(dev, seed):
    """Prefill then greedy decode for each model, weights and prompts drawn
    from ``seed``; returns ({model: launches}, {(model, kernel, dtype,
    window): the first call's inputs, on the host}, lines)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves

    lines, launches, first = {}, {}, {}
    for name in SERVE_MODELS:
        cfg = get_config(name)                      # dtype bfloat16
        batch, prompt = serve_shape(name)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params = M.init_params(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        # the model's parameters: the loaded tree without head_f32, the
        # float32 master copy of the head kept for the prefill's float32
        # logits; param_bytes is the tree's memory on the card, head
        # included
        head = params.get("head_f32")
        head_f32_bytes = (0 if head is None
                          else head.numel() * head.element_size())
        n_params = sum(x.numel() for x in tree_leaves(params)) \
            - (0 if head is None else head.numel())
        param_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(params))
        shape = InputShape("serve", seq_len=prompt + SERVE_GEN,
                           global_batch=batch, mode="prefill")
        prefill_fn = steps.make_prefill_step(cfg, None, shape)
        serve_fn = steps.make_serve_step(cfg, None, shape)
        rng = np.random.default_rng(seed)
        prompts = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (batch, prompt))).to(dev)
        extra = frontend_embeddings(cfg, rng, batch, dev)

        def decode(nxt, caches, n_steps):
            toks = [nxt]
            for j in range(n_steps):
                pos = torch.full((batch,), prompt + j, dtype=torch.int32,
                                 device=dev)
                nxt, caches = serve_fn(params, caches,
                                       {"ids": nxt[:, None], "pos": pos})
                toks.append(nxt)
            return torch.stack(toks, 1), caches

        # warm-up: cuBLAS handles and every torch kernel once, short prompt
        nxt, caches = prefill_fn(params, {"ids": prompts[:, :256], **extra})
        decode(nxt, caches, 1)
        del nxt, caches

        with path_run(dev, key=window_key) as run:
            t = time.perf_counter()
            nxt, caches = prefill_fn(params, {"ids": prompts, **extra})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            after_prefill = {k: m.launches for k, m in run["mods"].items()}
            rglru_by_entry = dict(run["mods"]["rglru_scan"].launches_by_entry)
            flash_by_window = {w: n for (k, _, w), n in run["by_key"].items()
                               if k == "flash_attention"}
            t = time.perf_counter()
            tokens, caches = decode(nxt, caches, SERVE_GEN - 1)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev)
        total = run["launches"]
        in_decode = {k: total[k] - after_prefill[k] for k in KERNELS}
        calls_by_dtype = {k: dict(collections.Counter(d for d, _ in c))
                          for k, c in run["calls"].items() if c}
        del caches, run
        tokens = tokens.cpu()

        # a profiled repeat: prefill and 4 decode steps; it keeps the LLM
        # kernels' first call under each (kernel, dtype, window) for the
        # kernels phase (held here, so that the timed run's peak memory does
        # not count them; rglru_scan's and flash_attention's on the host, so
        # that the next model's timed peak holds only what it held before:
        # their inputs are packed, and come back with the same layout)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with path_run(dev, keep_first=True, key=window_key) as rep, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            nxt2, caches = prefill_fn(params, {"ids": prompts, **extra})
            decode(nxt2, caches, 4)
            torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t
        for k, (args, kw) in rep["first"].items():
            if k[0] in ("rglru_scan", "flash_attention"):
                args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in args)
            first[(name,) + k] = (args, kw)
        del caches, rep
        device_s = device_seconds(prof)
        busy_s = sum(device_s.values())
        ssd_s = (ssd_scan_seconds(device_s, after_prefill["ssd_scan"])
                 if after_prefill["ssd_scan"] else None)
        rglru_s = rglru_scan_seconds(device_s, after_prefill["rglru_scan"])
        flash_s = sum(v for k, v in device_s.items()
                      if FLASH_FWD_KERNELS.search(k))
        if after_prefill["flash_attention"] and not flash_s:
            raise AssertionError(f"{name}: flash_attention launched but no "
                                 f"device event matched its kernel's name")

        moe_line, nxt3 = None, None
        if cfg.moe is not None:
            # the MoE's drops at the published capacity factor: a prefill and
            # 4 decode steps again with every layer's routes noted
            with moe_routes() as routes:
                nxt3, caches = prefill_fn(params, {"ids": prompts, **extra})
                n_pre = len(routes)
                decode(nxt3, caches, 4)
            drops = [int((~r["keep"]).sum()) for r in routes]
            pairs = [r["keep"].numel() for r in routes]
            moe_line = {
                "capacity_factor": cfg.moe.capacity_factor,
                "capacity_prefill": moe.capacity(cfg.moe, batch * prompt),
                "capacity_decode": moe.capacity(cfg.moe, batch),
                "layers": n_pre,
                "dropped_pairs_prefill": sum(drops[:n_pre]),
                "pairs_prefill": sum(pairs[:n_pre]),
                "dropped_pairs_decode_4_steps": sum(drops[n_pre:]),
                "pairs_decode_4_steps": sum(pairs[n_pre:])}
            del caches, routes

        # the first decode step against a full forward over prompt + token;
        # MoE at PARITY_CAPACITY_FACTOR, every layer's routes compared
        pcfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=PARITY_CAPACITY_FACTOR))
        par = decode_parity(name, pcfg, params, prompts, shape.seq_len, dev,
                            extra.get("extra_emb"))
        logits_p, logits_d, logits_f, tok0 = (par.pop(k) for k in (
            "logits_p", "logits_d", "logits_f", "tok0"))
        held, parity, scale = par["held"], par["parity"], par["scale"]
        finite = bool(torch.isfinite(logits_p).all()
                      and torch.isfinite(logits_d).all()
                      and torch.isfinite(logits_f).all())
        in_vocab = bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
        # the first token again, at the serve path's own capacity factor
        same_first = bool(torch.equal(
            (tok0 if nxt3 is None else nxt3).cpu(), tokens[:, 0]))
        n_decode = SERVE_GEN - 1
        lines[name] = {
            "params": n_params, "param_bytes": param_bytes,
            "head_f32_bytes": head_f32_bytes,
            "dtype": cfg.dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "batch": batch, "prompt": prompt,
            "generated": SERVE_GEN, "capacity": shape.seq_len,
            "reduced": serve_reduced(name), "init_s": init_s,
            **({"frontend": {
                "kind": cfg.frontend.kind,
                "n_embeds": cfg.frontend.n_embeds,
                "embeddings": "stubbed: normal(0, 0.02) from the seed, "
                              "replacing the first n_embeds positions"}}
               if cfg.frontend is not None else {}),
            "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": batch * prompt / prefill_s,
            "decode_ms_per_step": decode_s * 1e3 / n_decode,
            "decode_tokens_per_s": batch * n_decode / decode_s,
            "peak_device_bytes": peak,
            "launches_prefill": {k: after_prefill[k] for k in KERNELS
                                 if after_prefill[k]},
            "launches_decode": {k: v for k, v in in_decode.items() if v},
            "flash_attention_launches_prefill_by_window": {
                str(w): n for w, n in flash_by_window.items()},
            "rglru_scan_launches_prefill_by_entry": rglru_by_entry,
            "calls_by_dtype": calls_by_dtype,
            **({"moe": moe_line} if moe_line else {}),
            "profiled": {"what": "prefill + 4 decode steps",
                         "wall_s": prof_wall_s, "device_busy_s": busy_s,
                         "device_idle_share": 1.0 - busy_s / prof_wall_s,
                         "device_s_by_name": dict(sorted(
                             device_s.items(), key=lambda kv: -kv[1])[:20]),
                         "elementwise_device_s": sum(
                             v for k, v in device_s.items()
                             if ELEMENTWISE.search(k)),
                         "flash_attention_device_s": flash_s,
                         "rglru_scan_device_s": rglru_s,
                         **({"ssd_scan_device_s": ssd_s,
                             "ssd_scan_share_of_busy": ssd_s["total"]
                             / busy_s} if ssd_s else {})},
            "parity_max_rel_err": parity, "parity_tolerance": PARITY_TOL,
            "parity_rows_held": held,
            **({"parity_capacity_factor": PARITY_CAPACITY_FACTOR,
                "parity_route_flips": par["flips"],
                "parity_route_drop_differences": par["drop_differences"],
                "parity_rows_routed_alike": par["rows_routed_alike"],
                "parity_forced_replay": par["forced_replay"]}
               if cfg.moe is not None else {}),
            "logits_max_abs": scale, "finite": finite,
            "tokens_in_vocab": in_vocab,
            "first_token_repeats": same_first,
            "tokens_head": tokens[:2, :8].tolist()}
        del params, prompts, extra, logits_p, logits_d, logits_f
        emit({"phase": "serve", "model": name, **lines[name]})
        want = SERVE_LAUNCHES[name]
        got = {k: after_prefill[k] for k in KERNELS if after_prefill[k]}
        if got != want:
            raise AssertionError(f"{name}: prefill launched {got}, not {want}")
        if flash_by_window != SERVE_FLASH_BY_WINDOW.get(name, {}):
            raise AssertionError(f"{name}: flash_attention's prefill launches "
                                 f"by window {flash_by_window}, not "
                                 f"{SERVE_FLASH_BY_WINDOW.get(name)}")
        if any(in_decode.values()):
            raise AssertionError(f"{name}: decode launched {in_decode}")
        if sum(rglru_by_entry.values()) != after_prefill["rglru_scan"]:
            raise AssertionError(f"{name}: rglru_scan's launches by entry "
                                 f"{rglru_by_entry} do not sum to "
                                 f"{after_prefill['rglru_scan']}")
        if not (finite and in_vocab):
            raise AssertionError(f"{name}: finite {finite}, tokens in the "
                                 f"vocabulary {in_vocab}")
        if not parity <= PARITY_TOL:
            raise AssertionError(f"{name}: decode vs full forward {parity} "
                                 f"of max|logit| > {PARITY_TOL}")
        launches[name] = total
    torch.cuda.empty_cache()
    return launches, first, lines


# ---------------------------------------------------------------------------
# train: Mamba2-130M at full width, replicas stacked on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mamba2-130m"
TRAIN_SEQ = 4_096                 # train_4k's sequence length
TRAIN_REPLICAS, TRAIN_ROWS = 2, 4  # sequences a replica a step
TRAIN_STEPS = 6
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
TRAIN_STALENESS = 2
# Adam moves an entry by about lr_t a step (5e-4, then 1e-3 after the
# warm-up), so max |δ| grows by about 1e-3 a step between syncs: the bound
# lies between two steps' growth (1.5e-3 from the start, 2e-3 later) and
# three's, so the clock is due first at the third step and the value
# trigger alone fires at the second step after a sync
TRAIN_VALUE_BOUND = 1.8e-3
TRAIN_REDUCED = {"global_batch": f"{TRAIN_REPLICAS} replicas x {TRAIN_ROWS} "
                                 f"sequences = {TRAIN_REPLICAS * TRAIN_ROWS} "
                                 f"of train_4k's 256",
                 "steps": f"{TRAIN_STEPS}"}
# the backwards against their plain versions on the card, per output:
# rglru_scan's is the plain version's arithmetic op for op on the card (dx,
# dr, di the same bits), dΛ sums (b, l) in another order: 1e-4 max|plain| +
# 1e-3 |plain|, plus 2^-6 |plain| where the output is bfloat16 (both
# rounded to bfloat16).  flash_attention's float32 entry: the same; its
# bfloat16 entry reads D = rowsum(dO O) from the forward's bfloat16 output
# (2^-9 relative), which the float32 plain version does not round, and the
# output is rounded to bfloat16: 1e-2 max|plain| + 2^-6 |plain| (the least
# absolute factor that passed was at most 3.3e-3 on an H100 at its stress
# cases and 1.6e-3 at the train call; each case prints its own).
BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-4, 1e-3 + 2**-6)}
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-2, 2**-6)}


def _bwd_close(got, want, tol):
    """(ok, max abs err, the least absolute factor that would pass) of a
    backward's outputs against the plain version's: |got - want| <= a
    max|want| + r |want| per output, (a, r) = tol[dtype]."""
    ok, err, need = True, 0.0, 0.0
    for g, w in zip(got, want):
        if w is None:
            ok &= g is None
            continue
        a, r = tol[g.dtype]
        g32, w32 = g.float(), w.float()
        d = (g32 - w32).abs()
        top = float(w32.abs().max())
        ok &= bool((d <= a * top + r * w32.abs()).all()) and g.dtype == w.dtype
        err = max(err, float(d.max()))
        if top > 0:
            need = max(need, float((d - r * w32.abs()).max()) / top)
    return ok, err, need


def _same_bits(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


SSD_BWD_ENTRY = {
    torch.bfloat16: "wgmma, float32 operands split into bf16 hi + lo: both "
                    "chunk masses, the state passes (8 chunks in flight), "
                    "64-step tiles per (side, tile, chunk, group) walking "
                    "the group's heads (C B^T once, dB / dC summed on chip, "
                    "TMA), dt, dA (five launches)",
    torch.float32: "float32 pipes: chunk masses, state passes, 32-row "
                   "tiles, dt, group sums, dA (six launches)"}
SSD_BWD_KERNEL = re.compile(r"bwd_(mass_bf16|pass_bf16|chunk_bf16|"
                            r"chunk_state|state_pass|chunk|dt|group_sum|dA)"
                            r"_kernel")
TRAIN_STEP_RTOL, TRAIN_STEP_ATOL = 2e-4, 2e-5


def check_ssd_bwd(dev, x, dt, A, B, C, chunk, initial_state, dy, dfinal):
    """The backward kernel against its plain version on the card; times
    both.  A bfloat16 case carries the bfloat16 kernels' registers, spills,
    shared memory and blocks a multiprocessor.  The bound counts the
    products the function needs once, at the bf16 tensor-core rate, as the
    forward's row counts its own: over the
    pairs s <= t of each chunk's real steps, C B^T, dC and dB once per
    (batch, group) (the heads' dy xdt^T masks summed first) and dy xdt^T
    and dxdt once per (batch, head); per step and head the four state
    products (the backward mass, dC's, dxdt's and dB's terms; d a reuses
    S_in^T dy).  The chunk-entry states are taken as given: recomputing
    them, or reading them saved, costs more, so this stays a lower bound.
    The bytes are x, dy, dx, B, C, dB, dC, dt, ddt, A, dA and the states
    given or returned, each once."""
    from repro_torch.kernels.ssd_scan import ops, ref

    args = (x, dt, A, B, C, chunk, initial_state, dy, dfinal)
    got = ops.ssd_scan_bwd(*args)
    want = ref.ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    ok, err, _ = _bwd_close(got, want, BWD_TOL)
    if not ok:
        raise AssertionError(f"ssd_scan_bwd {tuple(x.shape)} {x.dtype}: "
                             f"kernel != plain (max abs err {err})")
    same = _same_bits(got, ops.ssd_scan_bwd(*args))
    if not same:
        raise AssertionError(f"ssd_scan_bwd {tuple(x.shape)} {x.dtype}: two "
                             f"calls differ in bits")
    del want
    big = x.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.ssd_scan_bwd(*args), reps=10 if big else REPS)
    plain_ms = cuda_ms(lambda: ref.ssd_scan_bwd(*args), reps=3, warmup=1)
    extra = {}
    if x.dtype == torch.bfloat16:
        extra["kernel_attrs"] = ops.bwd_bf16_attrs(dev)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    cs = min(chunk, l)
    # the pairs s <= t within each chunk (the last one may be short)
    tri = sum(c * (c + 1) // 2
              for c in (min(cs, l - k) for k in range(0, l, cs)))
    fma = b * (g * 3 * n * tri + h * (2 * p * tri + 4 * p * n * l))
    esize = x.element_size()
    nbytes = (3 * x.numel() + 4 * B.numel()) * esize \
        + 4 * (2 * dt.numel() + 2 * A.numel()) \
        + sum(4 * t.numel() for t in (initial_state, dfinal, got[5])
              if t is not None)
    flops = 2 * fma
    bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
    return {"shape": f"x {'x'.join(map(str, x.shape))} B/C "
                     f"{'x'.join(map(str, B.shape))} {_dname(x.dtype)} chunk "
                     f"{chunk}" + (" initial state" if initial_state
                                   is not None else "")
                     + (" dfinal" if dfinal is not None else "")
                     + ("" if x.is_contiguous() else " column slices"),
            "entry": SSD_BWD_ENTRY[x.dtype], "tflops": flops / ms / 1e9,
            "bound_share": bound_ms / ms, "max_abs_err": err,
            "tolerance": "1e-4 max|plain| + 1e-3 |plain| (+ 2^-6 |plain| "
                         "for a bfloat16 output)",
            "same_bits_twice": same, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            **extra}


def ssd_bwd_stress_cases(dev):
    """Padding, g > 1 (up to 12 heads a group), an initial state and
    dfinal, column slices, l a multiple of neither the 64-step tile nor the
    chunk, partial tiles (p 32, n 64), in both dtypes."""
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, h, gr, p, n, chunk, init, dfin in (
                (2, 37, 4, 1, 8, 6, 8, False, True),
                (1, 300, 4, 2, 64, 128, 256, True, True),
                (2, 100, 6, 3, 16, 32, 32, True, False),
                (1, 5, 2, 1, 3, 4, 16, False, True),
                (1, 300, 24, 2, 64, 128, 256, True, True),
                (1, 1000, 4, 1, 64, 128, 256, False, True),
                (2, 200, 4, 1, 32, 64, 128, True, False)):
            xbc = randn(b, l, h * p + 2 * gr * n).to(dtype)
            x = xbc[..., :h * p].reshape(b, l, h, p)
            B = xbc[..., h * p:h * p + gr * n].reshape(b, l, gr, n)
            C = xbc[..., h * p + gr * n:].reshape(b, l, gr, n)
            dt = torch.nn.functional.softplus(randn(b, l, h) - 1.0)
            A = -torch.exp(randn(h) * 0.5)
            out.append(check_ssd_bwd(
                dev, x, dt, A, B, C, chunk,
                randn(b, h, p, n) if init else None,
                randn(b, l, h, p).to(dtype),
                randn(b, h, p, n) if dfin else None))
    return out


def train_step_card_vs_cpu(dev, seed, arch=TRAIN_ARCH):
    """Two reduced float32 steps of ``arch`` (SGD, cvap) on the card against
    the same steps on the CPU, from one state and batch: on the card the
    float32 entries of its kernels and of their backwards, on the CPU the
    plain versions.  The value bound is out of reach and the staleness 1,
    so step 1 does not sync and leaves δ = -lr g on each replica, the
    step's gradient itself: it is held at the gradients' tolerance.  Step 2
    syncs on the clock, and the params after it are held at the params'
    tolerance."""
    from repro_torch.configs import ConsistencySpec, TrainConfig, \
        reduced_config
    from repro_torch.launch import steps
    from repro_torch.launch.state import init_train_state, map_state
    from repro_torch.models.common import tree_paths

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    tcfg = TrainConfig(arch=arch, optimizer="sgd", lr=1e-2,
                       warmup_steps=0, consistency=ConsistencySpec(
                           model="cvap", staleness=1, value_bound=1e3))
    cpu = init_train_state(cfg, tcfg, tp=1, dp=2, seed=seed, device="cpu")
    # the same state on the card; the step and the clocks stay on the host
    host = {id(t) for t in (cpu.step, cpu.opt.count,
                            cpu.sync.steps_since_sync, cpu.sync.sync_count)}
    card = map_state(lambda t: t if id(t) in host else t.to(dev, copy=True),
                     cpu)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"ids": ids[:, :-1], "labels": ids[:, 1:],
             **frontend_embeddings(cfg, rng, 4, "cpu")}
    step = steps.make_train_step(cfg, tcfg)

    def gap(got, want):
        """(max |got - want|, max excess over the tolerance)."""
        d = (got.cpu() - want).abs()
        return float(d.max()), float((d - TRAIN_STEP_ATOL - TRAIN_STEP_RTOL
                                      * want.abs()).max())

    out, ok = {"loss_rel_err": [], "synced": []}, True
    for i in (1, 2):
        cpu, m_cpu = step(cpu, batch)
        card, m_card = step(card, batch)
        torch.cuda.synchronize()
        out["loss_rel_err"].append(
            abs(float(m_card["loss"]) - float(m_cpu["loss"]))
            / abs(float(m_cpu["loss"])))
        out["synced"].append([float(m_card["synced"]),
                              float(m_cpu["synced"])])
        if i == 1:
            # the gradients, as -δ / lr on both sides
            lr = float(m_cpu["lr"])
            gaps = [gap(-card.sync.delta[n] / lr, -want / lr)
                    for n, want in cpu.sync.delta.items()]
            out["grad_max_abs_err"] = max(g for g, _ in gaps)
            out["grad_max_abs"] = max(float(w.abs().max()) / lr
                                      for w in cpu.sync.delta.values())
        else:
            gaps = [gap(tree_paths(card.params)[n], want)
                    for n, want in tree_paths(cpu.params).items()]
            out["params_max_abs_err"] = max(g for g, _ in gaps)
        ok &= max(e for _, e in gaps) <= 0.0
    ok &= max(out["loss_rel_err"]) <= 1e-5 \
        and out["synced"] == [[0.0, 0.0], [1.0, 1.0]]
    return {"config": f"{cfg.name} float32, 2 replicas x 2 x 64 tokens, "
                      f"sgd lr 1e-2, cvap(1, 1e3), 2 steps",
            **out, "ok": ok,
            "tolerance": f"loss rtol 1e-5; step 1's gradients (-δ / lr) "
                         f"and step 2's params rtol {TRAIN_STEP_RTOL}, atol "
                         f"{TRAIN_STEP_ATOL}; synced [0, 1] on both"}


def _train_steps(state, step_fn, it, n_steps, run, policy, counters=None,
                 value_bound=TRAIN_VALUE_BOUND):
    """``n_steps`` steps of ``step_fn`` on batches from ``it`` inside the
    path_run ``run``.  Returns (state, {"walls", "waits" (the host's wait
    on the data), "losses", "synced", "triggers" (which of clock and value
    was due: TRAIN_STALENESS, and the step's max|δ| from vap_accum against
    ``value_bound``), "gmax" (that max), "invariant" (the VAP invariant
    after the step), "launches" (with ``counters``, a function returning
    launch counts: each step's)} of lists)."""
    from repro_torch.core.sync import vap_invariant_ok

    hist = {k: [] for k in ("walls", "waits", "losses", "synced", "triggers",
                            "gmax", "invariant", "launches")}
    for _ in range(n_steps):
        t = time.perf_counter()
        batch = next(it)
        t_data = time.perf_counter()
        since = int(state.sync.steps_since_sync[0])
        n_vap = len(run["calls"]["vap_accum"])
        before = counters() if counters else {}
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        after = counters() if counters else {}
        hist["launches"].append({k: after[k] - before[k] for k in after})
        hist["waits"].append(t_data - t)
        hist["walls"].append(t_end - t)
        hist["losses"].append(float(metrics["loss"]))
        hist["synced"].append(bool(metrics["synced"]))
        step_max = max(float(m) for _, m in run["calls"]["vap_accum"][n_vap:])
        hist["gmax"].append(step_max)
        hist["triggers"].append(
            (["clock"] if since + 1 >= TRAIN_STALENESS + 1 else [])
            + (["value"] if step_max > value_bound else []))
        hist["invariant"].append(bool(vap_invariant_ok(policy,
                                                       state.sync).all()))
    return state, hist


def run_train_phase(dev, seed, smi):
    """Mamba2-130M at full width and depth, trained on the card over
    TRAIN_REPLICAS replicas stacked there, each on TRAIN_ROWS sequences of
    TRAIN_SEQ SyntheticLM tokens a step; Adam, cvap.  Returns (launches,
    the backward's first call, lines)."""
    from repro_torch.configs import ConsistencySpec, TrainConfig, get_config
    from repro_torch.core import policies
    from repro_torch.data import SyntheticLM, batches
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import steps
    from repro_torch.launch.state import init_train_state
    from repro_torch.models.common import tree_leaves

    cfg = get_config(TRAIN_ARCH)                         # bfloat16 compute
    tcfg = TrainConfig(arch=TRAIN_ARCH, optimizer="adam", lr=TRAIN_LR,
                       warmup_steps=TRAIN_WARMUP, seed=seed,
                       consistency=ConsistencySpec(
                           model="cvap", staleness=TRAIN_STALENESS,
                           value_bound=TRAIN_VALUE_BOUND))
    policy = policies.from_spec(tcfg.consistency)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    state = init_train_state(cfg, tcfg, tp=1, dp=TRAIN_REPLICAS, seed=seed,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_leaves = len(tree_leaves(state.params))
    n_params = sum(x[0].numel() for x in tree_leaves(state.params))
    step_fn = steps.make_train_step(cfg, tcfg)
    it = batches(SyntheticLM(cfg.vocab_size, seed=seed),
                 TRAIN_REPLICAS * TRAIN_ROWS, TRAIN_SEQ)

    # the plain versions are counted, and must not run on this path
    plain = {"ssd_chunked": 0, "ssd_scan_bwd": 0}
    orig_plain = {k: getattr(ssd_ref, k) for k in plain}

    def counting(name):
        def call(*a, **kw):
            plain[name] += 1
            return orig_plain[name](*a, **kw)
        return call

    for k in plain:
        setattr(ssd_ref, k, counting(k))
    try:
        with path_run(dev, keep_first=True) as run:
            state, hist = _train_steps(state, step_fn, it, TRAIN_STEPS, run,
                                       policy)
        walls, waits, losses, synced, invariant = (hist[k] for k in (
            "walls", "waits", "losses", "synced", "invariant"))
        peak = torch.cuda.max_memory_allocated(dev)
        launches = run["launches"]
        first_bwd = run["first"].get(("ssd_scan_bwd", torch.bfloat16))
        fwd_calls = len(run["calls"]["ssd_scan"])
        del run

        # one more step, profiled (its counts checked apart)
        batch = next(it)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with path_run(dev) as prun, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t
        prof_launches = prun["launches"]
        del prun
    finally:
        for k, fn in orig_plain.items():
            setattr(ssd_ref, k, fn)
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())
    fwd_s = ssd_scan_seconds(device_s, prof_launches["ssd_scan"])
    bwd_by_name = {k: v for k, v in device_s.items()
                   if SSD_BWD_KERNEL.search(k)}
    bwd_s = sum(bwd_by_name.values())
    del state, prof
    torch.cuda.empty_cache()

    tokens = TRAIN_REPLICAS * TRAIN_ROWS * TRAIN_SEQ
    step_med = statistics.median(walls[1:])
    card_vs_cpu = train_step_card_vs_cpu(dev, seed)
    per_step = TRAIN_REPLICAS * TRAIN_STEPS
    want = {"ssd_scan": (2 if tcfg.remat else 1) * cfg.n_layers * per_step,
            "ssd_scan_bwd": cfg.n_layers * per_step,
            "vap_accum": n_leaves * TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    line = {"phase": "train", "model": TRAIN_ARCH, "nvidia_smi": smi,
            "params": n_params, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "dtype": cfg.dtype, "master_dtype": "float32",
            "replicas": TRAIN_REPLICAS, "rows_per_replica": TRAIN_ROWS,
            "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "reduced": TRAIN_REDUCED, "optimizer": "adam", "lr": TRAIN_LR,
            "warmup_steps": TRAIN_WARMUP, "remat": tcfg.remat,
            "policy": f"cvap({TRAIN_STALENESS}, {TRAIN_VALUE_BOUND})",
            "init_s": init_s,
            "step_wall_s": walls, "step_wall_median_s": step_med,
            "tokens_per_s": tokens / step_med,
            "data_wait_s": waits, "data_wait_total_s": sum(waits),
            "peak_device_bytes": peak,
            "losses": losses, "synced": synced, "triggers": hist["triggers"],
            "delta_max_abs": hist["gmax"], "vap_invariant_ok": invariant,
            "launches": got, "launches_per_replica_step": {
                k: v / per_step for k, v in got.items() if k != "vap_accum"},
            "vap_accum_per_step": got["vap_accum"] / TRAIN_STEPS,
            "leaves": n_leaves, "ssd_scan_forward_calls": fwd_calls,
            "plain_calls": plain,
            "profiled": {"what": "one more step", "wall_s": prof_wall_s,
                         "device_busy_s": busy_s,
                         "device_idle_share": 1.0 - busy_s / prof_wall_s,
                         "launches": {k: prof_launches[k] for k in want},
                         "ssd_scan_forward_device_s": fwd_s,
                         "ssd_scan_backward_device_s": bwd_s,
                         "ssd_scan_backward_by_name": {
                             _short(k): v for k, v in bwd_by_name.items()},
                         "ssd_scan_backward_ms_per_call_by_name": {
                             _short(k): v * 1e3 / max(
                                 prof_launches["ssd_scan_bwd"], 1)
                             for k, v in bwd_by_name.items()},
                         "elementwise_device_s": sum(
                             v for k, v in device_s.items()
                             if ELEMENTWISE.search(k)),
                         "device_s_by_name": dict(sorted(
                             device_s.items(), key=lambda kv: -kv[1])[:25])},
            "card_vs_cpu_step": card_vs_cpu}
    emit(line)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if not all(invariant):
        raise AssertionError(f"train: the VAP invariant broke: {invariant}")
    if not (any(synced) and not all(synced)):
        raise AssertionError(f"train: synced {synced}: need a step that "
                             f"synced and one that did not")
    if got != want:
        raise AssertionError(f"train: launched {got}, not {want}")
    if prof_launches["ssd_scan_bwd"] != cfg.n_layers * TRAIN_REPLICAS:
        raise AssertionError(f"train: the profiled step launched "
                             f"{prof_launches}")
    if any(plain.values()):
        raise AssertionError(f"train: the plain versions ran: {plain}")
    if not bwd_by_name or fwd_s is None:
        raise AssertionError("train: the profile shows no ssd_scan kernel")
    if first_bwd is None:
        raise AssertionError("train: no bfloat16 ssd_scan_bwd call noted")
    if not card_vs_cpu["ok"]:
        raise AssertionError(f"train: a step on the card != on the CPU: "
                             f"{card_vs_cpu}")
    return launches, first_bwd, line


# ---------------------------------------------------------------------------
# train_rg: RecurrentGemma-9B at full width and reduced depth, one replica
# ---------------------------------------------------------------------------

TRAIN_RG_ARCH = "recurrentgemma-9b"
TRAIN_RG_LAYERS = 5     # one rec/rec/attn unit and the model's two-layer tail
TRAIN_RG_ROWS = 2       # sequences a step
TRAIN_RG_STEPS = 4
TRAIN_RG_REDUCED = {
    "layers": f"{TRAIN_RG_LAYERS} of 38: one rec/rec/attn unit and the "
              f"model's own two-layer float32 tail",
    "global_batch": f"{TRAIN_RG_ROWS} sequences of train_4k's 256",
    "steps": f"{TRAIN_RG_STEPS}",
    "replicas": "1 (the reference's mesh=None step): the float32 master, "
                "Adam's moments and δ of one replica take 32.8 GB, two "
                "would take 65.6 GB before any gradient"}
RGLRU_BWD_ENTRY = "time-parallel: g's chain alone (r and dh streamed newest " \
                  "first by TMA, a thread a lane), then every 32-step " \
                  "chunk at once (a thread a (row, lane, chunk), its tiles " \
                  "by TMA) from the state the forward saved entering it, " \
                  "then dΛ's partials summed in order (three launches)"
FLASH_BWD_ENTRY = {
    torch.bfloat16: "wgmma: D = rowsum(dO O); dk / dv per 64-key tile and "
                    "slice of the G heads (K, V kept, Q, dO streamed by "
                    "TMA, one warpgroup forming P^T and dV, one dS^T and "
                    "dK), the slices' float32 partials summed in order; dq "
                    "per 128 query rows (K, V streamed, S and dP again); "
                    "P and dS rounded to bf16 (three or four launches)",
    torch.float32: "float32 pipes: D = rowsum(dO O), then dk / dv per "
                   "32-key tile walking the band's query tiles and the G "
                   "heads, then dq per 32-row tile (three launches)"}
RGLRU_BWD_KERNELS = re.compile(r"rglru_bwd_(chain|chunk|dparam)_kernel")
RGLRU_FWD_KERNEL = re.compile(r"\brglru_kernel\b")
VAP_KERNEL = re.compile(r"vap_accum_kernel")
FLASH_BWD_KERNELS = re.compile(r"flash_bwd_(dot|dkdv|dq|kv_wgmma|sum|q_wgmma)"
                               r"_kernel")
FLASH_FWD_KERNELS = re.compile(r"flash_(wgmma|fwd)_kernel")


def check_rglru_bwd(dev, x, r_gate, i_gate, a_param, initial, dh,
                    dh_last=None, c=8.0, states=None):
    """The rglru_scan backward from the forward's ``states`` (the train
    path's own where it gives them, else the forward's launch writes them
    first) against its plain version on the card (``ref.rglru_bwd``: the
    forward's loop, then an explicit reverse sweep in float32): dx, dr, di
    and dinitial bitwise, dΛ (summed in the kernel's order) within BWD_TOL;
    twice for the same bits, and once without states for the same bits;
    timed from the states.  The bound counts the bytes it must move (x, r,
    i, dh read and dx, dr, di written once, Λ and dΛ, the states given or
    returned) and ~31 float32 operations an element (the gates and the step
    again, the reverse step and the chain)."""
    from repro_torch.kernels.rglru_scan import ops, ref

    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in (x, r_gate, i_gate, a_param, initial, dh, dh_last,
                           c))
    if states is None:
        states = ops.rglru_with_states(*args[:5], c)[2]
    got = ops.rglru_bwd(*args, states=states)
    want = ref.rglru_bwd(*args)
    torch.cuda.synchronize()
    ok, err, need = _bwd_close(got, want, BWD_TOL)
    bitwise = _same_bits(got[:3] + got[4:], want[:3] + want[4:])  # but dΛ
    if not (ok and bitwise):
        raise AssertionError(f"rglru_bwd {tuple(x.shape)} {x.dtype}: kernel "
                             f"!= plain (max abs err {err}; dx, dr, di, "
                             f"dinitial bitwise: {bitwise})")
    same = _same_bits(got, ops.rglru_bwd(*args, states=states))
    if not same:
        raise AssertionError(f"rglru_bwd {tuple(x.shape)} {x.dtype}: two "
                             f"calls differ in bits")
    without = _same_bits(got, ops.rglru_bwd(*args))
    if not without:
        raise AssertionError(f"rglru_bwd {tuple(x.shape)} {x.dtype}: "
                             f"without the forward's states the bits differ")
    del want
    big = x.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.rglru_bwd(*args, states=states),
                 reps=10 if big else REPS)
    plain_ms = cuda_ms(lambda: ref.rglru_bwd(*args), reps=3 if big else 5,
                       warmup=1)
    esize = x.element_size()
    nbytes = esize * (7 * x.numel() + 2 * a_param.numel()) + 4 * sum(
        t.numel() for t in (initial, dh_last, got[4]) if t is not None)
    bound_ms, bound_by = bound(nbytes, 31 * x.numel(), torch.float32)
    return {"shape": f"x/r/i/dh {'x'.join(map(str, x.shape))} "
                     f"{_dname(x.dtype)}"
                     + (" initial" if initial is not None else "")
                     + (" dh_last" if dh_last is not None else ""),
            "entry": ops.RGLRU_BWD_ENTRIES[x.dtype],
            "design": RGLRU_BWD_ENTRY, "max_abs_err": err,
            "least_abs_factor": need,
            "tolerance": f"dx, dr, di, dinitial bitwise; dΛ "
                         f"{BWD_TOL[x.dtype][0]} max|plain| + "
                         f"{BWD_TOL[x.dtype][1]:.5f} |plain|",
            "bitwise_but_dlambda": bitwise, "same_bits_twice": same,
            "same_bits_without_states": without, "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


def check_linear_recurrence_bwd(dev, a, b, initial, dh, dh_last=None):
    """The bare recurrence's backward entry against its plain version on
    the card, as check_rglru_bwd: da, db and dinitial bitwise."""
    from repro_torch.kernels.rglru_scan import ops, ref

    args = (a, b, initial, dh, dh_last)
    states = ops.linear_recurrence_with_states(a, b, initial)[2]
    got = ops.linear_recurrence_bwd(*args, states=states)
    want = ref.linear_recurrence_bwd(*args)
    torch.cuda.synchronize()
    ok, err, need = _bwd_close(got, want, BWD_TOL)
    bitwise = _same_bits(got, want)
    if not (ok and bitwise):
        raise AssertionError(f"linear_recurrence_bwd {tuple(a.shape)}: "
                             f"kernel != plain (max abs err {err}, bitwise "
                             f"{bitwise})")
    same = _same_bits(got, ops.linear_recurrence_bwd(*args, states=states))
    if not same:
        raise AssertionError(f"linear_recurrence_bwd {tuple(a.shape)}: two "
                             f"calls differ in bits")
    without = _same_bits(got, ops.linear_recurrence_bwd(*args))
    if not without:
        raise AssertionError(f"linear_recurrence_bwd {tuple(a.shape)}: "
                             f"without the forward's states the bits differ")
    del want
    big = a.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.linear_recurrence_bwd(*args, states=states))
    plain_ms = cuda_ms(lambda: ref.linear_recurrence_bwd(*args),
                       reps=3 if big else 5, warmup=1)
    nbytes = 4 * (5 * a.numel() + sum(
        t.numel() for t in (initial, dh_last, got[2]) if t is not None))
    bound_ms, bound_by = bound(nbytes, 5 * a.numel(), torch.float32)
    return {"shape": f"a/b/dh {'x'.join(map(str, a.shape))} float32"
                     + (" initial" if initial is not None else "")
                     + (" dh_last" if dh_last is not None else ""),
            "entry": "linear_recurrence_bwd_f32", "max_abs_err": err,
            "least_abs_factor": need, "bitwise": bitwise,
            "same_bits_twice": same, "same_bits_without_states": without,
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def rglru_bwd_stress_cases(dev):
    """Both fused entries with an initial state and dh_last, w not a
    multiple of 8 (rows the forward pads for TMA), l = 1, and the sqrt
    clamp's region (a within 1e-12 of 1: the forward's check_rglru_sqrt
    domain's lower end), each twice for the same bits, from the forward's
    states and without them; then the bare recurrence's entry."""
    g = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    out = {"rglru_scan_bwd": [], "linear_recurrence_bwd": []}
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, w, init, last, clamp in ((2, 64, 128, True, True, False),
                                           (1, 100, 50, True, False, False),
                                           (3, 1, 40, False, True, False),
                                           (2, 37, 256, True, True, True),
                                           (2, 333, 4096, True, True, False)):
            r = uniform(0, 1, b, l, w)
            lam = randn(w)
            if clamp:           # -c softplus(Λ) r ~ -1e-12: 1 - a² clamped
                r = uniform(0, 1e-3, b, l, w)
                lam = torch.full((w,), -30.0, device=dev)
            out["rglru_scan_bwd"].append(check_rglru_bwd(
                dev, randn(b, l, w, dtype=dtype), r.to(dtype),
                uniform(0, 1, b, l, w).to(dtype), lam.to(dtype),
                randn(b, w) if init else None, randn(b, l, w, dtype=dtype),
                randn(b, w) if last else None))
    for b, l, w in ((2, 64, 128), (1, 33, 50), (2, 4096, 4096)):
        out["linear_recurrence_bwd"].append(check_linear_recurrence_bwd(
            dev, uniform(0.7, 0.999, b, l, w), randn(b, l, w) * 0.1,
            randn(b, w), randn(b, l, w), randn(b, w)))
    return out


def check_flash_bwd(dev, q, k, v, q_pos, k_pos, out, lse, dout, window=None,
                    cap=None, out_lo=None):
    """The flash_attention backward against its plain version on the card
    (``ref.attention_bwd``: dense float32 formulas), with the forward's
    output residual ``out_lo`` in bfloat16, twice, failing where the two
    differ in bits; both timed (a bfloat16 case with the bfloat16
    kernels' registers and shared memory), and one library call where one
    computes the same
    function: the backward of scaled_dot_product_attention with the window
    as a boolean mask (no softcap), its forward run once outside the
    timing.  The bound counts 2 (3 dh + 2 dv) flops a (query, key) pair the
    mask keeps, at the inputs' type's rate, and q, k, v, o, do, lse read and
    dq, dk, dv written once."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v, out, dout = (t.detach() for t in (q, k, v, out, dout))
    args = (q, k, v, q_pos, k_pos, out, lse, dout, window, cap, out_lo)
    got = ops.flash_attention_bwd(*args)
    want = flash_bwd_plain(q, k, v, q_pos, k_pos, window, cap, dout)
    torch.cuda.synchronize()
    ok, err, need = _bwd_close(got, want, FLASH_BWD_TOL)
    if not ok:
        raise AssertionError(f"flash_attention_bwd {tuple(q.shape)} "
                             f"{q.dtype}: kernel != plain (max abs err "
                             f"{err}, least absolute factor {need})")
    same = _same_bits(got, ops.flash_attention_bwd(*args))
    if not same:
        raise AssertionError(f"flash_attention_bwd {tuple(q.shape)} "
                             f"{q.dtype}: two calls differ in bits")
    del want
    torch.cuda.empty_cache()
    b, sq, kvh, G, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    big = q.numel() > 10_000_000
    ms = cuda_ms(lambda: ops.flash_attention_bwd(*args),
                 reps=5 if big else REPS, warmup=1 if big else 3)
    plain_ms = cuda_ms(lambda: flash_bwd_plain(q, k, v, q_pos, k_pos,
                                               window, cap, dout),
                       reps=3 if big else 5, warmup=1)
    mask = k_pos[None, :].long() <= q_pos[:, None].long()
    if window is not None:
        mask &= k_pos[None, :].long() > q_pos[:, None].long() - window
    library_ms = None
    if cap is None:
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * G, sq, dh).detach() \
            .requires_grad_(True)
        ks = k.permute(0, 2, 1, 3).detach().requires_grad_(True)
        vs = v.permute(0, 2, 1, 3).detach().requires_grad_(True)
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True)
        do_lib = dout.permute(0, 2, 3, 1, 4).reshape(o_lib.shape)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), do_lib, retain_graph=True),
            reps=5 if big else REPS, warmup=1 if big else 3)
        del o_lib, qs, ks, vs
    # the bfloat16 kernels' registers, spills and shared memory (d 256)
    extra = ({"kernel_attrs": ops.bwd_bf16_attrs(dev)}
             if q.dtype == torch.bfloat16 else {})
    pairs = int(mask.sum()) * b * kvh * G
    flops = 2 * pairs * (3 * dh + 2 * dv)
    esize = q.element_size()
    nbytes = esize * 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * (lse.numel() + sq + skv)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    return {"shape": f"q {'x'.join(map(str, q.shape))} kv {skv}x{dv} "
                     f"{_dname(q.dtype)} window {window} cap {cap}",
            "entry": ops.BWD_ENTRY[q.dtype],
            "design": FLASH_BWD_ENTRY[q.dtype],
            "empty_key_slots": int((k_pos == 2**30).sum()),
            "max_abs_err": err, "least_abs_factor": need,
            "tolerance": f"{FLASH_BWD_TOL[q.dtype][0]} max|plain| + "
                         f"{FLASH_BWD_TOL[q.dtype][1]:.5f} |plain|",
            "same_bits_twice": same, "tflops": flops / ms / 1e9,
            "bound_share": bound_ms / ms, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention's backward (attn_mask="
                       "window mask, enable_gqa=True)" if cap is None
                       else None,
            "bound_ms": bound_ms, "bound_by": bound_by, "pairs": pairs,
            **extra}


# (b, sq, skv, kvh, G, dh, dv, window, cap, empty key slots): no window; a
# softcap with G 4; dv != dh; a window with a cap; a q suffix over ragged
# sq / skv with the second half of the key slots empty (rows that see no
# key); dv > dh, both off the tiles; the RecurrentGemma train call's heads
# and width (kv heads 1, G 16, d 256) at 700 positions with a window below
# one tile; Gemma2-9B's (kv heads 8, G 2, d 256, softcap 50) at 600
# positions, windowed below one tile and global; DeepSeek's MLA (16 kv
# heads, G 1, q / k 192, v 128, causal) at 512 positions
FLASH_BWD_CASES = ((2, 256, 256, 2, 2, 64, 64, None, None, False),
                   (1, 300, 300, 1, 4, 32, 32, None, 50.0, False),
                   (1, 128, 128, 4, 1, 192, 128, None, None, False),
                   (1, 512, 512, 1, 1, 128, 128, 64, 30.0, False),
                   (1, 200, 333, 1, 4, 128, 64, 100, None, True),
                   (2, 130, 130, 1, 2, 48, 80, 50, None, False),
                   (1, 700, 700, 1, 16, 256, 256, 40, None, False),
                   (1, 600, 600, 8, 2, 256, 256, 40, 50.0, False),
                   (1, 600, 600, 8, 2, 256, 256, None, 50.0, False),
                   (2, 512, 512, 16, 1, 192, 128, None, None, False))


def flash_bwd_stress_cases(dev):
    """FLASH_BWD_CASES in float32 and bfloat16; the forward as training runs
    it gives o, lse and (bfloat16) o's rounding residual."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, kvh, G, dh, dv, window, cap, empty in FLASH_BWD_CASES:
            q = randn(b, sq, kvh, G, dh, dtype=dtype)
            k = randn(b, skv, kvh, dh, dtype=dtype)
            v = randn(b, skv, kvh, dv, dtype=dtype)
            q_pos = torch.arange(skv - sq, skv, dtype=torch.int32, device=dev)
            k_pos = torch.arange(skv, dtype=torch.int32, device=dev)
            if empty:
                k_pos[skv // 2:] = 2**30
            o, lse, lo = ops.flash_attention(q, k, v, q_pos, k_pos, window,
                                             cap, return_lse=True)
            out.append(check_flash_bwd(dev, q, k, v, q_pos, k_pos, o, lse,
                                       randn(b, sq, kvh, G, dv, dtype=dtype),
                                       window, cap, lo))
    return out


def train_launches_per_step(cfg, remat):
    """One train step's launches by entry as ``M.group_layers`` implies
    them: under remat a unit layer's forward runs twice (the backward
    recomputes the unit), a prefix or tail layer's once; each backward
    once.  The RG-LRU's entries by dtype: the stacked units' bfloat16, and
    float32 outside them (RecurrentGemma's tail, whose float32 1-D leaves
    promote the residual stream).  Also the flash backward's launches a
    step by window."""
    from repro_torch.models import model as M

    prefix, unit, n_units, tail = M.group_layers(cfg, M.layer_metas(cfg))
    fwd = 2 if remat else 1

    def n(metas, kind):
        return sum(m.kind == kind for m in metas)

    want = {"flash_attention": n(prefix + tail, "attn")
            + fwd * n_units * n(unit, "attn"),
            "flash_attention_bwd": n(prefix + tail, "attn")
            + n_units * n(unit, "attn")}
    if cfg.recurrent is not None and cfg.recurrent.kind == "rglru":
        want.update({"rglru_bf16": fwd * n_units * n(unit, "rec"),
                     "rglru_f32": n(prefix + tail, "rec"),
                     "rglru_bwd_bf16": n_units * n(unit, "rec"),
                     "rglru_bwd_f32": n(prefix + tail, "rec")})
    by_window = collections.Counter(
        m.window for m in prefix + tail + unit * n_units if m.kind == "attn")
    return want, dict(by_window)


def train_first_bwd_keys(cfg, want, by_window):
    """The backwards' first calls a train step makes, by (name, dtype,
    window), from :func:`train_launches_per_step`'s counts: the flash
    backward's in the compute dtype once a window, the RG-LRU's once an
    entry's dtype."""
    keys = {("flash_attention_bwd", getattr(torch, cfg.dtype), w)
            for w in by_window}
    return keys | {("rglru_scan_bwd", dtype, None)
                   for entry, dtype in (("rglru_bwd_bf16", torch.bfloat16),
                                        ("rglru_bwd_f32", torch.float32))
                   if want.get(entry)}


def moe_step_routes(calls, cfg, remat):
    """One train step's MoE routing from its dispatch calls
    (:func:`moe_routes`): the pairs
    dropped in each MoE layer's forward, and the pairs whose expert or
    slot differ between a unit's forward and its recomputation in the
    backward (remat).  The forward runs the MoE layers in layer order, the
    backward recomputes the units in reverse, each unit's layers in
    order."""
    from repro_torch.models import model as M

    prefix, unit, n_units, tail = M.group_layers(cfg, M.layer_metas(cfg))
    fwd = [c for c in calls if not c["recompute"]]
    again = [c for c in calls if c["recompute"]]
    n_pre = sum(m.use_moe for m in prefix)
    per_unit = sum(m.use_moe for m in unit)
    # the forward's index of each recomputed call
    order = [n_pre + u * per_unit + j for u in reversed(range(n_units))
             for j in range(per_unit)] if remat else []
    if len(again) != len(order) or len(fwd) != n_pre + n_units * per_unit \
            + sum(m.use_moe for m in tail):
        raise AssertionError(f"MoE dispatch calls: {len(fwd)} forward, "
                             f"{len(again)} recomputed, not as the layers "
                             f"imply")
    differ = sum(int((fwd[i]["ids"] != r["ids"]).sum()
                     + (fwd[i]["keep"] != r["keep"]).sum())
                 for i, r in zip(order, again))
    return [int((~c["keep"]).sum()) for c in fwd], differ


def flash_bwd_plain(q, k, v, q_pos, k_pos, window, cap, dout):
    """``ref.attention_bwd`` over slices of the batch and the kv heads
    where one float32 logits tensor of the whole call would pass
    FLASH_PLAIN_SLICE_BYTES (the plain backward holds several: at
    Gemma2-9B's train call 2 x 16 heads x 8,192^2 float32 is 8.6 GB).
    Batch rows and kv heads are independent, so the slices' results are
    the whole call's."""
    from repro_torch.kernels.flash_attention import ref

    b, sq, kvh, G, _ = q.shape
    per_head = 4 * G * sq * k.shape[1]
    heads = max(1, min(kvh, int(FLASH_PLAIN_SLICE_BYTES // per_head)))
    if heads >= kvh and b * per_head * kvh <= FLASH_PLAIN_SLICE_BYTES:
        return ref.attention_bwd(q, k, v, q_pos, k_pos, window, cap, dout)
    parts = [[ref.attention_bwd(q[i:i + 1, :, h:h + heads],
                                k[i:i + 1, :, h:h + heads],
                                v[i:i + 1, :, h:h + heads], q_pos, k_pos,
                                window, cap, dout[i:i + 1, :, h:h + heads])
              for h in range(0, kvh, heads)] for i in range(b)]
    return tuple(torch.cat([torch.cat([p[j] for p in row], 2)
                            for row in parts], 0) for j in range(3))


@dataclasses.dataclass(frozen=True)
class TrainCell:
    """One full-width, reduced-depth training cell on the card: one
    replica, ``rows`` SyntheticLM sequences of ``seq`` tokens a step,
    ``steps`` Adam steps at learning rate ``lr`` under
    cvap(TRAIN_STALENESS, :meth:`value_bound`), remat on."""
    phase: str
    arch: str
    layers: int
    rows: int
    seq: int
    steps: int
    reduced: dict
    notes: dict = dataclasses.field(default_factory=dict)
    lr: float = TRAIN_LR

    def value_bound(self) -> float:
        """TRAIN_VALUE_BOUND scaled with the learning rate: Adam moves an
        entry by about lr a step, so the bound stays between two steps'
        growth of max|δ| and three's."""
        return round(TRAIN_VALUE_BOUND * self.lr / TRAIN_LR, 12)


# the card's 80 GB, which a training cell's peak must stay under
TRAIN_PEAK_LIMIT = 80e9
TRAIN_RG = TrainCell(
    "train_rg", TRAIN_RG_ARCH, TRAIN_RG_LAYERS, TRAIN_RG_ROWS, TRAIN_SEQ,
    TRAIN_RG_STEPS, TRAIN_RG_REDUCED)
TRAIN_GEMMA2 = TrainCell(
    "train_gemma2", "gemma2-9b", 4, 2, 8_192, 4,
    {"layers": "4 of 42: two local/global units (the model's period)",
     "global_batch": "2 sequences of 8,192 tokens (train_4k's 256 of "
                     "4,096 cut to 2, at 8,192 so that the 4,096-token "
                     "window masks on the local layers)",
     "steps": "4",
     "replicas": "1 (the reference's mesh=None step): the float32 master, "
                 "Adam's moments and δ take 16 bytes a parameter, 27.4 GB "
                 "at 4 layers, 148 GB at 42"})
TRAIN_DEEPSEEK = TrainCell(
    "train_deepseek", "deepseek-v2-lite-16b", 3, 2, TRAIN_SEQ, 4,
    {"layers": "3 of 27: the dense first layer, then two MoE layers",
     "global_batch": "2 sequences of train_4k's 256",
     "steps": "4",
     "replicas": "1 (the reference's mesh=None step): 16 bytes a "
                 "parameter, 26.7 GB at 3 layers, 251 GB at 27"},
    {"moe_gradient_bits": "the dispatch gather's and the combine's "
                          "backward accumulate through PyTorch's index_put "
                          "(atomic adds), whose float sum order is not "
                          "fixed: "
                          "the gradient is not bit-repeatable run to run "
                          "(the forward and the routes are)"})
# Pixtral-12B: 16 bytes a parameter make 34.6 GB at 3 layers (2.16 B
# parameters), 196 GB at 40.  Reckoned before its first run from
# train_gemma2's 62.3 GB at 1.71 B: the master, moments, δ, the update
# buffer and the gradients take 24 bytes a parameter (51.8 GB), the compute
# cast 4.3 GB, the activations of 2 x 4,096 tokens under remat a few GB
# (Gemma2's 2 x 8,192 tokens, 256,000-word head and the kept calls took
# ~18 GB): ~62-66 GB, under the ~75 GB at which it would take 2 layers
# The frontend cells' learning rates.  At the other cells' 1e-3 both losses
# rose over the 4 steps on the card (H100 80GB HBM3, 700 W): Pixtral's
# 12.27, 20.33, 15.01, 19.16, MusicGen's 48-layer stack's 8.18, 14.93,
# 11.99, 12.99.  So do the reference's and the port's alike on the CPU at
# MusicGen's full width, where at the reduced width 1e-3 falls
# (tests/test_torch_frontends.py::test_adam_at_full_width_rises_at_1e3_in_
# both): Adam's first step moves every weight by its whole lr, the same
# way across a row's d inputs, so its effect grows with the width.  Each
# cell takes the largest of 1e-3, 3e-4, 1e-4, 3e-5, 1e-5 and 3e-6 at which
# its last loss lies below its first; the value bound scales with it.  Over
# that sweep a 4-step run's last loss is U-shaped in lr: above the choice
# the steps overshoot (MusicGen at 3e-5 ends at 8.38), below it they move
# less (3e-6 ends at 6.56, 1e-5 at 5.99)
TRAIN_PIXTRAL = TrainCell(
    "train_pixtral", "pixtral-12b", 3, 2, TRAIN_SEQ, 4,
    {"layers": "3 of 40: the float32 master, Adam's moments and δ take 16 "
               "bytes a parameter, 34.6 GB at 3 layers, 196 GB at 40; the "
               "update and the gradients take 8 more (a peak of ~62-66 GB "
               "reckoned at 3, under the ~75 GB at which it would take 2)",
     "global_batch": "2 sequences of train_4k's 256, each with 256 patch "
                     "embeddings",
     "steps": "4",
     "replicas": "1 (the reference's mesh=None step)"},
    {"lr_note": "lr 1e-4, not the other cells' 1e-3: the largest of 1e-3, "
                "3e-4, 1e-4, 3e-5 at which its last loss lay below its "
                "first (at 1e-3 it rose, 12.27 to 19.16, as the "
                "reference's run rises at full width: tests/"
                "test_torch_frontends.py)"},
    lr=1e-4)
# MusicGen-medium at full depth: 1.37 B parameters, 21.8 GB at 16 bytes
TRAIN_MUSICGEN = TrainCell(
    "train_musicgen", "musicgen-medium", 48, 4, TRAIN_SEQ, 4,
    {"global_batch": "4 sequences of train_4k's 256, each with 64 "
                     "conditioning frames",
     "steps": "4"},
    {"lr_note": "lr 1e-5, not the other cells' 1e-3: the largest of 1e-3, "
                "3e-4, 1e-4, 3e-5, 1e-5, 3e-6 at which its last loss lay "
                "below its first (at 1e-3 it rose, 8.18 to 12.99, as the "
                "reference's run rises at full width: tests/"
                "test_torch_frontends.py; at 3e-5 to 8.38, and below 8.18 "
                "only from its sixth step)"},
    lr=1e-5)
TRAIN_LM_CELLS = (TRAIN_GEMMA2, TRAIN_DEEPSEEK, TRAIN_PIXTRAL, TRAIN_MUSICGEN)


def run_train_lm_phase(dev, seed, smi, cell: TrainCell):
    """``cell.arch`` at full width and ``cell.layers`` layers, trained on
    the card as one replica through init_train_state and make_train_step.
    Returns (launches, the backwards' first calls {(name, dtype, window):
    (args, kw)}, line)."""
    from repro_torch.configs import ConsistencySpec, TrainConfig, get_config
    from repro_torch.core import policies
    from repro_torch.data import SyntheticLM, batches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.launch import steps
    from repro_torch.launch.state import init_train_state
    from repro_torch.launch.train import frontend_draws
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves

    name = cell.phase
    cfg = dataclasses.replace(get_config(cell.arch),
                              n_layers=cell.layers)  # bfloat16 compute
    tcfg = TrainConfig(arch=cell.arch, optimizer="adam", lr=cell.lr,
                       warmup_steps=TRAIN_WARMUP, seed=seed,
                       consistency=ConsistencySpec(
                           model="cvap", staleness=TRAIN_STALENESS,
                           value_bound=cell.value_bound()))
    policy = policies.from_spec(tcfg.consistency)
    want_step, want_bwd_by_window = train_launches_per_step(cfg, tcfg.remat)
    gc.collect()
    torch.cuda.empty_cache()
    # what earlier phases still hold (the first calls kept for the kernels
    # phase), inside this phase's peak
    held_at_start = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    state = init_train_state(cfg, tcfg, tp=1, dp=1, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_leaves = len(tree_leaves(state.params))
    n_params = sum(x[0].numel() for x in tree_leaves(state.params))
    state_bytes = {
        "master_adam_delta": sum(x.numel() * x.element_size() for x in
                                 tree_leaves(state.params)
                                 + tree_leaves(state.opt.mu)
                                 + tree_leaves(state.opt.nu)
                                 + list(state.sync.delta.values()))}
    step_fn = steps.make_train_step(cfg, tcfg)
    it = batches(SyntheticLM(cfg.vocab_size, seed=seed), cell.rows, cell.seq)
    draw = frontend_draws(cfg, seed, cell.rows)
    if draw is not None:
        # a frontend's embeddings, drawn each step as launch.train.run
        # draws them (on the host, inside the step's wall)
        it = ({**b, "extra_emb": draw()} for b in it)

    # the plain versions are counted, and must not run on this path
    plain_fns = {(rg_ref, "rglru"), (rg_ref, "rglru_bwd"),
                 (fa_ref, "attention"), (fa_ref, "attention_bwd")}
    plain = {fn_name: 0 for _, fn_name in plain_fns}
    orig_plain = {(mod, fn_name): getattr(mod, fn_name)
                  for mod, fn_name in plain_fns}

    def counting(mod, fn_name):
        def call(*a, **kw):
            plain[fn_name] += 1
            return orig_plain[(mod, fn_name)](*a, **kw)
        return call

    def counters():
        return {**rg_ops.launches_by_entry, **rg_ops.bwd_launches_by_entry,
                "flash_attention": fa_ops.launches,
                "flash_attention_bwd": fa_ops.bwd_launches}

    for mod, fn_name in plain_fns:
        setattr(mod, fn_name, counting(mod, fn_name))
    moe_line = None
    try:
        with path_run(dev, keep_first=True, key=window_key) as run, \
                moe_routes() as routed:
            state, hist = _train_steps(state, step_fn, it, cell.steps, run,
                                       policy, counters, cell.value_bound())
        walls, losses, synced, invariant = (hist[k] for k in (
            "walls", "losses", "synced", "invariant"))
        per_step = [{k: c[k] for k in want_step} for c in hist["launches"]]
        peak = torch.cuda.max_memory_allocated(dev)
        launches = run["launches"]
        by_entry = run["rglru_scan_by_entry"]
        bwd_by_window = {str(w): n // cell.steps
                         for (k, _, w), n in run["by_key"].items()
                         if k == "flash_attention_bwd"}
        first = {k: v for k, v in run["first"].items()
                 if k[0] in ("rglru_scan_bwd", "flash_attention_bwd")}
        first_shapes = {f"{k[0]} {_dname(k[1])} window {k[2]}": [
            list(a.shape) for a in args if isinstance(a, torch.Tensor)]
            for k, (args, _) in first.items()}
        del run
        if cfg.moe is not None:
            # each step's dispatch calls: the forward's drops by layer, and
            # the routes the backward's recomputation changed
            n_calls = len(routed) // cell.steps
            drops, differ = zip(*(moe_step_routes(
                routed[i * n_calls:(i + 1) * n_calls], cfg, tcfg.remat)
                for i in range(cell.steps)))
            moe_line = {
                "capacity_factor": cfg.moe.capacity_factor,
                "capacity": moe.capacity(cfg.moe, cell.rows * cell.seq),
                "pairs_per_layer": routed[0]["keep"].numel(),
                "dropped_pairs_by_step_and_layer": [list(d) for d in drops],
                "remat_route_differences": sum(differ),
                "dispatch_calls_per_step": n_calls}
        del routed

        # one more step, profiled (its counts checked apart); a window whose
        # device events miss a launch of the forward kernels is discarded
        # and another step taken, as profiled_device_ms does
        discarded = []
        for _ in range(3):
            batch = next(it)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with path_run(dev) as prun, profile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                state, _ = step_fn(state, batch)
                torch.cuda.synchronize()
            prof_wall_s = time.perf_counter() - t
            prof_launches = prun["launches"]
            del prun
            events = collections.Counter()
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    for kname, pattern in (("flash_attention",
                                            FLASH_FWD_KERNELS),
                                           ("vap_accum", VAP_KERNEL),
                                           ("rglru_scan", RGLRU_FWD_KERNEL)):
                        events[kname] += bool(pattern.search(e.name))
            if all(events[k] == prof_launches[k] for k in events):
                break
            discarded.append(dict(events))
            print(f"profiler: {name} step's window with device events "
                  f"{dict(events)} for launches {prof_launches} discarded",
                  file=sys.stderr)
            del prof
        else:
            raise AssertionError(f"{name}: profiler windows {discarded} "
                                 f"miss launches, window after window")
    finally:
        for (mod, fn_name), fn in orig_plain.items():
            setattr(mod, fn_name, fn)
    device_s = device_seconds(prof)
    busy_s = sum(device_s.values())

    def by(pattern):
        return {k: v for k, v in device_s.items() if pattern.search(k)}

    rg_bwd, fa_bwd, fa_fwd = (by(RGLRU_BWD_KERNELS), by(FLASH_BWD_KERNELS),
                              by(FLASH_FWD_KERNELS))
    rg_fwd = rglru_scan_seconds(device_s, prof_launches["rglru_scan"])
    del state, prof
    torch.cuda.empty_cache()

    tokens = cell.rows * cell.seq
    step_med = statistics.median(walls[1:])
    card_vs_cpu = train_step_card_vs_cpu(dev, seed, cell.arch)
    rglru = "rglru_bf16" in want_step
    fa_want = want_step["flash_attention_bwd"]
    line = {"phase": name, "model": cell.arch, "nvidia_smi": smi,
            "params": n_params, "layers": cfg.n_layers,
            "layer_kinds": [m.kind for m in M.layer_metas(cfg)],
            "layer_windows": [m.window for m in M.layer_metas(cfg)],
            "d_model": cfg.d_model,
            **({"rglru_width": cfg.recurrent.width} if rglru else {}),
            "heads": f"{cfg.n_heads} x {cfg.d_head}, {cfg.n_kv_heads} kv",
            **({"frontend": {"kind": cfg.frontend.kind,
                             "n_embeds": cfg.frontend.n_embeds}}
               if cfg.frontend is not None else {}),
            "norm": cfg.norm_kind, "mlp": f"{cfg.act}, "
            + ("gated" if cfg.gated_mlp else "not gated"),
            "window": cfg.window, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype,
            "master_dtype": "float32", "state_bytes": state_bytes,
            "replicas": 1, "rows": cell.rows, "seq_len": cell.seq,
            "steps": cell.steps, "reduced": cell.reduced, **cell.notes,
            "optimizer": "adam", "lr": cell.lr,
            "warmup_steps": TRAIN_WARMUP, "remat": tcfg.remat,
            "policy": f"cvap({TRAIN_STALENESS}, {cell.value_bound()})",
            "init_s": init_s, "step_wall_s": walls,
            "step_wall_median_s": step_med,
            "tokens_per_s": tokens / step_med,
            "peak_device_bytes": peak,
            "device_bytes_held_at_start": held_at_start,
            "losses": losses, "synced": synced,
            "triggers": hist["triggers"], "delta_max_abs": hist["gmax"],
            "vap_invariant_ok": invariant,
            "launches": {k: launches[k] for k in (
                "rglru_scan", "rglru_scan_bwd", "flash_attention",
                "flash_attention_bwd", "vap_accum")},
            "rglru_scan_by_entry": by_entry,
            "launches_per_step": per_step, "want_per_step": want_step,
            "flash_attention_bwd_per_step_by_window": bwd_by_window,
            "want_flash_attention_bwd_per_step_by_window": {
                str(w): n for w, n in want_bwd_by_window.items()},
            "vap_accum_per_step": launches["vap_accum"] / cell.steps,
            "leaves": n_leaves, "plain_calls": plain,
            "first_backward_calls": first_shapes,
            **({"moe": moe_line} if moe_line else {}),
            "profiled": {"what": "one more step", "wall_s": prof_wall_s,
                         "windows_discarded": discarded,
                         "device_busy_s": busy_s,
                         "device_idle_share": 1.0 - busy_s / prof_wall_s,
                         "launches": {k: prof_launches[k] for k in (
                             "rglru_scan", "rglru_scan_bwd",
                             "flash_attention", "flash_attention_bwd",
                             "vap_accum")},
                         "rglru_scan_forward_device_s": rg_fwd,
                         "rglru_scan_backward_device_s": sum(
                             rg_bwd.values()),
                         "flash_attention_forward_device_s": sum(
                             fa_fwd.values()),
                         "flash_attention_backward_device_s": sum(
                             fa_bwd.values()),
                         "backward_by_name": {**rg_bwd, **fa_bwd},
                         "elementwise_device_s": sum(
                             v for k, v in device_s.items()
                             if ELEMENTWISE.search(k)),
                         "device_s_by_name": dict(sorted(
                             device_s.items(), key=lambda kv: -kv[1])[:25])},
            "card_vs_cpu_step": card_vs_cpu}
    emit(line)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if not all(invariant):
        raise AssertionError(f"{name}: the VAP invariant broke: "
                             f"{invariant}")
    if not any(synced):
        raise AssertionError(f"{name}: no step synced: {synced}")
    if any(s != want_step for s in per_step):
        raise AssertionError(f"{name}: launches a step {per_step}, not "
                             f"{want_step}")
    if bwd_by_window != line["want_flash_attention_bwd_per_step_by_window"]:
        raise AssertionError(f"{name}: the flash backward's launches a step "
                             f"by window {bwd_by_window}, not "
                             f"{want_bwd_by_window}")
    if launches["vap_accum"] != n_leaves * cell.steps:
        raise AssertionError(f"{name}: vap_accum launched "
                             f"{launches['vap_accum']}, not one a leaf a "
                             f"step")
    want_prof_bwd = (want_step.get("rglru_bwd_bf16", 0)
                     + want_step.get("rglru_bwd_f32", 0), fa_want)
    if (prof_launches["rglru_scan_bwd"], prof_launches["flash_attention_bwd"]
            ) != want_prof_bwd:
        raise AssertionError(f"{name}: the profiled step launched "
                             f"{prof_launches}")
    if any(plain.values()):
        raise AssertionError(f"{name}: the plain versions ran: {plain}")
    if not (fa_bwd and fa_fwd and (rg_bwd and rg_fwd or not rglru)):
        raise AssertionError(f"{name}: the profile shows no backward or "
                             f"forward kernel by name")
    if set(first) != train_first_bwd_keys(cfg, want_step,
                                          want_bwd_by_window):
        raise AssertionError(f"{name}: first backward calls noted "
                             f"{sorted(map(str, first))}")
    if peak >= TRAIN_PEAK_LIMIT:
        raise AssertionError(f"{name}: peak device memory {peak} bytes, not "
                             f"under {TRAIN_PEAK_LIMIT:.0e}")
    if moe_line is not None and moe_line["remat_route_differences"]:
        raise AssertionError(f"{name}: remat's recomputation routed "
                             f"{moe_line['remat_route_differences']} pairs "
                             f"otherwise than the forward")
    if not card_vs_cpu["ok"]:
        raise AssertionError(f"{name}: a step on the card != on the CPU: "
                             f"{card_vs_cpu}")
    return launches, first, line


def path_shapes(calls):
    """The median call of each kernel on the main path: ps_apply's per
    (R, C) block, heaviest block first, and topk_mag's per length."""
    blocks = {}
    for R, C, N in calls["ps_apply"]:
        blocks.setdefault((R, C), []).append(N)
    apply = [(R, C, statistics.median_low(ns))
             for (R, C), ns in sorted(blocks.items(),
                                      key=lambda kv: -kv[0][0] * kv[0][1])]
    return apply, sorted(set(calls["topk_mag"]))


T_START = time.perf_counter()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve phase's weights and prompts")
    ap.add_argument("--topk-cases", type=int, nargs="+",
                    metavar="N SEED",
                    help="run only topk_mag's cases at N magnitudes from "
                         "SEED, pair by pair, and print each (the smoke runs "
                         "them in a child process)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke test runs "
                 "only on the card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    if args.topk_cases:
        pairs = args.topk_cases
        for n, seed in zip(pairs[::2], pairs[1::2]):
            emit(topk_case(torch.device("cuda"), n, seed))
        return
    from repro_torch.kernels import _build

    from repro_torch.data import synthetic_corpus

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.load()
    regs = re.findall(r"entry function '(\w+)'.*?Used (\d+) registers",
                      _build.BUILD_INFO["log"], re.S)
    emit({"phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": _build.BUILD_INFO["seconds"],
          "build_cached": _build.BUILD_INFO["cached"],
          "registers": {k[-40:]: int(v) for k, v in regs}})

    walls = {}

    def timed(phase, fn, *a):
        """fn(*a), its wall printed on a line of its own."""
        t = time.perf_counter()
        out = fn(*a)
        walls[phase] = time.perf_counter() - t
        emit({"phase_wall": phase, "s": walls[phase]})
        return out

    t = time.perf_counter()
    corpus = synthetic_corpus(n_docs=N_DOCS, vocab_size=VOCAB,
                              n_topics=TRUE_TOPICS, doc_len=DOC_LEN, seed=0)
    corpus_s = time.perf_counter() - t
    launches, calls, lda_wall_s = timed("lda", run_lda_phase, dev, corpus,
                                        corpus_s)
    wire_launches, wire_wall_s = timed("wire", run_wire_phase, dev, corpus,
                                       lda_wall_s)
    durable_launches, replay_launches = timed(
        "durable", run_durable_phase, dev, corpus, wire_wall_s)
    (replica_launches, replica_calls, tcp_launches,
     ingest_launches) = timed("replicas", run_replicas_phase, dev, corpus,
                              wire_wall_s)
    (elastic_launches, elastic_by_site,
     autoscale_launches) = timed("elastic", run_elastic_phase, dev, corpus,
                                 wire_wall_s)
    spmd_launches, vap_shapes = timed("lda_spmd", run_lda_spmd_phase, dev,
                                      corpus)
    launches.update(spmd_launches)
    app_launches, app_calls = timed("apps", run_apps_phase, dev)
    serve_launches, first, serve_lines = timed("serve", run_serve_phase, dev,
                                               args.seed)
    for name in ("flash_attention", "rglru_scan"):
        launches[name] = serve_launches["recurrentgemma-9b"][name]
    launches["ssd_scan"] = serve_launches["mamba2-130m"]["ssd_scan"]
    train_launches, first_bwd, train_line = timed(
        "train", run_train_phase, dev, args.seed, smi)
    launches["ssd_scan_bwd"] = train_launches["ssd_scan_bwd"]
    train_rg_launches, first_rg, train_rg_line = timed(
        "train_rg", run_train_lm_phase, dev, args.seed, smi, TRAIN_RG)
    for name in ("rglru_scan_bwd", "flash_attention_bwd"):
        launches[name] = train_rg_launches[name]
    train_lm = {cell.phase: timed(cell.phase, run_train_lm_phase, dev,
                                  args.seed, smi, cell)
                for cell in TRAIN_LM_CELLS}
    t_kernels = time.perf_counter()
    kernels_s, t_part = {}, [t_kernels]

    def part_done(name):
        """The kernels phase's wall, part by part."""
        now = time.perf_counter()
        kernels_s[name] = now - t_part[0]
        t_part[0] = now

    # first the paths' shapes (the table's rows), then stress shapes: a
    # batch 40,000 rows deep with sentinels in f64 and f32, a batch of 4,096
    # entries all on one row, topk_mag at TOPK_STRESS_N, and
    # for vap_accum a bfloat16 delta, an odd length on the vector and the
    # scalar path, and NaN / inf / -0.0 in delta
    apply_shapes, topk_lengths = path_shapes(calls)
    app_shapes, _ = path_shapes(app_calls)
    ingest_shapes, _ = path_shapes({"ps_apply": replica_calls,
                                    "topk_mag": []})
    R, C, _ = apply_shapes[0]
    big = vap_shapes[0]
    cases = {
        "ps_apply": [check_ps_apply(dev, R, C, N, torch.float64, seed, False)
                     for seed, (R, C, N) in enumerate(apply_shapes)]
        + [check_ps_apply(dev, R_, C_, N_, torch.float64, 60 + i, False)
           for i, (R_, C_, N_) in enumerate(app_shapes)]
        + [{"site": "replica ingest",
            **check_ps_apply(dev, R_, C_, N_, torch.float64, 70 + i, False)}
           for i, (R_, C_, N_) in enumerate(ingest_shapes)]
        + [check_ps_apply(dev, R, C, 40_000, torch.float64, 10, True),
           check_ps_apply(dev, R, C, 40_000, torch.float32, 11, True),
           check_ps_apply(dev, R, C, 4_096, torch.float64, 12, False,
                          one_row=True)],
        "topk_mag": check_topk_mags(
            [(n, 20 + i) for i, n in enumerate(topk_lengths)]
            + [(n, 30 + i) for i, n in enumerate(TOPK_STRESS_N)]),
        "vap_accum": [check_vap_accum(dev, shape, torch.float32, 40 + i)
                      for i, shape in enumerate(vap_shapes)]
        + [check_vap_accum(dev, big, torch.bfloat16, 50),
           check_vap_accum(dev, (8_193,), torch.float32, 51),
           check_vap_accum(dev, (8_193,), torch.bfloat16, 52, offset=1),
           check_vap_accum(dev, vap_shapes[-1], torch.float32, 53,
                           special=True),
           check_vap_accum(dev, vap_shapes[-1], torch.bfloat16, 54,
                           special=True)],
    }
    part_done("ps_apply, topk_mag, vap_accum")
    # the LLM kernels: first at the serve path's first call, then stress
    # (rglru_scan: the serve path's first bfloat16 call, then the float32
    # tail's first)
    bf16, f32 = torch.bfloat16, torch.float32
    path_llm = {"flash_attention": []}
    for model, window in FLASH_PATH_CALLS:
        args, kw = first.pop((model, "flash_attention", bf16, window))
        path_llm["flash_attention"].append({
            "call": f"{model} prefill, window {window}",
            **check_flash(dev, *(a.to(dev) for a in args),
                          tol=FLASH_PATH_TOL, **kw)})
        del args
        torch.cuda.empty_cache()
    (x, dt, A, B, C), kw = first[("mamba2-130m", "ssd_scan", bf16, None)]
    path_llm["ssd_scan"] = [check_ssd(dev, x, dt, A, B, C, **kw)]
    path_llm["rglru_scan"] = [
        check_rglru(dev, *(a.to(dev) for a in args), **kw)
        for args, kw in (first[("recurrentgemma-9b", "rglru_scan", bf16,
                                None)],
                         first[("recurrentgemma-9b", "rglru_scan", f32,
                                None)])]
    del first, x, B, C
    torch.cuda.empty_cache()
    part_done("LLM forwards at the paths' calls")
    stress = llm_stress_cases(dev)
    part_done("LLM forwards' stress cases")
    for name, path_cases in path_llm.items():
        cases[name] = path_cases + stress[name]
    # the ssd_scan backward at the train path's first call, then stress;
    # vap_accum at the train path's largest leaf (the embedding, stacked)
    cases["ssd_scan_bwd"] = ([check_ssd_bwd(dev, *first_bwd[0])]
                             + ssd_bwd_stress_cases(dev))
    # the train call's device time by kernel, from the train phase's
    # profiled step (a profile this late in the process loses events)
    cases["ssd_scan_bwd"][0]["device_ms_by_kernel"] = train_line[
        "profiled"]["ssd_scan_backward_ms_per_call_by_name"]
    del first_bwd
    part_done("ssd_scan backward")
    # the rglru_scan backward at the train_rg path's first call in each
    # dtype (the unit's bfloat16, the tail's float32), then stress; the
    # flash_attention backward at its first call, then stress; each first
    # call with its kernels' device time a call from train_rg's profile
    bwd_stress = rglru_bwd_stress_cases(dev)
    cases["rglru_scan_bwd"] = [
        check_rglru_bwd(dev, *a, **kw) for a, kw in (
            first_rg[("rglru_scan_bwd", bf16, None)],
            first_rg[("rglru_scan_bwd", f32, None)])] \
        + bwd_stress["rglru_scan_bwd"]
    part_done("rglru_scan backward")
    a, kw = first_rg[("flash_attention_bwd", bf16, 2048)]
    cases["flash_attention_bwd"] = [{
        "call": "recurrentgemma-9b train, window 2048",
        "launches_per_step": train_rg_line[
            "flash_attention_bwd_per_step_by_window"]["2048"],
        **check_flash_bwd(dev, *a, **kw)}]
    # then the dense, MLA and frontend train paths' first call of each
    # window (Gemma2-9B's windowed and global: G 2, d 256, softcap 50;
    # DeepSeek's MLA: G 1, q / k 192, v 128; Pixtral's G 4 at d 128;
    # MusicGen's G 1 at d 64), each with its launches a step
    for cell in TRAIN_LM_CELLS:
        _, first_lm, lm_line = train_lm[cell.phase]
        for key in [k for k in first_lm if k[0] == "flash_attention_bwd"]:
            a, kw = first_lm.pop(key)
            prof = lm_line["profiled"]
            n_calls = max(prof["launches"]["flash_attention_bwd"], 1)
            cases["flash_attention_bwd"].append({
                "call": f"{cell.arch} train, window {key[2]}",
                "launches_per_step": lm_line[
                    "flash_attention_bwd_per_step_by_window"][str(key[2])],
                **check_flash_bwd(dev, *a, **kw),
                # the phase's profiled step, over all its windows' calls
                "phase_device_ms_per_call_by_kernel": {
                    k: v * 1e3 / n_calls
                    for k, v in prof["backward_by_name"].items()
                    if FLASH_BWD_KERNELS.search(k)}})
            del a, kw
            torch.cuda.empty_cache()
    n_path = len(cases["flash_attention_bwd"])
    part_done("flash_attention backward at the paths' calls")
    cases["flash_attention_bwd"] += flash_bwd_stress_cases(dev)
    part_done("flash_attention backward's stress cases")
    rg_prof = train_rg_line["profiled"]
    n_calls = max(rg_prof["launches"]["flash_attention_bwd"], 1)
    cases["flash_attention_bwd"][0]["device_ms_per_call_by_kernel"] = {
        k: v * 1e3 / n_calls for k, v in rg_prof["backward_by_name"].items()
        if FLASH_BWD_KERNELS.search(k)}
    # the RG-LRU backward's by entry: the profiled step made want_per_step's
    # calls of each, its kernels told apart by their element type
    for case, entry in zip(cases["rglru_scan_bwd"][:2],
                           ("rglru_bwd_bf16", "rglru_bwd_f32")):
        n_calls = max(train_rg_line["want_per_step"][entry], 1)
        bf16_kernels = entry.endswith("bf16")
        case["device_ms_per_call_by_kernel"] = {
            k: v * 1e3 / n_calls
            for k, v in rg_prof["backward_by_name"].items()
            if RGLRU_BWD_KERNELS.search(k)
            and ("__nv_bfloat16" in k) == bf16_kernels}
        case["device_ms_per_call"] = sum(
            case["device_ms_per_call_by_kernel"].values())
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    cases["rglru_scan_bwd"][0]["kernel_attrs"] = rg_ops.bwd_attrs(dev)
    del first_rg
    torch.cuda.empty_cache()
    train_vap = check_vap_accum(dev, (TRAIN_REPLICAS, 50_280, 768),
                                torch.float32, 55)
    # and at the largest leaf of any path: train_pixtral's embedding (its
    # untied head is the same size), one replica
    pixtral_vap = check_vap_accum(dev, (1, 131_072, 5_120), torch.float32, 56,
                                  plain_on_card=True)
    part_done("vap_accum at the train paths' largest leaves")
    linear_recurrence = stress["linear_recurrence"]
    emit({"phase": "kernels",
          "tolerance": "bitwise (0) for ps_apply, topk_mag, vap_accum, "
                       "rglru_scan (its fused entries against the plain "
                       "version on the card, linear_recurrence on CPU "
                       "copies); flash_attention, ssd_scan and the "
                       "backwards per case",
          "path_calls": {**{k: len(v) for k, v in calls.items()},
                         "vap_accum": launches["vap_accum"]},
          "app_calls": {k: len(v) for k, v in app_calls.items()},
          "replica_ingest_calls": len(replica_calls),
          "app_launches": app_launches,
          "rglru_sqrt": check_rglru_sqrt(dev),
          "cases": {**cases, "linear_recurrence": linear_recurrence,
                    "linear_recurrence_bwd":
                        bwd_stress["linear_recurrence_bwd"]}})

    source = {"ps_apply": ("src/repro_torch/kernels/ps_apply/kernel.cu",
                           "src/repro/kernels/ps_apply/kernel.py:47"),
              "topk_mag": ("src/repro_torch/kernels/topk_mag/kernel.cu",
                           "src/repro/kernels/topk_mag/kernel.py:41"),
              "vap_accum": ("src/repro_torch/kernels/vap_accum/kernel.cu",
                            "src/repro/kernels/vap_accum/kernel.py:34"),
              "flash_attention": (
                  "src/repro_torch/kernels/flash_attention/kernel.cu",
                  "src/repro/kernels/flash_attention/kernel.py:86"),
              "ssd_scan": ("src/repro_torch/kernels/ssd_scan/kernel.cu",
                           "src/repro/kernels/ssd_scan/kernel.py:79"),
              "rglru_scan": ("src/repro_torch/kernels/rglru_scan/kernel.cu",
                             "src/repro/kernels/rglru_scan/kernel.py:88"),
              "ssd_scan_bwd": (
                  "src/repro_torch/kernels/ssd_scan/backward.cu",
                  "none: no TPU kernel (the JAX package differentiates "
                  "src/repro/kernels/ssd_scan/ref.py:34 with "
                  "jax.value_and_grad)"),
              "rglru_scan_bwd": (
                  "src/repro_torch/kernels/rglru_scan/backward.cu",
                  "none: no TPU kernel (the JAX package differentiates "
                  "src/repro/kernels/rglru_scan/ref.py:34 with "
                  "jax.value_and_grad)"),
              "flash_attention_bwd": (
                  "src/repro_torch/kernels/flash_attention/backward.cu",
                  "none: no TPU kernel (the JAX package differentiates "
                  "src/repro/models/attention.py:41, attention_core, with "
                  "jax.value_and_grad)")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    table = []
    for name, (src, replaces) in source.items():
        main_case = cases[name][0]          # the main path's shape
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "wire_launches": wire_launches[name],
                      "durable_launches": durable_launches[name],
                      "replicas_launches": replica_launches[name],
                      "replicas_tcp_launches": tcp_launches[name],
                      "elastic_launches": elastic_launches[name],
                      "elastic_autoscale_launches": autoscale_launches[name],
                      "replay_launches": {
                          k: v[name] for k, v in replay_launches.items()},
                      "train_launches": train_launches[name],
                      "train_rg_launches": train_rg_launches[name],
                      **{f"{phase}_launches": lm[0][name]
                         for phase, lm in train_lm.items()},
                      **{k: main_case[k] for k in keys}})
    # vap_accum on the train path: one launch a leaf a step
    table[2]["train"] = {"launches": train_launches["vap_accum"],
                         **{k: train_vap[k] for k in keys}}
    table[2]["train_pixtral"] = {
        "launches": train_lm[TRAIN_PIXTRAL.phase][0]["vap_accum"],
        **{k: pixtral_vap[k] for k in keys + ("plain_on",)}}
    # ps_apply's second call site: replica ingest, at its median call on
    # the full word_topic buffer; launches: the replicas' own in the
    # replicas phase's main run
    ingest = next(c for c in cases["ps_apply"]
                  if c.get("site") == "replica ingest")
    table[0]["replica_ingest"] = {"launches": ingest_launches,
                                  **{k: ingest[k] for k in keys}}
    # the elastic phase's main run, split by call site: the shards' applies
    # (the held next-epoch replay among them) and the replica's ingest
    table[0]["elastic_launches_by_site"] = elastic_by_site
    # rglru_scan's entries: the fused one per dtype at the serve path's
    # calls, the bare recurrence at the serve shape (off the path); launches:
    # each entry's own count over RecurrentGemma-9B's prefill
    rg_launches = serve_lines["recurrentgemma-9b"][
        "rglru_scan_launches_prefill_by_entry"]
    rg_row = next(r for r in table if r["name"] == "rglru_scan")
    rg_row["entries"] = [
        {"entry": case["entry"], "replaces": source["rglru_scan"][1],
         "launches": rg_launches[case["entry"]],
         **{k: case[k] for k in keys}}
        for case in cases["rglru_scan"][:2]] + [
        {"entry": "linear_recurrence_f32",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:51",
         "launches": rg_launches["linear_recurrence_f32"],
         **{k: linear_recurrence[-1][k] for k in keys}}]
    # the entries' launches on the train_rg path
    rg_row["train_rg_launches_by_entry"] = train_rg_line[
        "rglru_scan_by_entry"]
    # the bfloat16 forward at the serve call, also writing its log-sum-exp
    # and residual (the train path's forward)
    fa_row = next(r for r in table if r["name"] == "flash_attention")
    fa_row["ms_with_lse"] = cases["flash_attention"][0]["ms_with_lse"]
    # its serve calls model by model (launches: each window's in the
    # model's prefill), then the stress calls at Qwen3's and OLMoE's
    # attention, which no path launches
    fa_row["launches_by_model"] = {
        m: serve_launches[m]["flash_attention"] for m in SERVE_MODELS
        if serve_launches[m]["flash_attention"]}
    fa_row["calls"] = [
        {"call": case["call"], "launches": serve_lines[model][
            "flash_attention_launches_prefill_by_window"][str(window)],
         **{k: case[k] for k in keys}}
        for (model, window), case in zip(FLASH_PATH_CALLS,
                                         cases["flash_attention"])] + [
        {"call": case["call"], "launches": 0,
         **{k: case[k] for k in keys}}
        for case in cases["flash_attention"] if "stress" in case.get(
            "call", "")]
    # the flash backward's train calls, path by path: each first call of
    # each window, with its launches a step in its phase
    fab_row = next(r for r in table if r["name"] == "flash_attention_bwd")
    fab_row["calls"] = [
        {"call": case["call"],
         "launches_per_step": case["launches_per_step"],
         **{k: case[k] for k in keys + ("tflops", "bound_share")}}
        for case in cases["flash_attention_bwd"][:n_path]]
    # the bare recurrence's backward entry, off the path
    rgb_row = next(r for r in table if r["name"] == "rglru_scan_bwd")
    rgb_row["entries"] = [
        {"entry": "linear_recurrence_bwd_f32", "launches": train_rg_line[
            "rglru_scan_by_entry"]["linear_recurrence_bwd_f32"],
         **{k: bwd_stress["linear_recurrence_bwd"][-1][k] for k in keys}}]
    part_done("the rest and the table")
    walls["kernels"] = time.perf_counter() - t_kernels
    emit({"phase": "walls", "s": walls, "kernels_s": kernels_s,
          "smoke_s": time.perf_counter() - T_START})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
