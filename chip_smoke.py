#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``adapcc_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card: ``nvidia-smi`` name and power limit, device name, compute
   capability (Hopper, 9.0, is required);
2. build the CUDA kernels from ``adapcc_tpu_torch/csrc``, one ``nvcc`` per
   source, all at once (seconds and ptxas lines printed; one line of
   registers and spills a float32 backward kernel, and no spill allowed at
   the main path's padded head dim of 64);
3. hold each flash kernel (forward, dq, dk/dv) against its plain torch
   version on the card, causal and not, in bfloat16 and float32, at the main
   path's shape and a smaller one, then all three (bf16: the wgmma kernels)
   over ``WGMMA_GRID`` (head dims 8 to 128, T = 200, one head), each check
   one counted launch; run the float32 dq and dk/dv twice on the same
   inputs at ``F32_BITS_SHAPES`` and require the same bits (no atomics, no
   order that changes from run to run); time kernel, plain version and, as
   a yardstick only,
   ``torch.nn.functional.scaled_dot_product_attention`` (its backward, one
   call for dq, dk and dv, is the library time of both backward kernels),
   each kernel and sdpa both by CUDA events around back-to-back calls
   (``cuda_ms``) and by device time (``device_ms``: the profiler's kernel
   records, without the gaps in which the device waits for the host);
4. hold each ring kernel (K1a, K1b) against ``_ring_plain`` bit for bit at
   world 2, 4 and 8, float32 and bfloat16, reduce-scatter, all-gather (from
   the full payload and from each rank's own chunk, as the stacked
   all-gather calls it) and both, on a payload under ``chunk_bytes`` (K1a)
   and a ragged one over it whose chunks stream, unpadded, as several tiles
   and a ragged last one (K1b); show that a wedged ring raises and the next
   call is exact; at each kernel's path payload, hold both phases bit for
   bit again and time them against the bound, the plain version, a one-call
   yardstick and the whole stacked dispatch, each by CUDA events and by
   device time;
5. slice 1's main path: ``bench.py``'s GPT-2 (12 layers, d_model 1024, 16
   heads, vocab 16384, T=512, per-rank batch 16, bf16 parameters, flash
   attention) trained 5 steps by ``DDPTrainer`` under ``Strategy.ring(1)``
   with AdamW(3e-4, weight decay 1e-4), world 1 over NCCL, weights from seed
   0; the losses are finite and fall, each flash kernel launched ``n_layer ×
   steps`` times, and the losses agree with the same 5 steps under plain
   ``attention="xla"``; step time, tokens/s, a profile of one more step;
6. the ring engine's entry points (``ring_allreduce``, ``ring_reduce_scatter``,
   ``ring_all_gather``) at world 4 on a 4 MiB (K1a) and a 64 MiB (K1b)
   per-rank payload, against the plain ring;
7. slice 2's main path: the same GPT-2 and weights trained 5 steps by the
   single-controller ZeRO-1 ring step (``zero1_train_step``) at world 4,
   per-rank batch 16: losses finite and falling, one K1b reduce-scatter and
   one K1b all-gather per step, and the per-rank losses within 1e-6 of the
   same 5 steps with ``_ring_plain`` in place of the kernels; step time,
   global tokens/s, and a profile of one more step with the ring's share,
   which must hold no padding copy (``aten::constant_pad_nd``);
8. the fused-codec ring kernels (K5a, K5b) against ``_fused_ring_plain`` bit
   for bit: world 2, 4 and 8, int8 at blocks 128, 256 and 1024 and bf16,
   reduce-scatter (its owned chunks, all that a fused reduce-scatter alone
   returns), all-gather (from the full payload and from each rank's own
   chunk) and both, on a payload under ``chunk_bytes`` (K5a) and a ragged
   one whose chunks stream, unpadded, as whole tiles and a ragged last one
   (K5b); K5a and K5b give the same bits on one input at every staging
   size; a wedged fused ring raises and the next call is exact; a bf16
   payload and ``block_size=384`` are refused;
9. slice 3's main path: the four per-rank float32 gradients of the same
   GPT-2 (world 4, per-rank batch 16) in ZeRO-1's flat layout, 642.6 MiB a
   rank, through ``CollectiveEngine(4, Strategy.ring(4), wire_dtype
   "int8")``: ``ring_allreduce`` (K5b), the same under
   ``ADAPCC_FUSED_WIRE=off`` (the unfused quant ring, with its reroute
   reason), bf16, ``ring_reduce_scatter`` and ``ring_all_gather`` (K5b), and
   a 4 MiB-a-rank allreduce (K5a); every rank's result identical, the int8
   allreduce within ``ring_error_bound`` of the float32 sum and within 4
   ulps of the unfused ring, the bf16 one bit for bit equal to
   ``_fused_ring_plain`` on the same input; each K5 kernel timed against its bound, its
   plain version, K1 on the same payload, the unfused quant ring and the
   stacked dispatch, by CUDA events and by device time (K5b: its
   reduce-scatter and all-gather alone too, each held bit for bit first);
   one profiled engine int8 allreduce must hold no padding copy;
10. training with the codec: the ZeRO-1 ring step with ``wire_dtype="int8"``
   at world 4, 5 steps (one K1b reduce-scatter and all-gather a step; loss
   gap to phase 7), and ``DDPTrainer(grad_compress="int8",
   error_feedback=True)`` at world 1, 5 steps: losses finite and falling,
   step time and tokens/s;
11. slice 8's main path, the engine's strategy-tree ("schedule") plane with
   relay masks: (a) the same GPT-2's bf16 gradients of 8 ranks (one token
   shard each), bucketed by ``build_bucket_plan`` at the hook's 100 MB cap
   in the flax leaf order and layout, each bucket stacked ``[8, n]`` and
   averaged by ``CollectiveEngine(8, 4-4_1.xml).all_reduce(active_gpus=all
   but rank 3, op=AVG)``, the two-host strategy with one straggler, on its
   merged plan (7 reduce and 5 broadcast groups): every row identical, the
   relay's too, the first and the largest bucket bit for bit equal to the
   same call on CPU copies, every bucket within 8 bf16 roundings of a
   float64 masked mean, the trace naming ``schedule`` merged; (b) phase 9's
   float32 gradients (world 4) through ``Strategy.ring(4, 4)`` (merged),
   ``Strategy.binary(4, 2)`` and ``4.xml`` (one tree): SUM unmasked on the
   schedule plane, AVG with rank 2 a relay, MAX, ``reduce`` and
   ``broadcast``, each held bit for bit against the CPU run of the same call
   on a bucket-sized slice; (a) and (b) time each dispatch by CUDA events
   and device time, with its launches, beside a one-call plain reduction
   (and K1b's RS+AG for the ring); (c) ``DDPTrainer(sync_mode="schedule")``
   at world 1, 5 steps from phase 5's weights and batch: losses bit for bit
   phase 5's.  The flash kernels' launches are counted over (a) and (c).
12. slice 9's main path, the façade, the Communicator's bootstrap and the
   coordinator: (a) ``AdapCC.init`` with ``entry_point=DETECT`` at world 8
   on the card in a temporary topology directory (detect, the offset-probe
   profile timed by CUDA events, par-trees synthesis; the probe matrices'
   ranges and the strategy printed), then ``setup(ALLREDUCE)`` and an AVG
   ``allreduce`` of phase 11a's eight bf16 gradients with rank 3 a relay:
   every row identical, bucket 0 bit for bit the same call on a CPU
   communicator over the same strategy file; (b) ``CoordinatorLogic``
   (default constants) behind a ``WaitTimeProbe`` with 8 emulated
   participants, rank 3 slow: its frozen active lists drive the façade
   allreduce; then a controller barrier with rank 5 silent under a 0.3 s
   fault timeout gives status 0 and the alive set, and the allreduce goes
   on over it; (c) ``DDPTrainer(communicator=comm)`` at world 1, 5 steps
   from phase 5's weights and batch, each step's mask negotiated through
   the gRPC coordinator (where ``grpc`` imports): losses bit for bit phase
   5's, the masks and the negotiation round-trips printed.  No TPU kernel is
   on the façade's or the coordinator's own path; 12c launches the flash
   kernels ``n_layer × steps`` times each.
13. slice 10's main path, gradient accumulation, the overlapped syncs,
   ZeRO-1 without the ring and checkpoints, from phase 5's weights and
   batches, 5 steps each: (a) ``DDPTrainer(accum_steps=4)`` at world 1 (4
   rows a microbatch): losses finite, falling and within ``LOSS_ATOL`` of
   phase 5's, each flash kernel ``n_layer × 4 × 5`` times, step time, a
   profile of one more step, and the device time of the float32
   accumulation against its bound; (b) the same with
   ``overlap="microbatch"``: losses bit for bit (a)'s (or, failing that,
   within the JAX package's bound, and said so), and from a profiler trace
   of one step the device records on each stream but the compute stream,
   with the share of their time beside compute-stream records; (c)
   ``overlap="bucket"`` without accumulation, on the psum plane and with
   ``sync_mode="schedule"``: losses bit for bit phase 5's and 11c's, the
   chunk collectives a step (counted) equal to the bucket plan's; (d) ZeRO-1
   with ``ring=False`` (JAX's default layout) at world 4, overlap off and
   ``"bucket"``: bit for bit each other, within ``ZERO1_LAYOUT_LOSS_ATOL``
   of phase 7's ring losses, no ring kernel launched; (e) ZeRO-1 on the
   ring: 2 steps, ``CheckpointManager.save``, a fresh model and optimizer
   restored from it on the card, 3 more steps: losses bit for bit phase 7's;
   the checkpoint refused by a non-ring optimizer, and (d)'s non-ring state
   by a ring one; save and restore seconds and bytes.  Phase 13's flash and
   K1b launches are counted into the kernels line.
14. slice 11's main path, the plan tuner, on databases in a temporary
   directory: (a) ``CollectiveEngine(4, ring(4), tuner=choose)``
   on a 4 MiB-a-rank payload (K1a/K5a, and K1b/K5b at small chunks) and on
   phase 9's 642.6 MiB gradients (K1b/K5b), dispatched until every cell of
   ``candidates("allreduce", algos=("ring",))`` holds its trial budget
   (``TUNER_DISPATCH_CAP``), each cell's first dispatch bit for bit its
   plain version; each cell's samples, median and prior, the choice, its
   source and the incumbent; the database saved and reloaded ranks the
   same plan; (b) ``DDPTrainer(tune=True, tune_every=2)`` on phase 5's
   GPT-2, weights and batch, 12 steps, on a database seeded with every
   cell at its trial budget and hook-bucket/bf16 fastest: each step's cell
   and walltime, each adoption; losses finite, every cell a candidate, the
   winner adopted after step 2 (codec and overlap rewritten on the hook),
   step 3 runs it as a new configuration whose first step is discarded,
   one sample a step but each configuration's first; (c) ``Zero1Optimizer(ring=True,
   tuner=choose)`` at world 4, 3 steps: the chunk in the grid, losses bit
   for bit phase 7's; (d) ``timed_roundtrip`` int8 and bf16 on one rank's
   642.6 MiB and a 4-byte-a-rank ``ring_allreduce``: the codec rate and α
   the cost model's defaults take, and record mode's cost on a 4 MiB
   dispatch.  Phase 14's launches are counted into the kernels line.
15. slice 12's main path, the latency plane, the two-level plane and the
   ``hier`` and ``milp`` policies: (a) ``CollectiveEngine(w, ring(w))`` at
   worlds 4 and 8, float32, 4 B to 4 MiB a rank: ``all_reduce`` pinned to
   ``rd`` and ``tree``, the psum plane (``torch_fused``) and
   ``ring_allreduce`` (K1a), each bit for bit the plain sum on
   integer-valued data and within ``(world - 1)·2⁻²⁴`` of Σ|x| of the
   float64 sum on random data, each by events, device time, launches and
   the median walltime of a synced dispatch, beside the bound (the stacked
   tensor read and written once); what ``auto`` picks at each size against
   the cost model's crossover at the card's defaults; rd and tree with rank
   3 a relay (AVG) bit for bit the plain masked mean on every row; rd at
   world 6 refused with the JAX engine's words; (b) every leaf of phase
   11a's world-8 bf16 gradients through ``all_reduce(algo="auto", op=AVG)``:
   the leaves and bytes each plane took, the pass's device time, launches
   and walltime against the same leaves on the psum plane, each leaf within
   ``SCHEDULE_BF16_TOL`` of the float64 mean; (c) a choosing
   ``CollectiveEngine(8, ring(8))`` on a fresh database at 4 KiB and 4 MiB a
   rank, dispatched until every cell of the full grid (rd and tree included)
   holds its trial budget, each cell's first dispatch bit for bit its plain
   version, the choice and its source; (d) phase 11a's gradients on the
   world as 2 slices × 4, rank 3 a relay (AVG): the projected schedule of
   ``4-4_1.xml`` and the composed plan the ``hier`` policy synthesizes, bit
   for bit the plain masked mean on integer-valued bf16 data and within
   ``SCHEDULE_BF16_TOL`` on the gradients, by device time and launches
   against phase 11a and the bound; (e) ``AdapCC.init`` on that two-level
   world with ``policy="hier"`` and one relayed allreduce of the buckets,
   then ``policy="milp"`` on a two-host world-8 profile: the solve's
   seconds, the trees, one relayed allreduce.  Phase 15's launches (K1a
   from (a) and (c), K1b, K5a and K5b from (c)) are counted into the
   kernels line.
16. slice 13's main path, the schedule compiler's IR plane through
   ``all_reduce(algo="ir")``, each program naive (``ADAPCC_IR_OPT=off``) and
   optimized: (a) phase 11a's world-8 bf16 gradients, rank 3 a relay (AVG):
   the IR ring bit for bit the merged plane on ``Strategy.ring(8, 8)``
   (where the world divides a bucket; chunk boundaries differ elsewhere), IR
   rd and tree bit for bit ``algo="rd"``/``"tree"``, ``program_from_strategy``
   on ``4-4_1.xml`` and the pipelined bidirectional ring against the plain
   masked mean, the two-level program on 2 slices × 4 against the composed
   plan (bit for bit on integer-valued data, within ``SCHEDULE_BF16_TOL`` on
   the gradients where the order of adds differs), each by device time,
   launches and synced walltime against the bound (the stacked tensor read
   and written once), its plane and phase 11a; (b) float32 at world 8, 4 KiB
   and 4 MiB a rank, unmasked: naive and optimized bit for bit, ring, rd
   and tree bit for bit their planes, each program's static dispatches
   beside its times, rd coalesced to one dispatch a round; (c) the fused
   int8 ring bit for bit its unfused form, with the wire bytes of a run
   against float32's; (d) a recording tuner fills the ``ir`` and ``ir-opt``
   cells, which join a grid that names "ir" and no default grid.  No kernel
   lies on this path: phase 16 launches none, and fails if it does.
17. slice 14's main path, elastic failover and the supervisor on phase 11a's
   world-8 bf16 gradients over ``4-4_1.xml``: (a) ``StandbyPlanCache.build``
   ranks the 10 shrink scenarios (8 one-rank-down, 2 one-host-down) on the
   cost model's H100 defaults (labels, shapes, predicted seconds, the build's
   host seconds), and ``warm`` prepares the top 4 on every bucket's shape;
   (b) a ``Supervisor`` over ``CoordinatorLogic(8, fault_plan=...)`` on an
   injected clock drives an 8-step fault plan (rank 3 slow throughout, a
   warmed plan's rank down from step 2 to 5, an unwarmed plan's rank down
   from step 6): each step a poll, then an AVG ``all_reduce`` of every bucket
   under ``current_mask()`` and the supervisor's engine epoch, printing the
   epochs, mask, plan, ``cache_hit``, device ms and synced walltime; the
   warmed failover and the recovery are cache hits, the cold failover a
   miss, every row identical, bucket 0 bit for bit its CPU run, every bucket
   within ``SCHEDULE_BF16_TOL`` of the float64 masked mean, and a dispatch
   at the pre-swap epoch raises; (c) a second ``Supervisor`` on the same
   journal resumes to an equal WorldView with no epoch bump, and an fsync'd
   append is timed; (d) ``simulate_fault_plan`` of the same plan beside the
   measured walltimes; (e) the supervised ``DDPTrainer(sync_mode="schedule",
   bsp=False)`` at world 1, 5 steps: losses bit for bit phase 11c's, then
   ``prewarm`` (state bit for bit unchanged), ``adopt_strategy`` True and no
   new build generation (K2–K4 counted into the kernels line); (f)
   ``AdapCC.init(policy="sim-rank")`` at world 8, its winner and synthesis
   seconds, and one relayed allreduce of the buckets, bucket 0 bit for bit
   its CPU run.
18. slice 15's main path, the online adaptation loop: (a) a recording
   tuner on the world-8 engine over ``4-4_1.xml`` times a full drift window
   of phase 11a's bf16 buckets (unmasked: the tuner times the flat path,
   never a relayed schedule dispatch, JAX's rule) and of the ring plane's
   allreduce of phase 9's gradients at world 8 (float32 on K1b, int8 on
   K5b, each first dispatch bit for bit its plain walk); every signal of
   that window is printed against the H100 defaults and against the
   bootstrap's calibration from the card's offset probes (``topo_profile``
   through ``calibrate_from_profile_dir``), the window's float32 medians
   calibrate the model through the battery funnel
   (``calibrate_from_battery``), and ``AdaptationController(mode="swap")``
   over that calibration reads a second, fresh window without a swap; (b) JAX's
   degradation drill (the JAX package's default classes on 4 hosts × 2,
   the inter-host class 10× slower at 1 MiB) on a ring(8) engine: it fires
   within one window, re-calibrates (the temporary ``calibration.json``
   stamped ``drift-recal``), re-ranks, passes the hysteresis gate and swaps
   through the standby cache; the first dispatch after it (bucket 0, rank 3
   a relay) is a cache hit at epoch +1, rows identical and bit for bit its
   CPU run, timed against the incumbent's; (c) JAX's congestion drill under
   ``Supervisor(adapt=ctl, adapt_every=1)`` with a seeded inter-host
   ``CongestionProfile``: triage says congestion, the re-route swaps under
   the contended model with the calibration byte for byte unchanged, only
   the transitions are journaled, and the restore is a cache hit; (d)
   ``DDPTrainer(sync_mode="schedule")`` at world 1, 6 steps under a
   controller (``trainer=``, ``trainer_prewarm=``) fed each step time:
   losses bit for bit phase 11c's, a step-time drift reported
   ``uninvertible`` with no swap, the host ms the loop adds a step, K2–K4
   72 launches each; (e) ``SharedFabric`` plans two jobs on the H100
   defaults, ``solve_broadcast_lp`` and ``simulate_flow_broadcast`` run on
   the 8-rank graph, and a ``VariabilityMonitor`` samples the card's offset
   probe for ``VARIABILITY_S`` seconds.
19. slice 16's main path, ZeRO-1's elastic state and the memory-lean GPT-2:
   (a) ``DDPTrainer(zero1=True)`` at world 1 over NCCL, 5 steps from phase
   5's weights and batch: the first loss bit for bit phase 5's, the rest
   within ``LOSS_ATOL`` (phase 5 updates bf16 parameters with torch's
   AdamW, this run a float32 master cast to bf16: at most a bf16 rounding
   of each parameter a step apart), K2–K4 60 launches each, step ms,
   tokens/s and peak allocated bytes; ``shard_replicas=1`` refused at world
   1 (the message printed); (b) the memory-lean configuration on that
   trainer, remat ``"full"`` and ``"dots"`` with ``lm_loss_chunked(block=
   LEAN_BLOCK)`` and ``adamw(mu_dtype=bfloat16)``: losses within
   ``LEAN_LOSS_REL`` of 19a's and the two policies bit for bit alike, step ms
   and peak memory against 19a, K2 120 launches and K3, K4 60 (the
   recomputation runs the flash forward again: its kernels are no matrix
   product a policy keeps); one run at dropout 0.1 twice from one
   generator seed: the same losses, no flash launch (materialized
   attention); (c) ``AsyncCheckpointManager(max_to_keep=2)`` in a temporary
   directory: ``save_async`` after steps 3 and 4 of 19b's ``"dots"`` run
   (its losses bit for bit), ``wait``, ``verify``, the host stall of each
   ``save_async`` against a synchronous ``save`` and the bytes; a fresh
   trainer restores step 4 and its next loss is the uninterrupted run's bit
   for bit; a bit-flipped copy raises ``CheckpointCorrupt``; (d) the
   stacked ZeRO-1 at world 4 (phase 7's ``zero1_train_step``, ring on K1b
   and off): 2 steps, a ``ShardReplicaStore`` capture, row 1's master and
   moments zeroed and repaired bit for bit, a re-balance 4 → 2 → 4 that
   gives the canonical flat master and moments back bit for bit (host
   seconds and bytes printed, and the cost model's recovery prices for this
   payload, labelled model output); and on a float32 copy of the model
   (JAX's setting) on the ring, 2 steps, then 2 more uninterrupted against
   2 after a shrink to world 2: the masters within JAX's
   convergence-equivalence tolerance (``SHRINK_RTOL``, ``SHRINK_ATOL``), the
   key biases, whose true gradient is zero, within Adam's 2·lr a step.
20. slice 17's main path, sequence parallelism on the flash kernels'
   ``lse`` path: (a) K2, K3 and K4 against their plain versions under
   ``TOLERANCE`` with a random ``lse`` cotangent folded into ``delta``, at
   the ring's blocks ``[256, 512, 64]`` bf16 causal and not and at
   Ulysses' ``[64, 2048, 64]`` causal, each timed by device time against
   its bound and sdpa's at the same shape; (b) the stacked ring at world
   ``SP_WORLD`` (flash blocks) on q/k/v ``[16, 2048, 16, 64]`` bf16: output
   and gradients against one flash over the whole sequence within the bf16
   bound ``sp_attention`` derives, each kernel launched ``SP_WORLD`` times
   (one diagonal launch over every rank, one full launch a later step);
   (c) Ulysses the same, one launch of each kernel; (d)
   ``gpt2_sp_train_step`` stacked at world 4, ring then Ulysses, 5 steps of
   MAIN's widths at ``max_seq = 2048`` (T_local 512, weights from seed 0,
   a ``[16, 2048]`` batch): losses within ``LOSS_ATOL`` of ``DDPTrainer``
   at world 1 on the unsharded batch, K2–K4 ``n_layer × 4 × 5`` launches
   each on the ring and ``n_layer × 5`` on Ulysses, no ring kernel, step ms
   and peak memory, the ring step profiled; (e) DP × SP (data 2 × sp 2) at
   depth 2, 3 steps, against the unsharded run.
21. slice 18's main path, the pipeline-parallel plane and expert
   parallelism: (a) K2, K3 and K4 against their plain versions under
   ``TOLERANCE`` at a pipeline microbatch's shape ``[64, 512, 64]`` bf16
   causal, timed by device time against their bounds and sdpa; MAIN split
   by ``partition_gpt2`` into ``PIPE_STAGES`` stages stacked on the card,
   the composed microbatched baseline (``composed_loss``) from the seed-0
   weights, then ``PIPE_STEPS`` AdamW steps of ``PipelineExecutor`` over
   the ``[16, 512]`` batch in ``PIPE_MICROBATCHES`` microbatches, GPipe and
   then 1F1B, each step with ``sync_tied_embedding``: each flash kernel
   ``n_layer × PIPE_MICROBATCHES`` launches a step, the first step's loss
   and gradients bit for bit the baseline's, GPipe's losses and first
   gradients bit for bit 1F1B's, losses finite, falling and within
   ``LOSS_ATOL`` of ``DDPTrainer``'s at world 1 on the same batch; hops
   against ``program.total_sends()``, stash peaks against
   ``pipeline_stash_bytes``, the bubble and ``pipeline_step_time`` beside
   step ms, tokens/s and peak memory; (b) ``expert_parallel_moe`` at
   ``MoEConfig()``'s widths (8 experts, d_model 256, d_hidden 1024, top-2,
   bf16), EP world ``MOE_WORLD`` stacked, engine-routed, over the main
   batch's 8,192 tokens: forward and backward against the dense ``MoEMLP``
   at a capacity where nothing drops (``EP_ATOL``), the forward + backward
   ms at the config's capacity, the exchange's device ms against its
   bytes' bound; ``train_moe`` at those widths trains (losses falling) and,
   under ``ADAPCC_TUNER=record``, infers and prints its ``[tuner]
   all_to_all`` line.
22. slice 19's main path, serving: (a) ``serve_gpt2``'s float32 GPT-2 at
   MAIN's widths (``SERVE_MAIN``: 12 layers, d_model 1024, 16 heads, vocab
   16384, max_seq 512; weights from seed 0), its ``TPDecodeModel`` at world
   ``SERVE_WORLD`` stacked × ``SERVE_SLOTS`` slots held teacher-forced
   against the model's own decode row by row, logits bit for bit; the
   ``SlotKVCache`` pages' allocation against ``nbytes_per_rank``;
   ``GPT2Server`` over ``SERVE_TRACE`` (32 Poisson requests, prompts of
   8-64 tokens, 16-64 new ones, ``temperature=1, top_k=50``) under ``auto``
   and under ``ring``, the decode collectives' histograms, equal streams,
   and the first ``SERVE_ALONE`` requests each equal to its own
   ``generate`` run alone; decode step p50/p99 ms (synced walltime),
   tokens/s, TTFT and sojourn percentiles in steps, peak memory, the
   engine-free step's compute a layer against ``decode_step_time``'s price
   and what ``auto`` picks on the card's coefficients; (b)
   ``ClusterRouter`` with two world-``DISAGG_WORLD`` pods of
   ``DISAGG_SLOTS`` slots on the same trace, off wire, the decode pod
   killed once mid-run: every stream (the victims' too) bit for bit
   22a's, one ``kv_transfer`` event a migration, each migration's ms; the
   int8 wire's token KL at full width, its admission under
   ``ADAPCC_KV_KL_BOUND``, and served on ``DISAGG_INT8_REQUESTS`` requests
   its wire bytes under the payload's and each migration's ms against the
   codec pass's bound; (c) ``serve_gpt2 --json`` end to end, its summary
   parsed, and ``--trace-out`` replayed through ``ADAPCC_SERVE_TRACE``
   giving the same request rows byte for byte.  No kernel of the kernels
   line is on this path: the phase launches none of them.
23. slice 20's main path, the training workloads: (a) ``train_gpt2.run``
   with ``GPT2_WORKLOAD_ARGV`` (MAIN's widths, float32 as JAX trains,
   ``--attn flash``: the float32 K2–K4, one epoch of the default corpus,
   ``--sample``): validation perplexity before and after (lower after),
   hits@1, losses finite and falling, step ms and tokens/s over the epoch
   (synced at its ends), peak memory, the sample; K2, K3 and K4 launched
   as often as the code says (a layer a step, K2 a layer a held-out or
   hits@1 forward too); the first step's loss against plain float32
   attention within ``GPT2_F32_LOSS_ATOL``; then the float32 K2–K4 alone at
   ``GPT2_F32_SHAPE`` against their plain versions, by device time and
   events against the plain version, the bound (67 TFLOP/s float32) and
   float32 sdpa (recorded under ``float32`` in the kernels line); (b) every
   ``train_ddp`` preset under ddp, zero1 and fsdp at world 1,
   ``DDP_PRESET_STEPS`` steps at ``DDP_PRESET_LR``, logged losses finite
   and falling; (c)
   ResNet-50 v1.5 (ImageNet stem, 224x224, 1000 classes, batch 64) under
   group and batch norm and ViT-S/16 (batch 128), bf16, through
   ``DDPTrainer`` at world 1: step ms, images/s, peak; (d)
   ``accuracy_benchmark`` at its defaults (recorded: VGG11 stays at chance
   in 3 epochs, as on JAX) and with ``ACCURACY_LEARNS`` (top-1 above 5×
   chance by the last epoch), and ``main_elastic --supervise --model
   resnet18 --norm batch --deterministic`` crashed after epoch 1: the
   worker restarts, resumes at epoch 2, and its final parameters and SyncBN
   statistics equal an uninterrupted run's bit for bit
   (``ELASTIC_PARAM_TOL`` and ``ELASTIC_STATS_TOL`` are 0); (e) the GNS estimator's arithmetic on the card on
   stacked gradients (``GNS_WORLD`` ranks of the ResNet-18 preset), the
   norms within ``GNS_RTOL`` of float64 host sums.

The world-4 ring on one card stands in for NVLink only in its protocol and
its device-memory traffic.  The last lines are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from adapcc_tpu_torch import compiler
from adapcc_tpu_torch.adapt import AdaptationController, DriftDetector, SharedFabric, resolve_drift_window
from adapcc_tpu_torch.api import AdapCC
from adapcc_tpu_torch.checkpoint import (
    BLOB_NAME, AsyncCheckpointManager, CheckpointCorrupt, CheckpointManager, TrainCheckpointState,
)
from adapcc_tpu_torch.comm import engine as comm_engine
from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.comm.engine import CollectiveEngine, _merged_plan
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world, mesh_ip_table
from adapcc_tpu_torch.communicator import Communicator
from adapcc_tpu_torch.compiler import lower as ir_lower
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.coordinator import CoordinatorLogic
from adapcc_tpu_torch.ddp.bucketing import build_bucket_plan, flatten_to_buckets
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adam, adamw
from adapcc_tpu_torch.elastic import FaultEvent, FaultPlan, ShardReplicaStore, StandbyPlanCache
from adapcc_tpu_torch.elastic import rebalance
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss, lm_loss_chunked
from adapcc_tpu_torch.models.gpt2_generate import generate
from adapcc_tpu_torch.models.moe import MoEConfig, MoEMLP
from adapcc_tpu_torch.measure import WaitTimeProbe, emulate_heterogeneous_steps
from adapcc_tpu_torch.ops import _build
from adapcc_tpu_torch.ops import flash_attention as fa
from adapcc_tpu_torch.parallel.axis import Mesh
from adapcc_tpu_torch.parallel.expert import expert_parallel_moe, moe_capacity
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, _flatten, _flatten_meta, zero1_train_step
from adapcc_tpu_torch.parallel.gpt2_sp import gpt2_sp_train_step
from adapcc_tpu_torch.parallel.ring_attention import ring_attention
from adapcc_tpu_torch.parallel.ulysses import ulysses_attention
from adapcc_tpu_torch.pipe import (
    PipelineExecutor, composed_loss, partition_gpt2, pipeline_schedule, split_params, stage_forward,
    sync_tied_embedding,
)
from adapcc_tpu_torch.primitives import ALLREDUCE, DETECT, PROFILE, SKIP_BOOTSTRAP, ReduceOp
from adapcc_tpu_torch.quant import get_codec, ring_error_bound, timed_roundtrip, wire_ring_allreduce_stacked
from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE
from adapcc_tpu_torch.serve import (
    SERVE_TRACE_ENV, ClusterRouter, GPT2Server, SlotKVCache, TPDecodeModel, measure_token_kl, resolve_kv_kl_bound,
    synthesize_arrival_trace,
)
from adapcc_tpu_torch.sim import (
    CongestionProfile, calibrate_from_battery, calibrate_from_profile_dir, cost_model, load_or_default,
    simulate_fault_plan, simulate_flow_broadcast,
)
from adapcc_tpu_torch.strategy import hierarchy
from adapcc_tpu_torch.strategy.flow_lp import solve_broadcast_lp
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.synthesizer import Synthesizer
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml, parse_strategy_xml, write_ip_table
from adapcc_tpu_torch.supervisor import DecisionJournal, LivenessConfig, Supervisor
from adapcc_tpu_torch.topology.profile import NetworkProfiler, gather_topo_profile
from adapcc_tpu_torch.topology.variability import VariabilityMonitor, detect_drift, load_trace
from adapcc_tpu_torch.tuner import (
    CollectiveTuner, TuningDatabase, TuningKey, TuningPolicy, mesh_fingerprint, size_bucket, topology_fingerprint,
)
from adapcc_tpu_torch.tuner import measure as tuner_measure
from adapcc_tpu_torch.tuner.policy import (
    ALGO_PATHS, DEFAULT_CHUNK_GRID, IR_OPT_PATH, IR_PATH, NO_CHUNK, QUANT_PATH, hook_overlap_of, hook_path,
)
from adapcc_tpu_torch.utils.observability import CollectiveTrace, MetricsRegistry
from adapcc_tpu_torch.data import device_batches
from adapcc_tpu_torch.measure.gns import GNSEstimator, stacked_grad_sq_norms
from adapcc_tpu_torch.models.resnet import ResNet50
from adapcc_tpu_torch.models.vit import ViT, ViTConfig
from adapcc_tpu_torch.workloads import accuracy_benchmark, train_ddp, train_gpt2

# the main path: bench.py's configuration (bench.py:366-385, per-rank batch 16)
MAIN = GPT2Config(
    vocab_size=16384, max_seq=512, n_layer=12, n_head=16, d_model=1024,
    dtype=torch.bfloat16, attention="flash", flash_block=256,
)
BATCH = 16
STEPS = 5
SEED = 0
#: the ZeRO-1 ring path's world (its ranks' rows all on this card)
ZERO1_WORLD = 4
#: per-rank payloads of the engine path: 4 MiB is the largest that stays
#: one stage per chunk at the default 4 MiB chunk_bytes (K1a), 64 MiB streams
ENGINE_ELEMS = {"ring_k1a": (4 << 20) // 4, "ring_k1b": (64 << 20) // 4}
#: the ZeRO-1 ring path against its plain-ring run, per-rank losses
ZERO1_LOSS_ATOL = 1e-6

#: phase 3's wider grid for K2, K3 and K4, (B, T, H, D): head dims on one
#: 64-column TMA box and on two, with and without columns past D (8 to
#: 128); T = 200, which no tile divides; one head (B·H = 1) and several; one
#: row; one row past a tile
WGMMA_GRID = [(1, 200, 1, d) for d in (8, 32, 40, 64, 96, 128)] + [
    (3, 200, 2, 64), (2, 512, 4, 128), (1, 1, 1, 64), (1, 65, 1, 64)]
#: phase 3's run-to-run bit identity of the float32 dq and dk/dv, (B, T, H,
#: D): the main path's shape and a ragged T at each padded head dim
F32_BITS_SHAPES = [(BATCH, MAIN.max_seq, MAIN.n_head, MAIN.d_model // MAIN.n_head),
                   (1, 200, 1, 32), (3, 200, 2, 64), (1, 200, 1, 128)]

# kernel vs plain: float32 differs only in summation order; a bf16 output is
# one float32 result rounded once by each side, so two bf16 ulps (2**-7
# relative) bound the gap, plus an absolute floor for values near zero
TOLERANCE = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
# flash vs xla attention on the main path, per step: the two paths round
# attention to bf16 at different points (xla rounds scores and
# probabilities, flash keeps float32 inside the kernel), about 2**-8 relative
# on each attention output; through 12 layers and 5 AdamW steps that moves
# the float32 loss by far less than 0.5% of its starting value ln(16384)
LOSS_ATOL = 0.05

# H100 SXM peaks (data sheet, dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SOURCES = ("flash_attention", "ring")
#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": ("adapcc_tpu_torch/csrc/flash_attention.cu", "adapcc_tpu/ops/flash_attention.py:60"),
    "flash_dq": ("adapcc_tpu_torch/csrc/flash_attention.cu", "adapcc_tpu/ops/flash_attention.py:92"),
    "flash_dkv": ("adapcc_tpu_torch/csrc/flash_attention.cu", "adapcc_tpu/ops/flash_attention.py:124"),
    "ring_k1a": ("adapcc_tpu_torch/csrc/ring.cu", "adapcc_tpu/comm/pallas_ring.py:428"),
    "ring_k1b": ("adapcc_tpu_torch/csrc/ring.cu", "adapcc_tpu/comm/pallas_ring.py:510"),
    "ring_k5a": ("adapcc_tpu_torch/csrc/ring.cu", "adapcc_tpu/comm/pallas_ring.py:735"),
    "ring_k5b": ("adapcc_tpu_torch/csrc/ring.cu", "adapcc_tpu/comm/pallas_ring.py:865"),
}
#: the fused ring checks' codecs: (wire_dtype, block_size)
FUSED_CODECS = (("int8", 128), ("int8", 256), ("int8", 1024), ("bf16", None))
#: the int8 allreduce against the unfused quant ring: the reference's
#: documented contraction headroom between its two data planes
FUSED_ULPS = 4
#: phase 11: the two-host world-8 strategy, rank 3 a straggler (a relay)
SCHEDULE_WORLD = 8
SCHEDULE_XML = "tests/fixtures/strategy/4-4_1.xml"
SCHEDULE_ACTIVE = [0, 1, 2, 4, 5, 6, 7]
#: its merged plan's groups, as the JAX package computes them
SCHEDULE_GROUPS = (7, 5)
#: the hook's bucket cap (GradSyncHook's bucket_cap_mb default)
BUCKET_CAP_MB = 100.0
#: a bf16 relay-masked AVG against the float64 mean: 7 adds and one division,
#: each rounding at most 2**-8 of a partial sum bounded by sum |x|, so at most
#: 8 * 2**-8 = 2**-5 of mean |x| over the active ranks
SCHEDULE_BF16_TOL = 2.0 ** -5
#: a float32 sum of 4 against float64: 3 adds, each at most 2**-24 of sum |x|
SCHEDULE_F32_TOL = 4 * 2.0 ** -24
#: phase 12: the straggler the coordinator demotes, the participant that
#: goes silent at the controller barrier, and that barrier's fault timeout
FACADE_SLOW = 3
FACADE_SILENT = 5
FACADE_FAULT_TIMEOUT_S = 0.3
#: phase 13: microbatches a step (BATCH / ACCUM rows each)
ACCUM = 4
#: the JAX package's bound on the microbatch pipeline's reordered float32
#: adds (tests/test_overlap.py), for where the bits do not hold
MICROBATCH_RTOL = 2e-5
MICROBATCH_ATOL = 1e-6
#: ZeRO-1 without the ring against phase 7's ring losses: the same function,
#: but the 4 contributions of each gradient element are added in another
#: order (a float32 rounding or two), which Adam can magnify to about lr in
#: an element whose gradient nearly cancels, and which then moves a bf16
#: parameter by a rounding or not; over 5 steps that moves the loss (about
#: 9.7) far less than 1e-2
ZERO1_LAYOUT_LOSS_ATOL = 1e-2
#: phase 14(a): dispatches a payload may take to fill every cell's budget
#: (each cell needs its budget and one warmup; the explorer fills the least
#: sampled cell a quarter of the time)
TUNER_DISPATCH_CAP = 1500
#: phase 14(b): tuned DDP steps and the policy's re-choice period
TUNE_STEPS = 12
TUNE_EVERY = 2
#: phase 14(b)'s seeded database: every ddp_step cell at the policy's trial
#: budget, the winner (``TUNE_WINNER``: codec and overlap both other than the
#: prior's incumbent, hook/off) far faster than the rest, so the first
#: re-choice adopts it and the adoption path runs on the card
TUNE_WINNER = ("bucket", "bf16")
TUNE_SEED_S = {True: 1e-3, False: 1.0}
#: phase 14(c): ZeRO-1 steps under the tuned chunk
TUNED_ZERO1_STEPS = 3
#: phase 14(d): codec round trips and 4-byte dispatches timed
CODEC_ITERS = 5
ALPHA_ITERS = 50
#: phase 15(a): the latency plane's worlds and per-rank payloads (bytes),
#: the relay of its relay check, and the trace impl each arm must show
LATENCY_WORLDS = (4, 8)
LATENCY_BYTES = (4, 4 << 10, 64 << 10, 1 << 20, 4 << 20)
LATENCY_RELAY = 3
LATENCY_IMPLS = {"rd": "rd", "tree": "tree", "psum": "torch_fused", "ring": "cuda_ring[vmem]"}
#: the refusal of rd at world 6, word for word the JAX engine's
RD_WORLD6_REFUSAL = (
    "allreduce algo='rd' cannot run here: recursive doubling pairs ranks by XOR and needs a power-of-two world, "
    "got 6; the cost model prices the fold-in, the data plane rejects it")
#: synced dispatches a walltime median is taken over, and profiled calls
SYNCED_ITERS = 10
PHASE15_ITERS = 5
#: 15(d)-(e): the two-level layout of the world-8 gradients
TWO_LEVEL_SLICES = 2
#: 15(e): the two-host ip table of the milp policy's world-8 profile
MILP_IPS = ["h0"] * 4 + ["h1"] * 4
#: phase 16: the IR plane's float32 payloads at world 8 (bytes a rank), and
#: the calls a timing takes
IR_BYTES = (4 << 10, 4 << 20)
PHASE16_ITERS = 3
#: phase 17: the supervised failover's fault plan over ``FAILOVER_STEPS``
#: steps: rank ``SCHEDULE_ACTIVE``'s relay (3) slow throughout, a warmed
#: one-rank-down plan's rank down at ``FAILOVER_DOWN[0]`` and back at
#: ``FAILOVER_DOWN[1]``, a built but unwarmed plan's rank down at
#: ``FAILOVER_COLD_STEP``; the top ``FAILOVER_WARM_K`` plans are warmed
FAILOVER_STEPS = 8
FAILOVER_SLOW = 3
FAILOVER_DOWN = (2, 5)
FAILOVER_COLD_STEP = 6
FAILOVER_WARM_K = 4
#: fsync'd journal appends a timing takes
JOURNAL_APPENDS = 20
#: phase 18: JAX's drills (tests/test_adapt.py, test_fabric.py) on 4 hosts
#: of 2 ranks; 18b's payload and degradation, 18c's payload and seeded
#: congestion profile (one inter-host window of 4 steps in 16), 18d's steps,
#: drift window and step-time drift, 18e's probe span
ADAPT_DRILL_IPS = {r: f"10.0.0.{r // 2}" for r in range(SCHEDULE_WORLD)}
ADAPT_DRILL_BYTES = 1 << 20
ADAPT_DRILL_SCALE = 10.0
ADAPT_CONGESTION_BYTES = 16 << 20
ADAPT_CONGESTION = {"steps": 16, "seed": 9, "n_windows": 1}
ADAPT_TRAIN_STEPS = 6
ADAPT_STEP_WINDOW = 3
ADAPT_STEP_DRIFT = 5.0
VARIABILITY_S = 2.0
#: phase 19: the chunked loss's vocabulary block on the main path
LEAN_BLOCK = 2048
#: 19b's losses against 19a's: the chunked loss's bfloat16 head against the
#: dense one, JAX's tolerance (tests/test_chunked_ce.py:70, 2 % of the value)
LEAN_LOSS_REL = 0.02
#: 19c: the steps after which save_async runs
CKPT_STEPS = (3, 4)
#: 19d: steps before the elastic drill, and of each branch after it
ELASTIC_STEPS = 2
#: 19d: JAX's convergence-equivalence tolerance for a mid-run shrink
#: (tests/test_elastic.py:383)
SHRINK_RTOL, SHRINK_ATOL = 2e-5, 1e-6
#: profiler captures a device timing takes before an empty one is a
#: failure: on an NVIDIA H100 80GB HBM3 at 700 W with torch 2.11 the
#: profiler has come back with no device record for a library yardstick and
#: for a port kernel that launched (its launch and its bits are checked
#: apart from its timing), up to three times running, so any capture is
#: retaken, after a pause and one more call
PROFILE_ATTEMPTS = 5
PROFILE_RETRY_PAUSE_S = 0.2
#: spin kernels a capture launches before its calls and after them: on the
#: same card and torch a capture has lost one call's device records in most
#: captures and four of five K1a calls' in some (PERF.md §7); the pads, left
#: out of the count, take such a loss at either end
PROFILER_PADS = 8
#: phase 20: the sequence-parallel axis on this card and the sequence it
#: shards: MAIN's widths at T = 2048, T_local = 512
SP_WORLD = 4
SP_MAIN = dataclasses.replace(MAIN, max_seq=2048)
#: 20(b)-(c): q/k/v [B, T, H, D], MAIN's widths over the whole sequence
SP_ATT_SHAPE = (BATCH, SP_MAIN.max_seq, MAIN.n_head, MAIN.d_model // MAIN.n_head)
#: 20(a): (label, (B, T, H, D), causal): the ring's blocks (B·H = 256 rows of
#: T_local, its own block causal, a past one full) and Ulysses' launch on one
#: rank (B·H/world = 64 rows of the whole T)
SP_KERNEL_CASES = (
    ("ring block, diagonal", (BATCH, SP_MAIN.max_seq // SP_WORLD, MAIN.n_head, 64), True),
    ("ring block, full", (BATCH, SP_MAIN.max_seq // SP_WORLD, MAIN.n_head, 64), False),
    ("ulysses, one rank", (BATCH // SP_WORLD, SP_MAIN.max_seq, MAIN.n_head, 64), True),
)
#: 20(e): DP x SP on one card, at depth 2
SP_DPSP = {"data": 2, "sp": 2}
SP_DPSP_LAYERS = 2
SP_DPSP_STEPS = 3
#: phase 21(a): MAIN split into PIPE_STAGES stages stacked on this card, the
#: [BATCH, T] batch in PIPE_MICROBATCHES microbatches, PIPE_STEPS AdamW steps
#: a schedule
PIPE_STAGES = 4
PIPE_MICROBATCHES = 4
PIPE_STEPS = 3
#: the (B, T, H, D) a pipeline microbatch gives the flash kernels
PIPE_KERNEL_SHAPE = (BATCH // PIPE_MICROBATCHES, MAIN.max_seq, MAIN.n_head, MAIN.d_model // MAIN.n_head)
#: 21(b): MoEConfig()'s widths at EP world MOE_WORLD over the main batch's
#: tokens; train_moe's steps
MOE_WORLD = 4
MOE_TOKENS = BATCH * MAIN.max_seq
#: EP against the dense MoE, each tensor against its largest element: every
#: element is one float32 sum rounded once to bf16 on each side, and the two
#: sides add their terms in different orders (the experts' weight gradients
#: sum over every rank's tokens), so they may round to neighbouring bf16
#: values: one bf16 ulp, at most 2**-7 of the value
EP_ATOL = 2.0 ** -7
MOE_TRAIN_STEPS = 20
MOE_INFER_STEPS = 5
#: phase 22: serve_gpt2's float32 model at MAIN's widths, its stacked
#: tensor-parallel world and decode slots, and its arrival trace
SERVE_MAIN = dataclasses.replace(MAIN, dtype=torch.float32, attention="xla")
SERVE_WORLD = 4
SERVE_SLOTS = 8
SERVE_TRACE = dict(num_requests=32, rate=0.25, seed=SEED, prompt_len=(8, 64), max_new_tokens=(16, 64))
SERVE_SAMPLING = dict(temperature=1.0, top_k=50)
#: requests held against their own generate run alone
SERVE_ALONE = 4
#: steps of the teacher-forced logits check (slot s joins at step s)
SERVE_TF_STEPS = 24
#: engine-free decode steps timed for the compute a layer
SERVE_STEP_ITERS = 20
#: 22b: two pods of this world and slot count, the int8 wire on a prefix
DISAGG_WORLD = 2
DISAGG_SLOTS = 4
DISAGG_INT8_REQUESTS = 8
#: 22b: the router step after which the decode pod is killed (at the first
#: step from there on at which it holds lanes)
DISAGG_KILL_STEP = 100
#: phase 23(a): train_gpt2 at MAIN's widths (the issue's command), float32
#: and flash, its corpus at the default 200,000 tokens
GPT2_WORKLOAD_ARGV = ["--vocab", "16384", "--seq", "512", "--layers", "12", "--heads", "16", "--dmodel", "1024",
                      "--batch", "16", "--attn", "flash", "--epochs", "1", "--sample"]
#: the float32 K2–K4 timed alone at the workload's (B, T, H, D)
GPT2_F32_SHAPE = (16, 512, 16, 64)
#: the first step's loss, float32 flash against float32 plain attention: the
#: same function, its sums in another order (a float32 rounding of each
#: attention output, far under 1e-5 of a loss of ln(16384) ≈ 9.7 through 12
#: layers)
GPT2_F32_LOSS_ATOL = 1e-4
#: 23b: steps of each train_ddp preset (losses logged at 0, 5 and the last)
#: and its Adam learning rate: at the workload's default 1e-3 ResNet-50's
#: loss on the fixed batch rose over 10 steps (2.96, 10.63, 5.48 logged on
#: an H100 80GB HBM3 at 700 W), and JAX's preset rises there too: from one
#: initialization the port follows JAX's losses at 1e-3, 3.25 then 8.90
#: (tests/test_torch_resnet50_preset.py), so the presets run at 1e-4
DDP_PRESET_STEPS = 10
DDP_PRESET_LR = 1e-4
#: 23c: steps a published-width image model takes, and its batch
IMAGE_STEPS = 5
RESNET_BATCH = 64
VIT_BATCH = 128
#: 23d: main_elastic resumed against uninterrupted, each tensor against its
#: largest element.  Both run ``--deterministic``
#: (``torch.use_deterministic_algorithms``), so the resumed run
#: repeats the uninterrupted one bit for bit, as on the CPU
#: (tests/test_torch_main_elastic.py): any lost weight, momentum or running
#: statistic shows.  Without it the convolution backward reduces in no fixed
#: order, and 15 SGD-momentum steps magnified that to 6.8e-3 on the
#: parameters (an H100 80GB HBM3 at 700 W), the size of a lost momentum
ELASTIC_PARAM_TOL = 0.0
ELASTIC_STATS_TOL = 0.0
#: 23d: accuracy_benchmark's smoke model, which learns the blobs within its
#: 3 default epochs (its default VGG11 stays at chance there, on JAX's CPU
#: run of the same defaults too: 14.06, 10.16, 10.16 % top-1)
ACCURACY_LEARNS = ["--model", "mlp"]
#: 23e: the GNS arithmetic on the card: train_ddp's ResNet-18 preset as a
#: stacked world of GNS_WORLD ranks (NCCL refuses two ranks on one card),
#: GNS_STEPS Adam steps; the two squared norms against the host's float64
#: sums of the same gradients (float32 sums of ~11M squares, pairwise)
GNS_WORLD = 2
GNS_STEPS = 3
GNS_RTOL = 1e-5


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, between two CUDA
    events: where the host takes longer to issue a call than the device to
    run it, this measures the host."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pads() -> None:
    for _ in range(PROFILER_PADS):
        torch.cuda._sleep(1000)


def _device_events(prof) -> list:
    """The device's kernel, memcpy and memset records of a profile, but the
    capture's spin-kernel pads (:func:`_pads`).  A
    record_function range (the optimizer's "Optimizer.step#AdamW.step")
    shows on the device too, under its host range's name, spanning kernels
    already counted: a device record that shares a host record's name is
    left out.  (Kernels named after a lambda hold a '#' too, as
    "{lambda(float)#1}": a filter on '#' dropped them.)"""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != DeviceType.CUDA}
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.key not in host and "spin_kernel" not in e.key]


def device_ms(fn, iters: int = 20, warmup: int = 3, attempts: int = PROFILE_ATTEMPTS) -> float:
    """Mean device time of one ``fn`` call (:func:`device_stats`)."""
    return device_stats(fn, iters, warmup, attempts)[0]


def device_stats(fn, iters: int = 20, warmup: int = 3, attempts: int = PROFILE_ATTEMPTS) -> tuple:
    """``(ms, launches)``: the mean device time of one ``fn`` call, and the
    device records (kernels, copies, fills) it launches a call.  The time is
    the durations of the kernels it launches, from the profiler's kernel
    records over ``iters`` calls, so the device's idle gaps between calls
    do not count.  Each kernel counts
    its records' mean duration times its launches a call (its records over
    ``iters``, rounded): late in a long process the profiler has kept 9
    records of 10 calls, which a plain sum over ``iters`` would read as a
    kernel 10% faster.  A kernel seen less than once a call counts its
    total over ``iters``.  A capture with no device record is taken again
    up to ``attempts`` times, then fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the profiler has come back with no device record at all for calls
    # that launch kernels, and without some of a capture's records (PERF.md,
    # open questions): the calls sit between pads of spin kernels
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pads()
            for _ in range(iters):
                fn()
            _pads()
            torch.cuda.synchronize()
        kernels = _device_events(prof)
        if kernels:
            break
        pads = sum(e.count for e in prof.key_averages() if "spin_kernel" in e.key)
        print(f"device_ms: the profiler recorded no device time (capture {attempt} of {attempts}; "
              f"{pads} of its {2 * PROFILER_PADS} pads recorded)", flush=True)
        time.sleep(PROFILE_RETRY_PAUSE_S)
        fn()
        torch.cuda.synchronize()
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    missing = [(e.key[:60], e.count) for e in kernels if e.count % iters]
    if missing:
        print(f"device_ms: the profiler kept {missing} records over {iters} calls: each such kernel counts "
              f"its records' mean", flush=True)
    per_call = (e.self_device_time_total / e.count * round(e.count / iters) if e.count >= iters / 2
                else e.self_device_time_total / iters for e in kernels)
    launches = sum(round(e.count / iters) for e in kernels)
    return sum(per_call) / 1e3, launches


def bound(name: str, bh: int, t: int, d: int, dtype: torch.dtype, causal: bool):
    """``(bound_ms, bound_by)``: the larger of bytes over HBM rate (each
    input read once, each output written once) and flops over peak, counting
    only the unmasked (q, k) pairs these inputs need."""
    n = bh * t * d * torch.finfo(dtype).bits // 8
    stats = bh * t * 4  # one float32 per row: lse or delta
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    moved, flops = {
        "flash_fwd": (4 * n + stats, 4 * d * pairs),        # q k v -> o, lse
        "flash_dq": (5 * n + 2 * stats, 6 * d * pairs),     # q k v do lse delta -> dq
        "flash_dkv": (6 * n + 2 * stats, 8 * d * pairs),    # q k v do lse delta -> dk dv
    }[name]
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_runs(dev: torch.device, B: int, T: int, H: int, D: int, dtype: torch.dtype, causal: bool,
               dlse: bool = False):
    """``{kernel: (kernel call, plain call, wrapper)}`` on ``[B·H, T, D]``
    inputs from ``SEED``, and the inputs ``(q, k, v, do, scale)``.  With
    ``dlse``, a random ``lse`` cotangent folds into ``delta`` (``delta =
    rowsum(do∘o) − dlse``), as a ring merge's backward gives it."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = ((torch.randn(B * H, T, D, device=dev, generator=gen) * 0.5).to(dtype) for _ in range(4))
    scale = D ** -0.5
    o_ref, lse_ref = fa._fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    if dlse:
        delta = delta - torch.randn(B * H, T, device=dev, generator=gen) * 0.5
    res = (q, k, v, do, lse_ref, delta, scale, causal)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, causal),
                      lambda: fa._fwd_plain(q, k, v, scale, causal), fa.flash_fwd),
        "flash_dq": (lambda: fa.flash_dq(*res), lambda: fa._dq_plain(*res), fa.flash_dq),
        "flash_dkv": (lambda: fa.flash_dkv(*res), lambda: fa._dkv_plain(*res), fa.flash_dkv),
    }
    return runs, (q, k, v, do, scale)


def check_flash(name: str, run, shape: tuple, dtype: torch.dtype, causal: bool) -> float:
    """One launch of ``name`` against its plain version under ``TOLERANCE``;
    fails unless it agrees and its wrapper counted exactly that launch.
    Returns the largest absolute error."""
    kernel, plain, wrapper = run
    before = wrapper.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    launched = wrapper.launches - before
    rtol, atol = TOLERANCE[dtype]
    err, excess = 0.0, 0.0
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
        diff = (g.float() - w.float()).abs()
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: non-finite output")
        err = max(err, diff.max().item())
        excess = max(excess, (diff - atol - rtol * w.float().abs()).max().item())
    ok = excess <= 0 and launched == 1
    B, T, H, D = shape
    print(f"check {name:9s} B={B} T={T} H={H} D={D} {str(dtype)[6:]:8s} "
          f"causal={causal!s:5s} max_abs_err={err:.3e} (rtol {rtol:.1e}, atol {atol:.0e}) "
          f"launches {launched} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version or did not launch once")
    return err


def check_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version, then all three over
    ``WGMMA_GRID``; returns the main-shape (bf16, causal) record of each
    kernel: error, times (events and device), bound, and the library call's
    times (sdpa's backward stands for K3 and K4 together)."""
    shapes = [(BATCH, MAIN.max_seq, MAIN.n_head, MAIN.d_model // MAIN.n_head), (2, 128, 4, 32)]
    records = {}
    for B, T, H, D in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                runs, (q, k, v, do, scale) = flash_runs(dev, B, T, H, D, dtype, causal)
                for name, run in runs.items():
                    err = check_flash(name, run, (B, T, H, D), dtype, causal)
                    if (B, T, H, D) == shapes[0] and dtype == MAIN.dtype and causal:
                        kernel, plain, _ = run
                        b_ms, b_by = bound(name, B * H, T, D, dtype, causal)
                        records[name] = {
                            "max_abs_err": err,
                            "ms": cuda_ms(kernel),
                            "device_ms": device_ms(kernel),
                            "plain_ms": cuda_ms(plain, iters=5),
                            "bound_ms": b_ms,
                            "bound_by": b_by,
                            "library_ms": None,
                        }
                if (B, T, H, D) == shapes[0] and dtype == MAIN.dtype and causal:
                    yardsticks(records, q, k, v, do, scale, (B, T, H, D))
    # all three over the wider grid: head dims on one and two TMA boxes and
    # past them, a T no tile divides, one head, one row
    for B, T, H, D in WGMMA_GRID:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                runs, _ = flash_runs(dev, B, T, H, D, dtype, causal)
                for name, run in runs.items():
                    check_flash(name, run, (B, T, H, D), dtype, causal)
    for shape in F32_BITS_SHAPES:
        for causal in (True, False):
            check_bits(dev, shape, causal)
    return records


def check_bits(dev: torch.device, shape: tuple, causal: bool) -> None:
    """The float32 dq and dk/dv twice on the same inputs: fails unless every
    output is the same bit for bit (each block writes only its own rows,
    in a fixed order)."""
    runs, _ = flash_runs(dev, *shape, torch.float32, causal, dlse=True)
    for name in ("flash_dq", "flash_dkv"):
        kernel = runs[name][0]
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        same = all(same_bits(a, b) for a, b in zip(first, second))
        B, T, H, D = shape
        print(f"bits {name:9s} B={B} T={T} H={H} D={D} float32 causal={causal!s:5s} twice: "
              f"{'identical' if same else 'DIFFER'}", flush=True)
        if not same:
            raise RuntimeError(f"float32 {name} gave different bits on the same inputs")


def yardsticks(records: dict, q, k, v, do, scale: float, shape: tuple) -> None:
    """sdpa's causal forward and backward on the kernels' inputs, timed by
    events and by device time into the flash records; prints K2 against the
    forward and K3 + K4 against the backward (one call for dq, dk and dv).
    Yardsticks only: the port never calls library attention."""
    B, T, H, D = shape
    ql, kl, vl = (x.view(B, H, T, D) for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)

    fwd_ms, fwd_dev = cuda_ms(fwd), device_ms(fwd)
    ql, kl, vl = (x.detach().requires_grad_() for x in (ql, kl, vl))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)
    dol = do.view(B, H, T, D)

    def bwd():
        return torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True)

    bwd_ms, bwd_dev = cuda_ms(bwd), device_ms(bwd)
    records["flash_fwd"].update(library_ms=fwd_ms, library_device_ms=fwd_dev)
    for name in ("flash_dq", "flash_dkv"):
        records[name].update(library_ms=bwd_ms, library_device_ms=bwd_dev,
                             library_covers="dq, dk and dv: one sdpa backward")
    for label, key, lib_fwd, lib_bwd in (("events", "ms", fwd_ms, bwd_ms),
                                         ("device", "device_ms", fwd_dev, bwd_dev)):
        k2, k3, k4 = (records[n][key] for n in ("flash_fwd", "flash_dq", "flash_dkv"))
        print(f"yardstick ({label}): sdpa forward {lib_fwd:.4f} ms, K2 {k2:.4f} ms ({k2 / lib_fwd:.2f}x); "
              f"sdpa backward (dq, dk, dv in one call) {lib_bwd:.4f} ms, K3 {k3:.4f} + K4 {k4:.4f} = "
              f"{k3 + k4:.4f} ms ({(k3 + k4) / lib_bwd:.2f}x)", flush=True)


def ring_bound(world: int, payload_bytes: int) -> tuple:
    """``(bound_ms, "bytes")`` of a ring reduce-scatter or all-gather over a
    per-rank payload of ``payload_bytes`` (P): the reduce-scatter reads every
    rank's input once (world·P) and writes each rank's chunk (P in all); the
    all-gather reads P and writes world·P.  No arithmetic bound comes near."""
    return (world + 1) * payload_bytes / HBM_BYTES_S * 1e3, "bytes"


def _ring_cases(world: int, dtype: torch.dtype):
    """(kernel name, per-rank elements, chunk_bytes) of the ring checks:
    ragged payloads, one under ``chunk_bytes`` (one tile per chunk, K1a) and
    one whose 37-tile chunks stream, unpadded, as 4 tiles of 8 and a ragged
    last tile of 5 (K1b)."""
    tile = ring._tile_elems(dtype)
    return (("ring_k1a", world * 3 * tile - 77, None),
            ("ring_k1b", world * 37 * tile - 123, 8 * tile * dtype.itemsize))


def check_ring(dev: torch.device) -> None:
    """Each ring kernel against ``_ring_plain``, bit for bit, through the
    dispatch (``_run_ring_chunks``: plan, kernel); then a wedged ring must
    raise."""
    wrappers = {w.__name__: w for w in ring.KERNELS}
    for world in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for kname, n, chunk_bytes in _ring_cases(world, dtype):
                gen = torch.Generator(device=dev).manual_seed(SEED)
                x = torch.randn(world, n, device=dev, generator=gen).to(dtype)
                chunks, _ = ring._pad_chunks(x, world)
                ranks = torch.arange(world, device=dev)
                own = chunks[ranks, ranks]  # [world, S, 128]: rank r's chunk r
                plan = ring.plan_ring_schedule(chunks[0].numel(), dtype, world, chunk_bytes)
                stage_rows = plan.stage_bytes // (128 * dtype.itemsize)
                for phase, buf, rs, ag in (("rs", chunks, True, False), ("ag", chunks, False, True),
                                           ("ag-own", own, False, True), ("rs+ag", chunks, True, True)):
                    before = wrappers[kname].launches
                    got = ring._run_ring_chunks(buf, rs=rs, ag=ag, chunk_bytes=chunk_bytes)
                    want = ring._ring_plain(chunks, rs, ag)
                    ring.check_errors()
                    ok = torch.equal(got, want) and wrappers[kname].launches == before + 1
                    print(f"check {kname} world={world} {str(dtype)[6:]:8s} {phase:6s} n={n} "
                          f"{plan.path} n_tiles={plan.n_tiles} stage_rows={stage_rows} "
                          f"chunk_rows={chunks.shape[2]} bit-exact {'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise RuntimeError(f"{kname} disagrees with _ring_plain or did not launch")
    # a wedged protocol fails instead of hanging: rank 1 stops after the
    # entry barrier, its neighbours' spins run out
    gen = torch.Generator(device=dev).manual_seed(SEED)
    chunks, _ = ring._pad_chunks(torch.randn(4, 4 * 3 * 1024, device=dev, generator=gen), 4)
    t0 = time.perf_counter()
    try:
        ring.ring_k1a(chunks, True, True, timeout_s=0.2, fault_rank=1)
        ring.check_errors()
    except RuntimeError as e:
        print(f"wedge check: raised after {time.perf_counter() - t0:.2f} s: {e}", flush=True)
    else:
        raise RuntimeError("a wedged ring returned instead of raising")
    again = ring.ring_k1a(chunks, True, True)
    ring.check_errors()
    if not torch.equal(again, ring._ring_plain(chunks, True, True)):
        raise RuntimeError("the ring disagrees with _ring_plain after a wedged call")
    print("wedge check: the next call is bit-exact again", flush=True)


def check_fused_ring(dev: torch.device) -> None:
    """Each fused ring kernel against ``_fused_ring_plain``, bit for bit,
    through the dispatch; K5a and K5b agree on one input; a wedged fused
    ring raises; what the kernels do not take is refused."""
    wrappers = {w.__name__: w for w in ring.KERNELS}
    for world in (2, 4, 8):
        for wire, block in FUSED_CODECS:
            for kname, n, chunk_bytes in (("ring_k5a", world * 3 * 1024 - 77, None),
                                          ("ring_k5b", world * 37 * 1024 - 123, 8 * 1024 * 4)):
                gen = torch.Generator(device=dev).manual_seed(SEED)
                x = torch.randn(world, n, device=dev, generator=gen)
                x[:, :1024] = 0.0  # whole zero blocks: scale 1, codes 0
                chunks, _ = ring._pad_chunks(x, world)
                ranks = torch.arange(world, device=dev)
                own = chunks[ranks, ranks]
                plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, world, chunk_bytes,
                                               wire_dtype=wire, block_size=block)
                for phase, buf, rs, ag in (("rs", chunks, True, False), ("ag", chunks, False, True),
                                           ("ag-own", own, False, True), ("rs+ag", chunks, True, True)):
                    before = wrappers[kname].launches
                    got = ring._run_ring_chunks(buf, rs=rs, ag=ag, chunk_bytes=chunk_bytes,
                                                wire_dtype=wire, block_size=block)
                    want = ring._fused_ring_plain(chunks, rs, ag, wire, block or 0)
                    if not ag:  # a reduce-scatter alone returns the owned chunks
                        want = want[ranks, (ranks + 1) % world]
                    ring.check_errors()
                    ok = torch.equal(got, want) and wrappers[kname].launches == before + 1
                    print(f"check {kname} world={world} {wire}/{block or '-'} {phase:6s} n={n} {plan.path} "
                          f"n_tiles={plan.n_tiles} stage_rows={plan.stage_bytes // 512} "
                          f"chunk_rows={chunks.shape[2]} unpadded, shape {tuple(got.shape)} "
                          f"bit-exact {'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise RuntimeError(f"{kname} disagrees with _fused_ring_plain or did not launch")
    # one input, every staging size: a 13-tile chunk on the vmem path (K5a)
    # and streamed at budgets of 1, 5 and 13 tiles (K5b: with the int8
    # scales' share, 13 tiles of 8 rows, 4 of 32 and 2 of 56, the last two
    # ragged)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    chunks, _ = ring._pad_chunks(torch.randn(4, 4 * 13 * 1024, device=dev, generator=gen), 4)
    one_stage = ring._run_ring_chunks(chunks, rs=True, ag=True, chunk_bytes=1 << 30, wire_dtype="int8")
    for tiles in (1, 5, 13):
        streamed = ring._run_ring_chunks(chunks, rs=True, ag=True, chunk_bytes=tiles * 4096, wire_dtype="int8")
        ring.check_errors()
        if not torch.equal(streamed, one_stage):
            raise RuntimeError(f"K5b at {tiles}-tile staging disagrees with K5a")
    print("check K5a and K5b: the same bits at staging of 1, 5 and 13 tiles and one stage", flush=True)
    # a wedged fused ring fails instead of hanging, and the next call is exact
    t0 = time.perf_counter()
    try:
        ring.ring_k5a(chunks, True, True, "int8", timeout_s=0.2, fault_rank=1)
        ring.check_errors()
    except RuntimeError as e:
        print(f"fused wedge check: raised after {time.perf_counter() - t0:.2f} s: {e}", flush=True)
    else:
        raise RuntimeError("a wedged fused ring returned instead of raising")
    again = ring.ring_k5a(chunks, True, True, "int8")
    ring.check_errors()
    if not torch.equal(again, one_stage):
        raise RuntimeError("the fused ring disagrees with itself after a wedged call")
    print("fused wedge check: the next call is bit-exact again", flush=True)
    # what the kernels do not take is refused before any launch
    launches = [w.launches for w in ring.KERNELS]
    for what, call in (("a bfloat16 payload", lambda: ring.ring_k5a(chunks.bfloat16(), True, True, "int8")),
                       ("block_size=384", lambda: ring.ring_k5a(chunks, True, True, "int8", 384))):
        try:
            call()
        except ValueError as e:
            print(f"fused refusal: {what}: {e}", flush=True)
        else:
            raise RuntimeError(f"the fused ring took {what}")
    if [w.launches for w in ring.KERNELS] != launches:
        raise RuntimeError("a refused fused call launched a kernel")


def time_ring(dev: torch.device, kname: str, per_rank: int) -> dict:
    """Reduce-scatter and all-gather of ``kname`` at world 4, float32, on a
    ``per_rank``-element payload per rank: each held bit for bit against
    the plain ring, then kernel, plain, yardstick and whole-dispatch (the
    stacked entry point the ZeRO-1 path calls) times against the bound, by
    CUDA events and, for all but the plain version, by device time.  Returns
    the kernels-line record: the reduce-scatter's fields, and the
    all-gather's under ``ag_``."""
    world = ZERO1_WORLD
    wrapper = {w.__name__: w for w in ring.KERNELS}[kname]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(world, per_rank, device=dev, generator=gen)
    chunks, chunk = ring._pad_chunks(x, world)
    plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, world)
    if plan.path != {"ring_k1a": "vmem", "ring_k1b": "hbm-stream"}[kname]:
        raise RuntimeError(f"{kname}: a {per_rank}-element payload plans {plan.path}")
    stage_rows = plan.stage_bytes // 512
    last_rows = chunks.shape[2] - (plan.n_tiles - 1) * stage_rows
    own = chunks[:, 0].contiguous()  # [world, S, 128]: the all-gather's input, one chunk per rank
    payload_bytes = world * chunk * 4
    b_ms, b_by = ring_bound(world, payload_bytes)
    phases = {
        # (kernel input, rs, ag, yardstick: one torch call computing the same
        # function, timed only; the stacked entry point the ZeRO-1 path calls)
        "rs": (chunks, True, False, lambda: chunks.view(world, world, chunk).sum(0),
               lambda: ring.ring_reduce_scatter_stacked(x)),
        "ag": (own, False, True, lambda: own.view(world, chunk).repeat(world, 1, 1),
               lambda: ring.ring_all_gather_stacked(own.view(world, chunk))),
    }
    rec = {"bound_ms": b_ms, "bound_by": b_by}
    for phase, (buf, rs, ag, library, dispatch) in phases.items():
        def kernel():
            return wrapper(buf, rs, ag) if kname == "ring_k1a" else wrapper(buf, rs, ag, stage_rows)

        def plain():
            return ring._ring_plain(buf, rs, ag)

        got, want = kernel(), plain()
        ring.check_errors()
        err = (got.float() - want.float()).abs().max().item()
        exact = torch.equal(got, want)
        del got, want
        times = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
                 "plain_ms": cuda_ms(plain, iters=5),
                 "library_ms": cuda_ms(library), "library_device_ms": device_ms(library),
                 "dispatch_ms": cuda_ms(dispatch), "dispatch_device_ms": device_ms(dispatch)}
        ring.check_errors()
        print(f"time {kname} {phase} world={world} float32 payload {payload_bytes / 2**20:.1f} MiB/rank "
              f"({plan.path}, n_tiles={plan.n_tiles}, stage {plan.stage_bytes} B, last tile {last_rows} rows): "
              f"kernel {times['ms']:.4f} ms (device {times['device_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}), "
              f"plain {times['plain_ms']:.4f} ms, yardstick {times['library_ms']:.4f} ms "
              f"(device {times['library_device_ms']:.4f}), stacked dispatch {times['dispatch_ms']:.4f} ms "
              f"(device {times['dispatch_device_ms']:.4f}), max_abs_err {err}, "
              f"bit-exact {'ok' if exact else 'FAIL'}", flush=True)
        if not exact:
            raise RuntimeError(f"{kname} {phase} disagrees with _ring_plain at its path's payload")
        prefix = "" if phase == "rs" else "ag_"
        rec.update({f"{prefix}max_abs_err": err, **{prefix + k: v for k, v in times.items()}})
    del x, chunks, own, phases
    torch.cuda.empty_cache()
    return rec


def train(cfg: GPT2Config, world, init_state, tokens, on_trainer=None, steps: int = STEPS, **trainer_kw):
    """``steps`` DDPTrainer steps from ``init_state``; returns (losses, step
    seconds, a function that runs one more step).  ``on_trainer`` is called
    with the trainer before the first step."""
    model = GPT2(cfg, device=world.device, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(3e-4), world, Strategy.ring(world.world_size),
                         **trainer_kw)
    if on_trainer is not None:
        on_trainer(trainer)
    state = TrainState.create(model, trainer.tx)
    losses, seconds = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens)
        losses.append(loss.item())  # waits for the step
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, lambda: trainer.step(state, tokens)


def zero1_run(dev: torch.device, init_state, tokens, steps: int = STEPS, **opt_kw):
    """``steps`` ZeRO-1 steps at ``ZERO1_WORLD`` from ``init_state`` with
    ``Zero1Optimizer(**opt_kw)``; returns (per-step ``[world]`` losses, step
    seconds, (model, opt, master, opt_state, step))."""
    model = GPT2(MAIN, device=dev, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    opt = Zero1Optimizer(adamw(3e-4), ZERO1_WORLD, **opt_kw)
    master, opt_state = opt.init(model)
    step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
    losses, seconds = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, loss = step(model, master, opt_state, tokens)
        losses.append(loss.tolist())  # waits for the step
        seconds.append(time.perf_counter() - t0)
    ring.check_errors()
    return losses, seconds, (model, opt, master, opt_state, step)


def train_zero1(dev: torch.device, init_state, tokens, wire_dtype=None):
    """``STEPS`` ZeRO-1 ring steps at ``ZERO1_WORLD`` from ``init_state``;
    returns (per-step ``[world]`` losses, step seconds, one more step)."""
    losses, seconds, (model, _, master, opt_state, step) = zero1_run(
        dev, init_state, tokens, ring=True, wire_dtype=wire_dtype)
    return losses, seconds, lambda: step(model, master, opt_state, tokens)


@contextlib.contextmanager
def plain_ring():
    """The ring dispatch with ``_ring_plain`` in place of both kernels: the
    reference run of the ZeRO-1 path (the port itself never does this)."""
    saved = ring.ring_k1a, ring.ring_k1b
    ring.ring_k1a = lambda chunks, rs, ag, **_: ring._ring_plain(chunks, rs, ag)
    ring.ring_k1b = lambda chunks, rs, ag, stage_rows, **_: ring._ring_plain(chunks, rs, ag)
    try:
        yield
    finally:
        ring.ring_k1a, ring.ring_k1b = saved


def engine_path(dev: torch.device) -> dict:
    """The ring engine's entry points as a user calls them, world 4, on one
    payload per ring kernel; each result against the plain ring.  Returns
    the launches of each kernel in this run."""
    world = ZERO1_WORLD
    trace = CollectiveTrace()
    eng = CollectiveEngine(world, Strategy.ring(world), trace=trace)
    for w in ring.KERNELS:
        w.launches = 0
    for kname, n in ENGINE_ELEMS.items():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(world, n, device=dev, generator=gen)
        ar, rs = eng.ring_allreduce(x), eng.ring_reduce_scatter(x)
        ag = eng.ring_all_gather(rs)
        with plain_ring():
            want = (eng.ring_allreduce(x), eng.ring_reduce_scatter(x), eng.ring_all_gather(rs))
        ring.check_errors()
        ok = all(torch.equal(a, b) for a, b in zip((ar, rs, ag), want))
        print(f"engine path {kname}: {n} float32 per rank, impl "
              f"{sorted({e.impl for e in trace.events()[-6:-3]})}, bit-exact vs plain {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise RuntimeError(f"the engine's ring entry points disagree with the plain ring ({kname})")
    return {w.__name__: w.launches for w in (ring.ring_k1a, ring.ring_k1b)}


def gpt2_gradients(dev: torch.device, init_state, tokens) -> torch.Tensor:
    """``[ZERO1_WORLD, N]`` float32: each rank's gradient of the main GPT-2
    on its ``BATCH``-row shard of ``tokens``, in ZeRO-1's flat layout (real
    gradients: int8 error depends on each block's absmax)."""
    model = GPT2(MAIN, device=dev, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    meta = _flatten_meta(model, ZERO1_WORLD, 8 * 128)
    stacked = torch.empty((ZERO1_WORLD, meta.padded), dtype=torch.float32, device=dev)
    for r in range(ZERO1_WORLD):
        model.zero_grad(set_to_none=True)
        shard = tokens[r * BATCH:(r + 1) * BATCH]
        lm_loss(model(shard), shard).backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
        _flatten(grads, meta, out=stacked[r])
    return stacked


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest ``|a - b|`` in units of the float32 spacing at
    ``max(|a|, |b|)``, elementwise."""
    m = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
    return float(((a - b).abs() / spacing).max())


def fused_engine_path(dev: torch.device, grads: torch.Tensor) -> dict:
    """Slice 3's main path: the engine's compressed ring collectives on the
    full GPT-2 gradient, as a user calls them; returns the launches of each
    ring kernel in this run."""
    world = ZERO1_WORLD
    strategy = Strategy.ring(world)
    strategy.wire_dtype = "int8"
    trace = CollectiveTrace()
    eng = CollectiveEngine(world, strategy, trace=trace)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    small = torch.randn(world, ENGINE_ELEMS["ring_k1a"], device=dev, generator=gen)
    for w in ring.KERNELS:
        w.launches = 0
        w.phases.clear()
    fused = eng.ring_allreduce(grads)
    bf16 = eng.ring_allreduce(grads, wire_dtype="bf16")
    rs = eng.ring_reduce_scatter(grads)
    ag = eng.ring_all_gather(rs)
    small_out = eng.ring_allreduce(small)
    os.environ[ring.FUSED_WIRE_ENV] = "off"
    try:
        unfused = eng.ring_allreduce(grads)
    finally:
        del os.environ[ring.FUSED_WIRE_ENV]
    ring.check_errors()
    launches = {w.__name__: w.launches for w in ring.KERNELS}
    events = trace.events()
    impls = [e.impl for e in events]
    reroute = events[-1].extra.get("reroute_reason", "")
    print(f"fused path: impls {impls}; reroute_reason {reroute!r}; "
          f"wire bytes per rank {[e.extra['wire_bytes'] for e in events]}", flush=True)
    want_impls = [f"cuda_ring[{p}]" for p in ("hbm-stream+int8", "hbm-stream+bf16", "hbm-stream+int8",
                                               "hbm-stream+int8", "vmem+int8")] + ["quant_ring[int8]"]
    if impls != want_impls or "ADAPCC_FUSED_WIRE=off" not in reroute:
        raise RuntimeError(f"the fused path dispatched {impls}, expected {want_impls}")
    for label, out in (("int8", fused), ("bf16", bf16), ("4 MiB int8", small_out), ("unfused int8", unfused)):
        if not all(torch.equal(out[r], out[0]) for r in range(1, world)):
            raise RuntimeError(f"the {label} allreduce differs between ranks")
    total = grads.sum(0)
    bound = torch.from_numpy(ring_error_bound(grads.cpu().numpy())).to(dev)
    err = (fused[0] - total).abs()
    gap = ulp_gap(fused, unfused)
    small_err_ok = bool(((small_out[0] - small.sum(0)).abs()
                         <= torch.from_numpy(ring_error_bound(small.cpu().numpy())).to(dev)).all())
    # bf16 has no rounding headroom to grant: the walk is held bit for bit
    # against its plain version on the same input
    bf16_chunks, _ = ring._pad_chunks(grads, world)
    bf16_want = ring._fused_ring_plain(bf16_chunks, True, True, "bf16").reshape(world, -1)[:, : grads.shape[1]]
    bf16_ok = torch.equal(bf16, bf16_want)
    del bf16_chunks, bf16_want
    print(f"fused path: int8 allreduce of {grads.shape[1]} float32 a rank: max |err| vs the float32 sum "
          f"{err.max().item():.3e} (bound max {bound.max().item():.3e}, largest err/bound "
          f"{(err / bound).max().item():.3f}); largest gap to the unfused quant ring {gap} ulps "
          f"(tolerance {FUSED_ULPS}); bf16 max |err| {(bf16[0] - total).abs().max().item():.3e}, "
          f"bit-exact against _fused_ring_plain {bf16_ok}; "
          f"4 MiB int8 within bound {small_err_ok}", flush=True)
    if not (bool((err <= bound).all()) and gap <= FUSED_ULPS and small_err_ok and bf16_ok):
        raise RuntimeError("the fused allreduce is outside its bounds")
    del fused, bf16, unfused, small_out
    # reduce-scatter: row r is the reduced chunk r; all-gather: every rank
    # holds the codec's value of every rank's chunk, bit for bit
    chunk = rs.shape[1]
    rs_ok = bool(((rs - total.view(world, chunk)).abs() <= bound.view(world, chunk)).all())
    apply = get_codec("int8").apply
    ag_ok = all(torch.equal(ag[r, src], apply(rs[src])) for src in range(world) for r in range(world))
    print(f"fused path: reduce-scatter within bound {rs_ok}; all-gather equal to the codec's value of every "
          f"chunk on every rank {ag_ok}", flush=True)
    if not (rs_ok and ag_ok):
        raise RuntimeError("the fused reduce-scatter or all-gather is wrong")
    return launches


def time_fused(dev: torch.device, kname: str, stacked: torch.Tensor) -> dict:
    """The int8 allreduce walk (RS+AG, one launch) of ``kname`` at world 4 on
    ``stacked`` ``[world, P]``, on the chunks the dispatch hands it
    (unpadded): held bit for bit against the plain version, then kernel,
    plain, K1 on the same payload (its own plan), the unfused quant ring and
    the stacked dispatch against the bound, by CUDA events and (all but the
    plain version and the quant ring) by device time.  K5b also holds and
    times its reduce-scatter and all-gather alone.  One profiled stacked
    dispatch must run no padding copy."""
    world = stacked.shape[0]
    wrapper = {w.__name__: w for w in ring.KERNELS}[kname]
    chunks, chunk = ring._pad_chunks(stacked, world)
    plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, world, wire_dtype="int8")
    stage_rows = plan.stage_bytes // 512
    stage_rows1 = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, world).stage_bytes // 512
    if plan.path != {"ring_k5a": "vmem", "ring_k5b": "hbm-stream"}[kname]:
        raise RuntimeError(f"{kname}: a {stacked.shape[1]}-element payload plans {plan.path}")
    streamed = kname == "ring_k5b"
    last_rows = chunks.shape[2] - (plan.n_tiles - 1) * stage_rows

    def kernel(buf=chunks, rs=True, ag=True):
        return wrapper(buf, rs, ag, stage_rows, "int8") if streamed else wrapper(buf, rs, ag, "int8")

    def plain():
        return ring._fused_ring_plain(chunks, True, True, "int8")

    def k1():
        return ring.ring_k1b(chunks, True, True, stage_rows1) if streamed else ring.ring_k1a(chunks, True, True)

    def check(label, got, want):
        ring.check_errors()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"{kname} {label} disagrees with _fused_ring_plain at its path's payload")
        return err

    strategy = Strategy.ring(world)
    strategy.wire_dtype = "int8"
    eng = CollectiveEngine(world, strategy)

    def dispatch():
        return eng.ring_allreduce(stacked)

    err = check("rs+ag", kernel(), plain())
    iters = 10 if streamed else 20  # K5a as K1a: a launch of microseconds, its host time in the mean
    payload_bytes = world * chunk * 4
    rec = {"max_abs_err": err, "bound_ms": 2 * world * payload_bytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
           "library_ms": None}
    rec.update({"ms": cuda_ms(kernel, iters=iters), "device_ms": device_ms(kernel, iters=iters),
                "plain_ms": cuda_ms(plain, iters=3),
                "k1_ms": cuda_ms(k1, iters=iters), "k1_device_ms": device_ms(k1, iters=iters),
                "quant_ring_ms": cuda_ms(lambda: wire_ring_allreduce_stacked(stacked, "int8"), iters=3),
                "dispatch_ms": cuda_ms(dispatch, iters=iters), "dispatch_device_ms": device_ms(dispatch, iters=iters)})
    if streamed:
        ranks = torch.arange(world, device=dev)
        own = chunks[:, 0].contiguous()  # the all-gather's input, one chunk a rank
        rec["rs_max_abs_err"] = check("rs", kernel(chunks, True, False),
                                      ring._fused_ring_plain(chunks, True, False, "int8")[ranks, (ranks + 1) % world])
        rec["ag_max_abs_err"] = check("ag", kernel(own, False, True), ring._fused_ring_plain(own, False, True, "int8"))
        rec.update({"rs_ms": cuda_ms(lambda: kernel(chunks, True, False), iters=10),
                    "rs_device_ms": device_ms(lambda: kernel(chunks, True, False), iters=10),
                    "ag_ms": cuda_ms(lambda: kernel(own, False, True), iters=10),
                    "ag_device_ms": device_ms(lambda: kernel(own, False, True), iters=10),
                    "rs_bound_ms": ring_bound(world, payload_bytes)[0]})
        del own
    ring.check_errors()
    print(f"time {kname} int8 rs+ag world={world} payload {payload_bytes / 2**20:.1f} MiB/rank ({plan.path}, "
          f"n_tiles={plan.n_tiles}, stage {plan.stage_bytes} B, last tile {last_rows} rows, unpadded): kernel "
          f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), bound {rec['bound_ms']:.4f} ms (bytes), "
          f"plain {rec['plain_ms']:.4f} ms, {'K1b' if streamed else 'K1a'} {rec['k1_ms']:.4f} ms (device "
          f"{rec['k1_device_ms']:.4f}), unfused quant ring {rec['quant_ring_ms']:.4f} ms, stacked dispatch "
          f"{rec['dispatch_ms']:.4f} ms (device {rec['dispatch_device_ms']:.4f})"
          + (f"; rs alone {rec['rs_ms']:.4f} ms (device {rec['rs_device_ms']:.4f}), ag alone {rec['ag_ms']:.4f} "
             f"ms (device {rec['ag_device_ms']:.4f}) (bound each {rec['rs_bound_ms']:.4f} ms)" if streamed else "")
          + f"; max_abs_err {err}, bit-exact ok", flush=True)
    # the stacked dispatch hands the kernel the caller's chunks: no padding
    # copy (a host op: the profile needs no device records)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dispatch()
        torch.cuda.synchronize()
    ops = sorted({e.key for e in prof.key_averages() if e.key.startswith("aten::")})
    pads = sum(e.count for e in prof.key_averages() if e.key == "aten::constant_pad_nd")
    print(f"profile (engine int8 allreduce, {kname}): aten::constant_pad_nd x{pads}; host ops {ops}", flush=True)
    if pads:
        raise RuntimeError(f"the engine int8 allreduce ({kname}) ran aten::constant_pad_nd {pads} times")
    del chunks, eng
    torch.cuda.empty_cache()
    return rec




# --------------------------------------------------------------------------- #
# phase 11: the schedule plane (slice 8)
# --------------------------------------------------------------------------- #


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits, so that -0.0 and +0.0 differ."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def time_dispatch(fn, iters: int = 10) -> dict:
    """A dispatch's events time, device time and device launches a call."""
    dev_ms, launches = device_stats(fn, iters=iters)
    return {"ms": cuda_ms(fn, iters=iters), "device_ms": dev_ms, "launches": launches}


def _fmt(times: dict) -> str:
    return f"events {times['ms']:.4f} ms, device {times['device_ms']:.4f} ms, {times['launches']} launches"


def plain_masked(stacked: torch.Tensor, active, op: ReduceOp):
    """The yardstick: one plain reduction over the rows of the same
    function (masked sum, mean or max), without the tree rounds."""
    world = stacked.shape[0]
    mask = torch.zeros(world, dtype=torch.bool, device=stacked.device)
    mask[list(range(world)) if active is None else active] = True
    if op is ReduceOp.MAX:
        return lambda: stacked.masked_fill(~mask[:, None], float("-inf")).amax(0)
    weight = mask.to(stacked.dtype)[:, None]
    count = torch.full((), int(mask.sum()), dtype=stacked.dtype, device=stacked.device)
    if op is ReduceOp.AVG:
        return lambda: (stacked * weight).sum(0) / count
    return lambda: (stacked * weight).sum(0)


def schedule_gradients(dev: torch.device, init_state, tokens):
    """Phase 11a's payload: each of ``SCHEDULE_WORLD`` ranks' bf16 gradient
    of the main GPT-2 on its ``BATCH``-row shard, in the flax leaf order and
    layout the hook buckets (``DDPTrainer._flax_layout``), packed by the
    hook's plan: ``(plan, [world, n_b] per bucket)``."""
    model = GPT2(MAIN, device=dev, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    order, transposed = DDPTrainer._flax_layout(model)
    params = list(model.parameters())
    plan, stacked = None, None
    for r in range(SCHEDULE_WORLD):
        model.zero_grad(set_to_none=True)
        shard = tokens[r * BATCH:(r + 1) * BATCH]
        lm_loss(model(shard), shard).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        leaves = [grads[i].t() if transposed[i] else grads[i] for i in order]
        if plan is None:
            plan = build_bucket_plan(leaves, BUCKET_CAP_MB)
            stacked = [torch.empty((SCHEDULE_WORLD, n), dtype=torch.bfloat16, device=dev)
                       for n in plan.bucket_sizes]
        for b, bucket in enumerate(flatten_to_buckets(plan, leaves)):
            stacked[b][r].copy_(bucket)
    return plan, stacked


def schedule_world8(dev: torch.device, init_state, tokens) -> tuple:
    """Phase 11a: the two-host world-8 strategy averages the bench GPT-2's
    bucketed bf16 gradients with rank 3 a relay, as the hooks of 8
    processes would.  Returns the bucket plan, the gradients, ``[8, n_b]`` a
    bucket, and the dispatches' device ms and bound ms summed over the
    buckets."""
    plan, buckets = schedule_gradients(dev, init_state, tokens)
    strategy = parse_strategy_xml(SCHEDULE_XML)
    merged = _merged_plan(strategy)
    groups = (len(merged.reduce_groups), len(merged.broadcast_groups))
    print(f"schedule 11a: {SCHEDULE_XML}, world {SCHEDULE_WORLD}, active {SCHEDULE_ACTIVE}; merged plan "
          f"{groups[0]} reduce and {groups[1]} broadcast groups; bucket plan {plan.num_buckets} buckets of "
          f"{[round(b / 2**20, 2) for b in plan.bucket_bytes]} MiB a rank (bf16, cap {BUCKET_CAP_MB} MB), "
          f"{plan.total_bytes / 2**20:.1f} MiB a rank, {SCHEDULE_WORLD * plan.total_bytes / 2**30:.2f} GiB stacked",
          flush=True)
    if groups != SCHEDULE_GROUPS:
        raise RuntimeError(f"the merged plan has {groups} groups, the JAX package's {SCHEDULE_GROUPS}")
    trace = CollectiveTrace()
    eng = CollectiveEngine(SCHEDULE_WORLD, strategy, trace=trace)
    cpu_eng = CollectiveEngine(SCHEDULE_WORLD, strategy)
    largest = max(range(plan.num_buckets), key=lambda b: plan.bucket_sizes[b])
    active = torch.tensor(SCHEDULE_ACTIVE, device=dev)
    times = {}
    for b, stacked in enumerate(buckets):
        def call(x=stacked, e=eng):
            return e.all_reduce(x, active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG)

        out = call()
        rec = trace.events()[-1]
        if rec.impl != "schedule" or rec.extra["merged"] is not True:
            raise RuntimeError(f"bucket {b} did not run the merged schedule plane: {rec}")
        rows_same = all(same_bits(out[r], out[0]) for r in range(1, SCHEDULE_WORLD))
        x = stacked.index_select(0, active).double()
        err = (out[0].double() - x.mean(0)).abs()
        within = bool((err <= SCHEDULE_BF16_TOL * x.abs().mean(0)).all())
        exact = None
        if b in (0, largest):
            exact = same_bits(out.cpu(), call(stacked.cpu(), cpu_eng))
        n = stacked.shape[1]
        times[b] = {"dispatch": time_dispatch(call), "plain": time_dispatch(plain_masked(stacked, SCHEDULE_ACTIVE,
                                                                                       ReduceOp.AVG))}
        bound = 2 * stacked.numel() * stacked.element_size() / HBM_BYTES_S * 1e3
        print(f"schedule 11a bucket {b}: {n} bf16 a rank; rows identical (relay 3 too) "
              f"{'ok' if rows_same else 'FAIL'}; max |err| vs float64 mean {float(err.max()):.3e} "
              f"{'ok' if within else 'FAIL'}; bit for bit vs CPU {'-' if exact is None else 'ok' if exact else 'FAIL'}; "
              f"dispatch {_fmt(times[b]['dispatch'])}; plain masked mean {_fmt(times[b]['plain'])}; "
              f"bound {bound:.4f} ms (bytes: [8, n] read and written once)", flush=True)
        if not rows_same or not within or exact is False:
            raise RuntimeError(f"phase 11a bucket {b} failed its checks")
        del out, x, err
        if b == 0:  # where the executor's time goes, op by op
            profile_step("schedule 11a bucket 0", call, times[b]["dispatch"]["ms"])
    torch.cuda.empty_cache()
    bound_ms = sum(2 * b.numel() * b.element_size() for b in buckets) / HBM_BYTES_S * 1e3
    return plan, buckets, sum(t["dispatch"]["device_ms"] for t in times.values()), bound_ms


def schedule_world4(dev: torch.device, grads: torch.Tensor) -> None:
    """Phase 11b: phase 9's float32 gradients (world 4) through three
    strategies' schedule plane, each call held bit for bit against its CPU
    run on a bucket-sized slice, then timed on the whole payload."""
    world = grads.shape[0]
    slice_n = int(BUCKET_CAP_MB * 2**20) // grads.element_size()
    relay2 = [0, 1, 3]
    ring_eng = CollectiveEngine(world, Strategy.ring(world))
    k1b = time_dispatch(lambda: ring_eng.ring_allreduce(grads))
    print(f"schedule 11b: {grads.shape[1]} float32 a rank ({grads.shape[1] * 4 / 2**20:.1f} MiB), world {world}; "
          f"CPU checks on the first {slice_n} a rank; yardstick K1b RS+AG (ring_allreduce) {_fmt(k1b)}", flush=True)
    ring.check_errors()
    calls = {
        "all_reduce SUM": lambda e, x: e.all_reduce(x, op=ReduceOp.SUM),
        "all_reduce AVG relay 2": lambda e, x: e.all_reduce(x, active_gpus=relay2, op=ReduceOp.AVG),
        "all_reduce MAX": lambda e, x: e.all_reduce(x, op=ReduceOp.MAX),
        "reduce AVG relay 2": lambda e, x: e.reduce(x, active_gpus=relay2, op=ReduceOp.AVG),
        "broadcast": lambda e, x: e.broadcast(x),
    }
    yardsticks = {"all_reduce SUM": (None, ReduceOp.SUM), "all_reduce AVG relay 2": (relay2, ReduceOp.AVG),
                  "all_reduce MAX": (None, ReduceOp.MAX)}
    plain = {k: time_dispatch(plain_masked(grads, *v)) for k, v in yardsticks.items()}
    for k, v in plain.items():
        print(f"schedule 11b yardstick plain {k}: {_fmt(v)}", flush=True)
    strategies = {"ring(4,4)": Strategy.ring(world, world), "binary(4,2)": Strategy.binary(world, 2),
                  "4.xml": parse_strategy_xml("tests/fixtures/strategy/4.xml")}
    sliced = grads[:, :slice_n].contiguous()
    sliced_cpu = sliced.cpu()
    for sname, strategy in strategies.items():
        trace = CollectiveTrace()
        eng = CollectiveEngine(world, strategy, trace=trace, use_xla_fastpath=False)
        cpu_eng = CollectiveEngine(world, strategy, use_xla_fastpath=False)
        for cname, fn in calls.items():
            exact = same_bits(fn(eng, sliced).cpu(), fn(cpu_eng, sliced_cpu))
            out = fn(eng, grads)
            rec = trace.events()[-1]
            ok = exact and rec.impl == "schedule" and bool(torch.isfinite(out).all())
            if cname.startswith("all_reduce"):
                ok = ok and all(same_bits(out[r], out[0]) for r in range(1, world))
            if cname in ("all_reduce SUM", "all_reduce AVG relay 2"):
                x = grads.index_select(0, torch.tensor(relay2 if "relay" in cname else range(world), device=dev))
                want = x.double().mean(0) if "AVG" in cname else x.double().sum(0)
                scale = x.abs().double().mean(0) if "AVG" in cname else x.abs().double().sum(0)
                ok = ok and bool(((out[0].double() - want).abs() <= SCHEDULE_F32_TOL * scale + 1e-30).all())
                del x, want, scale
            del out
            t = time_dispatch(lambda: fn(eng, grads))
            print(f"schedule 11b {sname:11s} {cname:22s}: merged {rec.extra['merged']}; bit for bit vs CPU "
                  f"{'ok' if exact else 'FAIL'}, checks {'ok' if ok else 'FAIL'}; {_fmt(t)}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 11b {sname} {cname} failed its checks")
            if cname == "all_reduce SUM" and sname != "binary(4,2)":
                profile_step(f"schedule 11b {sname} all_reduce SUM", lambda: fn(eng, grads), t["ms"])
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 12: the façade, the bootstrap and the coordinator (slice 9)
# --------------------------------------------------------------------------- #


def facade_allreduce(label: str, buckets: list, active: list, cpu_comm=None, iters: int = 10) -> dict:
    """The façade's AVG allreduce of each ``[8, n]`` bf16 bucket over
    ``active``, as the hooks of 8 processes would run it: every row
    identical, each bucket within ``SCHEDULE_BF16_TOL`` of a float64 masked
    mean, bucket 0 bit for bit ``cpu_comm``'s run when one is given.
    Returns the events, device time and launches summed over the buckets."""
    total = {"ms": 0.0, "device_ms": 0.0, "launches": 0}
    idx = torch.tensor(active, device=buckets[0].device)
    for b, stacked in enumerate(buckets):
        def call(x=stacked):
            return AdapCC.allreduce(x, active_gpus=active, op=ReduceOp.AVG)

        out = call()
        rows_same = all(same_bits(out[r], out[0]) for r in range(1, out.shape[0]))
        x = stacked.index_select(0, idx).double()
        err = (out[0].double() - x.mean(0)).abs()
        within = bool((err <= SCHEDULE_BF16_TOL * x.abs().mean(0)).all())
        exact = None
        if cpu_comm is not None and b == 0:
            exact = same_bits(out.cpu(), cpu_comm.all_reduce(stacked.cpu(), active_gpus=active, op=ReduceOp.AVG))
        times = time_dispatch(call, iters=iters)
        for k in total:
            total[k] += times[k]
        print(f"{label} bucket {b}: {stacked.shape[1]} bf16 a rank, active {active}; rows identical "
              f"{'ok' if rows_same else 'FAIL'}; max |err| vs float64 mean {float(err.max()):.3e} "
              f"{'ok' if within else 'FAIL'}; bit for bit vs CPU {'-' if exact is None else 'ok' if exact else 'FAIL'}; "
              f"dispatch {_fmt(times)}", flush=True)
        if not rows_same or not within or exact is False:
            raise RuntimeError(f"{label} bucket {b} failed its checks")
        del out, x, err
    torch.cuda.empty_cache()
    return total


def facade_bootstrap(buckets: list, workdir: str, ref_ms: float, bound_ms: float) -> None:
    """Phase 12a: the DETECT bootstrap at world 8 on the card, then the
    façade's allreduce of phase 11a's gradients on the synthesized
    strategy, rank 3 a relay, beside phase 11a's ``ref_ms`` and the
    ``bound_ms`` of the same gradients."""
    topo = os.path.join(workdir, "12a")
    args = CommArgs(strategy_file=f"{topo}/strategy.xml", logical_graph=f"{topo}/logical_graph.xml",
                    topology_dir=topo, entry_point=DETECT, parallel_degree=2)
    t0 = time.perf_counter()
    AdapCC.init(args, world_size=SCHEDULE_WORLD)
    boot_s = time.perf_counter() - t0
    lat, bw = gather_topo_profile(topo, SCHEDULE_WORLD)
    off = ~np.eye(SCHEDULE_WORLD, dtype=bool)
    print(f"facade 12a: DETECT bootstrap at world {SCHEDULE_WORLD} on {AdapCC.communicator.device} in "
          f"{boot_s:.2f} s; probe latency {lat[off].min() * 1e6:.2f}-{lat[off].max() * 1e6:.2f} us, bandwidth "
          f"{bw[off].min():.1f}-{bw[off].max():.1f} GB/s (one card: device-memory copies of a [8, n] float32 "
          f"tensor by row offset, timed by CUDA events, not links)", flush=True)
    if not (lat[off] > 0).all() or not (bw[off] > 0).all():
        raise RuntimeError("the profile left an off-diagonal pair unmeasured")
    with open(args.strategy_file) as f:
        print(f"facade 12a: synthesized strategy {f.read()}", flush=True)
    strategy = AdapCC.communicator.strategy
    print(f"facade 12a: {strategy.synthesis}, {strategy.num_trans} tree(s), chunk_bytes {strategy.chunk_bytes}, "
          f"merged plan {'yes' if _merged_plan(strategy) is not None else 'no'}", flush=True)
    AdapCC.setup(ALLREDUCE)
    cpu_comm = Communicator(CommArgs(strategy_file=args.strategy_file, topology_dir=os.path.join(workdir, "12a-cpu"),
                                     entry_point=SKIP_BOOTSTRAP), world_size=SCHEDULE_WORLD, device="cpu")
    cpu_comm.init_threads(ALLREDUCE)
    total = facade_allreduce("facade 12a", buckets, SCHEDULE_ACTIVE, cpu_comm)
    print(f"facade 12a: AVG allreduce of the {len(buckets)} buckets (relay 3): events {total['ms']:.4f} ms, "
          f"device {total['device_ms']:.4f} ms, {total['launches']} launches; phase 11a on 4-4_1.xml "
          f"{ref_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes)", flush=True)


def facade_coordinator(buckets: list) -> None:
    """Phase 12b: the coordinator's decisions drive the façade: rent-or-buy
    over 8 emulated participants with one straggler, then a controller
    barrier with one silent participant."""
    logic = CoordinatorLogic(SCHEDULE_WORLD)
    probe = WaitTimeProbe(logic)
    waits = emulate_heterogeneous_steps(probe, SCHEDULE_WORLD, 2, base_compute_s=0.005, heter_alpha=40.0,
                                        slow_ranks=(FACADE_SLOW,))
    frozen = [sorted(logic.active_list(step)) for step in range(2)]
    print(f"facade 12b: rent-or-buy, rank {FACADE_SLOW} slow (x40 of 5 ms): wait times "
          f"{[round(w * 1e3, 2) for w in waits]} ms, negotiation round-trips (worst rank) "
          f"{[round(probe.rpc_overhead(s) * 1e3, 2) for s in range(2)]} ms, frozen active lists {frozen}",
          flush=True)
    if any(FACADE_SLOW in f or len(f) < 2 for f in frozen):
        raise RuntimeError(f"the straggler was not demoted: {frozen}")
    total = facade_allreduce("facade 12b (frozen list)", buckets, frozen[-1])
    print(f"facade 12b: AVG allreduce over the frozen list: device {total['device_ms']:.4f} ms, "
          f"{total['launches']} launches", flush=True)
    barrier = CoordinatorLogic(SCHEDULE_WORLD, fault_timeout=FACADE_FAULT_TIMEOUT_S)
    reporting = [r for r in range(SCHEDULE_WORLD) if r != FACADE_SILENT]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(reporting)) as pool:
        answers = list(pool.map(lambda r: barrier.controller_arrive(0, r), reporting))
    barrier_s = time.perf_counter() - t0
    alive = sorted(answers[0][0])
    print(f"facade 12b: controller barrier, rank {FACADE_SILENT} silent, fault timeout {FACADE_FAULT_TIMEOUT_S} s: "
          f"statuses {sorted({a[1] for a in answers})}, alive {alive}, {barrier_s:.3f} s", flush=True)
    if any(a[1] != 0 or sorted(a[0]) != reporting for a in answers):
        raise RuntimeError(f"the controller barrier did not report the alive set: {answers}")
    total = facade_allreduce("facade 12b (alive set)", buckets, alive)
    print(f"facade 12b: AVG allreduce over the alive set: device {total['device_ms']:.4f} ms, "
          f"{total['launches']} launches", flush=True)


def negotiated_ddp(init_state, tokens, workdir: str):
    """Phase 12c: DDP at world 1 with a coordinator-attached Communicator:
    every step negotiates its mask (over gRPC where ``grpc`` imports).
    Returns (losses, step seconds, negotiated masks, round-trips)."""
    world = build_world_mesh(1)
    topo = os.path.join(workdir, "12c")
    comm = Communicator(CommArgs(strategy_file=f"{topo}/strategy.xml", logical_graph=f"{topo}/lg.xml",
                                 topology_dir=topo), world=world)
    if importlib.util.find_spec("grpc") is not None:
        comm.enable_coordinator(is_master=True, process_rank=0, num_processes=1, port=0)
    else:
        print("grpc: not installed, the gRPC transport not driven on the card", flush=True)
    masks, trainers = [], []

    def record(trainer):
        negotiate = trainer.hook.negotiate

        def recorded(step):
            mask = negotiate(step)
            masks.append(mask.tolist())
            return mask

        trainer.hook.negotiate = recorded
        trainers.append(trainer)

    try:
        losses, seconds, _ = train(MAIN, world, init_state, tokens, on_trainer=record, communicator=comm)
        rtts = [dt for _, dt in comm.rpc_latencies]
        print(f"negotiated 12c: masks {masks}; negotiation round-trips {[round(t * 1e3, 3) for t in rtts]} ms; "
              f"rent-or-buy calibrated {trainers[0]._coord_calibrated} (one rank: its profile has no link)",
              flush=True)
    finally:
        comm.clear()
        destroy_world()
    return losses, seconds, masks, rtts



# --------------------------------------------------------------------------- #
# phase 13: accumulation, the overlapped syncs, ZeRO-1 without the ring and
# checkpoints (slice 10)
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def counted(owner, name: str):
    """Count the calls of ``owner.name`` while the block runs (a step's
    chunk dispatches); yields the list of calls."""
    calls = []
    inner = getattr(owner, name)

    def counting(*args, **kwargs):
        calls.append(name)
        return inner(*args, **kwargs)

    setattr(owner, name, counting)
    try:
        yield calls
    finally:
        setattr(owner, name, inner)


def refused(fn, match: str) -> str:
    """The message of the ``ValueError`` that ``fn`` must raise."""
    try:
        fn()
    except ValueError as e:
        if match not in str(e):
            raise RuntimeError(f"refused for another reason than {match!r}: {e}") from e
        return str(e)
    raise RuntimeError(f"not refused (expected {match!r})")


def accumulation_ms(dev: torch.device, init_state) -> dict:
    """Device time of the trainer's float32 accumulation on the main GPT-2:
    one microbatch's adds (each parameter's gradient into its float32
    accumulator; the bf16 parameters stand in for gradients of their shapes)
    and the final divide and cast, each beside its bytes' bound (an add
    reads 4 + 2 and writes 4 bytes an element; divide and cast read 4 and
    write 2)."""
    model = GPT2(MAIN, device=dev, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    params = [p.detach() for p in model.parameters()]
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    n = sum(p.numel() for p in params)
    add_ms, add_launches = device_stats(lambda: [a.add_(g) for a, g in zip(acc, params)], iters=10)
    fin_ms, fin_launches = device_stats(lambda: [(a / ACCUM).to(p.dtype) for a, p in zip(acc, params)], iters=10)
    return {"params": n, "add_ms": add_ms, "add_launches": add_launches, "add_bound_ms": n * 10 / HBM_BYTES_S * 1e3,
            "final_ms": fin_ms, "final_launches": fin_launches, "final_bound_ms": n * 6 / HBM_BYTES_S * 1e3}


def stream_overlap(label: str, step) -> dict:
    """One profiled step's device records by stream, from the profiler's
    trace: for each stream but the compute stream (the one the flash forward
    runs on) the records, their device time, and how much of it overlaps
    records on the compute stream.  Returns ``{stream: (records, µs,
    overlapped µs)}``."""
    import bisect
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="adapcc_trace_") as workdir:
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    records = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    streams: dict = {}
    for e in records:
        streams.setdefault(e.get("args", {}).get("stream"), []).append(e)
    compute = next((sid for sid, evs in streams.items() if any("flash_fwd" in e["name"] for e in evs)), None)
    if compute is None:
        print(f"streams ({label}): no flash forward record in the trace (not measured)", flush=True)
        return {}
    busy = []  # the compute stream's records, merged into disjoint intervals
    for e in sorted(streams[compute], key=lambda e: e["ts"]):
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    starts = [b[0] for b in busy]

    def covered(start: float, end: float) -> float:
        i, total = max(bisect.bisect_right(starts, start) - 1, 0), 0.0
        while i < len(busy) and busy[i][0] < end:
            total += max(0.0, min(end, busy[i][1]) - max(start, busy[i][0]))
            i += 1
        return total

    out = {}
    print(f"streams ({label}): compute stream {compute}: {len(streams[compute])} records, "
          f"{sum(float(e['dur']) for e in streams[compute]):.1f} us", flush=True)
    for sid, evs in streams.items():
        if sid == compute:
            continue
        total = sum(float(e["dur"]) for e in evs)
        overlapped = sum(covered(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in evs)
        names: dict = {}
        for e in evs:
            names[e["name"][:60]] = names.get(e["name"][:60], 0) + 1
        top = sorted(names.items(), key=lambda kv: -kv[1])[:3]
        print(f"streams ({label}): stream {sid}: {len(evs)} records, {total:.1f} us, {overlapped:.1f} us "
              f"({100 * overlapped / max(total, 1e-9):.1f}%) beside compute-stream records; most: {top}", flush=True)
        out[sid] = (len(evs), total, overlapped)
    return out


def slice10(dev: torch.device, init_state, tokens, z_tokens, losses, z_losses, c_losses_11) -> dict:
    """Phase 13, slice 10's main path (the module docstring): from phase
    5's weights, ``tokens`` (DDP) and ``z_tokens`` (ZeRO-1), held against
    phase 5's ``losses``, phase 7's ``z_losses`` and phase 11c's
    ``c_losses_11``.  Returns the flash and K1b launches of its runs."""
    z_tokens_step = ZERO1_WORLD * BATCH * MAIN.max_seq
    t13 = time.perf_counter()
    p13 = dict.fromkeys((*(w.__name__ for w in fa.KERNELS), "ring_k1b"), 0)

    def reset() -> None:
        for w in (*fa.KERNELS, *ring.KERNELS):
            w.launches = 0
            getattr(w, "phases", {}).clear()

    def tally(ws=fa.KERNELS) -> dict:
        """The launches of the run just made, added to phase 13's count;
        the counts set to 0 for the next (profiled and timed extra calls
        are read by neither)."""
        got = {w.__name__: w.launches for w in ws}
        for k, v in got.items():
            p13[k] += v
        reset()
        return got

    reset()
    # (a) DDP with 4 microbatches a step
    world = build_world_mesh(1)
    a_losses, a_seconds, a_more = train(MAIN, world, init_state, tokens, accum_steps=ACCUM)
    a_launches = tally()
    a_gap = max(abs(a - b) for a, b in zip(a_losses, losses))
    a_step_s = float(np.mean(a_seconds[1:]))
    print(f"accum 13a (DDP, accum_steps={ACCUM}, world 1): losses {a_losses}; max gap to phase 5 {a_gap:.3e} "
          f"(tolerance {LOSS_ATOL}); launches {a_launches}; step {a_step_s * 1e3:.2f} ms, "
          f"{BATCH * MAIN.max_seq / a_step_s:.1f} tokens/s (every step {[round(t * 1e3, 2) for t in a_seconds]} ms)",
          flush=True)
    want = MAIN.n_layer * ACCUM * STEPS
    if any(n != want for n in a_launches.values()):
        raise RuntimeError(f"expected {want} launches of each flash kernel in 13a, got {a_launches}")
    if not all(np.isfinite(a_losses)) or not a_losses[-1] < a_losses[0] or not a_gap <= LOSS_ATOL:
        raise RuntimeError(f"13a losses not finite, falling and within {LOSS_ATOL} of phase 5's: {a_losses}")
    profile_step("ddp accum 4", a_more, a_step_s * 1e3)
    del a_more
    reset()
    acc = accumulation_ms(dev, init_state)
    print(f"accum 13a: float32 accumulation of {acc['params']} parameters, one microbatch: device "
          f"{acc['add_ms']:.4f} ms ({acc['add_launches']} launches; bound {acc['add_bound_ms']:.4f} ms); divide "
          f"and cast {acc['final_ms']:.4f} ms ({acc['final_launches']}; bound {acc['final_bound_ms']:.4f}); a step "
          f"{ACCUM * acc['add_ms'] + acc['final_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    # (b) the same with each microbatch's sync on a side stream
    b_losses, b_seconds, b_more = train(MAIN, world, init_state, tokens, accum_steps=ACCUM, overlap="microbatch")
    b_launches = tally()
    b_bits = b_losses == a_losses
    b_close = all(abs(b - a) <= MICROBATCH_ATOL + MICROBATCH_RTOL * abs(a) for a, b in zip(a_losses, b_losses))
    b_step_s = float(np.mean(b_seconds[1:]))
    print(f"accum 13b (overlap='microbatch'): losses {b_losses}; bit for bit 13a's {'ok' if b_bits else 'NO'}"
          f"{'' if b_bits else f', within rtol {MICROBATCH_RTOL} / atol {MICROBATCH_ATOL} ' + ('ok' if b_close else 'FAIL')}"
          f"; launches {b_launches}; step {b_step_s * 1e3:.2f} ms, {BATCH * MAIN.max_seq / b_step_s:.1f} tokens/s "
          f"(every step {[round(t * 1e3, 2) for t in b_seconds]} ms)", flush=True)
    if not (b_bits or b_close) or any(n != want for n in b_launches.values()):
        raise RuntimeError(f"13b disagrees with 13a or launched the flash kernels otherwise: {b_launches}")
    profile_step("ddp accum 4 microbatch", b_more, b_step_s * 1e3)
    side = stream_overlap("accum 13b", b_more)
    del b_more
    reset()
    if not any(n for n, _, _ in side.values()):
        raise RuntimeError("13b ran no device work beside the compute stream: the syncs did not leave it")
    destroy_world()
    torch.cuda.empty_cache()
    # (c) bucket-rolling sync, on the psum plane and on the schedule plane
    world = build_world_mesh(1)
    hooks = []
    with counted(torch.distributed, "all_reduce") as calls:
        c_losses, c_seconds, c_more = train(MAIN, world, init_state, tokens, overlap="bucket",
                                            on_trainer=lambda t: hooks.append(t.hook))
    plan = hooks[0].recorded_buckets
    chunks = [-(-size // max(1, cb // 2)) for size, cb in plan]  # bf16 buckets
    from_plan = sum(chunks)
    c_step_s = float(np.mean(c_seconds[1:]))
    print(f"bucket 13c (psum plane): losses {c_losses}; bit for bit phase 5's {'ok' if c_losses == losses else 'FAIL'}; "
          f"{len(plan)} buckets of {[round(size * 2 / 2**20, 1) for size, _ in plan]} MiB at "
          f"{sorted({cb for _, cb in plan})} B chunks; {len(calls) / STEPS:.1f} chunk all_reduces a step "
          f"({from_plan} from the plan); step {c_step_s * 1e3:.2f} ms", flush=True)
    if c_losses != losses or len(calls) != from_plan * STEPS:
        raise RuntimeError(f"13c: losses {c_losses} vs {losses}, {len(calls)} chunk collectives")
    c_launches = tally()
    profile_step("ddp bucket psum", c_more, c_step_s * 1e3)
    del c_more
    reset()
    with counted(comm_engine, "_tree_allreduce_chunk") as calls:
        cs_losses, cs_seconds, _ = train(MAIN, world, init_state, tokens, overlap="bucket", sync_mode="schedule")
    cs_step_s = float(np.mean(cs_seconds[1:]))
    print(f"bucket 13c (schedule plane): losses {cs_losses}; bit for bit phase 11c's "
          f"{'ok' if cs_losses == c_losses_11 else 'FAIL'}; {len(calls) / STEPS:.1f} tree chunks a step; step "
          f"{cs_step_s * 1e3:.2f} ms", flush=True)
    if cs_losses != c_losses_11 or len(calls) != sum(n for n in chunks if n > 1) * STEPS:
        raise RuntimeError(f"13c schedule plane: losses {cs_losses} vs {c_losses_11}, {len(calls)} tree chunks")
    cs_launches = tally()
    if any(n != MAIN.n_layer * STEPS for n in (*c_launches.values(), *cs_launches.values())):
        raise RuntimeError(f"expected {MAIN.n_layer * STEPS} launches of each flash kernel in each 13c run: "
                           f"{c_launches}, {cs_launches}")
    destroy_world()
    torch.cuda.empty_cache()
    # (d) ZeRO-1 without the ring (JAX's default layout), unchunked and in
    # chunks
    d_runs = {}
    for mode in ("off", "bucket"):
        d_losses, d_seconds, d_more = zero1_run(dev, init_state, z_tokens, ring=False, overlap=mode)
        _, d_opt, d_master, d_opt_state, _ = d_more
        d_runs[mode] = (d_losses, float(np.mean(d_seconds[1:])), d_opt.overlap_chunks(), d_master.shape)
        d_k = {w.__name__: w.launches for w in ring.KERNELS}
        d_launches = tally()
        if mode == "off":
            d_ckpt = TrainCheckpointState(None, (d_master, d_opt_state.state_dict()), extra=d_opt.checkpoint_extra())
        if any(d_k.values()) or any(n != MAIN.n_layer * ZERO1_WORLD * STEPS for n in d_launches.values()):
            raise RuntimeError(f"13d {mode}: ring launches {d_k}, flash launches {d_launches}")
        d_model, d_step = d_more[0], d_more[4]
        profile_step(f"zero1 no ring {mode}", lambda: d_step(d_model, d_master, d_opt_state, z_tokens),
                     d_runs[mode][1] * 1e3, forbid=("aten::constant_pad_nd",))
        reset()
        del d_master, d_opt_state, d_model, d_step, d_more
        torch.cuda.empty_cache()
    (d0, d0_s, c0, shape), (d1, d1_s, c1, _) = d_runs["off"], d_runs["bucket"]
    d_gap = float(np.abs(np.array(d0) - np.array(z_losses)).max())
    print(f"zero1 13d (ring=False, world {ZERO1_WORLD}): master {tuple(shape)} float32 "
          f"({shape[1] * 4 / 2**20:.1f} MiB a rank), {c1} chunks under 'bucket'; losses off {d0}; bucket bit for bit "
          f"{'ok' if d1 == d0 else 'FAIL'}; max gap to phase 7's ring {d_gap:.3e} (tolerance {ZERO1_LAYOUT_LOSS_ATOL}); "
          f"no ring launch; step off {d0_s * 1e3:.2f} ms, bucket {d1_s * 1e3:.2f} ms, "
          f"{z_tokens_step / d0_s:.1f} / {z_tokens_step / d1_s:.1f} tokens/s global", flush=True)
    if d1 != d0 or c0 != 1 or c1 < 2 or not d_gap <= ZERO1_LAYOUT_LOSS_ATOL:
        raise RuntimeError("13d: the chunked path differs from the unchunked one, or left phase 7's losses")
    # (e) ZeRO-1 on the ring, 2 steps, a checkpoint, a fresh model and
    # optimizer restored from it, 3 more steps
    e_losses, _, (model, opt, master, opt_state, _) = zero1_run(dev, init_state, z_tokens, steps=2, ring=True)
    with tempfile.TemporaryDirectory(prefix="adapcc_ckpt_") as workdir:
        mgr = CheckpointManager(workdir, max_to_keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, TrainCheckpointState(model.state_dict(), (master, opt_state.state_dict()), step=2,
                                         extra=opt.checkpoint_extra()))
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(workdir, "2", "state.ckpt"))
        del model, opt, master, opt_state
        torch.cuda.empty_cache()
        model = GPT2(MAIN, device=dev, seed=SEED + 1).to(torch.bfloat16)
        opt = Zero1Optimizer(adamw(3e-4), ZERO1_WORLD, ring=True)
        blank, blank_state = opt.init(model)
        ckpt = TrainCheckpointState(model.state_dict(), (blank, blank_state.state_dict()), extra=opt.checkpoint_extra())
        del blank, blank_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not mgr.restore(ckpt):
            raise RuntimeError("13e: no checkpoint to restore")
        model.load_state_dict(ckpt.params)
        master, opt_state = opt.restore(ckpt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        moments = [t for t in opt_state.state[master].values() if t.is_floating_point() and t.dim()]
        if not (master.is_cuda and all(t.is_cuda for t in (*ckpt.params.values(), *moments))):
            raise RuntimeError("13e: the restored state is not on the card")
        step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
        for _ in range(STEPS - 2):
            e_losses.append(step(model, master, opt_state, z_tokens)[3].tolist())
        ring.check_errors()
        # the layout guard: this ring checkpoint into JAX's default layout,
        # and 13d's non-ring state into this ring optimizer
        plain = Zero1Optimizer(adamw(3e-4), ZERO1_WORLD)
        guards = [
            refused(lambda: plain.restore(ckpt), "layout mismatch"),
            refused(lambda: mgr.restore(TrainCheckpointState(None, (master, {}), extra=plain.checkpoint_extra())),
                    "checkpoint layout mismatch"),
            refused(lambda: opt.restore(d_ckpt), "layout mismatch"),
            refused(lambda: TrainCheckpointState(None, (master, {}), extra=opt.checkpoint_extra()).apply_snapshot(
                d_ckpt.capture_snapshot()), "checkpoint layout mismatch"),
        ]
    del d_ckpt
    e_k1b = dict(ring.ring_k1b.phases)
    e_launches = tally((*fa.KERNELS, ring.ring_k1b))
    print(f"checkpoint 13e (ZeRO-1 ring): losses {e_losses}; bit for bit phase 7's "
          f"{'ok' if e_losses == z_losses else 'FAIL'}; save {save_s:.3f} s, restore {restore_s:.3f} s, "
          f"{nbytes} bytes ({nbytes / 2**30:.2f} GiB, {nbytes / 2**30 / save_s:.2f} / "
          f"{nbytes / 2**30 / restore_s:.2f} GiB/s); launches {e_launches}, ring_k1b by phase {e_k1b}", flush=True)
    for msg in guards:
        print(f"checkpoint 13e: refused: {msg[:110]}", flush=True)
    if e_losses != z_losses or e_k1b != {"rs": STEPS, "ag": STEPS}:
        raise RuntimeError(f"13e: the resumed run differs from phase 7's: {e_losses} vs {z_losses}, K1b {e_k1b}")
    if any(e_launches[w.__name__] != MAIN.n_layer * ZERO1_WORLD * STEPS for w in fa.KERNELS):
        raise RuntimeError(f"13e launched the flash kernels otherwise: {e_launches}")
    del model, opt, master, opt_state, step, ckpt
    torch.cuda.empty_cache()
    print(f"phase 13 launches: {p13}; phase 13 {time.perf_counter() - t13:.1f} s", flush=True)
    return p13


# --------------------------------------------------------------------------- #
# phase 14: the plan tuner (slice 11)
# --------------------------------------------------------------------------- #


def plain_allreduce(x: torch.Tensor, wire_dtype: str, block_size: int = 256) -> torch.Tensor:
    """The plain version of the ring allreduce the engine ran on ``x``: the
    walk of ``_ring_plain`` (or, under a codec, ``_fused_ring_plain``) on
    the same padded chunks."""
    world = x.shape[0]
    flat = x.reshape(world, -1)
    chunks, _ = ring._pad_chunks(flat, world)
    work = (ring._ring_plain(chunks, True, True) if wire_dtype == "off"
            else ring._fused_ring_plain(chunks, True, True, wire_dtype, block_size))
    return work.reshape(world, -1)[:, : flat.shape[1]].reshape(x.shape)


def _cell(key) -> str:
    chunk = f"{key.chunk_bytes >> 10} KiB" if key.chunk_bytes else "-"
    return f"{key.path}/{chunk}/{key.wire_dtype}"


def tuner_engine_cells(dev: torch.device, grads: torch.Tensor, workdir: str) -> None:
    """Phase 14(a): ``CollectiveEngine(4, ring(4), tuner=choose)`` on a fresh
    database in ``workdir``, each payload dispatched with ``algo="ring"``
    until every cell of ``candidates("allreduce", algos=("ring",))`` holds
    its trial budget;
    each cell's first dispatch held bit for bit against the plain version
    (the quant ring has no kernel); the medians, the choice, the incumbent;
    the database saved, reloaded, and ranking the same plan."""
    world = ZERO1_WORLD
    db_path = os.path.join(workdir, "engine_tuning.jsonl")
    topology = mesh_fingerprint(dev, world=world)
    tuner = CollectiveTuner(world, topology, db=TuningDatabase(db_path), mode="choose")
    db, policy = tuner.db, tuner.policy
    trace = CollectiveTrace()
    eng = CollectiveEngine(world, Strategy.ring(world), trace=trace, tuner=tuner)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    payloads = {"4 MiB": torch.randn(world, ENGINE_ELEMS["ring_k1a"], device=dev, generator=gen),
                "642.6 MiB": grads}
    for label, x in payloads.items():
        nbytes = x[0].numel() * 4
        cells = policy.candidates("allreduce", nbytes, "float32", algos=("ring",))
        t0, dispatches, first = time.perf_counter(), 0, {}
        while any(db.count(c) < policy.trial_budget for c in cells):
            if dispatches >= TUNER_DISPATCH_CAP:
                raise RuntimeError(f"14a {label}: {dispatches} dispatches left cells under budget: "
                                   f"{[(_cell(c), db.count(c)) for c in cells]}")
            out = eng.ring_allreduce(x, algo="ring")  # the ring plane's cells (phase 15c: the full grid)
            dispatches += 1
            event = trace.events()[-1]
            key = tuner_measure._key_from_event(event, world, topology)
            if key not in cells:
                raise RuntimeError(f"14a {label}: dispatch {dispatches} ran {key}, outside the candidates")
            if key not in first:
                if key.path == QUANT_PATH:
                    first[key] = None  # the unfused quant ring: eager torch, no kernel
                else:
                    first[key] = torch.equal(out, plain_allreduce(x, key.wire_dtype))
                print(f"tuner 14a {label} dispatch {dispatches}: first of cell {_cell(key)} ({event.impl}, "
                      f"source {event.extra['tuner']['source']}, applied {event.extra['tuner']['applied']}); "
                      f"bit for bit its plain version {'-' if first[key] is None else first[key]}", flush=True)
                if first[key] is False:
                    raise RuntimeError(f"14a {label}: cell {_cell(key)} disagrees with its plain version")
            del out
        span = time.perf_counter() - t0
        for c in cells:
            st = db.stats(c)
            print(f"tuner 14a {label} cell {_cell(c):28s}: {st.count} samples, median {st.median_s * 1e3:.4f} ms, "
                  f"iqr {st.iqr_s * 1e3:.4f}, min {st.min_s * 1e3:.4f}, max {st.max_s * 1e3:.4f} ms; prior "
                  f"{policy.prior_time(c, nbytes) * 1e3:.4f} ms; samples "
                  f"{[round(t * 1e3, 4) for t in db.samples(c)]}", flush=True)
        plan = tuner.choose("allreduce", nbytes, "float32", algos=("ring",))
        incumbent = policy.incumbent("allreduce", nbytes)
        print(f"tuner 14a {label}: {len(cells)} cells filled in {dispatches} dispatches ({span:.1f} s); chosen "
              f"{_cell(plan.key)} (source {plan.source}, {plan.expected_s * 1e3:.4f} ms); incumbent "
              f"{_cell(incumbent) if incumbent else None}", flush=True)
        if plan.source != "measured":
            raise RuntimeError(f"14a {label}: a filled grid chose by {plan.source}")
    db.save()
    reloaded = TuningPolicy(TuningDatabase(db_path), world, topology)
    for label, x in payloads.items():
        nbytes = x[0].numel() * 4
        a = tuner.rank_only("allreduce", nbytes, "float32", algos=("ring",))
        b = reloaded.rank_only("allreduce", nbytes, "float32", algos=("ring",))
        print(f"tuner 14a {label}: saved and reloaded database ranks {_cell(b.key)} ({b.source}), the live one "
              f"{_cell(a.key)}", flush=True)
        if (a.key, a.source) != (b.key, b.source):
            raise RuntimeError(f"14a {label}: the reloaded database ranks another plan")
    del payloads
    torch.cuda.empty_cache()


def measured_defaults(dev: torch.device, grads: torch.Tensor, smi: str) -> None:
    """Phase 14(d): the codec rate and α the cost model's card defaults
    take: ``timed_roundtrip`` int8 and bf16 on one rank's 642.6 MiB
    gradient, and the 4-byte-a-rank stacked ``ring_allreduce`` (K1a) over
    its 2·(world − 1) hops; beside them, the cost of record mode on a 4 MiB
    dispatch."""
    world = ZERO1_WORLD
    row = grads[0]
    registry = MetricsRegistry()
    rates = {}
    for name in ("int8", "bf16"):
        for _ in range(CODEC_ITERS):
            timed_roundtrip(name, row, registry=registry)
        t = registry.snapshot()["timings"]
        q, d = t[f"quant.{name}.quantize"]["p50_s"], t[f"quant.{name}.dequantize"]["p50_s"]
        rates[name] = row.numel() * 4 / ((q + d) / 2)
        print(f"defaults 14d codec {name}: quantize p50 {q * 1e3:.4f} ms, dequantize p50 {d * 1e3:.4f} ms on "
              f"{row.numel() * 4 / 2**20:.1f} MiB float32: {rates[name] / 1e9:.2f} GB/s a pass ({smi})", flush=True)
    eng = CollectiveEngine(world, Strategy.ring(world))
    x = torch.randn(world, 1, device=dev)

    def walltimes(engine, payload, sync_each: bool = True) -> list:
        for _ in range(3):
            engine.ring_allreduce(payload)
        torch.cuda.synchronize()
        out = []
        for _ in range(ALPHA_ITERS):
            t0 = time.perf_counter()
            engine.ring_allreduce(payload)
            if sync_each:
                torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return out

    t = float(np.median(walltimes(eng, x)))
    alpha = t / (2 * (world - 1))
    print(f"defaults 14d alpha: 4-byte-a-rank ring_allreduce (K1a) walltime median {t * 1e6:.2f} us over "
          f"{ALPHA_ITERS}, alpha {alpha * 1e6:.3f} us a hop ({smi})", flush=True)
    print(f"defaults 14d: cost model now alpha {cost_model.MEASURED_ALPHA_S * 1e6:.3f} us, codec "
          f"{cost_model.DEFAULT_CODEC_BYTES_PER_S / 1e9:.2f} GB/s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    small = torch.randn(world, ENGINE_ELEMS["ring_k1a"], device=dev, generator=gen)
    rec = CollectiveEngine(world, Strategy.ring(world), tuner=CollectiveTuner(
        world, mesh_fingerprint(dev, world=world), db=TuningDatabase(persist=False), mode="record"))
    free = walltimes(eng, small, sync_each=False)
    synced = walltimes(eng, small)
    recorded = walltimes(rec, small)
    print(f"defaults 14d record-mode overhead, 4 MiB ring_allreduce (K1a): untuned {np.mean(free) * 1e3:.4f} ms a "
          f"dispatch unsynced, {np.median(synced) * 1e3:.4f} ms median synced; record mode "
          f"{np.median(recorded) * 1e3:.4f} ms median ({rec.tuner.timer.recorded} recorded, "
          f"{rec.tuner.timer.discarded} discarded)", flush=True)


def tuned_ddp(dev: torch.device, init_state, tokens, workdir: str) -> None:
    """Phase 14(b): ``DDPTrainer(tune=True, tune_every=TUNE_EVERY)`` on phase
    5's GPT-2, weights and batch, world 1 over NCCL, ``TUNE_STEPS`` steps
    on a database seeded so that ``TUNE_WINNER`` wins the first re-choice:
    each step's cell and walltime, each adoption; losses finite; every
    executed cell a candidate; at least one adoption, the step after it
    runs the adopted codec and overlap on a new configuration whose first
    step is discarded; one measured sample a step but the first of each
    configuration."""
    world = build_world_mesh(1)
    model = GPT2(MAIN, device=world.device, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    tuner = CollectiveTuner.for_mesh(world, db_path=os.path.join(workdir, "ddp_tuning.jsonl"))
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(3e-4), world, Strategy.ring(1), tune=True,
                         tuner=tuner, tune_every=TUNE_EVERY)
    state = TrainState.create(model, trainer.tx)
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    candidates = trainer.tuner.policy.candidates("ddp_step", grad_bytes, overlap_modes=trainer._overlap_modes)
    winner = tuner.key_for("ddp_step", grad_bytes, hook_path(TUNE_WINNER[0]), NO_CHUNK, TUNE_WINNER[1])
    if winner not in candidates or winner == trainer._step_cell(grad_bytes):
        raise RuntimeError(f"14b: the seeded winner {_cell(winner)} is not a non-incumbent candidate")
    for key in candidates:
        for i in range(tuner.policy.trial_budget):
            tuner.db.record(key, TUNE_SEED_S[key == winner] * (1 + i / 100), ts=float(i))
    seeded = {k: tuner.db.count(k) for k in candidates}
    losses, cells, adoptions, walls = [], [], [], {}
    for i in range(TUNE_STEPS):
        cell = trainer._step_cell(grad_bytes)
        discarded, count = tuner.timer.discarded, tuner.db.count(cell)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens)
        losses.append(loss.item())
        dt = time.perf_counter() - t0
        cells.append(cell)
        # a step on a new configuration is its warmup: discarded, not recorded
        warmup = tuner.timer.discarded == discarded + 1 and tuner.db.count(cell) == count
        if not warmup and tuner.db.count(cell) != count + 1:
            raise RuntimeError(f"14b step {i + 1}: neither discarded nor recorded under {_cell(cell)}")
        if adoptions and adoptions[-1][0] == i and not warmup:
            raise RuntimeError(f"14b step {i + 1}: the first step on the adopted {_cell(cell)} was recorded")
        after = trainer._step_cell(grad_bytes)
        if after != cell:
            adoptions.append((i + 1, after))
            if (trainer.hook.effective_compress(), trainer.hook.overlap) != (after.wire_dtype,
                                                                           hook_overlap_of(after.path)):
                raise RuntimeError(f"14b: adopted {_cell(after)} but the hook runs "
                                   f"{trainer.hook.effective_compress()}/{trainer.hook.overlap}")
        if not warmup:
            walls.setdefault(cell, []).append(dt)
        print(f"tuner 14b step {i + 1}: cell {_cell(cell)}, {dt * 1e3:.2f} ms, loss {losses[-1]:.6f}"
              + (" (warmup, discarded)" if warmup else "")
              + (f"; adopted {_cell(after)}" if after != cell else ""), flush=True)
    destroy_world()
    db = tuner.db
    samples = sum(db.count(k) - seeded.get(k, 0) for k in db.keys())
    gens = len(trainer._built)
    for k in db.keys():
        st = db.stats(k)
        measured = (f", measured steps' median {np.median(walls[k]) * 1e3:.2f} ms" if k in walls else "")
        print(f"tuner 14b cell {_cell(k)}: {db.count(k) - seeded.get(k, 0)} measured samples "
              f"(+{seeded.get(k, 0)} seeded), median of all {st.median_s * 1e3:.2f} ms{measured}", flush=True)
    print(f"tuner 14b: {samples} samples for {TUNE_STEPS} steps over {gens} configurations; adoptions "
          f"{[(s, _cell(k)) for s, k in adoptions]}; grid {[_cell(c) for c in candidates]}", flush=True)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"14b losses not finite: {losses}")
    if any(c not in candidates for c in cells):
        raise RuntimeError(f"14b ran a cell outside the candidates: {[_cell(c) for c in cells]}")
    if not adoptions or adoptions[0] != (TUNE_EVERY, winner):
        raise RuntimeError(f"14b: expected the adoption of {_cell(winner)} after step {TUNE_EVERY}, "
                           f"got {[(s, _cell(k)) for s, k in adoptions]}")
    if cells[TUNE_EVERY] != winner:
        raise RuntimeError(f"14b: step {TUNE_EVERY + 1} ran {_cell(cells[TUNE_EVERY])}, not the adopted cell")
    if samples != TUNE_STEPS - gens:
        raise RuntimeError(f"14b: {samples} samples in the database, expected {TUNE_STEPS} - {gens}")
    del model, state, trainer
    torch.cuda.empty_cache()


def tuned_zero1(dev: torch.device, init_state, z_tokens, z_losses, workdir: str) -> None:
    """Phase 14(c): ``Zero1Optimizer(ring=True, tuner=choosing)`` at world 4,
    ``TUNED_ZERO1_STEPS`` steps: the chunk in the grid, losses bit for bit
    phase 7's first steps (the ring adds in the same order at any tile
    size), each step but the first recorded under ``tuning_key()``."""
    tuner = CollectiveTuner(ZERO1_WORLD, mesh_fingerprint(dev, world=ZERO1_WORLD),
                            db_path=os.path.join(workdir, "zero1_tuning.jsonl"), mode="choose")
    losses, seconds, (_, opt, *_) = zero1_run(dev, init_state, z_tokens, steps=TUNED_ZERO1_STEPS, ring=True,
                                              tuner=tuner)
    key = opt.tuning_key()
    want = z_losses[:TUNED_ZERO1_STEPS]
    print(f"tuner 14c (ZeRO-1 ring, world {ZERO1_WORLD}): chunk {opt.ring_chunk_bytes} bytes "
          f"({opt.tuned_plan.source}, cell {_cell(key)}); losses {losses}; bit for bit phase 7's "
          f"{'ok' if losses == want else 'FAIL'}; steps {[round(s * 1e3, 2) for s in seconds]} ms; "
          f"{tuner.db.count(key)} samples under the cell", flush=True)
    if opt.ring_chunk_bytes not in DEFAULT_CHUNK_GRID:
        raise RuntimeError(f"14c: chunk {opt.ring_chunk_bytes} is not in the grid {DEFAULT_CHUNK_GRID}")
    if losses != want:
        raise RuntimeError(f"14c: the tuned chunk's losses differ from phase 7's: {losses} vs {want}")
    if tuner.db.count(key) != TUNED_ZERO1_STEPS - 1:
        raise RuntimeError(f"14c: {tuner.db.count(key)} samples under {key}, expected {TUNED_ZERO1_STEPS - 1}")
    torch.cuda.empty_cache()


def slice11(dev: torch.device, init_state, tokens, z_tokens, z_losses, smi: str) -> dict:
    """Phase 14, slice 11's main path (the module docstring); returns the
    launches of each kernel in it."""
    t14 = time.perf_counter()
    kernels = (*fa.KERNELS, *ring.KERNELS)
    for w in kernels:
        w.launches = 0
    with tempfile.TemporaryDirectory(prefix="adapcc_tuner_") as workdir:
        grads = gpt2_gradients(dev, init_state, z_tokens)
        tuner_engine_cells(dev, grads, workdir)
        measured_defaults(dev, grads, smi)
        del grads
        torch.cuda.empty_cache()
        tuned_ddp(dev, init_state, tokens, workdir)
        tuned_zero1(dev, init_state, z_tokens, z_losses, workdir)
    ring.check_errors()
    p14 = {w.__name__: w.launches for w in kernels}
    print(f"phase 14 launches: {p14}; phase 14 {time.perf_counter() - t14:.1f} s", flush=True)
    if not all(p14.values()):
        raise RuntimeError(f"a kernel was not launched in phase 14: {p14}")
    return p14


def synced_ms(fn, iters: int = SYNCED_ITERS) -> float:
    """Median walltime of one ``fn`` call with the device synced after it:
    what a caller waiting on the result pays, host dispatch included."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out)) * 1e3


def _stacked_bound_ms(stacked: torch.Tensor) -> float:
    """The bytes bound of a stacked allreduce: the ``[world, n]`` tensor read
    once and written once, over the card's memory rate."""
    return 2 * stacked.numel() * stacked.element_size() / HBM_BYTES_S * 1e3


def latency_plane(dev: torch.device, smi: str) -> None:
    """Phase 15(a): the latency plane against the psum plane and K1a."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for world in LATENCY_WORLDS:
        trace = CollectiveTrace()
        eng = CollectiveEngine(world, Strategy.ring(world), trace=trace)
        timer = CollectiveEngine(world, Strategy.ring(world))
        crossover = eng._allreduce_crossover_bytes()
        arms = {"rd": lambda e, x: e.all_reduce(x, algo="rd"), "tree": lambda e, x: e.all_reduce(x, algo="tree"),
                "psum": lambda e, x: e.all_reduce(x), "ring": lambda e, x: e.ring_allreduce(x)}
        picks = {}
        for nbytes in LATENCY_BYTES:
            n = nbytes // 4
            ints = torch.randint(-64, 65, (world, n), device=dev, generator=gen).float()
            rand = torch.randn(world, n, device=dev, generator=gen)
            want_int = ints.sum(0)
            exact = rand.double().sum(0)
            tol = (world - 1) * 2.0 ** -24 * rand.double().abs().sum(0)
            for arm, call in arms.items():
                out = call(eng, ints)
                impl = trace.events()[-1].impl
                bits = all(same_bits(out[r], want_int) for r in range(world))
                out = call(eng, rand)
                within = bool(((out.double() - exact[None]).abs() <= tol[None]).all())
                times = time_dispatch(lambda c=call, x=rand: c(timer, x), iters=PHASE15_ITERS)
                wall = synced_ms(lambda c=call, x=rand: c(timer, x))
                print(f"latency 15a world {world} {nbytes} B a rank, {arm}: {impl}; integer data bit for bit the "
                      f"plain sum {'ok' if bits else 'FAIL'}; random data within (w-1)*2^-24*sum|x| "
                      f"{'ok' if within else 'FAIL'}; {_fmt(times)}; synced walltime {wall:.4f} ms; bound "
                      f"{_stacked_bound_ms(rand):.6f} ms ({smi})", flush=True)
                if impl != LATENCY_IMPLS[arm] or not bits or not within:
                    raise RuntimeError(f"15a world {world} {nbytes} B {arm} ran {impl} or failed its checks")
            eng.all_reduce(rand, algo="auto")
            picks[nbytes] = trace.events()[-1].impl
            if picks[nbytes] != ("rd" if nbytes < crossover else "torch_fused"):
                raise RuntimeError(f"15a world {world}: auto picked {picks[nbytes]} at {nbytes} B against the "
                                   f"crossover {crossover:.0f} B")
        print(f"latency 15a world {world}: auto picks {picks} (cost model crossover at the card's defaults "
              f"{crossover:.0f} B a rank: rd below it)", flush=True)
        # the relay contract: rank 3 contributes nothing, forwards, receives
        active = [r for r in range(world) if r != LATENCY_RELAY]
        ints = torch.randint(-64, 65, (world, 1024), device=dev, generator=gen).float()
        want = plain_masked(ints, active, ReduceOp.AVG)()
        for arm in ("rd", "tree"):
            out = eng.all_reduce(ints, algo=arm, active_gpus=active, op=ReduceOp.AVG)
            ok = all(same_bits(out[r], want) for r in range(world))
            print(f"latency 15a world {world} {arm} AVG, rank {LATENCY_RELAY} a relay: every row (the relay's "
                  f"too) bit for bit the plain masked mean {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"15a world {world}: {arm} broke the relay contract")
    try:
        CollectiveEngine(6, Strategy.ring(6)).all_reduce(torch.ones(6, 8, device=dev), algo="rd")
    except ValueError as e:
        if str(e) != RD_WORLD6_REFUSAL:
            raise RuntimeError(f"15a: rd at world 6 refused in other words: {e}") from e
        print(f"latency 15a world 6: rd refused: {e}", flush=True)
    else:
        raise RuntimeError("15a: rd ran at world 6")


def _leaves(plan, buckets: list) -> list:
    """Each gradient leaf of the bucket plan as its own ``[world, n]``
    tensor, cut from the stacked buckets."""
    offsets = [0] * plan.num_buckets
    leaves = []
    for i, shape in enumerate(plan.leaf_shapes):
        b, n = plan.leaf_bucket[i], int(np.prod(shape))
        leaves.append(buckets[b][:, offsets[b]:offsets[b] + n].contiguous())
        offsets[b] += n
    return leaves


def selector_on_leaves(plan, buckets: list, smi: str) -> None:
    """Phase 15(b): ``auto`` on every leaf of the world-8 bf16 gradients."""
    leaves = _leaves(plan, buckets)
    trace = CollectiveTrace()
    eng = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD), trace=trace)
    timer = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD))
    taken: dict = {}
    for i, leaf in enumerate(leaves):
        out = eng.all_reduce(leaf, algo="auto", op=ReduceOp.AVG)
        impl = trace.events()[-1].impl
        count, nbytes, sizes = taken.get(impl, (0, 0, set()))
        taken[impl] = (count + 1, nbytes + leaf[0].numel() * 2, sizes | {leaf[0].numel() * 2})
        x = leaf.double()
        rows_same = all(same_bits(out[r], out[0]) for r in range(1, SCHEDULE_WORLD))
        within = bool(((out[0].double() - x.mean(0)).abs() <= SCHEDULE_BF16_TOL * x.abs().mean(0)).all())
        if not rows_same or not within:
            raise RuntimeError(f"15b leaf {i} ({tuple(leaf.shape)}) on {impl} failed its checks")
    for impl, (count, nbytes, sizes) in sorted(taken.items()):
        print(f"selector 15b: {impl}: {count} leaves, {nbytes / 2**20:.3f} MiB a rank, leaf sizes "
              f"{min(sizes)}-{max(sizes)} B a rank", flush=True)
    passes = {"auto": lambda: [timer.all_reduce(x, algo="auto", op=ReduceOp.AVG) for x in leaves],
              "psum plane": lambda: [timer.all_reduce(x, op=ReduceOp.AVG) for x in leaves]}
    for name, run in passes.items():
        times = time_dispatch(run, iters=1)
        wall = synced_ms(run, iters=3)
        print(f"selector 15b: {len(leaves)} leaves on {name}: {_fmt(times)} a pass; synced walltime {wall:.4f} ms "
              f"a pass; bound {sum(_stacked_bound_ms(x) for x in leaves):.4f} ms (bytes) ({smi})", flush=True)
    print(f"selector 15b: every leaf's rows identical and within {SCHEDULE_BF16_TOL} of the float64 mean; "
          f"crossover {eng._allreduce_crossover_bytes():.0f} B a rank at world {SCHEDULE_WORLD}", flush=True)


def _plain_cell(x: torch.Tensor, key) -> torch.Tensor:
    """The plain version of the cell a ring_allreduce dispatch ran: the
    latency plane's executor on CPU copies, or the plain ring walk."""
    if key.path in ALGO_PATHS:
        return CollectiveEngine(x.shape[0], Strategy.ring(x.shape[0]))._latency_allreduce(x.cpu(), key.path)[0]
    return plain_allreduce(x, key.wire_dtype)


def tuner_full_grid(dev: torch.device, workdir: str) -> None:
    """Phase 15(c): a choosing ``CollectiveEngine(8, ring(8))`` fills the
    full allreduce grid, rd and tree among its cells."""
    world = SCHEDULE_WORLD
    topology = mesh_fingerprint(dev, world=world)
    tuner = CollectiveTuner(world, topology, db=TuningDatabase(os.path.join(workdir, "grid.jsonl")), mode="choose")
    db, policy = tuner.db, tuner.policy
    trace = CollectiveTrace()
    eng = CollectiveEngine(world, Strategy.ring(world), trace=trace, tuner=tuner)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, nbytes in (("4 KiB", 4 << 10), ("4 MiB", 4 << 20)):
        x = torch.randn(world, nbytes // 4, device=dev, generator=gen)
        cells = policy.candidates("allreduce", nbytes, "float32")
        t0, dispatches, first = time.perf_counter(), 0, {}
        while any(db.count(c) < policy.trial_budget for c in cells):
            if dispatches >= TUNER_DISPATCH_CAP:
                raise RuntimeError(f"15c {label}: {dispatches} dispatches left cells under budget: "
                                   f"{[(_cell(c), db.count(c)) for c in cells]}")
            out = eng.ring_allreduce(x)
            dispatches += 1
            event = trace.events()[-1]
            key = tuner_measure._key_from_event(event, world, topology)
            if key not in cells:
                raise RuntimeError(f"15c {label}: dispatch {dispatches} ran {key}, outside the candidates")
            if key not in first:
                first[key] = None if key.path == QUANT_PATH else same_bits(out.cpu(), _plain_cell(x, key).cpu())
                if first[key] is False:
                    raise RuntimeError(f"15c {label}: cell {_cell(key)} disagrees with its plain version")
            del out
        span = time.perf_counter() - t0
        for c in cells:
            st = db.stats(c)
            print(f"tuner 15c {label} cell {_cell(c):28s}: {st.count} samples, median {st.median_s * 1e3:.4f} ms, "
                  f"iqr {st.iqr_s * 1e3:.4f}; prior {policy.prior_time(c, nbytes) * 1e3:.4f} ms; first dispatch bit "
                  f"for bit its plain version {'-' if first.get(c) is None else first[c]}", flush=True)
        plan = tuner.choose("allreduce", nbytes, "float32")
        print(f"tuner 15c {label}: {len(cells)} cells ({sum(c.path in ALGO_PATHS for c in cells)} rd/tree) filled "
              f"in {dispatches} dispatches ({span:.1f} s); chosen {_cell(plan.key)} (source {plan.source}, "
              f"{plan.expected_s * 1e3:.4f} ms)", flush=True)
        if not {"rd", "tree"} <= {c.path for c in cells} or plan.source != "measured":
            raise RuntimeError(f"15c {label}: the grid lacks rd/tree, or a filled grid chose by {plan.source}")


def _two_level_run(label: str, eng: CollectiveEngine, buckets: list, ref_ms: float, bound_ms: float,
                   smi: str, want_impl: str) -> None:
    """One two-level AVG allreduce of the world-8 buckets with rank 3 a
    relay: integer-valued bf16 bit for bit the plain masked mean on every
    row, each gradient bucket's rows identical and within
    ``SCHEDULE_BF16_TOL``; the pass by device time and launches."""
    gen = torch.Generator(device=buckets[0].device).manual_seed(SEED)
    ints = torch.randint(-8, 9, buckets[0].shape, device=buckets[0].device, generator=gen).to(torch.bfloat16)
    out = eng.all_reduce(ints, active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG)
    want = plain_masked(ints, SCHEDULE_ACTIVE, ReduceOp.AVG)()
    bits = all(same_bits(out[r], want) for r in range(SCHEDULE_WORLD))
    impl = eng.trace.events()[-1].impl
    del ints, out, want
    idx = torch.tensor(SCHEDULE_ACTIVE, device=buckets[0].device)
    for b, stacked in enumerate(buckets):
        out = eng.all_reduce(stacked, active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG)
        x = stacked.index_select(0, idx).double()
        rows_same = all(same_bits(out[r], out[0]) for r in range(1, SCHEDULE_WORLD))
        within = bool(((out[0].double() - x.mean(0)).abs() <= SCHEDULE_BF16_TOL * x.abs().mean(0)).all())
        if not rows_same or not within:
            raise RuntimeError(f"{label} bucket {b} failed its checks")
        del out, x
    torch.cuda.empty_cache()
    times = time_dispatch(lambda: [eng.all_reduce(x, active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG)
                                   for x in buckets], iters=2)
    extras = eng.trace.events()[-1].extra
    print(f"{label}: {impl} {extras.get('hier', '')}; integer-valued bf16 bit for bit the plain masked mean on "
          f"every row {'ok' if bits else 'FAIL'}; every bucket's rows identical and within {SCHEDULE_BF16_TOL} of "
          f"the float64 mean; {_fmt(times)} for the {len(buckets)} buckets; phase 11a (flat, this run) "
          f"{ref_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes) ({smi})", flush=True)
    if impl != want_impl or not bits:
        raise RuntimeError(f"{label} ran {impl}, not {want_impl}, or broke the bits")
    torch.cuda.empty_cache()


def two_level_full_width(buckets: list, ref_ms: float, bound_ms: float, smi: str) -> None:
    """Phase 15(d): the world-8 gradients on 2 slices × 4 of the one card."""
    strategy = parse_strategy_xml(SCHEDULE_XML)
    eng = CollectiveEngine(SCHEDULE_WORLD, strategy, trace=CollectiveTrace(), num_slices=TWO_LEVEL_SLICES)
    _two_level_run("two-level 15d(i) projected 4-4_1.xml", eng, buckets, ref_ms, bound_ms, smi, "schedule")
    if eng.trace.events()[-1].extra.get("merged") is not True:
        raise RuntimeError("15d(i) did not run the merged two-level plan")
    nbytes = sum(b[0].numel() * b.element_size() for b in buckets)
    ips = mesh_ip_table(SCHEDULE_WORLD, TWO_LEVEL_SLICES)
    t0 = time.perf_counter()
    composed = Synthesizer(None, ips, "hier").synthesize(ALLREDUCE, 1, nbytes, None, None)
    plan = hierarchy.plan_of(composed)
    print(f"two-level 15d(ii): hier policy on {ips[0]}..{ips[-1]} ({TWO_LEVEL_SLICES} x "
          f"{SCHEDULE_WORLD // TWO_LEVEL_SLICES}), {nbytes / 2**20:.1f} MiB a rank, card defaults: "
          f"{time.perf_counter() - t0:.4f} s; plan {plan.to_row()}", flush=True)
    if plan.pod_algo != "rs-ag":
        raise RuntimeError(f"15d(ii): the hier policy chose pod algo {plan.pod_algo}")
    eng = CollectiveEngine(SCHEDULE_WORLD, composed, trace=CollectiveTrace(), num_slices=TWO_LEVEL_SLICES)
    _two_level_run("two-level 15d(ii) composed", eng, buckets, ref_ms, bound_ms, smi, "two_level[composed]")


def facade_two_level(buckets: list, workdir: str) -> None:
    """Phase 15(e): the façade on the two-level world with the hier policy,
    then the milp policy on a two-host world-8 profile."""
    topo = os.path.join(workdir, "15e-hier")
    args = CommArgs(strategy_file=f"{topo}/strategy.xml", logical_graph=f"{topo}/logical_graph.xml",
                    topology_dir=topo, entry_point=DETECT, parallel_degree=2, policy="hier")
    t0 = time.perf_counter()
    AdapCC.init(args, world_size=SCHEDULE_WORLD, num_slices=TWO_LEVEL_SLICES)
    boot_s = time.perf_counter() - t0
    strategy = AdapCC.communicator._load_strategy()
    plan = hierarchy.plan_of(strategy)
    print(f"facade 15e: AdapCC.init(DETECT, policy='hier') on {SCHEDULE_WORLD} ranks as {TWO_LEVEL_SLICES} slices "
          f"in {boot_s:.2f} s; ip table {AdapCC.communicator.ip_table}; plan {plan.sketch.num_pods} x "
          f"{plan.sketch.pod_size}, pod {plan.pod_algo}, leader {plan.leader_algo}", flush=True)
    AdapCC.setup(ALLREDUCE)
    eng = AdapCC.communicator._engine(ALLREDUCE)
    eng.trace = CollectiveTrace()
    total = facade_allreduce("facade 15e (hier)", buckets, SCHEDULE_ACTIVE, iters=PHASE15_ITERS)
    impl = eng.trace.events()[-1].impl
    print(f"facade 15e (hier): {impl}; device {total['device_ms']:.4f} ms, {total['launches']} launches for the "
          f"{len(buckets)} buckets", flush=True)
    if impl != "two_level[composed]":
        raise RuntimeError(f"15e: the façade's hier strategy ran {impl}")
    AdapCC.clear(ALLREDUCE)
    topo = os.path.join(workdir, "15e-milp")
    os.makedirs(topo)
    write_ip_table(MILP_IPS, os.path.join(topo, "ip_table.txt"))
    args = CommArgs(strategy_file=f"{topo}/strategy.xml", logical_graph=f"{topo}/logical_graph.xml",
                    topology_dir=topo, entry_point=PROFILE, parallel_degree=2, policy="milp")
    t0 = time.perf_counter()
    AdapCC.init(args, world_size=SCHEDULE_WORLD)
    boot_s = time.perf_counter() - t0
    lat, bw = gather_topo_profile(topo, SCHEDULE_WORLD)
    t0 = time.perf_counter()
    again = Synthesizer(None, MILP_IPS, "milp").synthesize(ALLREDUCE, 2, args.default_chunk_bytes, bw, lat)
    solve_s = time.perf_counter() - t0
    strategy = AdapCC.communicator._load_strategy()
    print(f"facade 15e: AdapCC.init(PROFILE, policy='milp') on the two-host ip table {MILP_IPS} in {boot_s:.2f} s; "
          f"the solve alone {solve_s:.4f} s ({again.synthesis}); strategy {emit_strategy_xml(strategy)}", flush=True)
    if not strategy.synthesis.startswith("milp"):
        raise RuntimeError(f"15e: the milp policy synthesized {strategy.synthesis}")
    AdapCC.setup(ALLREDUCE)
    total = facade_allreduce("facade 15e (milp)", buckets, SCHEDULE_ACTIVE, iters=PHASE15_ITERS)
    print(f"facade 15e (milp): device {total['device_ms']:.4f} ms, {total['launches']} launches for the "
          f"{len(buckets)} buckets", flush=True)
    AdapCC.clear(ALLREDUCE)


def slice12(dev: torch.device, plan, buckets: list, ref_ms: float, bound_ms: float, smi: str) -> dict:
    """Phase 15, slice 12's main path (the module docstring); returns the
    launches of each kernel in it."""
    t15 = time.perf_counter()
    kernels = (*fa.KERNELS, *ring.KERNELS)
    for w in kernels:
        w.launches = 0
    marks = [time.perf_counter()]
    latency_plane(dev, smi)
    marks.append(time.perf_counter())
    selector_on_leaves(plan, buckets, smi)
    marks.append(time.perf_counter())
    with tempfile.TemporaryDirectory(prefix="adapcc_slice12_") as workdir:
        tuner_full_grid(dev, workdir)
        marks.append(time.perf_counter())
        two_level_full_width(buckets, ref_ms, bound_ms, smi)
        marks.append(time.perf_counter())
        facade_two_level(buckets, workdir)
        marks.append(time.perf_counter())
    ring.check_errors()
    p15 = {w.__name__: w.launches for w in kernels}
    parts = ", ".join(f"15{c} {b - a:.1f} s" for c, a, b in zip("abcde", marks, marks[1:]))
    print(f"phase 15 launches: {p15}; phase 15 {time.perf_counter() - t15:.1f} s ({parts})", flush=True)
    if not all(p15[k.__name__] for k in ring.KERNELS):
        raise RuntimeError(f"a ring kernel was not launched in phase 15: {p15}")
    return p15


# --------------------------------------------------------------------------- #
# phase 16: the schedule compiler's IR plane (slice 13)
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def ir_opt(value: str):
    """``ADAPCC_IR_OPT`` set to ``value`` inside the block."""
    old = os.environ.get(compiler.IR_OPT_ENV)
    os.environ[compiler.IR_OPT_ENV] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[compiler.IR_OPT_ENV]
        else:
            os.environ[compiler.IR_OPT_ENV] = old


def wire_bytes(program, n: int, elem_bytes: int) -> int:
    """Bytes every pair of the color plan ships in one run of ``program`` on
    ``n``-element rows: the payload dtype, or a fused codec's arrays."""
    seg = -(-n // program.chunks)
    block = program.block_size or DEFAULT_BLOCK_SIZE
    nblocks = -(-seg // block)
    total = 0
    for colors in ir_lower._color_rounds(program):
        for col in colors:
            rows = col.k * len(col.perm)
            if col.codec == "int8":
                total += rows * nblocks * (block + 4)
            elif col.codec == "bf16":
                total += rows * seg * 2
            else:
                total += rows * seg * elem_bytes
    return total


def _ir_programs(relay) -> dict:
    """Phase 16's programs at world 8, each with ``relay`` a relay where
    one is given: name -> program."""
    relays = () if relay is None else (relay,)
    strategy = parse_strategy_xml(SCHEDULE_XML)
    return {
        "ring": dataclasses.replace(compiler.ring_allreduce_program(SCHEDULE_WORLD), relays=relays),
        "rd": dataclasses.replace(compiler.rd_allreduce_program(SCHEDULE_WORLD), relays=relays),
        "tree": dataclasses.replace(compiler.tree_allreduce_program(SCHEDULE_WORLD), relays=relays),
        "4-4_1.xml": dataclasses.replace(compiler.program_from_strategy(strategy), relays=relays),
        "pipelined": dataclasses.replace(compiler.pipelined_allreduce_program(SCHEDULE_WORLD), relays=relays),
        "two-level": dataclasses.replace(compiler.two_level_allreduce_program(
            TWO_LEVEL_SLICES, SCHEDULE_WORLD // TWO_LEVEL_SLICES), relays=relays),
    }


def ir_gradients(buckets: list, bound_ms: float, ref_ms: float, smi: str) -> None:
    """Phase 16(a)-(b) on phase 11a's bf16 gradients, rank 3 a relay (AVG):
    each program through ``all_reduce(algo="ir")`` naive and optimized,
    against the plane JAX pins it to, timed beside that plane."""
    ips = mesh_ip_table(SCHEDULE_WORLD, TWO_LEVEL_SLICES)
    nbytes = sum(b[0].numel() * b.element_size() for b in buckets)
    composed = Synthesizer(None, ips, "hier").synthesize(ALLREDUCE, 1, nbytes, None, None)
    flat_ring = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD, SCHEDULE_WORLD),
                                 trace=CollectiveTrace(), use_xla_fastpath=False)
    flat = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD), trace=CollectiveTrace())
    two_level = CollectiveEngine(SCHEDULE_WORLD, composed, trace=CollectiveTrace(), num_slices=TWO_LEVEL_SLICES)
    active = dict(active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG)
    # the plane JAX pins each program to, and whether the two add in one
    # order (bit for bit on any data) or not (bit for bit on integer-valued
    # data, within SCHEDULE_BF16_TOL of the float64 mean on the gradients)
    legacy = {
        "ring": (lambda x: flat_ring.all_reduce(x, **active), "merged plane ring(8, 8)", True),
        "rd": (lambda x: flat.all_reduce(x, algo="rd", **active), "latency plane rd", True),
        "tree": (lambda x: flat.all_reduce(x, algo="tree", **active), "latency plane tree", True),
        "4-4_1.xml": (lambda x: plain_masked(x, SCHEDULE_ACTIVE, ReduceOp.AVG)().expand_as(x),
                      "plain masked mean", False),
        "pipelined": (lambda x: plain_masked(x, SCHEDULE_ACTIVE, ReduceOp.AVG)().expand_as(x),
                      "plain masked mean", False),
        "two-level": (lambda x: two_level.all_reduce(x, **active), "composed plan (15d(ii))", False),
    }
    gen = torch.Generator(device=buckets[0].device).manual_seed(SEED)
    ints = torch.randint(-8, 9, buckets[0].shape, device=buckets[0].device, generator=gen).to(torch.bfloat16)
    idx = torch.tensor(SCHEDULE_ACTIVE, device=buckets[0].device)
    live = SCHEDULE_ACTIVE
    for name, program in _ir_programs(LATENCY_RELAY).items():
        eng = two_level if name == "two-level" else flat
        eng.set_schedule_program(program)
        ref, ref_name, same_order = legacy[name]
        row = {}
        for opt in ("off", "on"):
            with ir_opt(opt):
                ran = eng.optimized_schedule_program()
                out = eng.all_reduce(ints, algo="ir", op=ReduceOp.AVG)
                ev = eng.trace.events()[-1]
                want = ref(ints)
                bits = all(same_bits(out[r], want[r]) for r in live)
                grads_ok = True
                for b, stacked in enumerate(buckets):
                    out = eng.all_reduce(stacked, algo="ir", op=ReduceOp.AVG)
                    n = stacked.shape[1]
                    if same_order and (name != "ring" or n % SCHEDULE_WORLD == 0):
                        grads_ok &= all(same_bits(out[r], w) for r, w in zip(live, ref(stacked)[idx]))
                    else:
                        x = stacked.index_select(0, idx).double()
                        grads_ok &= bool(((out[idx].double() - x.mean(0)).abs()
                                          <= SCHEDULE_BF16_TOL * x.abs().mean(0)).all())
                    del out
                times = time_dispatch(lambda: [eng.all_reduce(x, algo="ir", op=ReduceOp.AVG) for x in buckets],
                                      iters=PHASE16_ITERS)
                wall = synced_ms(lambda: [eng.all_reduce(x, algo="ir", op=ReduceOp.AVG) for x in buckets],
                                 iters=PHASE16_ITERS)
            row[opt] = times["device_ms"]
            if name == "ring" and opt == "off":  # where the executor's time goes, op by op
                one = lambda: eng.all_reduce(buckets[0], algo="ir", op=ReduceOp.AVG)  # noqa: E731
                profile_step("ir 16a ring bucket 0", one, synced_ms(one, iters=PHASE16_ITERS))
            print(f"ir 16a {name} (ADAPCC_IR_OPT={opt}): {ev.extra['program']} {ran.fingerprint()} passes "
                  f"{ev.extra['passes']}, {ev.extra['dispatches']} dispatches{' ' + ev.extra['hier'] if 'hier' in ev.extra else ''}; "
                  f"integer-valued bf16 bit for bit the {ref_name} on every live row {'ok' if bits else 'FAIL'}; "
                  f"gradients {'bit for bit the ' + ref_name if same_order else 'within ' + str(SCHEDULE_BF16_TOL) + ' of the float64 mean'} "
                  f"{'ok' if grads_ok else 'FAIL'}; {_fmt(times)}; synced walltime {wall:.4f} ms for the "
                  f"{len(buckets)} buckets; bound {bound_ms:.4f} ms ({smi})", flush=True)
            if ev.impl != "ir" or not bits or not grads_ok:
                raise RuntimeError(f"16a {name} (ADAPCC_IR_OPT={opt}) failed its checks")
        torch.cuda.empty_cache()
        legacy_times = time_dispatch(lambda: [ref(x) for x in buckets], iters=PHASE16_ITERS)
        print(f"ir 16a {name}: the {ref_name} {_fmt(legacy_times)} for the buckets; device ms naive "
              f"{row['off']:.4f}, optimized {row['on']:.4f}, bound {bound_ms:.4f}, phase 11a's merged plane on "
              f"4-4_1.xml (this run) {ref_ms:.4f} ({smi})", flush=True)
        torch.cuda.empty_cache()


def ir_float32(dev: torch.device, smi: str) -> None:
    """Phase 16(a)-(c) at world 8 on float32, 4 KiB and 4 MiB a rank: the
    IR ring, rd and tree bit for bit their planes, naive against optimized
    bit for bit on every program (live rows), rd coalesced to one dispatch a
    round, and the fused int8 ring bit for bit its unfused form."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flat_ring = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD, SCHEDULE_WORLD),
                                 use_xla_fastpath=False)
    flat = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD), trace=CollectiveTrace())
    two_level = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD), trace=CollectiveTrace(),
                                 num_slices=TWO_LEVEL_SLICES)
    legacy = {"ring": lambda x: flat_ring.all_reduce(x), "rd": lambda x: flat.all_reduce(x, algo="rd"),
              "tree": lambda x: flat.all_reduce(x, algo="tree")}
    for nbytes in IR_BYTES:
        x = torch.randn(SCHEDULE_WORLD, nbytes // 4, device=dev, generator=gen)
        for name, program in _ir_programs(None).items():
            eng = two_level if name == "two-level" else flat
            eng.set_schedule_program(program)
            outs, row = {}, {}
            for opt in ("off", "on"):
                with ir_opt(opt):
                    outs[opt] = eng.all_reduce(x, algo="ir")
                    ev = eng.trace.events()[-1]
                    times = time_dispatch(lambda: eng.all_reduce(x, algo="ir"), iters=PHASE16_ITERS)
                    wall = synced_ms(lambda: eng.all_reduce(x, algo="ir"), iters=PHASE16_ITERS)
                row[opt] = (ev.extra["dispatches"], times, wall)
            same = same_bits(outs["off"], outs["on"])
            legacy_ok, legacy_times = None, None
            if name in legacy:
                legacy_ok = same_bits(outs["off"], legacy[name](x))
                legacy_times = time_dispatch(lambda: legacy[name](x), iters=PHASE16_ITERS)
            exact = x.double().sum(0)
            within = bool(((outs["on"].double() - exact).abs()
                           <= (SCHEDULE_WORLD - 1) * 2.0 ** -24 * x.double().abs().sum(0)).all())
            print(f"ir 16b world {SCHEDULE_WORLD} {nbytes} B a rank {name}: naive {row['off'][0]} dispatches "
                  f"{_fmt(row['off'][1])}, synced {row['off'][2]:.4f} ms; optimized {row['on'][0]} dispatches "
                  f"{_fmt(row['on'][1])}, synced {row['on'][2]:.4f} ms; float32 naive and optimized bit for bit "
                  f"{'ok' if same else 'FAIL'}; within (w-1)*2^-24*sum|x| of the float64 sum "
                  f"{'ok' if within else 'FAIL'}"
                  + ("" if legacy_ok is None else f"; bit for bit its plane {'ok' if legacy_ok else 'FAIL'} "
                     f"({_fmt(legacy_times)})")
                  + f"; bound {_stacked_bound_ms(x):.6f} ms ({smi})", flush=True)
            if not same or not within or legacy_ok is False:
                raise RuntimeError(f"16b {nbytes} B {name} failed its checks")
            if name == "rd" and row["on"][0] != int(np.log2(SCHEDULE_WORLD)) * 2:
                raise RuntimeError(f"16b: rd at world 8 optimized to {row['on'][0]} dispatches, not one a round")
        # (c) the fused int8 ring against its unfused form
        program = compiler.ring_allreduce_program(SCHEDULE_WORLD, wire_dtype="int8")
        flat.set_schedule_program(program)
        outs, row = {}, {}
        for opt in ("off", "on"):
            with ir_opt(opt):
                ran = flat.optimized_schedule_program()
                outs[opt] = flat.all_reduce(x, algo="ir")
                row[opt] = (ran, time_dispatch(lambda: flat.all_reduce(x, algo="ir"), iters=PHASE16_ITERS))
        same = same_bits(outs["off"], outs["on"])
        n = x.shape[1]
        fused_b, plain_b = wire_bytes(row["on"][0], n, 4), wire_bytes(row["off"][0], n, 4)
        print(f"ir 16c world {SCHEDULE_WORLD} {nbytes} B a rank int8 ring: fused ({row['on'][0].applied_passes}, "
              f"block {row['on'][0].block_size}, {ir_lower.dispatch_count(row['on'][0])} dispatches) bit for bit "
              f"its unfused form ({ir_lower.dispatch_count(row['off'][0])} dispatches) {'ok' if same else 'FAIL'}; "
              f"wire bytes of a run {fused_b} fused against {plain_b} float32 ({fused_b / plain_b:.4f}); fused "
              f"{_fmt(row['on'][1])}, unfused {_fmt(row['off'][1])} ({smi})", flush=True)
        if not same or "fuse_codec" not in row["on"][0].applied_passes:
            raise RuntimeError(f"16c {nbytes} B: the fused int8 ring differs from its unfused form")
        del x, outs
    torch.cuda.empty_cache()


def ir_tuner(dev: torch.device, workdir: str) -> None:
    """Phase 16(d): a recording tuner fills the ``ir`` cell (the ring, which
    the passes leave alone) and the ``ir-opt`` cell (rd, which they
    coalesce); the cells join a grid that names "ir"."""
    topology = mesh_fingerprint(dev, world=SCHEDULE_WORLD)
    path = os.path.join(workdir, "ir.jsonl")
    tuner = CollectiveTuner(SCHEDULE_WORLD, topology, db=TuningDatabase(path), mode="record")
    eng = CollectiveEngine(SCHEDULE_WORLD, Strategy.ring(SCHEDULE_WORLD), trace=CollectiveTrace(), tuner=tuner)
    x = torch.randn(SCHEDULE_WORLD, IR_BYTES[-1] // 4, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    with ir_opt("on"):
        for program in (compiler.ring_allreduce_program(SCHEDULE_WORLD), compiler.rd_allreduce_program(SCHEDULE_WORLD)):
            eng.set_schedule_program(program)
            for _ in range(1 + tuner.policy.trial_budget):
                eng.all_reduce(x, algo="ir")
    cells = tuner.policy.candidates("allreduce", IR_BYTES[-1], "float32", algos=("ir",))
    paths = {c.path: c for c in cells}
    tuner.db.save()
    with open(path) as f:
        first = f.readline().strip()
    for p in (IR_PATH, IR_OPT_PATH):
        if p not in paths:
            raise RuntimeError(f"16d: the recording tuner left no {p} cell: {cells}")
        st = tuner.db.stats(paths[p])
        print(f"ir 16d cell {_cell(paths[p])}: {st.count} samples, median {st.median_s * 1e3:.4f} ms", flush=True)
    print(f"ir 16d: the database's first line {first}", flush=True)
    if {IR_PATH, IR_OPT_PATH} & {c.path for c in tuner.policy.candidates("allreduce", IR_BYTES[-1], "float32")}:
        raise RuntimeError("16d: an IR cell joined the default grid")


def slice13(dev: torch.device, buckets: list, ref_ms: float, smi: str) -> dict:
    """Phase 16, slice 13's main path (the module docstring); returns the
    launches of each kernel in it, which must be none."""
    t16 = time.perf_counter()
    kernels = (*fa.KERNELS, *ring.KERNELS)
    for w in kernels:
        w.launches = 0
    bound_ms = sum(_stacked_bound_ms(b) for b in buckets)
    marks = [time.perf_counter()]
    ir_gradients(buckets, bound_ms, ref_ms, smi)
    marks.append(time.perf_counter())
    ir_float32(dev, smi)
    marks.append(time.perf_counter())
    with tempfile.TemporaryDirectory(prefix="adapcc_slice13_") as workdir:
        ir_tuner(dev, workdir)
    marks.append(time.perf_counter())
    p16 = {w.__name__: w.launches for w in kernels}
    parts = ", ".join(f"{c} {b - a:.1f} s" for c, a, b in zip(("16a", "16b-c", "16d"), marks, marks[1:]))
    print(f"phase 16 launches: {p16} (no kernel lies on the IR path); phase 16 {time.perf_counter() - t16:.1f} s "
          f"({parts})", flush=True)
    if any(p16.values()):
        raise RuntimeError(f"phase 16 launched a kernel: {p16}")
    return p16


# --------------------------------------------------------------------------- #
# phase 17: elastic failover and the supervisor (slice 14)
# --------------------------------------------------------------------------- #


def standby_ranking(buckets: list) -> tuple:
    """17(a): the standby cache of the world-8 engine over ``4-4_1.xml``,
    ranked on the cost model's H100 defaults, the top plans warmed on every
    bucket's shape (AVG, the op of 17(b)).  Returns (engine, trace, cache,
    per-rank bytes)."""
    trace = CollectiveTrace()
    eng = CollectiveEngine(SCHEDULE_WORLD, parse_strategy_xml(SCHEDULE_XML), trace=trace)
    per_rank = sum(b[0].numel() * b.element_size() for b in buckets)
    cache = StandbyPlanCache(eng, nbytes=per_rank, top_k=FAILOVER_WARM_K,
                             cost_model=cost_model.LinkCostModel(SCHEDULE_WORLD, source="defaults"),
                             device=buckets[0].device)
    t0 = time.perf_counter()
    plans = cache.build()
    build_s = time.perf_counter() - t0
    print(f"failover 17a: StandbyPlanCache.build() of {len(plans)} scenarios in {build_s:.4f} s (host), "
          f"{per_rank / 2**20:.1f} MiB a rank, cost model {cache.cost_model!r} (H100 defaults)", flush=True)
    for p in plans:
        print(f"failover 17a: {p.label:16s} {p.strategy.synthesis} x{p.strategy.num_trans} predicted "
              f"{p.predicted_s * 1e3:.4f} ms", flush=True)
    if len(plans) != SCHEDULE_WORLD + 2 or sum(p.label.startswith("host") for p in plans) != 2:
        raise RuntimeError(f"17a: expected {SCHEDULE_WORLD} one-rank-down and 2 one-host-down plans, got "
                           f"{[p.label for p in plans]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in buckets:
        warmed = cache.warm((b.shape[1],), b.dtype, op=ReduceOp.AVG)
    torch.cuda.synchronize()
    print(f"failover 17a: warm of the top {FAILOVER_WARM_K} ({[p.label for p in warmed]}) on the {len(buckets)} "
          f"bucket shapes in {time.perf_counter() - t0:.4f} s ({FAILOVER_WARM_K * len(buckets)} zeros "
          f"dispatches); engine strategy restored {eng.strategy is cache.base_strategy}", flush=True)
    if eng.strategy is not cache.base_strategy:
        raise RuntimeError("17a: warm left the engine on a standby strategy")
    return eng, trace, cache, per_rank


def _one_rank_down(plans, exclude) -> int:
    """The rank of the first one-rank-down plan of ``plans`` whose rank is
    not in ``exclude``."""
    return next(int(p.label[4:-5]) for p in plans if p.label.startswith("rank") and int(p.label[4:-5]) not in exclude)


def supervised_failover(eng, trace, cache, buckets: list, workdir: str, smi: str) -> tuple:
    """17(b)-(c): the supervised failover on the card, then a restart on the
    same journal.  Returns (fault plan, per-step synced walltime ms)."""
    ranked = cache.ranked()
    warm_rank = _one_rank_down(ranked[:FAILOVER_WARM_K], {FAILOVER_SLOW})
    cold_rank = _one_rank_down(ranked[FAILOVER_WARM_K:], {FAILOVER_SLOW, warm_rank})
    plan = FaultPlan([FaultEvent(0, "slow", FAILOVER_SLOW), FaultEvent(FAILOVER_DOWN[0], "down", warm_rank),
                      FaultEvent(FAILOVER_DOWN[1], "recover", warm_rank),
                      FaultEvent(FAILOVER_COLD_STEP, "down", cold_rank)], SCHEDULE_WORLD, label="phase17")
    logic = CoordinatorLogic(SCHEDULE_WORLD, fault_plan=plan)
    step = [0]
    clock = [0.0]
    journal = os.path.join(workdir, "supervisor.journal")
    config = LivenessConfig(timeout_s=100.0, period_s=1.0, grace=1)
    sup = Supervisor(logic, cache=cache, fault_plan=plan, step_source=lambda: step[0], journal_path=journal,
                     config=config, clock=lambda: clock[0])
    print(f"failover 17b: plan {[e.to_dict() for e in plan.events]} (rank {warm_rank}: best-ranked warmed "
          f"one-rank-down plan; rank {cold_rank}: built, not warmed)", flush=True)
    # bucket 0's CPU run, once a (strategy, active set): the steps between two
    # swaps repeat the same call, whose card result must repeat too
    cpu_b0, cpu_refs = buckets[0].cpu(), {}
    walls, hits = [], {}
    for s in range(FAILOVER_STEPS):
        step[0], clock[0] = s, float(s)
        t0 = time.perf_counter()
        taken = sup.poll()
        poll_ms = (time.perf_counter() - t0) * 1e3
        active = sup.applied_view.active_list()
        epoch = sup.engine_epoch
        n_before = len(trace.events())

        def dispatch(active=active, epoch=epoch):
            return [eng.all_reduce(b, active_gpus=active, op=ReduceOp.AVG, epoch=epoch) for b in buckets]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = dispatch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        walls.append(wall_ms)
        events = [e for e in trace.events()[n_before:] if e.primitive == "allreduce"]
        hit = [bool(e.extra["cache_hit"]) for e in events]
        hits[s] = hit
        dev_ms, dev_launches = device_stats(dispatch, iters=1, warmup=0)
        label = next((p.label for p in cache.plans.values() if p.strategy is eng.strategy), "base")
        rows_same = all(same_bits(o[r], o[0]) for o in outs for r in range(1, SCHEDULE_WORLD))
        act = torch.tensor(active, device=buckets[0].device)
        within = all(bool(((o[0].double() - b.index_select(0, act).double().mean(0)).abs()
                           <= SCHEDULE_BF16_TOL * b.index_select(0, act).double().abs().mean(0)).all())
                     for o, b in zip(outs, buckets))
        key = (eng.strategy.fingerprint(), tuple(active))
        if key not in cpu_refs:
            cpu_refs[key] = CollectiveEngine(SCHEDULE_WORLD, eng.strategy).all_reduce(
                cpu_b0, active_gpus=active, op=ReduceOp.AVG).to(buckets[0].device)
        exact = same_bits(outs[0], cpu_refs[key])
        print(f"failover 17b step {s}: decisions {[d['kind'] for d in taken]} (poll {poll_ms:.3f} ms); WorldView "
              f"epoch {sup.worldview().epoch}, engine epoch {epoch}; mask {sup.current_mask().astype(int).tolist()}; "
              f"plan {label}; cache_hit {hit}; synced walltime {wall_ms:.3f} ms, device {dev_ms:.4f} ms "
              f"({dev_launches} launches); rows identical {'ok' if rows_same else 'FAIL'}, within "
              f"{SCHEDULE_BF16_TOL} of the float64 mean {'ok' if within else 'FAIL'}, bucket 0 bit for bit CPU "
              f"{'ok' if exact else 'FAIL'}", flush=True)
        if not (rows_same and within and exact):
            raise RuntimeError(f"17b step {s} failed its checks")
        if s == FAILOVER_DOWN[0]:
            try:
                eng.all_reduce(buckets[0], active_gpus=active, op=ReduceOp.AVG, epoch=epoch - 1)
            except comm_engine.EpochMismatch as e:
                print(f"failover 17b: a dispatch at the pre-swap epoch raises: {e}", flush=True)
            else:
                raise RuntimeError("17b: a dispatch at the pre-swap epoch ran")
        del outs
    del cpu_b0, cpu_refs
    # the cold plan misses once a key: a bucket of a shape an earlier bucket
    # of its step had finds the plan that dispatch prepared
    shapes = [tuple(b.shape) for b in buckets]
    cold = [shapes.index(sh) != i for i, sh in enumerate(shapes)]
    want = {FAILOVER_DOWN[0]: [True] * len(buckets), FAILOVER_DOWN[1]: [True] * len(buckets), FAILOVER_COLD_STEP: cold}
    for s, hit in want.items():
        if hits[s] != hit:
            raise RuntimeError(f"17b step {s}: expected cache_hit {hit}, got {hits[s]}")
    swaps = [json.loads(line) for line in open(journal) if '"swap"' in line]
    print(f"failover 17b: swaps {[(d['label'], d['warmed'], d['engine_epoch']) for d in swaps]}; supervisor trace "
          f"records {sum(e.primitive == 'supervisor' for e in trace.events())}", flush=True)
    # 17c: a restart on the same journal
    view, engine_epoch = sup.applied_view, eng.epoch
    sup.stop()
    t0 = time.perf_counter()
    sup2 = Supervisor(logic, cache=cache, fault_plan=plan, step_source=lambda: step[0], journal_path=journal,
                      config=config, clock=lambda: clock[0])
    resume_ms = (time.perf_counter() - t0) * 1e3
    same = sup2.applied_view == view and eng.epoch == engine_epoch and sup2.engine_epoch == engine_epoch
    sup2.stop()
    probe = DecisionJournal(os.path.join(workdir, "probe.journal"))
    appends = []
    for i in range(JOURNAL_APPENDS):
        t0 = time.perf_counter()
        probe.append("probe", i=i)
        appends.append(time.perf_counter() - t0)
    probe.close()
    print(f"failover 17c: restart resumed in {resume_ms:.3f} ms to {sup2.applied_view} "
          f"{'ok' if same else 'FAIL'} (engine epoch {eng.epoch}, no bump); fsync'd append median "
          f"{float(np.median(appends)) * 1e6:.1f} us over {JOURNAL_APPENDS} (the checkout's file system)", flush=True)
    if not same:
        raise RuntimeError("17c: the restart did not resume to an equal WorldView without an epoch bump")
    return plan, walls


def failover_model(plan, cache, per_rank: int, walls: list, smi: str) -> None:
    """17(d): ``simulate_fault_plan`` on the cache's cost model beside the
    measured walltimes."""
    rows = simulate_fault_plan(cache.base_strategy, cache.cost_model, per_rank, plan, steps=FAILOVER_STEPS)
    for row, wall in zip(rows, walls):
        print(f"failover 17d step {row.step}: model {row.to_row()}; measured synced walltime {wall:.3f} ms",
              flush=True)
    steady_steps = [r.step for r in rows if not r.swapped]
    steady = float(np.median([walls[s] for s in steady_steps]))
    print(f"failover 17d: measured steady {steady:.3f} ms (the median of steps {steady_steps}), warm failover "
          f"{walls[FAILOVER_DOWN[0]]:.3f} ms, cold failover {walls[FAILOVER_COLD_STEP]:.3f} ms; the model's swap "
          f"stall {rows[FAILOVER_DOWN[0]].swap_s * 1e3:.3f} ms warm (its prior). On one card every 'link' is HBM and "
          f"the host's dispatch, not NVLink or a NIC: the model prices links this card does not have ({smi})",
          flush=True)


def supervised_trainer(dev: torch.device, init_state, tokens, c_losses: list) -> dict:
    """17(e): ``DDPTrainer(sync_mode="schedule", dynamic_mask=True,
    bsp=False)`` at world 1 under a world-1 supervisor, 5 steps from phase
    5's weights and batch; then ``prewarm`` of a second world-1 strategy
    (state bit for bit unchanged), ``adopt_strategy`` and one more step.
    Returns the flash kernels' launches."""
    for w in fa.KERNELS:
        w.launches = 0
    world = build_world_mesh(1)
    try:
        model = GPT2(MAIN, device=dev, seed=None).to(torch.bfloat16)
        model.load_state_dict(init_state)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(3e-4), world, Strategy.ring(1),
                             sync_mode="schedule", dynamic_mask=True, bsp=False)
        sup = Supervisor(CoordinatorLogic(1), trainer=trainer)
        trainer.attach_supervisor(sup)
        state = TrainState.create(model, trainer.tx)
        losses = [trainer.step(state, tokens)[1].item() for _ in range(STEPS)]
        print(f"failover 17e (supervised DDP, bsp=False, world 1): losses {losses}; bit for bit phase 11c's "
              f"{'ok' if losses == c_losses else 'FAIL'}", flush=True)
        if losses != c_losses:
            raise RuntimeError(f"17e: the supervised async-relay steps differ from phase 11c's: {losses} vs {c_losses}")
        before = ({k: v.clone() for k, v in model.state_dict().items()},
                  [{k: v.clone() for k, v in st.items() if torch.is_tensor(v)} for st in state.optimizer.state.values()],
                  [d.clone() for d in trainer._deferred])
        r0 = trainer.recompiles
        standby = Strategy.ring(1, num_trans=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warmed = trainer.prewarm(standby, state, tokens)
        torch.cuda.synchronize()
        prewarm_ms = (time.perf_counter() - t0) * 1e3
        after = ({k: v.clone() for k, v in model.state_dict().items()},
                 [{k: v.clone() for k, v in st.items() if torch.is_tensor(v)} for st in state.optimizer.state.values()],
                 [d.clone() for d in trainer._deferred])
        unchanged = (all(same_bits(before[0][k], after[0][k]) for k in before[0])
                     and all(same_bits(a[k], b[k]) for a, b in zip(before[1], after[1]) for k in a)
                     and all(same_bits(a, b) for a, b in zip(before[2], after[2])))
        r1 = trainer.recompiles
        adopted = trainer.adopt_strategy(standby)
        more = trainer.step(state, tokens)[1].item()
        r2 = trainer.recompiles
        print(f"failover 17e: prewarm {warmed} in {prewarm_ms:.2f} ms, state bit for bit unchanged "
              f"{'ok' if unchanged else 'FAIL'}; recompiles {r0} -> {r1} (prewarm) -> {r2} (adopt_strategy "
              f"{adopted}, one more step, loss {more})", flush=True)
        if not (warmed and unchanged and adopted and r1 == r0 + 1 and r2 == r1):
            raise RuntimeError("17e: prewarm/adopt_strategy failed its checks")
    finally:
        destroy_world()
    launches = {w.__name__: w.launches for w in fa.KERNELS}
    want = MAIN.n_layer * (STEPS + 1)
    if any(n != want for n in launches.values()):
        raise RuntimeError(f"17e: expected {want} launches of each flash kernel, got {launches}")
    return launches


def facade_sim_rank(buckets: list, workdir: str) -> None:
    """17(f): ``AdapCC.init(policy="sim-rank")`` at world 8, its winner and
    the synthesis seconds, one relayed allreduce of the buckets."""
    topo = os.path.join(workdir, "17f")
    args = CommArgs(strategy_file=f"{topo}/strategy.xml", logical_graph=f"{topo}/logical_graph.xml",
                    topology_dir=topo, entry_point=DETECT, parallel_degree=2, policy="sim-rank")
    t0 = time.perf_counter()
    AdapCC.init(args, world_size=SCHEDULE_WORLD)
    boot_s = time.perf_counter() - t0
    comm = AdapCC.communicator
    lat, bw = gather_topo_profile(topo, SCHEDULE_WORLD)
    t0 = time.perf_counter()
    again = Synthesizer(None, comm.ip_table, "sim-rank").synthesize(ALLREDUCE, 2, args.default_chunk_bytes, bw, lat)
    synth_s = time.perf_counter() - t0
    strategy = comm._load_strategy()
    print(f"failover 17f: AdapCC.init(DETECT, policy='sim-rank') on {SCHEDULE_WORLD} ranks in {boot_s:.2f} s; "
          f"winner {strategy.synthesis} x{strategy.num_trans}, wire_dtype {strategy.wire_dtype}; the ranking pass "
          f"alone {synth_s:.4f} s ({again.synthesis})", flush=True)
    if not strategy.synthesis.endswith("+sim-rank"):
        raise RuntimeError(f"17f: the sim-rank policy synthesized {strategy.synthesis}")
    AdapCC.setup(ALLREDUCE)
    try:
        outs = [AdapCC.allreduce(b, active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG) for b in buckets]
        exact = same_bits(outs[0].cpu(), CollectiveEngine(SCHEDULE_WORLD, strategy).all_reduce(
            buckets[0].cpu(), active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG))
        print(f"failover 17f: relayed AVG allreduce of the {len(buckets)} buckets (rank 3 a relay); bucket 0 bit "
              f"for bit the CPU call {'ok' if exact else 'FAIL'}", flush=True)
        if not exact:
            raise RuntimeError("17f: the sim-rank strategy's allreduce differs from its CPU run")
    finally:
        AdapCC.clear(ALLREDUCE)


def slice14(dev: torch.device, init_state, tokens, buckets: list, c_losses: list, smi: str) -> dict:
    """Phase 17, slice 14's main path (the module docstring); returns the
    launches of each kernel in it (the flash kernels, from 17(e) alone)."""
    t17 = time.perf_counter()
    for w in ring.KERNELS:
        w.launches = 0
    marks = [time.perf_counter()]
    eng, trace, cache, per_rank = standby_ranking(buckets)
    marks.append(time.perf_counter())
    with tempfile.TemporaryDirectory(prefix="adapcc_slice14_") as workdir:
        plan, walls = supervised_failover(eng, trace, cache, buckets, workdir, smi)
        marks.append(time.perf_counter())
        failover_model(plan, cache, per_rank, walls, smi)
        marks.append(time.perf_counter())
        del eng, trace, cache
        torch.cuda.empty_cache()
        p17 = supervised_trainer(dev, init_state, tokens, c_losses)
        marks.append(time.perf_counter())
        facade_sim_rank(buckets, workdir)
        marks.append(time.perf_counter())
    p17.update({w.__name__: w.launches for w in ring.KERNELS})
    parts = ", ".join(f"{c} {b - a:.1f} s" for c, a, b in zip(("17a", "17b-c", "17d", "17e", "17f"), marks, marks[1:]))
    print(f"phase 17 launches: {p17} (the flash kernels from 17e; no ring kernel lies on the failover path); "
          f"phase 17 {time.perf_counter() - t17:.1f} s ({parts})", flush=True)
    if any(p17[w.__name__] for w in ring.KERNELS):
        raise RuntimeError(f"phase 17 launched a ring kernel: {p17}")
    return p17


# --------------------------------------------------------------------------- #
# phase 18: the online adaptation loop (slice 15)
# --------------------------------------------------------------------------- #


def _drill_model(scale: float = 1.0, source: str = "drill") -> cost_model.LinkCostModel:
    """JAX's drill model: the JAX package's default classes as explicit
    coefficients (1 us and 45 GB/s inside a host, 25 us and 12.5 GB/s
    between hosts), the inter-host class ``scale`` times slower, on
    ``ADAPT_DRILL_IPS``."""
    return cost_model.LinkCostModel(
        SCHEDULE_WORLD, classes={cost_model.ICI: cost_model.LinkCoeffs(1e-6, 1.0 / 45e9),
                                 cost_model.DCN: cost_model.LinkCoeffs(25e-6, 1.0 / 12.5e9).scaled(scale)},
        ips=ADAPT_DRILL_IPS, source=f"{source}-x{scale:g}")


def _drill_controller(eng, model, cal_path: str, nbytes: int, bucket: torch.Tensor, fingerprint: str,
                      **kwargs) -> AdaptationController:
    """JAX's drill controller (window 4, factor 2, degree 2), warming on
    ``bucket``'s per-rank shape and dtype on its device."""
    table = [ADAPT_DRILL_IPS[r] for r in range(SCHEDULE_WORLD)]
    return AdaptationController(
        eng, Synthesizer(None, table), mode="swap", cost_model=model, calibration_path=cal_path, nbytes=nbytes,
        parallel_degree=2, warm_shape=tuple(bucket.shape[1:]), warm_dtype=bucket.dtype, fingerprint=fingerprint,
        detector=DriftDetector(SCHEDULE_WORLD, fingerprint, cost_model=model, factor=2.0, window=4),
        device=bucket.device, **kwargs)


def _signal(label: str, sig) -> str:
    return (f"{label} {sig.key.primitive} {_cell(sig.key)} @{sig.key.size_bucket / 2**20:g} MiB: median "
            f"{sig.median_s * 1e3:.4f} ms, reference {sig.reference_s * 1e3:.4f} ms ({sig.reference}), ratio "
            f"{sig.ratio:.4f}, fired {sig.fired} ({sig.count} samples)")


def _timed_buckets(eng, buckets: list) -> tuple:
    """One relayed SUM dispatch of every bucket: (synced walltime ms,
    device ms, launches), after a dispatch that prepares every shape."""
    def dispatch():
        return [eng.all_reduce(b, active_gpus=SCHEDULE_ACTIVE) for b in buckets]

    dispatch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = dispatch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    del outs
    dev_ms, launches = device_stats(dispatch, iters=1, warmup=0)
    return wall_ms, dev_ms, launches


def _window(eng, trace, buckets: list, x8: torch.Tensor, rounds: int, check: bool) -> float:
    """``rounds`` rounds of the 18(a) cells on the recording engine: every
    bucket unmasked (the ``xla`` cells) and the ring plane's float32 and
    int8 allreduce of ``x8``; with ``check`` the first ring dispatches are
    held bit for bit against their plain walk.  Returns the seconds."""
    t0 = time.perf_counter()
    for i in range(rounds):
        for b in buckets:
            eng.all_reduce(b)
        for wire in ("off", "int8"):
            out = eng.ring_allreduce(x8, wire_dtype=wire)
            if check and i == 0:
                event = trace.events()[-1]
                exact = same_bits(out, plain_allreduce(x8, wire))
                print(f"adapt 18a: ring_allreduce {wire} on {x8.shape[1] * 4 / 2**20:.1f} MiB a rank at world "
                      f"{SCHEDULE_WORLD}: {event.impl}; bit for bit its plain walk {'ok' if exact else 'FAIL'}",
                      flush=True)
                if not exact:
                    raise RuntimeError(f"18a: the {wire} ring allreduce differs from its plain walk")
            del out
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _medians(db, window: int) -> dict:
    """Each cell's median over its newest ``window`` samples."""
    return {key: float(np.median(db.samples(key)[-window:])) for key in db.keys()}


def adapt_detector(dev: torch.device, buckets: list, grads: torch.Tensor, workdir: str, smi: str) -> None:
    """18(a): the detector over the card's own cells (the module
    docstring).  A first window calibrates, a second one is the healthy
    control, which makes no swap."""
    strategy = parse_strategy_xml(SCHEDULE_XML)
    ips = dict(strategy.trees[0].ips or {})
    fp = topology_fingerprint(SCHEDULE_WORLD, ips)
    table = [ips[r] for r in range(SCHEDULE_WORLD)]
    tuner = CollectiveTuner(SCHEDULE_WORLD, fp, db=TuningDatabase(persist=False), mode="record")
    trace = CollectiveTrace()
    eng = CollectiveEngine(SCHEDULE_WORLD, strategy, trace=trace, tuner=tuner)
    for b in buckets:
        eng.all_reduce(b, active_gpus=SCHEDULE_ACTIVE, op=ReduceOp.AVG)
    print(f"adapt 18a: one relayed AVG dispatch a bucket ({[e.impl for e in trace.events()]}) leaves the recording "
          f"tuner {len(tuner.db.keys())} cells: the relayed schedule plane is not timed (JAX's rule), so the windows "
          f"come from unmasked dispatches", flush=True)
    x8 = torch.cat([grads, grads])  # phase 9's gradients as 8 ranks
    window = resolve_drift_window()
    span_s = _window(eng, trace, buckets, x8, window + 1, True)  # the timer drops each cell's first dispatch
    first = _medians(tuner.db, window)
    for key, med in first.items():
        print(f"adapt 18a: calibration window, cell {key.primitive} {_cell(key)} @{key.size_bucket / 2**20:g} MiB: "
              f"median {med * 1e3:.4f} ms ({tuner.db.count(key)} samples)", flush=True)
    print(f"adapt 18a: {window + 1} rounds of {len(buckets)} buckets and 2 ring allreduces in {span_s:.2f} s",
          flush=True)
    # the findings: the H100 defaults, and the bootstrap's calibration (the
    # card's offset probes into topo_profile_0, fitted per link)
    NetworkProfiler(SCHEDULE_WORLD, dev).dump(workdir)
    probe = calibrate_from_profile_dir(workdir, SCHEDULE_WORLD, ips)
    print(f"adapt 18a: the bootstrap's calibration from the card's offset probes: "
          f"{ {c: (round(k.alpha * 1e6, 3), round(1 / k.beta / 1e9, 2) if k.beta else 'inf') for c, k in probe.classes.items()} } "
          f"(alpha us, GB/s a class; on one card device-memory copies, and launch-bound)", flush=True)
    for label, model in (("the H100 defaults", cost_model.LinkCostModel(SCHEDULE_WORLD, ips=ips, source="defaults")),
                         ("the offset-probe calibration", probe.cost_model())):
        det = DriftDetector(SCHEDULE_WORLD, fp, cost_model=model)
        det.ingest_db(tuner.db)
        for sig in det.check().signals:
            print(_signal(f"adapt 18a against {label}:", sig), flush=True)
    # the card's own calibration: the window's medians through the battery
    # funnel (the ring algebra over the float32 cells); one card has one
    # link class, so the inter-host class takes the same fit
    rows = [{"collective": "allreduce", "world": SCHEDULE_WORLD, "size_bytes": key.size_bucket,
             "time_us": med * 1e6, "impl": "xla" if key.path == "xla" else "cuda_ring"}
            for key, med in first.items() if key.wire_dtype == "off"]
    battery = os.path.join(workdir, "battery.jsonl")
    with open(battery, "w") as f:
        f.write(json.dumps({"rows": rows}) + "\n")
    cal = calibrate_from_battery(battery, impls=("xla", "cuda_ring"))
    cal.classes[cost_model.DCN] = cal.classes[cost_model.ICI]
    cal.fingerprint, cal.samples = fp, window * len(rows)
    cal_path = os.path.join(workdir, "calibration.json")
    cal.save(cal_path)
    fit = cal.classes[cost_model.ICI]
    print(f"adapt 18a: the card's calibration from the window's float32 medians ({cal.source}): alpha "
          f"{fit.alpha * 1e6:.3f} us, {1 / fit.beta / 1e9:.2f} GB/s, both classes", flush=True)
    # the healthy control: a fresh window against the card's calibration
    _window(eng, trace, buckets, x8, window, False)
    del x8
    torch.cuda.empty_cache()
    ctl = AdaptationController(eng, Synthesizer(None, table), mode="swap", calibration_path=cal_path, db=tuner.db,
                               fingerprint=fp, nbytes=buckets[0][0].numel() * buckets[0].element_size(),
                               warm_shape=tuple(buckets[0].shape[1:]), warm_dtype=buckets[0].dtype, device=dev)
    t0 = time.perf_counter()
    rep = ctl.maybe_adapt()
    pass_ms = (time.perf_counter() - t0) * 1e3
    for sig in rep.drift.signals:
        print(_signal("adapt 18a healthy control against the card's calibration:", sig), flush=True)
    print(f"adapt 18a: healthy control: {rep.outcome}, swapped {rep.swapped}, engine epoch {eng.epoch}, the pass "
          f"{pass_ms:.3f} ms of host ({smi})", flush=True)
    if rep.outcome != "no-drift" or rep.swapped or eng.epoch != 0 or len(rep.drift.signals) != len(tuner.db.keys()):
        raise RuntimeError(f"18a: the healthy control did not read every cell without drift: {rep.to_row()}")


def adapt_degradation(buckets: list, workdir: str, smi: str) -> None:
    """18(b): JAX's degradation drill on a ring(8) engine, then the first
    dispatch after the swap (the module docstring)."""
    trace = CollectiveTrace()
    incumbent = Strategy.ring(SCHEDULE_WORLD, 1, ADAPT_DRILL_IPS)
    eng = CollectiveEngine(SCHEDULE_WORLD, incumbent, trace=trace)
    inc = _timed_buckets(eng, buckets)
    fp = "fp-drill"
    cal_path = os.path.join(workdir, "drill_calibration.json")
    ctl = _drill_controller(eng, _drill_model(), cal_path, ADAPT_DRILL_BYTES, buckets[0], fp)
    key = TuningKey("allreduce", size_bucket(ADAPT_DRILL_BYTES), SCHEDULE_WORLD, fp, "xla", 0, "off")
    reports, fired_at = [], None
    for scale in (1.0, ADAPT_DRILL_SCALE):
        pred = DriftDetector(SCHEDULE_WORLD, fp, cost_model=_drill_model(scale)).predicted_s(key)
        for i in range(ctl.detector.window):
            ctl.observe(key, pred * (0.95, 1.05)[i % 2])
            if scale > 1 and fired_at is None and ctl.detector.check().drifted:
                fired_at = i + 1
        reports.append(ctl.maybe_adapt())
    healthy, rep = reports
    with open(cal_path) as f:
        stamped = json.load(f)
    print(f"adapt 18b: healthy series {healthy.outcome}; degraded series (inter-host x{ADAPT_DRILL_SCALE:g}) fired "
          f"after {fired_at} of {ctl.detector.window} samples; triage {rep.triage}; recalibrated {rep.recalibrated} "
          f"({stamped['source']}, provenance {stamped['provenance']}, {stamped['samples']} samples); ranked "
          f"{rep.ranked}; {rep.outcome} to {rep.winner_label} {eng.strategy.synthesis} x{eng.strategy.num_trans} "
          f"wire {eng.strategy.wire_dtype} (predicted {rep.winner_pred_s * 1e3:.4f} ms against the incumbent's "
          f"{rep.incumbent_pred_s * 1e3:.4f}); epoch {rep.epoch}; aot_warm_s {rep.aot_warm_s:.6f}, stall_s "
          f"{rep.stall_s:.6f} (the port's warm: host plans and zeros dispatches, no compile)", flush=True)
    if not (healthy.outcome == "no-drift" and fired_at is not None and fired_at <= ctl.detector.window
            and rep.triage == "degradation" and rep.recalibrated and stamped["provenance"][-1] == "drift-recal"
            and rep.outcome == "swapped" and rep.epoch == 1 and eng.epoch == 1
            and rep.winner_pred_s < rep.incumbent_pred_s):
        raise RuntimeError(f"18b: the degradation drill missed a stage: {rep.to_row()}")
    b0 = buckets[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.all_reduce(b0, active_gpus=SCHEDULE_ACTIVE)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    event = trace.events()[-1]
    rows_same = all(same_bits(out[r], out[0]) for r in range(1, SCHEDULE_WORLD))
    cpu = CollectiveEngine(SCHEDULE_WORLD, eng.strategy).all_reduce(b0.cpu(), active_gpus=SCHEDULE_ACTIVE)
    exact = same_bits(out.cpu(), cpu)
    del out, cpu
    win = _timed_buckets(eng, buckets)
    print(f"adapt 18b: the first dispatch after the swap (bucket 0, rank 3 a relay): {event.impl}, cache_hit "
          f"{event.extra['cache_hit']}, epoch {event.extra.get('epoch')}, {first_ms:.3f} ms synced; rows identical "
          f"{'ok' if rows_same else 'FAIL'}, bit for bit its CPU run {'ok' if exact else 'FAIL'}; the {len(buckets)} "
          f"buckets synced {win[0]:.3f} ms, device {win[1]:.4f} ms ({win[2]} launches) against the incumbent's "
          f"{inc[0]:.3f} ms, {inc[1]:.4f} ms ({inc[2]} launches) ({smi})", flush=True)
    if not (event.extra["cache_hit"] is True and event.extra.get("epoch") == 1 and rows_same and exact):
        raise RuntimeError("18b: the first dispatch after the swap was not a warm, exact dispatch at epoch 1")


def adapt_congestion(buckets: list, workdir: str, smi: str) -> None:
    """18(c): JAX's congestion drill under the supervisor (the module
    docstring)."""
    from adapcc_tpu_torch.adapt import calibration_of

    model = _drill_model(source="fabric")
    trace = CollectiveTrace()
    incumbent = Strategy.ring(SCHEDULE_WORLD, 1, ADAPT_DRILL_IPS)
    eng = CollectiveEngine(SCHEDULE_WORLD, incumbent, trace=trace)
    cal_path = os.path.join(workdir, "fabric_calibration.json")
    calibration_of(model, fingerprint="fp", samples=3).save(cal_path)
    with open(cal_path, "rb") as f:
        before = f.read()
    profile = CongestionProfile.seeded(SCHEDULE_WORLD, **ADAPT_CONGESTION)
    ctl = _drill_controller(eng, model, cal_path, ADAPT_CONGESTION_BYTES, buckets[0], "fp",
                            congestion_profile=profile)
    journal = os.path.join(workdir, "adapt.journal")
    sup = Supervisor(CoordinatorLogic(SCHEDULE_WORLD), engine=eng, adapt=ctl, adapt_every=1, journal_path=journal,
                     clock=lambda: 0.0)
    print(f"adapt 18c: profile {profile.to_dict()}; probe cells {ctl._probe_sizes}", flush=True)
    b0, cpu_b0 = buckets[0], buckets[0].cpu()
    outcomes, hits = [], {}
    for step in range(ADAPT_CONGESTION["steps"]):
        ctl.tick(step)
        t0 = time.perf_counter()
        sup.poll()
        poll_ms = (time.perf_counter() - t0) * 1e3
        rep = ctl.reports[-1]
        outcomes.append(rep.outcome)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.all_reduce(b0, active_gpus=SCHEDULE_ACTIVE, epoch=sup.engine_epoch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        event = trace.events()[-1]
        exact = same_bits(out.cpu(), CollectiveEngine(SCHEDULE_WORLD, eng.strategy).all_reduce(
            cpu_b0, active_gpus=SCHEDULE_ACTIVE))
        hits[rep.outcome] = event.extra["cache_hit"]
        with open(cal_path, "rb") as f:
            untouched = f.read() == before
        print(f"adapt 18c step {step}: factors {profile.factors_at(step)}; {rep.outcome} (triage {rep.triage}); "
              f"poll {poll_ms:.3f} ms; engine epoch {sup.engine_epoch}, strategy {eng.strategy.synthesis}; bucket 0 "
              f"cache_hit {event.extra['cache_hit']}, {wall_ms:.3f} ms synced, bit for bit its CPU run "
              f"{'ok' if exact else 'FAIL'}; calibration untouched {'ok' if untouched else 'FAIL'}", flush=True)
        if not (exact and untouched):
            raise RuntimeError(f"18c step {step} failed its checks")
        del out
    sup.stop()
    with open(journal) as f:
        notes = [json.loads(line) for line in f]
    notes = [n for n in notes if n.get("kind") == "adapt"]
    print(f"adapt 18c: journal adapt notes {notes}", flush=True)
    want = ["congestion-reroute", "congestion-cleared"]
    reroute = outcomes.index("congestion-reroute") if "congestion-reroute" in outcomes else None
    if (reroute is None or "congestion-cleared" not in outcomes[reroute:] or [n["outcome"] for n in notes] != want
            or notes[0]["triage"] != "congestion" or hits.get("congestion-reroute") is not True
            or hits.get("congestion-cleared") is not True or eng.strategy.fingerprint() != incumbent.fingerprint()):
        raise RuntimeError(f"18c: the congestion drill missed a stage: {outcomes}, {notes}, {hits}")


def adapt_trainer(dev: torch.device, init_state, tokens, c_losses: list, workdir: str) -> dict:
    """18(d): the trainer under the loop (the module docstring).  Returns
    the flash kernels' launches."""
    for w in fa.KERNELS:
        w.launches = 0
    world = build_world_mesh(1)
    try:
        model = GPT2(MAIN, device=dev, seed=None).to(torch.bfloat16)
        model.load_state_dict(init_state)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(3e-4), world, Strategy.ring(1),
                             sync_mode="schedule")
        state = TrainState.create(model, trainer.tx)
        eng = CollectiveEngine(1, Strategy.ring(1))
        cal_path = os.path.join(workdir, "trainer_calibration.json")
        ctl = AdaptationController(
            eng, Synthesizer(None, ["h0"]), mode="swap", cost_model=cost_model.LinkCostModel.uniform(1),
            calibration_path=cal_path, trainer=trainer, trainer_prewarm=lambda s: trainer.prewarm(s, state, tokens),
            fingerprint="fp-train", detector=DriftDetector(1, "fp-train", window=ADAPT_STEP_WINDOW), device=dev)
        grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        losses, step_s, loop_ms, outcomes = [], [], [], []
        for _ in range(ADAPT_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.step(state, tokens)[1].item())
            step_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ctl.observe_step(step_s[-1], grad_bytes)
            outcomes.append(ctl.maybe_adapt().outcome)
            loop_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(ADAPT_STEP_WINDOW):
            ctl.observe_step(float(np.median(step_s)) * ADAPT_STEP_DRIFT, grad_bytes)
        rep = ctl.maybe_adapt()
    finally:
        destroy_world()
    launches = {w.__name__: w.launches for w in fa.KERNELS}
    print(f"adapt 18d (DDP sync_mode='schedule', world 1, under the loop): losses {losses}; the first {STEPS} bit "
          f"for bit phase 11c's {'ok' if losses[:STEPS] == c_losses else 'FAIL'}; step ms "
          f"{[round(s * 1e3, 2) for s in step_s]}; outcomes {outcomes}; observe_step + maybe_adapt "
          f"{[round(m, 4) for m in loop_ms]} ms of host a step; a step-time drift x{ADAPT_STEP_DRIFT:g}: "
          f"{rep.outcome} (fired {rep.fired}, swapped {rep.swapped}, recalibrated {rep.recalibrated}, engine epoch "
          f"{eng.epoch}); launches {launches}", flush=True)
    want = MAIN.n_layer * ADAPT_TRAIN_STEPS
    if (losses[:STEPS] != c_losses or any(o != "no-drift" for o in outcomes) or rep.outcome != "uninvertible"
            or rep.swapped or rep.recalibrated or eng.epoch != 0 or os.path.exists(cal_path)
            or any(n != want for n in launches.values())):
        raise RuntimeError(f"18d: the trainer under the loop failed its checks: {rep.to_row()}, {launches}")
    return launches


def adapt_host_planes(dev: torch.device, buckets: list, workdir: str, smi: str) -> None:
    """18(e): the shared fabric and the flow LP on the H100 defaults, and
    the variability probe on the card (the module docstring)."""
    strategy = parse_strategy_xml(SCHEDULE_XML)
    ips = dict(strategy.trees[0].ips or {})
    table = [ips[r] for r in range(SCHEDULE_WORLD)]
    model = cost_model.LinkCostModel(SCHEDULE_WORLD, ips=ips, source="defaults")
    per_rank = sum(b[0].numel() * b.element_size() for b in buckets)
    fab = SharedFabric(model, table)
    fab.add_job("training", priority="high", nbytes=per_rank)
    fab.add_job("batch", priority="low", nbytes=16 << 20)
    t0 = time.perf_counter()
    row = fab.frontier()
    plan_s = time.perf_counter() - t0
    print(f"adapt 18e: SharedFabric on the H100 defaults ({table}), frontier in {plan_s:.4f} s of host: "
          f"{json.dumps(row)}", flush=True)
    if json.dumps(row, sort_keys=True) != json.dumps(fab.frontier(), sort_keys=True) or len(row["coordinated"]["jobs"]) != 2:
        raise RuntimeError("18e: the frontier row is not one row of two jobs, byte for byte on a repeat")
    bw, _ = model.to_graphs()
    edges = [(s, d) for s in range(SCHEDULE_WORLD) for d in range(SCHEDULE_WORLD) if s != d]
    t0 = time.perf_counter()
    sol = solve_broadcast_lp(SCHEDULE_WORLD, edges, [bw[s][d] for s, d in edges], source=0)
    solve_s = time.perf_counter() - t0
    rounds = sol.comm_rounds()
    nbytes = buckets[0][0].numel() * buckets[0].element_size()
    tl = simulate_flow_broadcast(sol, model, nbytes)
    print(f"adapt 18e: solve_broadcast_lp on the 8-rank graph ({len(edges)} edges) in {solve_s:.4f} s of host: "
          f"makespan {sol.makespan:.6g} s a GB, {len(sol.rounds)} LP rounds, durations "
          f"{[round(d, 6) for d in sol.durations]}, {len(rounds)} comm rounds "
          f"{[list(r.edges) for r in rounds]}; simulate_flow_broadcast of bucket 0 ({nbytes / 2**20:.1f} MiB): "
          f"{tl.to_row()}", flush=True)
    if not (sol.makespan > 0 and tl.seconds > 0 and rounds):
        raise RuntimeError("18e: the flow LP broadcast gave no schedule")
    mon = VariabilityMonitor(SCHEDULE_WORLD, dev, interval_s=0.05, out_dir=os.path.join(workdir, "varmon"))
    mon.start()
    time.sleep(VARIABILITY_S)
    mon.stop()
    summary = mon.summary()
    values = [v for _, v in mon.bandwidth_trace]
    lat = [v * 1e6 for _, v in mon.latency_trace]
    loaded = load_trace(os.path.join(workdir, "varmon", "bandwidth.txt"))
    print(f"adapt 18e: VariabilityMonitor on the card's offset probe for {VARIABILITY_S:g} s: {summary}; latency "
          f"{min(lat):.2f}-{max(lat):.2f} us; detect_drift {detect_drift(values)}, sustained and down "
          f"{detect_drift(values, consecutive=3, direction='down')}; trace file {len(loaded)} readings ({smi})",
          flush=True)
    if summary["samples"] < 2 or len(loaded) != len(values):
        raise RuntimeError("18e: the variability monitor took fewer than two readings")


def slice15(dev: torch.device, init_state, tokens, z_tokens, buckets: list, c_losses: list, smi: str) -> dict:
    """Phase 18, slice 15's main path (the module docstring); returns the
    launches of each kernel in it (the ring kernels from 18a, the flash
    kernels from 18d)."""
    t18 = time.perf_counter()
    grads = gpt2_gradients(dev, init_state, z_tokens)
    for w in ring.KERNELS:
        w.launches = 0
    marks = [time.perf_counter()]
    with tempfile.TemporaryDirectory(prefix="adapcc_slice15_") as workdir:
        adapt_detector(dev, buckets, grads, workdir, smi)
        del grads
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        adapt_degradation(buckets, workdir, smi)
        marks.append(time.perf_counter())
        adapt_congestion(buckets, workdir, smi)
        marks.append(time.perf_counter())
        p18 = adapt_trainer(dev, init_state, tokens, c_losses, workdir)
        marks.append(time.perf_counter())
        adapt_host_planes(dev, buckets, workdir, smi)
        marks.append(time.perf_counter())
    p18.update({w.__name__: w.launches for w in ring.KERNELS})
    parts = ", ".join(f"{c} {b - a:.1f} s" for c, a, b in zip(("18a", "18b", "18c", "18d", "18e"), marks, marks[1:]))
    print(f"phase 18 launches: {p18} (the ring kernels from 18a, the flash kernels from 18d); phase 18 "
          f"{time.perf_counter() - t18:.1f} s ({parts}, the gradients {marks[0] - t18:.1f} s)", flush=True)
    if not (p18["ring_k1b"] and p18["ring_k5b"]):
        raise RuntimeError(f"phase 18 did not launch K1b and K5b: {p18}")
    return p18


# --------------------------------------------------------------------------- #
# phase 19: ZeRO-1's elastic state and the memory-lean GPT-2 (slice 16)
# --------------------------------------------------------------------------- #


def _lean_loss(block: int = LEAN_BLOCK):
    return lambda m, b: lm_loss_chunked(m, b, block=block)


def zero1_trainer_run(cfg: GPT2Config, world, init_state, tokens, tx, loss_fn, steps: int = STEPS,
                      on_step=None, generator=None, **trainer_kw):
    """``steps`` steps of ``DDPTrainer(zero1=True)`` from ``init_state``;
    ``on_step(i, trainer, state, model)`` after step ``i`` (from 1);
    ``generator`` draws the model's dropout masks.  Returns (losses, step
    seconds, peak bytes allocated, (trainer, state, model))."""
    model = GPT2(cfg, device=world.device, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    model.dropout_generator = generator
    trainer = DDPTrainer(loss_fn, tx, world, Strategy.ring(world.world_size), zero1=True, **trainer_kw)
    state = trainer.init_state(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens)
        losses.append(loss.item())  # waits for the step
        seconds.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i + 1, trainer, state, model)
    return losses, seconds, torch.cuda.max_memory_allocated(), (trainer, state, model)


def _trainer_ckpt(trainer, state, model) -> TrainCheckpointState:
    """A per-rank ZeRO-1 trainer's checkpoint: the replicated parameters,
    this rank's master row and optimizer state, the step, the layout tag."""
    return TrainCheckpointState(model.state_dict(), (state.master, state.optimizer.state_dict()), step=state.step,
                                extra=trainer.checkpoint_extra())


def _key_bias_mask(meta, device) -> torch.Tensor:
    """The flat layout's elements of every key bias (the middle third of a
    ``qkv`` bias), whose true gradient is zero: softmax is shift-invariant
    along each row, so its gradient is rounding noise that Adam scales up to
    steps of ±lr."""
    mask = torch.zeros(meta.padded, dtype=torch.bool, device=device)
    off = 0
    for leaf in meta.leaves:
        if leaf.name.endswith("attn.qkv.bias"):
            d = leaf.size // 3
            mask[off + d:off + 2 * d] = True
        off += leaf.size
    return mask


def lean_trainer(dev: torch.device, init_state, tokens, losses: list, smi: str) -> tuple:
    """19a–19c (the module docstring).  Returns (the flash launches of its
    runs, 19a's losses)."""
    p19 = dict.fromkeys((w.__name__ for w in fa.KERNELS), 0)

    def tally() -> dict:
        got = {w.__name__: w.launches for w in fa.KERNELS}
        for k, v in got.items():
            p19[k] += v
        for w in fa.KERNELS:
            w.launches = 0
        return got

    tokens_step = BATCH * MAIN.max_seq
    world = build_world_mesh(1)
    # (a) ZeRO-1 through the trainer, the plain configuration
    for w in fa.KERNELS:
        w.launches = 0
    base = torch.cuda.memory_allocated()
    a_losses, a_seconds, a_peak, held = zero1_trainer_run(MAIN, world, init_state, tokens, adamw(3e-4),
                                                          lambda m, b: lm_loss(m(b), b))
    del held
    a_launches = tally()
    a_gap = max(abs(a - b) for a, b in zip(a_losses, losses))
    a_step = float(np.mean(a_seconds[1:]))
    print(f"zero1 19a (DDPTrainer(zero1=True), world 1 over NCCL): losses {a_losses}; first loss bit for bit phase "
          f"5's {'ok' if a_losses[0] == losses[0] else 'FAIL'}; max gap to phase 5 {a_gap:.3e} (tolerance "
          f"{LOSS_ATOL}); launches {a_launches}; step {a_step * 1e3:.2f} ms, {tokens_step / a_step:.1f} tokens/s "
          f"(every step {[round(s * 1e3, 2) for s in a_seconds]} ms); peak allocated {a_peak / 2**30:.3f} GiB "
          f"({(a_peak - base) / 2**30:.3f} above the {base / 2**30:.3f} GiB held before the run) [{smi}]", flush=True)
    want = MAIN.n_layer * STEPS
    if a_losses[0] != losses[0] or not a_gap <= LOSS_ATOL or any(n != want for n in a_launches.values()):
        raise RuntimeError(f"19a: losses {a_losses} vs phase 5's {losses}, launches {a_launches}")
    if not all(np.isfinite(a_losses)) or not a_losses[-1] < a_losses[0]:
        raise RuntimeError(f"19a losses not finite and falling: {a_losses}")
    torch.cuda.empty_cache()
    try:
        DDPTrainer(lambda m, b: m(b), adamw(3e-4), world, Strategy.ring(1), zero1=True,
                   shard_replicas=1).init_state(GPT2(dataclasses.replace(MAIN, n_layer=1), device=dev, seed=None))
    except ValueError as e:
        print(f"zero1 19a: shard_replicas=1 at world 1 refused: {e}", flush=True)
    else:
        raise RuntimeError("19a: shard_replicas=1 at world 1 was not refused")
    # (b) the memory-lean configuration: remat, the chunked loss, a bf16
    # first moment; each policy runs the block's forward again in the
    # backward, flash included (its kernels are no matrix product the
    # policies keep), so K2 launches twice a layer a step, K3 and K4 once
    lean_tx = adamw(3e-4, mu_dtype=torch.bfloat16)
    want_lean = {"flash_fwd": 2 * want, "flash_dq": want, "flash_dkv": want}
    lean = {}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(MAIN, remat=True, remat_policy=policy)
        base_b = torch.cuda.memory_allocated()
        b_losses, b_seconds, b_peak, held = zero1_trainer_run(cfg, world, init_state, tokens, lean_tx, _lean_loss())
        b_launches = tally()
        b_state = held[1]
        mu = b_state.optimizer.state[b_state.master]["exp_avg"]
        lean[policy] = b_losses
        b_step = float(np.mean(b_seconds[1:]))
        b_gap = max(abs(a - b) / a for a, b in zip(a_losses, b_losses))
        print(f"lean 19b (remat {policy!r}, lm_loss_chunked block {LEAN_BLOCK}, mu {str(mu.dtype)[6:]}): losses "
              f"{b_losses}; max relative gap to 19a {b_gap:.3e} (tolerance {LEAN_LOSS_REL}); launches {b_launches} "
              f"(expected {want_lean}); step {b_step * 1e3:.2f} ms ({b_step / a_step:.3f}x 19a), "
              f"{tokens_step / b_step:.1f} tokens/s; peak allocated {b_peak / 2**30:.3f} GiB, "
              f"{(b_peak - base_b) / 2**30:.3f} above the {base_b / 2**30:.3f} held before "
              f"({(b_peak - base_b) / (a_peak - base):.3f}x 19a's) [{smi}]", flush=True)
        if b_launches != want_lean or not b_gap <= LEAN_LOSS_REL or mu.dtype != torch.bfloat16:
            raise RuntimeError(f"19b {policy}: losses {b_losses}, launches {b_launches}, mu {mu.dtype}")
        del held, b_state, mu
        torch.cuda.empty_cache()
    if lean["full"] != lean["dots"]:
        raise RuntimeError(f"19b: the two remat policies differ: {lean}")
    print("lean 19b: remat 'full' and 'dots' losses bit for bit", flush=True)
    drop_cfg = dataclasses.replace(MAIN, remat=True, remat_policy="dots", dropout=0.1)
    drops = []
    for _ in range(2):
        d_losses, d_seconds, d_peak, held = zero1_trainer_run(
            drop_cfg, world, init_state, tokens, lean_tx, _lean_loss(),
            generator=torch.Generator(device=dev).manual_seed(SEED))
        del held
        drops.append((d_losses, float(np.mean(d_seconds[1:])), d_peak, tally()))
        torch.cuda.empty_cache()
    (d1, d_step, d_peak, d_launches), (d2, _, _, d2_launches) = drops
    print(f"lean 19b (dropout 0.1, remat 'dots', the same generator twice): losses {d1} and {d2}, the same "
          f"{'ok' if d1 == d2 else 'FAIL'}; launches {d_launches}, {d2_launches} (materialized attention: none); step "
          f"{d_step * 1e3:.2f} ms; peak allocated {d_peak / 2**30:.3f} GiB", flush=True)
    if d1 != d2 or any(d_launches.values()) or any(d2_launches.values()) or not all(np.isfinite(d1)):
        raise RuntimeError(f"19b dropout: {d1} vs {d2}, launches {d_launches} {d2_launches}")
    # (c) async checkpoints of 19b's run
    dots = dataclasses.replace(MAIN, remat=True, remat_policy="dots")
    with tempfile.TemporaryDirectory(prefix="adapcc_ckpt_") as ckdir:
        mgr = AsyncCheckpointManager(os.path.join(ckdir, "async"), max_to_keep=2)
        stalls = {}

        def save(i, trainer, state, model):
            if i in CKPT_STEPS:
                t0 = time.perf_counter()
                mgr.save_async(i, _trainer_ckpt(trainer, state, model))
                stalls[i] = time.perf_counter() - t0

        c_losses, _, _, (c_trainer, c_state, c_model) = zero1_trainer_run(dots, world, init_state, tokens, lean_tx,
                                                                          _lean_loss(), on_step=save)
        t0 = time.perf_counter()
        mgr.wait()
        drain_s = time.perf_counter() - t0
        for s in mgr.published_steps():
            mgr.verify(s)
        newest = mgr.latest_step()
        blob = os.path.getsize(os.path.join(mgr._step_dir(newest), BLOB_NAME))
        sync_mgr = AsyncCheckpointManager(os.path.join(ckdir, "sync"), max_to_keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_mgr.save(newest, _trainer_ckpt(c_trainer, c_state, c_model))
        sync_s = time.perf_counter() - t0
        shutil.rmtree(sync_mgr._step_dir(newest))
        del c_trainer, c_state, c_model
        torch.cuda.empty_cache()
        print(f"ckpt 19c: save_async at steps {list(CKPT_STEPS)} (max_to_keep 2): published {mgr.published_steps()}, "
              f"verified; host stall of save_async {[round(s * 1e3, 2) for s in stalls.values()]} ms against save "
              f"{sync_s * 1e3:.2f} ms, the pipeline drained {drain_s * 1e3:.2f} ms after the run; {blob} bytes a "
              f"checkpoint ({blob / 2**30:.3f} GiB); losses bit for bit 19b's "
              f"{'ok' if c_losses == lean['dots'] else 'FAIL'}", flush=True)
        if c_losses != lean["dots"] or mgr.published_steps() != list(CKPT_STEPS):
            raise RuntimeError(f"19c: losses {c_losses} vs {lean['dots']}, steps {mgr.published_steps()}")
        # a fresh trainer restores the newest step and takes the next one
        model = GPT2(dots, device=dev, seed=None).to(torch.bfloat16)
        trainer = DDPTrainer(_lean_loss(), lean_tx, world, Strategy.ring(1), zero1=True)
        state = trainer.init_state(model)
        template = _trainer_ckpt(trainer, state, model)
        t0 = time.perf_counter()
        mgr.restore(template)
        restore_s = time.perf_counter() - t0
        model.load_state_dict(template.params)
        state.master.copy_(template.opt_state[0])
        state.optimizer.load_state_dict(template.opt_state[1])
        state.step = template.step
        next_losses = [trainer.step(state, tokens)[1].item() for _ in range(STEPS - newest)]
        r_launches = tally()
        print(f"ckpt 19c: restored step {newest} in {restore_s * 1e3:.2f} ms (verified); next losses {next_losses} "
              f"bit for bit the uninterrupted run's {'ok' if next_losses == lean['dots'][newest:] else 'FAIL'}; "
              f"launches {r_launches}", flush=True)
        if next_losses != lean["dots"][newest:]:
            raise RuntimeError(f"19c: resumed losses {next_losses} vs {lean['dots'][newest:]}")
        del model, trainer, state, template
        # a bit flipped in a copy of the newest step
        bad = AsyncCheckpointManager(os.path.join(ckdir, "flipped"))
        shutil.copytree(mgr._step_dir(newest), bad._step_dir(newest))
        with open(os.path.join(bad._step_dir(newest), BLOB_NAME), "r+b") as f:
            f.seek(blob // 2)
            byte = f.read(1)
            f.seek(blob // 2)
            f.write(bytes([byte[0] ^ 0x10]))
        try:
            bad.verify(newest)
        except CheckpointCorrupt as e:
            print(f"ckpt 19c: a bit-flipped copy refused: {e}", flush=True)
        else:
            raise RuntimeError("19c: a bit-flipped checkpoint verified")
        mgr.close()
    destroy_world()
    torch.cuda.empty_cache()
    return p19, a_losses


def zero1_elastic_drill(dev: torch.device, init_state, z_tokens, smi: str) -> dict:
    """19d (the module docstring): the stacked single-controller ZeRO-1 at
    world 4 on this card, on the ring (K1b) and off it.  Returns the flash
    and K1b launches of its training steps."""
    names = (*(w.__name__ for w in fa.KERNELS), "ring_k1b")
    p19 = dict.fromkeys(names, 0)

    def reset() -> None:
        for w in (*fa.KERNELS, *ring.KERNELS):
            w.launches = 0
            getattr(w, "phases", {}).clear()

    def tally() -> dict:
        got = {n: getattr(ring, n).launches if n.startswith("ring") else getattr(fa, n).launches for n in names}
        for k, v in got.items():
            p19[k] += v
        reset()
        return got

    coeffs = cost_model.LinkCoeffs(*cost_model.DEFAULT_COEFFS[cost_model.ICI])
    reset()
    for ring_on in (True, False):
        losses, _, (model, opt, master, opt_state, step) = zero1_run(dev, init_state, z_tokens, steps=ELASTIC_STEPS,
                                                                     ring=ring_on)
        launches = tally()
        want = MAIN.n_layer * ZERO1_WORLD * ELASTIC_STEPS
        if any(launches[w.__name__] != want for w in fa.KERNELS) or launches["ring_k1b"] != 2 * ELASTIC_STEPS * ring_on:
            raise RuntimeError(f"19d ring={ring_on}: launches {launches}")
        st = opt_state.state[master]
        saved = (master.clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone())
        state_bytes = sum(t.numel() * t.element_size() for t in saved)
        # the replica set: capture, lose row 1, repair it
        store = ShardReplicaStore(ZERO1_WORLD, replicas=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.capture((master, opt_state), ELASTIC_STEPS)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        for t in (master, st["exp_avg"], st["exp_avg_sq"]):
            t[1].zero_()
        t0 = time.perf_counter()
        rm, rsd = store.reconstruct((master, opt_state), [1], step=ELASTIC_STEPS)
        torch.cuda.synchronize()
        repair_s = time.perf_counter() - t0
        rst = rsd["state"][0]
        repaired = same_bits(rm, saved[0]) and same_bits(rst["exp_avg"], saved[1]) and same_bits(
            rst["exp_avg_sq"], saved[2])
        master.copy_(rm)
        opt_state.load_state_dict(rsd)
        del rm, rsd, rst
        # re-balance 4 → 2 → 4 of the repaired pair
        layout = opt.layout_metadata()
        two = Zero1Optimizer(adamw(3e-4), 2, ring=ring_on)
        four = Zero1Optimizer(adamw(3e-4), ZERO1_WORLD, ring=ring_on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m2, sd2 = rebalance.rebalance_zero1_pair((master, opt_state), model, layout, two)
        torch.cuda.synchronize()
        shrink_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m4, sd4 = rebalance.rebalance_zero1_pair((m2, sd2), model, two.layout_metadata(), four)
        torch.cuda.synchronize()
        grow_s = time.perf_counter() - t0
        total = opt._meta.total
        back = [(rebalance._to_canonical_flat(a, layout, total), rebalance._to_canonical_flat(b, layout, total)) for a, b in (
            (m4, saved[0]), (sd4["state"][0]["exp_avg"], saved[1]), (sd4["state"][0]["exp_avg_sq"], saved[2]))]
        round_trip = all(same_bits(a, b) for a, b in back)
        del m4, sd4, back
        price = cost_model.recovery_cost(ZERO1_WORLD, opt._meta.padded * 4, coeffs, state_bytes=state_bytes)
        print(f"elastic 19d (stacked ZeRO-1, world {ZERO1_WORLD}, ring={ring_on}): {ELASTIC_STEPS} steps, losses "
              f"{losses}; launches {launches}; state {state_bytes} bytes ({state_bytes / 2**30:.3f} GiB: master and "
              f"two moments); replica capture {capture_s * 1e3:.2f} ms, row 1 zeroed and repaired "
              f"{repair_s * 1e3:.2f} ms, bit for bit {'ok' if repaired else 'FAIL'}; re-balance 4 -> 2 "
              f"{shrink_s * 1e3:.2f} ms, 2 -> 4 {grow_s * 1e3:.2f} ms (host seconds, the card synchronized), "
              f"canonical master and moments back bit for bit {'ok' if round_trip else 'FAIL'} [{smi}]", flush=True)
        print(f"elastic 19d: cost model output for this payload (H100 defaults, not a measurement): "
              f"{ {k: float(v) for k, v in price.items()} }", flush=True)
        if not (repaired and round_trip):
            raise RuntimeError(f"19d ring={ring_on}: repair {repaired}, 4 -> 2 -> 4 {round_trip}")
        del model, opt, master, opt_state, step, store, saved, m2, sd2
        torch.cuda.empty_cache()
    shrink_drill(dev, init_state, z_tokens, smi)
    tally()
    return p19


def shrink_drill(dev: torch.device, init_state, z_tokens, smi: str) -> None:
    """19d's shrink: the stacked ZeRO-1 ring step at world 4 on a float32
    copy of the model (JAX's setting: float32 end to end, so only the
    order of the gradient sums differs between worlds; in bf16 each rank's
    gradient is rounded to 8 bits, and the partition alone moves a tenth
    of the elements past the tolerance), ``ELASTIC_STEPS`` steps, then
    ``ELASTIC_STEPS`` more uninterrupted against as many after a re-balance
    to world 2 with the same global batch: the masters within JAX's
    convergence-equivalence tolerance, the key biases within Adam's 2·lr a
    step."""
    cfg = dataclasses.replace(MAIN, dtype=torch.float32)
    model = GPT2(cfg, device=dev, seed=None)
    model.load_state_dict({k: v.float() for k, v in init_state.items()})
    opt = Zero1Optimizer(adamw(3e-4), ZERO1_WORLD, ring=True)
    master, opt_state = opt.init(model)
    loss = lambda m, b: lm_loss(m(b), b)  # noqa: E731
    step = zero1_train_step(loss, opt)
    for _ in range(ELASTIC_STEPS):
        step(model, master, opt_state, z_tokens)
    two = Zero1Optimizer(adamw(3e-4), 2, ring=True)
    m2, sd2 = rebalance.rebalance_zero1_pair((master, opt_state), model, opt.layout_metadata(), two)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    for _ in range(ELASTIC_STEPS):
        step(model, master, opt_state, z_tokens)
    torch.cuda.synchronize()
    a_s = (time.perf_counter() - t0) / ELASTIC_STEPS
    total = opt._meta.total
    a_flat = rebalance._to_canonical_flat(master, opt.layout_metadata(), total)
    model.load_state_dict(params)
    del params, master, opt_state
    b_master, b_opt = two.restore(TrainCheckpointState(None, (m2, sd2), extra=two.checkpoint_extra()))
    del m2, sd2
    b_step = zero1_train_step(loss, two)
    t0 = time.perf_counter()
    for _ in range(ELASTIC_STEPS):
        b_step(model, b_master, b_opt, z_tokens)
    torch.cuda.synchronize()
    b_s = (time.perf_counter() - t0) / ELASTIC_STEPS
    ring.check_errors()
    b_flat = rebalance._to_canonical_flat(b_master, two.layout_metadata(), total)
    gap = (a_flat - b_flat).abs()
    allowed = SHRINK_ATOL + SHRINK_RTOL * b_flat.abs()
    key = _key_bias_mask(opt._meta, dev)[:total]
    outside = int((gap > allowed)[~key].sum())
    key_max = float(gap[key].max())
    print(f"elastic 19d (float32 copy, ring): {ELASTIC_STEPS} more steps uninterrupted at world {ZERO1_WORLD} "
          f"({a_s * 1e3:.2f} ms a step) and after a shrink to 2 ({b_s * 1e3:.2f} ms a step): masters, {outside} of "
          f"{int((~key).sum())} elements outside rtol {SHRINK_RTOL} / atol {SHRINK_ATOL} (max gap "
          f"{float(gap[~key].max()):.3e}); the key biases (true gradient zero) max gap {key_max:.3e} (bound "
          f"{2 * 3e-4 * ELASTIC_STEPS:.1e}) [{smi}]", flush=True)
    if outside or not key_max <= 2 * 3e-4 * ELASTIC_STEPS:
        raise RuntimeError("19d: the shrunk run left the uninterrupted run's tolerance")
    del model, a_flat, b_flat, gap, allowed, key, b_master, b_opt
    torch.cuda.empty_cache()


def slice16(dev: torch.device, init_state, tokens, z_tokens, losses: list, smi: str) -> dict:
    """Phase 19, slice 16's main path (the module docstring); returns the
    launches of each kernel in it."""
    t19 = time.perf_counter()
    p19, _ = lean_trainer(dev, init_state, tokens, losses, smi)
    t19d = time.perf_counter()
    for k, v in zero1_elastic_drill(dev, init_state, z_tokens, smi).items():
        p19[k] = p19.get(k, 0) + v
    print(f"phase 19 launches: {p19}; phase 19 {time.perf_counter() - t19:.1f} s (19a-c {t19d - t19:.1f} s, 19d "
          f"{time.perf_counter() - t19d:.1f} s)", flush=True)
    return p19


# --------------------------------------------------------------------------- #
# phase 20: sequence parallelism (slice 17)
# --------------------------------------------------------------------------- #


def sdpa_device_ms(q, k, v, do, scale: float, shape: tuple, causal: bool) -> tuple:
    """sdpa's forward and its backward (dq, dk and dv in one call) on the
    kernels' ``[B·H, T, D]`` inputs, by device time: yardsticks only."""
    B, T, H, D = shape
    ql, kl, vl = (x.view(B, H, T, D) for x in (q, k, v))
    fwd_ms = device_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale))
    ql, kl, vl = (x.detach().requires_grad_() for x in (ql, kl, vl))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
    dol = do.view(B, H, T, D)
    bwd_ms = device_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True))
    return fwd_ms, bwd_ms


def sp_kernel_checks(dev: torch.device, smi: str) -> None:
    """20(a): K2, K3 and K4 against their plain versions (``TOLERANCE``) at
    the shapes the sequence-parallel path gives them, a random ``lse``
    cotangent folded into ``delta``; each timed by device time against its
    bound and sdpa's at the same shape."""
    for label, (B, T, H, D), causal in SP_KERNEL_CASES:
        runs, (q, k, v, do, scale) = flash_runs(dev, B, T, H, D, torch.bfloat16, causal, dlse=True)
        rec = {"shape": [B * H, T, D], "causal": causal}
        for name, run in runs.items():
            err = check_flash(name, run, (B, T, H, D), torch.bfloat16, causal)
            b_ms, b_by = bound(name, B * H, T, D, torch.bfloat16, causal)
            rec[name] = {"max_abs_err": err, "device_ms": device_ms(run[0]), "bound_ms": b_ms, "bound_by": b_by}
        rec["sdpa_fwd_ms"], rec["sdpa_bwd_ms"] = sdpa_device_ms(q, k, v, do, scale, (B, T, H, D), causal)
        k2, k3, k4 = (rec[n]["device_ms"] for n in ("flash_fwd", "flash_dq", "flash_dkv"))
        print(f"sp 20a {label} [{B * H}, {T}, {D}] bf16 causal={causal} (dlse folded in), device ms: "
              + "; ".join(f"{n} {rec[n]['device_ms']:.4f} (bound {rec[n]['bound_ms']:.4f}, {rec[n]['bound_by']})"
                          for n in ("flash_fwd", "flash_dq", "flash_dkv"))
              + f"; sdpa forward {rec['sdpa_fwd_ms']:.4f} (K2 {k2 / rec['sdpa_fwd_ms']:.2f}x), sdpa backward "
              f"{rec['sdpa_bwd_ms']:.4f} (K3 + K4 {(k3 + k4) / rec['sdpa_bwd_ms']:.2f}x); {smi}", flush=True)
        del runs, q, k, v, do


def _flash_counts() -> dict:
    return {w.__name__: w.launches for w in fa.KERNELS}


def _ring_counts() -> dict:
    return {w.__name__: w.launches for w in ring.KERNELS}


def _since(before: dict, now: dict) -> dict:
    return {k: now[k] - before[k] for k in before}


def sp_attention(dev: torch.device, kind: str, smi: str) -> dict:
    """20(b) the stacked ring / 20(c) Ulysses at world ``SP_WORLD`` on
    ``SP_ATT_SHAPE`` (flash, causal): output and q/k/v gradients against one
    flash over the whole sequence, within the bf16 bound below; each
    kernel's launches against the design's count; the fused call's ms
    against the one flash's.  Returns the path's launches.

    The bound: the ring rounds each block's output to bf16 (K2 writes bf16)
    before the float32 merge and the merged output once more; a block's
    output is a convex mix of v rows, so its rounding moves the result by
    at most ``2**-8·max|v|``, and each side's final rounding by ``2**-8·|o|``:
    ``|ring − flash| ≤ 2**-8·max|v| + 2·2**-8·|flash|``.  A gradient sums
    ``world`` block terms, each written in bf16 by K3/K4 and added in bf16,
    and takes its cotangent rounded to bf16 once a block: at most ``world +
    1`` roundings of terms of the gradient's size, ``(world + 1)·2**-8·
    max|grad| + 2·2**-8·|grad|``.  Ulysses runs the same rows through one
    launch each way and is held to the same bound (bit for bit is
    expected and printed)."""
    B, T, H, D = SP_ATT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = ((torch.randn(B, T, H, D, device=dev, generator=gen) * 0.5).to(torch.bfloat16) for _ in range(3))
    g = torch.randn(B, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
    fn = ring_attention if kind == "ring" else ulysses_attention

    def path():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(SP_WORLD, *leaves, causal=True, block_impl="flash")
        return out, torch.autograd.grad(out, leaves, g)

    def one_flash():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True)
        return out, torch.autograd.grad(out, leaves, g)

    ref, ref_grads = one_flash()
    before = _flash_counts()
    out, grads = path()
    torch.cuda.synchronize()
    launched = _since(before, _flash_counts())
    want = dict.fromkeys(launched, SP_WORLD if kind == "ring" else 1)
    u = 2.0 ** -8
    errs, ok = {}, True
    for name, got, ref_t, atol in [("o", out, ref, u * v.float().abs().max().item())] + [
            (f"d{n}", a, b, (SP_WORLD + 1) * u * b.float().abs().max().item())
            for n, a, b in zip("qkv", grads, ref_grads)]:
        diff = (got.float() - ref_t.float()).abs()
        errs[name] = diff.max().item()
        ok &= bool(torch.isfinite(got).all()) and (diff - atol - 2 * u * ref_t.float().abs()).max().item() <= 0
    exact = all(torch.equal(a, b) for a, b in zip((out, *grads), (ref, *ref_grads)))
    del out, grads, ref, ref_grads
    path_ms, flash_ms = cuda_ms(path, iters=3, warmup=1), cuda_ms(one_flash, iters=3, warmup=1)
    print(f"sp 20{'b' if kind == 'ring' else 'c'} {kind} world {SP_WORLD} q/k/v {list(SP_ATT_SHAPE)} bf16 causal: "
          f"max abs err vs one flash over T={T} {', '.join(f'{n} {e:.3e}' for n, e in errs.items())} "
          f"({'bit for bit' if exact else 'within the bf16 bound' if ok else 'FAIL'}); launches {launched} "
          f"(design {want}); forward + backward {path_ms:.3f} ms, one flash {flash_ms:.3f} ms (events); {smi}",
          flush=True)
    if not ok or launched != want:
        raise RuntimeError(f"20{kind}: the {kind} disagrees with one flash or launched {launched}, not {want}")
    return launched


def sp_train(dev: torch.device, cfg: GPT2Config, mesh, data_axis, init_state, tokens, steps: int) -> tuple:
    """``steps`` of ``gpt2_sp_train_step`` (``adamw(3e-4)``, as phase 5's
    trainer) on the stacked ``mesh``'s ``"sp"`` axis from ``init_state``;
    returns (losses, step seconds, peak bytes allocated, one more step)."""
    model = GPT2(cfg, device=dev, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    step = gpt2_sp_train_step(model, adamw(3e-4), mesh, axis_name="sp", data_axis=data_axis)
    state = {"opt": None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state["opt"], loss = step(model, state["opt"], tokens)
        losses.append(loss.item())  # waits for the step
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, torch.cuda.max_memory_allocated(), lambda: step(model, state["opt"], tokens)


def sp_gpt2(dev: torch.device, label: str, cfg: GPT2Config, mesh, data_axis, impls: tuple, steps: int,
            smi: str) -> dict:
    """20(d)/(e): the sequence-parallel step per ``impls`` on ``mesh``
    against ``DDPTrainer`` at world 1 on the unsharded batch, losses within
    ``LOSS_ATOL``, each flash kernel launched as the design counts, no ring
    kernel; step ms and peak memory.  Returns the path's launches."""
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(BATCH, cfg.max_seq))).to(dev)
    init_state = GPT2(cfg, device=dev, seed=SEED).to(torch.bfloat16).state_dict()
    world = build_world_mesh(1)
    torch.cuda.reset_peak_memory_stats()
    ref_losses, ref_seconds, _ = train(cfg, world, init_state, tokens, steps=steps)
    ref_peak = torch.cuda.max_memory_allocated()
    destroy_world()
    torch.cuda.empty_cache()
    ref_ms = float(np.mean(ref_seconds[1:])) * 1e3
    print(f"sp {label} reference (DDPTrainer, world 1, [{BATCH}, {cfg.max_seq}], {cfg.n_layer} layers, flash): "
          f"losses {ref_losses}; step {ref_ms:.2f} ms, peak {ref_peak / 2**30:.3f} GiB", flush=True)
    sp = mesh["sp"].size
    total = dict.fromkeys(_flash_counts(), 0)
    for impl in impls:
        sp_cfg = dataclasses.replace(cfg, sp_axis=mesh["sp"], sp_impl=impl)
        flash0, ring0 = _flash_counts(), _ring_counts()
        losses, seconds, peak, more = sp_train(dev, sp_cfg, mesh, data_axis, init_state, tokens, steps)
        launched, ring_launched = _since(flash0, _flash_counts()), _since(ring0, _ring_counts())
        want = dict.fromkeys(launched, cfg.n_layer * steps * (sp if impl == "ring" else 1))
        gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
        step_ms = float(np.mean(seconds[1:])) * 1e3
        print(f"sp {label} {impl} ({' x '.join(f'{a} {n}' for a, n in zip(mesh.axis_names, mesh.shape.values()))}, "
              f"stacked, T_local {cfg.max_seq // sp}): losses {losses}; max gap to the reference {gap:.3e} "
              f"(tolerance {LOSS_ATOL}); launches {launched} (design {want}), ring kernels {ring_launched}; step "
              f"{step_ms:.2f} ms ({BATCH * cfg.max_seq / step_ms * 1e3:.1f} tokens/s; every step "
              f"{[round(t * 1e3, 2) for t in seconds]} ms), peak {peak / 2**30:.3f} GiB; {smi}", flush=True)
        if not (gap <= LOSS_ATOL and np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"20 {label} {impl}: losses {losses} not within {LOSS_ATOL} of {ref_losses}")
        if launched != want or any(ring_launched.values()):
            raise RuntimeError(f"20 {label} {impl}: launches {launched} (design {want}), ring {ring_launched}")
        for k, n in launched.items():
            total[k] += n
        if label == "20d" and impl == "ring":
            profile_step(f"sp ring world {sp}", more, step_ms)
        del more
        torch.cuda.empty_cache()
    return total


def slice17(dev: torch.device, smi: str) -> dict:
    """Phase 20, slice 17's main path (the module docstring); returns the
    launches of each kernel on it."""
    t20 = time.perf_counter()
    sp_kernel_checks(dev, smi)
    torch.cuda.empty_cache()
    t20b = time.perf_counter()
    p20 = dict.fromkeys(_flash_counts(), 0)
    for part in (sp_attention(dev, "ring", smi), sp_attention(dev, "ulysses", smi),
                 sp_gpt2(dev, "20d", SP_MAIN, Mesh.stacked_mesh({"sp": SP_WORLD}), None, ("ring", "ulysses"),
                         STEPS, smi),
                 sp_gpt2(dev, "20e", dataclasses.replace(SP_MAIN, n_layer=SP_DPSP_LAYERS),
                         Mesh.stacked_mesh(SP_DPSP), "data", ("ring",), SP_DPSP_STEPS, smi)):
        for k, n in part.items():
            p20[k] += n
        torch.cuda.empty_cache()
    print(f"phase 20 launches: {p20}; phase 20 {time.perf_counter() - t20:.1f} s (20a {t20b - t20:.1f} s)",
          flush=True)
    return p20


def pipe_kernel_checks(dev: torch.device, smi: str) -> dict:
    """21(a): K2, K3 and K4 against their plain versions (``TOLERANCE``) at
    the shape a pipeline microbatch gives them, each timed by device time
    against its bound and sdpa's at the same shape.  Returns the records."""
    B, T, H, D = PIPE_KERNEL_SHAPE
    runs, (q, k, v, do, scale) = flash_runs(dev, B, T, H, D, torch.bfloat16, True)
    rec = {}
    for name, run in runs.items():
        err = check_flash(name, run, PIPE_KERNEL_SHAPE, torch.bfloat16, True)
        b_ms, b_by = bound(name, B * H, T, D, torch.bfloat16, True)
        rec[name] = {"max_abs_err": err, "device_ms": device_ms(run[0]), "bound_ms": b_ms, "bound_by": b_by}
    sdpa_fwd, sdpa_bwd = sdpa_device_ms(q, k, v, do, scale, PIPE_KERNEL_SHAPE, True)
    k2, k3, k4 = (rec[n]["device_ms"] for n in ("flash_fwd", "flash_dq", "flash_dkv"))
    print(f"pipe 21a kernels [{B * H}, {T}, {D}] bf16 causal, device ms: "
          + "; ".join(f"{n} {rec[n]['device_ms']:.4f} (bound {rec[n]['bound_ms']:.4f}, {rec[n]['bound_by']})"
                      for n in ("flash_fwd", "flash_dq", "flash_dkv"))
          + f"; sdpa forward {sdpa_fwd:.4f} (K2 {k2 / sdpa_fwd:.2f}x), sdpa backward {sdpa_bwd:.4f} "
          f"(K3 + K4 {(k3 + k4) / sdpa_bwd:.2f}x); {smi}", flush=True)
    return rec


def _set_grads(stages, grads) -> None:
    for stage, g in zip(stages, grads):
        for n, p in stage.named_parameters():
            p.grad = g[n]


def _same_grads(a, b) -> bool:
    return all(torch.equal(x[n], y[n]) for x, y in zip(a, b) for n in x)


def pipe_baseline(part, stages, tokens) -> tuple:
    """The composed microbatched twin of ``forward_backward``: each
    microbatch's ``composed_loss`` differentiated over every stage's
    parameters, the gradients added in microbatch order, the sums divided by
    the count, the tied head's gradient folded into ``wte``'s."""
    M = PIPE_MICROBATCHES
    mb = tokens.reshape(M, tokens.shape[0] // M, tokens.shape[1])
    names = [[n for n, _ in st.named_parameters()] for st in stages]
    params = [p for st in stages for p in st.parameters()]
    loss, acc = None, None
    for m in range(M):
        lm = composed_loss(MAIN, part, stages, mb[m])
        g = torch.autograd.grad(lm, params)
        loss = lm.detach() if loss is None else loss + lm.detach()
        acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
    m_t = torch.full((), M, dtype=loss.dtype, device=loss.device)
    loss = loss / m_t
    grads, i = [], 0
    for st_names in names:
        grads.append({n: acc[i + j] / torch.full((), M, dtype=acc[i + j].dtype, device=loss.device)
                      for j, n in enumerate(st_names)})
        i += len(st_names)
    head = grads[-1]["head_wte.weight"]
    grads[0]["wte.weight"] = grads[0]["wte.weight"] + head
    grads[-1]["head_wte.weight"] = torch.zeros_like(head)
    return loss, grads


def pipe_run(dev: torch.device, part, engine, model, tokens, kind: str) -> dict:
    """``PIPE_STEPS`` AdamW steps (``adamw(3e-4)``, DDP's) of the pipelined
    GPT-2 under ``kind`` from ``model``'s weights, ``sync_tied_embedding``
    after each; the flash launches of each step, losses, synced step
    seconds, the reports, the first step's gradients and the peak."""
    stages = split_params(model, part)
    opt = adamw(3e-4)([p for st in stages for p in st.parameters()])
    ex = PipelineExecutor(MAIN, part, engine, num_microbatches=PIPE_MICROBATCHES, schedule=kind, device=dev)
    out = {"losses": [], "seconds": [], "reports": [], "launches": [], "first_grads": None, "executor": ex}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(PIPE_STEPS):
        before = _flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, report = ex.forward_backward(stages, tokens)
        _set_grads(stages, grads)
        opt.step()
        sync_tied_embedding(stages)
        out["losses"].append(loss.item())  # waits for the step
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append(_since(before, _flash_counts()))
        out["reports"].append(report)
        if i == 0:
            out["first_grads"], out["first_loss"] = grads, loss
        del grads
    out["peak"] = torch.cuda.max_memory_allocated()
    del stages, opt
    return out


def pipeline_gpt2(dev: torch.device, smi: str) -> dict:
    """21(a) after the kernel checks: the pipelined GPT-2 (the module
    docstring).  Returns the flash launches of the pipelined steps."""
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, MAIN.vocab_size, size=(BATCH, MAIN.max_seq))).to(dev)
    model = GPT2(MAIN, device=dev, seed=SEED).to(torch.bfloat16)
    part = partition_gpt2(MAIN, PIPE_STAGES)
    print(f"pipe 21a partition: {PIPE_STAGES} stages, blocks {part.block_ranges}, parameters {part.param_counts}",
          flush=True)

    world = build_world_mesh(1)
    ddp_losses, ddp_seconds, _ = train(MAIN, world, model.state_dict(), tokens, steps=PIPE_STEPS)
    destroy_world()
    ddp_ms = float(np.mean(ddp_seconds[1:])) * 1e3
    torch.cuda.empty_cache()

    # the composed baseline from the same weights, outside the counted runs
    base_stages = split_params(model, part)
    base_loss, base_grads = pipe_baseline(part, base_stages, tokens)
    del base_stages
    torch.cuda.empty_cache()

    trace = CollectiveTrace()
    engine = CollectiveEngine(PIPE_STAGES, Strategy.ring(PIPE_STAGES), trace=trace)
    runs, total = {}, dict.fromkeys(_flash_counts(), 0)
    for kind in ("gpipe", "1f1b"):
        hops0 = len([e for e in trace.events() if e.primitive == "pipe_send"])
        runs[kind] = r = pipe_run(dev, part, engine, model, tokens, kind)
        hops = len([e for e in trace.events() if e.primitive == "pipe_send"]) - hops0
        ex, rep = r["executor"], r["reports"][0]
        want = dict.fromkeys(total, MAIN.n_layer * PIPE_MICROBATCHES)
        exact = torch.equal(r["first_loss"], base_loss) and _same_grads(r["first_grads"], base_grads)
        act_bytes = (BATCH // PIPE_MICROBATCHES) * MAIN.max_seq * MAIN.d_model * 2
        stash_model = [cost_model.pipeline_stash_bytes(PIPE_STAGES, PIPE_MICROBATCHES, kind, s, act_bytes)
                       for s in range(PIPE_STAGES)]
        step_ms = float(np.mean(r["seconds"][1:])) * 1e3
        gap = max(abs(a - b) for a, b in zip(r["losses"], ddp_losses))
        print(f"pipe 21a {kind}: losses {r['losses']} (DDP {ddp_losses}, max gap {gap:.3e}, tolerance {LOSS_ATOL}); "
              f"first step bit for bit the composed baseline: {exact}; launches a step {r['launches']} (design "
              f"{want}); hops {rep.hops} a step, traced {hops} in {PIPE_STEPS} steps (program total_sends "
              f"{ex.program.total_sends()}); ticks {rep.ticks}, bubble {rep.bubble_fraction:.4f} (cost model "
              f"{cost_model.pipeline_bubble_fraction(PIPE_STAGES, PIPE_MICROBATCHES):.4f}); stash peak "
              f"{rep.stash_peak}, bytes {rep.stash_peak_bytes} (cost model {stash_model}); step {step_ms:.2f} ms, "
              f"{BATCH * MAIN.max_seq / step_ms * 1e3:.1f} tokens/s (every step "
              f"{[round(t * 1e3, 2) for t in r['seconds']]} ms; DDP at world 1 on the same batch {ddp_ms:.2f} ms, "
              f"{BATCH * MAIN.max_seq / ddp_ms * 1e3:.1f} tokens/s); peak {r['peak'] / 2**30:.3f} GiB; {smi}",
              flush=True)
        if not (np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0] and gap <= LOSS_ATOL):
            raise RuntimeError(f"21a {kind}: losses {r['losses']} not finite, falling and within {LOSS_ATOL} of DDP's")
        if any(n != want for n in r["launches"]):
            raise RuntimeError(f"21a {kind}: launches {r['launches']}, not {want} a step")
        if not exact:
            raise RuntimeError(f"21a {kind}: the executor's first step differs from the composed baseline")
        if rep.hops != ex.program.total_sends() or hops != PIPE_STEPS * rep.hops:
            raise RuntimeError(f"21a {kind}: {rep.hops} hops a step, {hops} traced, program "
                               f"{ex.program.total_sends()}")
        sched = pipeline_schedule(PIPE_STAGES, PIPE_MICROBATCHES, kind)
        if rep.stash_peak != sched.stash_high_water or list(rep.stash_peak_bytes) != stash_model:
            raise RuntimeError(f"21a {kind}: stash {rep.stash_peak} {rep.stash_peak_bytes} against the table "
                               f"{sched.stash_high_water} and the cost model {stash_model}")
        for step_launches in r["launches"]:
            for k, n in step_launches.items():
                total[k] += n
        torch.cuda.empty_cache()
    same = runs["gpipe"]["losses"] == runs["1f1b"]["losses"] and \
        _same_grads(runs["gpipe"]["first_grads"], runs["1f1b"]["first_grads"])
    print(f"pipe 21a GPipe and 1F1B: losses and first gradients bit for bit: {same}; peak GiB "
          f"{runs['gpipe']['peak'] / 2**30:.3f} against {runs['1f1b']['peak'] / 2**30:.3f}", flush=True)
    if not same:
        raise RuntimeError("21a: GPipe and 1F1B differ")

    # the cost model's step price from this card's stage forward and hop
    stages = split_params(model, part)
    act = torch.randn(BATCH // PIPE_MICROBATCHES, MAIN.max_seq, MAIN.d_model, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: stage_forward(MAIN, part, 1, stages[1], act, None), iters=10)
    coeffs = cost_model.LinkCoeffs(*cost_model.DEFAULT_COEFFS[cost_model.ICI])
    priced = cost_model.pipeline_step_time(PIPE_STAGES, PIPE_MICROBATCHES, fwd_ms / 1e3, act_bytes, coeffs)
    print(f"pipe 21a cost model: pipeline_step_time {priced * 1e3:.2f} ms (a middle stage's forward of one "
          f"microbatch {fwd_ms:.3f} ms by events, hop {act_bytes} B at the card's default coefficients; stages "
          f"run one after another on one card, so the measured step is near the sum of the tasks)", flush=True)
    del stages, model, base_grads, runs
    return total


def ep_moe(dev: torch.device, smi: str) -> None:
    """21(b) (the module docstring)."""
    cfg = MoEConfig()
    # every expert can hold every token of a rank: nothing drops, so EP and
    # the dense module compute the same function
    check_cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    model = MoEMLP(check_cfg, device=dev, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(MOE_TOKENS, cfg.d_model, device=dev, generator=gen)
    g = torch.randn(MOE_TOKENS, cfg.d_model, device=dev, generator=gen)
    mesh = Mesh.stacked_mesh({"experts": MOE_WORLD})
    trace = CollectiveTrace()
    engine = CollectiveEngine(MOE_WORLD, Strategy.ring(MOE_WORLD), trace=trace)

    def run(fn):
        model.zero_grad(set_to_none=True)
        y, aux = fn()
        ((y.float() * g).sum() + aux).backward()
        return y.detach(), aux.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    def dense():
        y, aux = model(x[None])
        return y[0], aux

    want = run(dense)
    got = run(lambda: expert_parallel_moe(model, x, check_cfg, mesh, engine=engine))
    errs, ok = {}, True
    for name, a, b in [("y", got[0], want[0]), ("aux", got[1], want[1])] + [
            (f"d{n}", got[2][n], want[2][n]) for n in want[2]]:
        diff = (a.float() - b.float()).abs()
        errs[name] = diff.max().item()
        ok &= bool(torch.isfinite(a).all()) and bool((diff <= EP_ATOL * b.float().abs().max()).all())
    exact = all(torch.equal(a, b) for a, b in [(got[0], want[0]), (got[1], want[1])] +
                [(got[2][n], want[2][n]) for n in want[2]])
    events = [e.impl for e in trace.events() if e.primitive == "all_to_all"]
    print(f"ep 21b world {MOE_WORLD} stacked, engine-routed, {MOE_TOKENS} tokens, MoEConfig() widths at capacity "
          f"factor {check_cfg.capacity_factor} (no drops): max abs err vs dense MoEMLP "
          f"{', '.join(f'{n} {e:.3e}' for n, e in errs.items())} "
          f"({'bit for bit' if exact else 'within EP_ATOL of each max' if ok else 'FAIL'}); traced {events}; {smi}",
          flush=True)
    if not ok or events != ["torch_flat[moe]"] * 2:
        raise RuntimeError("21b: EP disagrees with the dense MoE or its exchanges were not traced")
    del model, got, want
    torch.cuda.empty_cache()

    # the config's own capacity: forward + backward time, the exchange's
    model = MoEMLP(cfg, device=dev, seed=SEED)
    cap = moe_capacity(cfg, MOE_TOKENS // MOE_WORLD)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        y, aux = expert_parallel_moe(model, x, cfg, mesh, engine=engine)
        ((y.float() * g).sum() + aux).backward()

    ep_ms = cuda_ms(fwd_bwd, iters=10)
    payload = torch.randn(MOE_WORLD, MOE_WORLD, (cfg.num_experts // MOE_WORLD) * cap * cfg.d_model,
                          device=dev).to(cfg.dtype)
    a2a_ms = device_ms(lambda: engine.all_to_all(payload))
    a2a_bound = 2 * payload.numel() * payload.element_size() / HBM_BYTES_S * 1e3
    if not torch.equal(engine.all_to_all(payload), payload.transpose(0, 1)):
        raise RuntimeError("21b: the engine's all_to_all is not the exchange")
    print(f"ep 21b capacity factor {cfg.capacity_factor} (capacity {cap} a rank and expert): forward + backward "
          f"{ep_ms:.3f} ms (events); the exchange's engine all_to_all of {payload.numel() * 2 / 2**20:.2f} MiB "
          f"bf16 (stacked [{MOE_WORLD}, {MOE_WORLD}, e_loc·C·D]): device {a2a_ms:.4f} ms, bound {a2a_bound:.4f} ms "
          f"(read and written once at {HBM_BYTES_S / 1e12:.2f} TB/s); {smi}", flush=True)
    del model, payload
    torch.cuda.empty_cache()

    from adapcc_tpu_torch.workloads import train_moe

    widths = ["--world", str(MOE_WORLD), "--experts", str(cfg.num_experts), "--dmodel", str(cfg.d_model),
              "--dhidden", str(cfg.d_hidden), "--top-k", str(cfg.top_k), "--batch", str(MOE_TOKENS),
              "--device", "cuda"]
    saved = {k: os.environ.get(k) for k in ("ADAPCC_TUNER", "ADAPCC_TUNER_DB")}
    try:
        with tempfile.TemporaryDirectory(prefix="adapcc_moe_") as d:
            os.environ["ADAPCC_TUNER"] = "off"
            first, last = train_moe.run(train_moe.build_parser().parse_args(
                widths + ["--steps", str(MOE_TRAIN_STEPS)]))
            print(f"ep 21b train_moe: loss {first:.4f} -> {last:.4f} in {MOE_TRAIN_STEPS} steps", flush=True)
            if not (np.isfinite([first, last]).all() and last < first):
                raise RuntimeError(f"21b: train_moe losses {first} -> {last} not finite and falling")
            os.environ.update(ADAPCC_TUNER="record", ADAPCC_TUNER_DB=os.path.join(d, "tuning.jsonl"))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train_moe.run(train_moe.build_parser().parse_args(
                    widths + ["--mode", "inference", "--steps", str(MOE_INFER_STEPS), "--tune-every", "1"]))
            out = buf.getvalue()
            print("".join(f"ep 21b train_moe inference: {line}\n" for line in out.splitlines()), end="", flush=True)
            if "[tuner] all_to_all" not in out or "computation time:" not in out:
                raise RuntimeError("21b: train_moe's inference printed no tuner line or no computation time")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def slice18(dev: torch.device, smi: str) -> dict:
    """Phase 21, slice 18's main path (the module docstring); returns the
    launches of each kernel on it."""
    t21 = time.perf_counter()
    pipe_kernel_checks(dev, smi)
    torch.cuda.empty_cache()
    p21 = pipeline_gpt2(dev, smi)
    torch.cuda.empty_cache()
    t21b = time.perf_counter()
    ep_moe(dev, smi)
    torch.cuda.empty_cache()
    print(f"phase 21 launches: {p21}; phase 21 {time.perf_counter() - t21:.1f} s (21b {time.perf_counter() - t21b:.1f} s)",
          flush=True)
    return p21


def _serve_hist(trace) -> dict:
    """The decode collectives' histogram of a dispatch trace: impl → count."""
    hist = {}
    for e in trace.events():
        if e.primitive == "allreduce":
            hist[e.impl] = hist.get(e.impl, 0) + 1
    return hist


@torch.no_grad()
def serve_teacher_forced(dev: torch.device, model: GPT2, world: int, slots: int, steps: int) -> int:
    """The sharded, batched decode step's logits against the model's own
    decode of each row alone, bit for bit: ``slots`` rows of random tokens,
    slot ``s`` joining at step ``s`` (every row at its own position), each
    layer combined by the engine under ``auto``.  Returns the rows held."""
    cfg = model.cfg
    tp = TPDecodeModel(model, world)
    eng = CollectiveEngine(world, Strategy.ring(world))
    cache = SlotKVCache(cfg, world, slots, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (slots, steps), device=dev, generator=gen)
    alone = [model.init_cache(1) for _ in range(slots)]
    held, worst = 0, 0.0
    for t in range(steps + slots - 1):
        rows = [s for s in range(slots) if s <= t < s + steps]
        pos = torch.tensor([min(max(0, t - s), steps - 1) for s in range(slots)], device=dev)
        tok = toks[torch.arange(slots, device=dev), pos][:, None]
        x = tp.embed(tok, pos)
        for layer in range(cfg.n_layer):
            k, v = cache.layers[layer]
            x = tp.post_attn(layer, x, eng.all_reduce(tp.attn_partial(layer, x, k, v, pos, rows), algo="auto")[0],
                             rows)
        logits = tp.logits(x, rows)
        for s in rows:
            ref, _ = model(tok[s : s + 1], decode=True, pos=int(pos[s]), cache=alone[s])
            worst = max(worst, float((ref - logits[s : s + 1]).abs().max()))
            held += bool(torch.equal(ref.view(torch.int32), logits[s : s + 1].view(torch.int32)))
    n = sum(min(steps, steps + slots - 1 - s) for s in range(slots))
    print(f"serve 22a teacher-forced: world {world} x {slots} slots, {n} rows over {steps + slots - 1} steps: "
          f"logits bit for bit the model's own decode of each row alone {held}/{n} (largest gap {worst:.3e})",
          flush=True)
    if held != n:
        raise RuntimeError(f"a batched decode row differs from its row alone ({n - held} of {n}, gap {worst:.3e})")
    return n


def serve_run(server, trace) -> tuple:
    """Run ``trace`` through ``server``: (results by id, wall seconds, peak
    device bytes during the run)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server.submit_trace(trace)
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    return {r.req_id: r for r in results}, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def serve_colocated(dev: torch.device, smi: str) -> tuple:
    """Phase 22a (the module docstring).  Returns (model, trace, streams by
    request id)."""
    t22 = time.perf_counter()
    model = GPT2(SERVE_MAIN, device=dev, seed=SEED).eval()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    serve_teacher_forced(dev, model, SERVE_WORLD, SERVE_SLOTS, SERVE_TF_STEPS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache = SlotKVCache(SERVE_MAIN, SERVE_WORLD, SERVE_SLOTS, device=dev)
    allocated = torch.cuda.memory_allocated() - before
    print(f"serve 22a: weights {weight_bytes / 1e9:.3f} GB float32; KV pages {cache!r}: {allocated} B allocated, "
          f"nbytes_per_rank {cache.nbytes_per_rank} B x world {SERVE_WORLD} = {cache.nbytes_per_rank * SERVE_WORLD} B",
          flush=True)
    if allocated != cache.nbytes_per_rank * SERVE_WORLD:
        raise RuntimeError("the KV pages' allocation is not nbytes_per_rank x world")
    del cache
    trace = synthesize_arrival_trace(SERVE_WORLD, vocab_size=SERVE_MAIN.vocab_size, **SERVE_TRACE)
    streams = {}
    for algo in ("auto", "ring"):
        ct = CollectiveTrace()
        server = GPT2Server(model, SERVE_WORLD, slots=SERVE_SLOTS, algo=algo, trace=ct, **SERVE_SAMPLING)
        results, wall, peak = serve_run(server, trace)
        s = server.summary()
        generated = sum(len(r.generated) for r in results.values())
        steps_computed = server.metrics.snapshot()["timings"]["serve.step_s"]["count"]
        hist = _serve_hist(ct)
        print(f"serve 22a ({algo}): {len(results)} requests, {server.clock} steps ({steps_computed} computed) in "
              f"{wall:.2f} s; decode step p50 {s['p50_step_ms']:.3f} ms, p99 {s['p99_step_ms']:.3f} ms (synced "
              f"walltime); {generated} tokens generated, {generated / wall:.1f} tokens/s; TTFT p50/p99 "
              f"{s['p50_ttft_steps']}/{s['p99_ttft_steps']} steps, sojourn p50/p99 {s['p50_sojourn_steps']}/"
              f"{s['p99_sojourn_steps']} steps; decode_collectives {hist}; peak memory {peak / 1e9:.3f} GB; "
              f"kv_cache_stats {s['kv_cache_stats']}; {smi}", flush=True)
        if len(results) != len(trace) or sum(hist.values()) != SERVE_MAIN.n_layer * steps_computed:
            raise RuntimeError(f"expected {len(trace)} requests and one allreduce a layer a computed step, got "
                               f"{len(results)} and {hist}")
        streams[algo] = {rid: r.tokens for rid, r in results.items()}
        if algo == "auto":
            auto_results, auto_step_ms = results, s["p50_step_ms"]
    if streams["auto"] != streams["ring"]:
        raise RuntimeError("the exact combine gave other streams under ring than under auto")
    for spec in trace.requests[:SERVE_ALONE]:
        ref = generate(model, [list(spec.prompt)], len(spec.prompt), spec.max_new_tokens,
                       generator=torch.Generator(device=dev).manual_seed(spec.seed), **SERVE_SAMPLING)
        same = ref[0].tolist() == auto_results[spec.req_id].tokens
        print(f"serve 22a: request {spec.req_id} (prompt {len(spec.prompt)}, {spec.max_new_tokens} new) equals its "
              f"generate run alone: {same}", flush=True)
        if not same:
            raise RuntimeError(f"request {spec.req_id} differs from its generate run alone")
    serve_compute(dev, model, auto_step_ms, smi)
    print(f"phase 22a {time.perf_counter() - t22:.1f} s", flush=True)
    return model, trace, streams["auto"]


class _NoCombine:
    """The decode step's collective left out: the stacked partial's sum on
    one row (what the combine delivers, without the engine)."""

    def all_reduce(self, partial, algo=None):
        return partial.sum(dim=0, keepdim=True)


@torch.no_grad()
def serve_compute(dev: torch.device, model: GPT2, step_ms: float, smi: str) -> None:
    """The full-width step's compute a layer (``SERVE_SLOTS`` slots mid-
    sequence, the allreduce left out, synced walltime) against
    ``decode_step_time``'s price on the card's coefficients, and what
    ``auto`` picks at the step's payload."""
    cfg = model.cfg
    tp = TPDecodeModel(model, SERVE_WORLD, **SERVE_SAMPLING)
    cache = SlotKVCache(cfg, SERVE_WORLD, SERVE_SLOTS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tok = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, 1), device=dev, generator=gen)
    pos = torch.full((SERVE_SLOTS,), cfg.max_seq // 2, device=dev)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in range(SERVE_SLOTS)]
    times = []
    for i in range(SERVE_STEP_ITERS + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp.decode_step(_NoCombine(), cache.layers, tok, pos, gens).tolist()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    times.sort()
    per_layer_s = times[len(times) // 2] / cfg.n_layer
    eng = CollectiveEngine(SERVE_WORLD, Strategy.ring(SERVE_WORLD))
    payload = SERVE_SLOTS * cfg.d_model * 4
    coeffs = cost_model.bottleneck_ring_coeffs(load_or_default(world=SERVE_WORLD), SERVE_WORLD)
    price = cost_model.decode_step_time(SERVE_WORLD, SERVE_SLOTS, cfg.n_layer, cfg.d_model, coeffs)
    measured = cost_model.decode_step_time(SERVE_WORLD, SERVE_SLOTS, cfg.n_layer, cfg.d_model, coeffs,
                                           compute_s_per_layer=per_layer_s)
    print(f"serve 22a compute: engine-free step p50 {times[len(times) // 2] * 1e3:.3f} ms (min {times[0] * 1e3:.3f}),"
          f" {per_layer_s * 1e6:.2f} us a layer (DEFAULT_DECODE_COMPUTE_S_PER_LAYER "
          f"{cost_model.DEFAULT_DECODE_COMPUTE_S_PER_LAYER * 1e6:.2f} us); auto on the card's coefficients picks "
          f"{eng._auto_algo(payload) or 'the flat plane'} at {payload} B a rank (crossover "
          f"{eng._allreduce_crossover_bytes():.0f} B); decode_step_time prices the step at "
          f"{price['step_time_s'] * 1e3:.3f} ms with the default ({price['algo']}, comm "
          f"{price['comm_s'] * 1e3:.3f} ms), {measured['step_time_s'] * 1e3:.3f} ms with this run's compute, against "
          f"the served step's p50 {step_ms:.3f} ms; {smi}", flush=True)
    # where the served step's time goes: one step with the engine (auto)
    profile_step("serve decode step", lambda: tp.decode_step(eng, cache.layers, tok, pos, gens).tolist(), step_ms)


def _migration_ms(trace) -> list:
    return [e.extra["duration_s"] * 1e3 for e in trace.events() if e.primitive == "kv_transfer"]


def serve_disagg(dev: torch.device, model: GPT2, trace, colocated: dict, smi: str) -> None:
    """Phase 22b (the module docstring)."""
    t22 = time.perf_counter()
    ct = CollectiveTrace()
    router = ClusterRouter(model, DISAGG_WORLD, DISAGG_WORLD, prefill_slots=DISAGG_SLOTS, decode_slots=DISAGG_SLOTS,
                           trace=ct, **SERVE_SAMPLING)
    router.submit_trace(trace)
    t0 = time.perf_counter()
    while router.clock < DISAGG_KILL_STEP or not router.decode.lanes:
        router.step()
    victims = router.kill_decode_pool()
    results = {r.req_id: r for r in router.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = router.summary()
    ms = _migration_ms(ct)
    same = sum(results[rid].tokens == colocated[rid] for rid in colocated)
    print(f"serve 22b (off wire): {len(results)} requests, {router.clock} steps in {wall:.2f} s; decode pod killed at "
          f"step {DISAGG_KILL_STEP}+ with victims {victims}; streams bit for bit 22a's {same}/{len(colocated)}; "
          f"kv_transfer events {len(ms)} for {s['kv_stream']['transfers']} migrations, {s['kv_stream']['payload_bytes']}"
          f" B; each migration p50 {sorted(ms)[len(ms) // 2]:.4f} ms, max {max(ms):.4f} ms (on one card the off wire "
          f"moves nothing: the bound is 0); TTFT p50/p99 {s['p50_ttft_steps']}/{s['p99_ttft_steps']} steps, sojourn "
          f"p50/p99 {s['p50_sojourn_steps']}/{s['p99_sojourn_steps']} steps; pools {s['pools']}; {smi}", flush=True)
    if not victims or same != len(colocated) or len(results) != len(colocated):
        raise RuntimeError("the disaggregated streams differ from the colocated ones (or no victim)")
    if len(ms) != s["kv_stream"]["transfers"] or router.metrics.snapshot()["counters"]["serve.migrated"] != len(ms):
        raise RuntimeError("a migration left no kv_transfer event")
    kl = measure_token_kl(model, DISAGG_WORLD, "int8")
    bound = resolve_kv_kl_bound()
    admitted = kl <= bound
    print(f"serve 22b (int8 wire): token KL {kl:.6e} nats at full width; admitted under ADAPCC_KV_KL_BOUND={bound}: "
          f"{admitted}", flush=True)
    if not admitted:
        try:
            ClusterRouter(model, DISAGG_WORLD, DISAGG_WORLD, prefill_slots=DISAGG_SLOTS, decode_slots=DISAGG_SLOTS,
                          kv_wire_dtype="int8")
        except ValueError as e:
            if "exceeds the acceptance bound" not in str(e):
                raise
        else:
            raise RuntimeError("the int8 wire was admitted above its KL bound")
    ct8 = CollectiveTrace()
    router8 = ClusterRouter(model, DISAGG_WORLD, DISAGG_WORLD, prefill_slots=DISAGG_SLOTS, decode_slots=DISAGG_SLOTS,
                            trace=ct8, kv_wire_dtype="int8", kv_kl_bound=max(bound, kl), **SERVE_SAMPLING)
    sub = dataclasses.replace(trace, requests=trace.requests[:DISAGG_INT8_REQUESTS])
    results8 = {r.req_id: r for r in serve_run(router8, sub)[0].values()}
    s8 = router8.summary()["kv_stream"]
    ms8 = _migration_ms(ct8)
    events = [e for e in ct8.events() if e.primitive == "kv_transfer"]
    bound_ms = [e.nbytes * 2 / cost_model.DEFAULT_HBM_BYTES_PER_S * 1e3 for e in events]
    same8 = sum(results8[rid].tokens == colocated[rid] for rid in results8)
    print(f"serve 22b (int8 wire): {len(results8)} requests, wire {s8['wire_bytes']} B of payload "
          f"{s8['payload_bytes']} B; each migration's ms against its bound (the codec pass reads and writes the float32"
          f" pages, 8 B an element over 3.35 TB/s): " + ", ".join(f"{a:.4f}/{b:.6f}" for a, b in zip(ms8, bound_ms))
          + f"; streams equal to the off wire's {same8}/{len(results8)}; {smi}", flush=True)
    if not s8["wire_bytes"] < s8["payload_bytes"] or len(results8) != len(sub):
        raise RuntimeError("the int8 wire did not shrink the KV stream")
    print(f"phase 22b {time.perf_counter() - t22:.1f} s", flush=True)


def serve_cli(smi: str) -> None:
    """Phase 22c (the module docstring): ``serve_gpt2`` on the card."""
    from adapcc_tpu_torch.workloads import serve_gpt2

    t22 = time.perf_counter()
    outputs = []
    with tempfile.TemporaryDirectory(prefix="adapcc_serve_") as workdir:
        path = os.path.join(workdir, "trace.json")
        argv = ["--json", "--requests", "6", "--world", str(SERVE_WORLD), "--slots", "4"]
        for extra, env in ((["--trace-out", path], None), ([], path)):
            if env is not None:
                os.environ[SERVE_TRACE_ENV] = env
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    serve_gpt2.main(argv + extra)
            finally:
                os.environ.pop(SERVE_TRACE_ENV, None)
            outputs.append(buf.getvalue().splitlines())
    rows = [[line for line in out if line.startswith('{"req_id"')] for out in outputs]
    summary = json.loads(outputs[0][-1])["summary"]
    print(f"serve 22c: serve_gpt2 {' '.join(argv)}: {len(rows[0])} rows, summary requests {summary['requests']}, "
          f"steps {summary['steps']}, step p50/p99 {summary['p50_step_ms']:.3f}/{summary['p99_step_ms']:.3f} ms, "
          f"decode_collectives {summary['decode_collectives']}; the replay through {SERVE_TRACE_ENV} gives the same "
          f"rows byte for byte: {rows[0] == rows[1]}; phase 22c {time.perf_counter() - t22:.1f} s; {smi}", flush=True)
    if rows[0] != rows[1] or len(rows[0]) != 6 or summary["requests"] != 6:
        raise RuntimeError("serve_gpt2's replayed trace gave other rows")


def slice19(dev: torch.device, smi: str) -> None:
    """Phase 22, slice 19's main path (the module docstring): it launches
    none of the kernels of the kernels line."""
    t22 = time.perf_counter()
    counts = {**_flash_counts(), **_ring_counts()}
    model, trace, colocated = serve_colocated(dev, smi)
    torch.cuda.empty_cache()
    serve_disagg(dev, model, trace, colocated, smi)
    del model
    torch.cuda.empty_cache()
    serve_cli(smi)
    after = {**_flash_counts(), **_ring_counts()}
    print(f"phase 22 launches of the kernels line: {_since(counts, after)}; phase 22 {time.perf_counter() - t22:.1f} s",
          flush=True)
    if after != counts:
        raise RuntimeError(f"the serving path launched a kernel of the kernels line: {_since(counts, after)}")


# --------------------------------------------------------------------------- #
# phase 23: the training workloads (slice 20)
# --------------------------------------------------------------------------- #


def gpt2_workload_launches(args, report: dict) -> dict:
    """The flash launches ``train_gpt2.run`` makes, from its code: a forward
    (K2 a layer) and a backward (K3, K4 a layer) a training step, a forward
    a held-out batch of each perplexity pass (before and after training),
    and a forward a ``HITS_CHUNK`` of hits@1's candidate sequences;
    ``generate`` decodes without them."""
    n_seqs = (args.corpus_tokens // args.seq)
    n_val = max(16, n_seqs // 10)
    steps = sum(report["epoch_steps"])
    evals = (1 + args.epochs) * (n_val // 16)
    hits = -(-min(n_val, 64) * 4 // train_gpt2.HITS_CHUNK)
    fwd = args.layers * (steps + evals + hits)
    return {"flash_fwd": fwd, "flash_dq": args.layers * steps, "flash_dkv": args.layers * steps}


def train_gpt2_full_width(dev: torch.device, smi: str) -> dict:
    """23a: ``train_gpt2`` at MAIN's widths, float32, flash, one epoch."""
    args = train_gpt2.build_parser().parse_args(GPT2_WORKLOAD_ARGV)
    report = {}
    for w in fa.KERNELS:
        w.launches = 0
    t0 = time.perf_counter()
    ppl0, ppl1 = train_gpt2.run(args, report=report)
    seconds = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in fa.KERNELS}
    want = gpt2_workload_launches(args, report)
    losses = report["losses"]
    steps, epoch_s = report["epoch_steps"][0], report["epoch_s"][0]
    step_ms = epoch_s / steps * 1e3
    tokens_s = steps * args.batch * args.seq / epoch_s
    print(f"23a train_gpt2 (float32, flash, {args.layers} layers, d_model {args.dmodel}, {args.heads} heads, "
          f"vocab {args.vocab}, T {args.seq}, batch {args.batch}, 1 epoch = {steps} steps): val ppl "
          f"{ppl0:.3f} -> {ppl1:.3f}; hits@1 {report['hits_at_1']:.3f} (chance 0.25); losses {losses}; "
          f"step {step_ms:.2f} ms (epoch {epoch_s:.3f} s over {steps} steps, synced at its ends), "
          f"{tokens_s:.1f} tokens/s; peak {report['peak_bytes'] / 2**30:.3f} GiB; sample continuation "
          f"{report['sample']}; run {seconds:.1f} s [{smi}]", flush=True)
    print(f"23a launches {launches}, from the code {want}", flush=True)
    if launches != want:
        raise RuntimeError(f"train_gpt2's flash launches {launches} differ from the code's count {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or not ppl1 < ppl0:
        raise RuntimeError(f"train_gpt2 did not learn: losses {losses}, ppl {ppl0} -> {ppl1}")
    if len(report["sample"]) != 24 or not all(0 <= t < args.vocab for t in report["sample"]):
        raise RuntimeError(f"train_gpt2's sample is malformed: {report['sample']}")
    # the first step's loss is the seeded model's loss on the first batch:
    # the same under plain attention, float32 on both sides
    stream = train_gpt2.markov_corpus(args.corpus_tokens, args.vocab, seed=0)
    packed = train_gpt2.pack_sequences(stream, args.seq)
    train_set = packed[:-max(16, len(packed) // 10)]
    first = next(iter(device_batches(train_set, args.batch, seed=0, device=dev))).long()
    cfg = GPT2Config(vocab_size=args.vocab, max_seq=args.seq, n_layer=args.layers, n_head=args.heads,
                     d_model=args.dmodel, dtype=torch.float32, attention="xla")
    with torch.no_grad():
        xla_loss = float(lm_loss(GPT2(cfg, device=dev, seed=0)(first), first))
    gap = abs(xla_loss - losses[0])
    print(f"23a first step's loss: flash {losses[0]:.6f}, plain attention {xla_loss:.6f}, gap {gap:.3e} "
          f"(tolerance {GPT2_F32_LOSS_ATOL})", flush=True)
    if not gap <= GPT2_F32_LOSS_ATOL:
        raise RuntimeError("the float32 flash step and plain attention disagree on the first loss")
    torch.cuda.empty_cache()
    return launches


def one_launch_device_ms(fn) -> object:
    """Device ms of ``fn``, a call that launches one kernel: a capture in
    which the profiler kept fewer records than calls (``device_stats`` then
    reads fewer launches than one a call) is taken again; None ("not
    measured") when every capture lost records."""
    for _ in range(PROFILE_ATTEMPTS):
        ms, launches = device_stats(fn)
        if launches == 1:
            return ms
        print(f"device_ms: {launches} launches a call read from the profiler's records of a one-launch call; "
              "capture taken again", flush=True)
    return None


def float32_flash_records(dev: torch.device, smi: str) -> dict:
    """23a: the float32 K2–K4 alone at the workload's ``[B·H, T, D]``, each
    held against its plain version, then timed by device time and events
    against the plain version, the bound and float32 sdpa."""
    B, T, H, D = GPT2_F32_SHAPE
    runs, (q, k, v, do, scale) = flash_runs(dev, B, T, H, D, torch.float32, True)
    out = {}
    for name, run in runs.items():
        err = check_flash(name, run, GPT2_F32_SHAPE, torch.float32, True)
        kernel, plain, _ = run
        b_ms, b_by = bound(name, B * H, T, D, torch.float32, True)
        out[name] = {"max_abs_err": err, "ms": cuda_ms(kernel), "device_ms": one_launch_device_ms(kernel),
                     "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms, "bound_by": b_by}
    ql, kl, vl = (x.view(B, H, T, D) for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)

    fwd_ms, fwd_dev = cuda_ms(fwd), device_ms(fwd)
    ql, kl, vl = (x.detach().requires_grad_() for x in (ql, kl, vl))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)
    dol = do.view(B, H, T, D)

    def bwd():
        return torch.autograd.grad(o, (ql, kl, vl), dol, retain_graph=True)

    bwd_ms, bwd_dev = cuda_ms(bwd), device_ms(bwd)
    out["flash_fwd"].update(library_ms=fwd_ms, library_device_ms=fwd_dev)
    for name in ("flash_dq", "flash_dkv"):
        out[name].update(library_ms=bwd_ms, library_device_ms=bwd_dev,
                         library_covers="dq, dk and dv: one float32 sdpa backward")
    for name, r in out.items():
        dev_ms = r["device_ms"]
        timed = dev_ms if dev_ms is not None else r["ms"]
        print(f"23a float32 {name} [{B * H}, {T}, {D}] causal: device "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, events "
              f"{r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / timed:.1f}% of it; plain {r['plain_ms']:.4f} ms; "
              f"float32 sdpa {'forward' if name == 'flash_fwd' else 'backward'} device {r['library_device_ms']:.4f} "
              f"ms [{smi}]", flush=True)
    del q, k, v, do, ql, kl, vl, o
    torch.cuda.empty_cache()
    return out


def train_ddp_presets(workdir: str) -> None:
    """23b: every ``train_ddp`` preset at world 1 under ddp, zero1 and fsdp,
    a few steps each; the bootstrap writes its topology files in
    ``workdir``.  Launches no kernel of the kernels line (the gpt2 preset
    runs JAX's default, plain attention)."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for model in train_ddp.MODELS:
            for mode in ("ddp", "zero1", "fsdp"):
                t0 = time.perf_counter()
                logged = train_ddp.main(["--model", model, "--dp-mode", mode, "--steps", str(DDP_PRESET_STEPS),
                                         "--lr", str(DDP_PRESET_LR)])
                destroy_world()
                torch.cuda.synchronize()
                print(f"23b train_ddp --model {model} --dp-mode {mode}: logged losses {logged} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                if not all(np.isfinite(logged)) or not logged[-1] < logged[0]:
                    raise RuntimeError(f"train_ddp {model} {mode}: losses not finite and falling: {logged}")
                torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)


def image_model_step(dev: torch.device, label: str, model, batch: int, size: int, classes: int,
                     smi: str, stateful: bool = False) -> None:
    """23c: ``IMAGE_STEPS`` AdamW steps of ``model`` through ``DDPTrainer``
    at world 1; step ms (mean after the first, each timed to completion),
    images/s, peak allocated."""
    world = build_world_mesh(1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(batch, size, size, 3, device=dev, generator=gen)
    y = torch.randint(0, classes, (batch,), device=dev, generator=gen)

    def loss_fn(m, b):
        return F.cross_entropy(m(b[0]).float(), b[1])

    trainer = DDPTrainer(loss_fn, adamw(1e-4), world, Strategy.ring(1))
    state = trainer.init_state(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, seconds = [], []
    for _ in range(IMAGE_STEPS):
        t0 = time.perf_counter()
        state, loss = trainer.step(state, (x, y))
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    destroy_world()
    step_s = float(np.mean(seconds[1:]))
    peak = torch.cuda.max_memory_allocated(dev)
    stats = ""
    if stateful:
        mean = [b for n, b in model.named_buffers() if n.endswith("mean")]
        stats = f"; running means moved in {sum(bool((m != 0).any()) for m in mean)} of {len(mean)} norms"
    print(f"23c {label}: losses {[round(v, 5) for v in losses]}; step {step_s * 1e3:.2f} ms, "
          f"{batch / step_s:.1f} images/s (mean of steps 2-{IMAGE_STEPS}; every step "
          f"{[round(s * 1e3, 2) for s in seconds]} ms); peak {peak / 2**30:.3f} GiB{stats} [{smi}]", flush=True)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{label}: non-finite loss {losses}")


def image_models(dev: torch.device, smi: str) -> None:
    """23c: ResNet-50 v1.5 (ImageNet stem, 224x224, 1000 classes) under
    group and batch norm and ViT-S/16 at their published widths, bf16."""
    for norm in ("group", "batch"):
        model = ResNet50(num_classes=1000, norm=norm, dtype=torch.bfloat16, device=dev)
        image_model_step(dev, f"ResNet-50 v1.5 norm={norm} (224x224, 1000 classes, batch {RESNET_BATCH}, bf16)",
                         model, RESNET_BATCH, 224, 1000, smi, stateful=norm == "batch")
        del model
        torch.cuda.empty_cache()
    cfg = ViTConfig()
    image_model_step(dev, f"ViT-S/16 ({cfg.image_size}x{cfg.image_size}, patch {cfg.patch_size}, d {cfg.d_model}, "
                     f"{cfg.n_layer} layers, {cfg.n_head} heads, batch {VIT_BATCH}, bf16)", ViT(cfg, device=dev),
                     VIT_BATCH, cfg.image_size, cfg.num_classes, smi)
    torch.cuda.empty_cache()


def elastic_run(workdir: str, tag: str, crash: bool) -> tuple:
    """``main_elastic --supervise`` in a child process (its workers are
    grandchildren); returns (stdout, the final checkpoint)."""
    ckpt = os.path.join(workdir, tag, "checkpoint.ckpt")
    argv = [sys.executable, "-m", "adapcc_tpu_torch.workloads.main_elastic", "--supervise", "--model",
            "resnet18", "--norm", "batch", "--deterministic", "--checkpoint-file", ckpt]
    if crash:
        argv += ["--crash-at-epoch", "1"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"main_elastic {tag} exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    state = TrainCheckpointState(params=None)
    with open(ckpt, "rb") as f:
        state.apply_snapshot(torch.load(f, map_location="cpu", weights_only=True))
    return proc.stdout, state


def workloads_accuracy_elastic(workdir: str, smi: str) -> None:
    """23d: ``accuracy_benchmark`` at its defaults, and ``main_elastic
    --supervise --model resnet18 --norm batch`` with a crash after epoch 1
    against the same run uninterrupted."""
    for argv in ([], ACCURACY_LEARNS):
        t0 = time.perf_counter()
        report = {}
        top1, top5 = accuracy_benchmark.run(accuracy_benchmark.build_parser().parse_args(argv), report=report)
        destroy_world()
        print(f"23d accuracy_benchmark {argv or '(defaults: VGG11)'}, 3 epochs: top-1/top-5 by epoch "
              f"{report['epochs']} ({time.perf_counter() - t0:.1f} s) [{smi}]", flush=True)
        if not np.isfinite(top1) or (argv and not top1 > 5 * 100.0 / 10):
            raise RuntimeError(f"accuracy_benchmark {argv}: top-1 {top1} is not well above chance (10%)")
    t0 = time.perf_counter()
    out, crashed = elastic_run(workdir, "crash", crash=True)
    t_crash = time.perf_counter() - t0
    _, straight = elastic_run(workdir, "straight", crash=False)
    lines = [ln for ln in out.splitlines() if ln.startswith("=>") or ln.startswith("epoch")]
    print(f"23d main_elastic --supervise --crash-at-epoch 1 ({t_crash:.1f} s): {lines}", flush=True)
    if "=> injected fault at epoch 1" not in out or "=> resuming from epoch 2" not in out:
        raise RuntimeError("main_elastic did not crash at epoch 1 and resume at epoch 2")
    gaps = {}
    for kind, a, b in (("params", crashed.params, straight.params),
                       ("running stats", crashed.extra["model_state"], straight.extra["model_state"])):
        gaps[kind] = max(float((a[k].float() - b[k].float()).abs().max() / b[k].float().abs().max().clamp_min(1e-12))
                         for k in b)
    moved = sum(bool((v != 0).any()) for k, v in crashed.extra["model_state"].items() if k.endswith("mean"))
    print(f"23d resumed against uninterrupted (epoch {crashed.epoch} vs {straight.epoch}): largest relative gap "
          f"{gaps} (tolerances {ELASTIC_PARAM_TOL}, {ELASTIC_STATS_TOL}); SyncBN running means carried in {moved} "
          f"norms [{smi}]", flush=True)
    if crashed.epoch != straight.epoch or gaps["params"] > ELASTIC_PARAM_TOL or \
            gaps["running stats"] > ELASTIC_STATS_TOL:
        raise RuntimeError(f"the resumed run differs from the uninterrupted one: {gaps}")


def gns_stacked(dev: torch.device, smi: str) -> None:
    """23e: ``measure/gns.py``'s estimator on the card over stacked
    gradients: each rank's gradient of its rows of train_ddp's ResNet-18
    batch, stacked ``[world, ...]``; ``stacked_grad_sq_norms`` against
    float64 host sums, the update on the mean gradient."""
    loss_fn, model, batch_fn = train_ddp.make_workload("resnet18", 64, dev)
    x, y = batch_fn()
    params = list(model.parameters())
    opt = adam(1e-4)(params)
    per = x.shape[0] // GNS_WORLD
    est = GNSEstimator(b_small=per, b_big=x.shape[0])
    rows = []
    for _ in range(GNS_STEPS):
        grads = []
        for r in range(GNS_WORLD):
            model.zero_grad(set_to_none=True)
            loss_fn(model, (x[r * per:(r + 1) * per], y[r * per:(r + 1) * per])).backward()
            grads.append([p.grad.detach().clone() for p in params])
        stacked = [torch.stack(g) for g in zip(*grads)]
        t0 = time.perf_counter()
        small, big = stacked_grad_sq_norms(stacked)
        small, big = float(small), float(big)
        norms_ms = (time.perf_counter() - t0) * 1e3
        want_small = float(np.mean([sum(float((g.double() ** 2).sum()) for g in rank) for rank in grads]))
        want_big = sum(float((g.double().mean(0) ** 2).sum()) for g in stacked)
        gaps = (abs(small - want_small) / want_small, abs(big - want_big) / want_big)
        rows.append((small, big, est.update(small, big), gaps, norms_ms))
        if max(gaps) > GNS_RTOL:
            raise RuntimeError(f"the card's GNS norms differ from the host's float64 sums: {gaps}")
        for p, g in zip(params, stacked):
            p.grad = g.mean(0)
        opt.step()
    print(f"23e GNS on stacked gradients (ResNet-18 preset, world {GNS_WORLD} stacked, b {per} / B {x.shape[0]}): "
          f"(E|G_b|², |G_B|², B_noise, relative gaps to float64, norms ms) by step {rows} [{smi}]", flush=True)


def slice20(dev: torch.device, smi: str, records: dict) -> dict:
    """Phase 23, slice 20's main path (the module docstring)."""
    t23 = time.perf_counter()
    launches = train_gpt2_full_width(dev, smi)
    f32 = float32_flash_records(dev, smi)
    for name, r in f32.items():
        records[name]["float32"] = {"shape": list(GPT2_F32_SHAPE), **r}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="adapcc_train_ddp_") as workdir:
        train_ddp_presets(workdir)
    print(f"23b {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    image_models(dev, smi)
    print(f"23c {time.perf_counter() - t:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="adapcc_elastic_") as workdir:
        workloads_accuracy_elastic(workdir, smi)
    gns_stacked(dev, smi)
    torch.cuda.empty_cache()
    print(f"phase 23 {time.perf_counter() - t23:.1f} s", flush=True)
    return launches


# kernel name fragments -> the layer of the step they belong to
_LAYERS = (
    ("flash kernels", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("ring kernels", ("ring_k1", "ring_k5")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("allreduce", ("nccl",)),
    ("optimizer", ("multi_tensor", "adam")),
)


def profile_step(label: str, step, step_ms: float, forbid: tuple = ()) -> tuple:
    """Device time of one more training step, by kernel and by layer; the
    device's busy share is that time over ``step_ms``, the unprofiled step.
    Fails if the step ran any of the host ops ``forbid`` names, whatever
    device records the profiler kept.  Returns (device ms, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # the host side, which issues the kernels (times inflated by the profiler)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    for op in forbid:
        found = [e for e in host if e.key == op]
        calls = sum(e.count for e in found)
        print(f"profile ({label}): {op} x{calls}, device "
              f"{sum(e.device_time_total for e in found) / 1e3:.3f} ms", flush=True)
        if calls:
            raise RuntimeError(f"the {label} step ran {op} {calls} times")
    kernels = _device_events(prof)
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms == 0:
        print(f"profile ({label}): the profiler recorded no device time (not measured)")
        return 0.0, 0
    by_layer = {}
    for e in kernels:
        layer = next((n for n, keys in _LAYERS if any(k in e.key.lower() for k in keys)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + e.self_device_time_total / 1e3
    named_lambda = sum(e.self_device_time_total for e in kernels if "#" in e.key) / 1e3
    print(f"profile ({label}): {total_ms:.3f} ms of kernels; device busy "
          f"{100 * total_ms / step_ms:.1f}% of the unprofiled {step_ms:.2f} ms step; kernels named after "
          f"a lambda {named_lambda:.3f} ms of it (a filter on '#' left them out before)")
    for layer, ms in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"profile ({label}): layer {layer:13s} {ms:9.3f} ms  {100 * ms / total_ms:5.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile ({label}): kernel {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"profile ({label}): host op {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:80]}")
    launches = sum(e.count for e in kernels)
    print(f"profile ({label}): {launches} device launches (kernels, copies, fills) in the step")
    return total_ms, launches


def build_all() -> None:
    """One ``nvcc`` per source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
                print(f"  ptxas ({lib.name.split('_')[0][3:]}): {line.strip()}")
    f32_backward_ptxas((_build.library_path("flash_attention")).with_suffix(".log").read_text())
    # the wgmma kernels' shared memory is all dynamic, which ptxas does not show
    smem = fa._library().adapcc_flash_smem_bytes
    print("  dynamic shared memory (flash, bf16): " + ", ".join(
        f"{kernel} D<={d} {smem(i, d)} B" for i, kernel in enumerate(("forward", "dk/dv", "dq")) for d in (64, 128)))
    print("  dynamic shared memory (flash, float32 backward): " + ", ".join(
        f"{kernel} D<={d} {smem(i, d)} B" for i, kernel in ((4, "dq"), (3, "dk/dv")) for d in (32, 64, 128)))


def f32_backward_ptxas(log: str) -> None:
    """One line a float32 backward kernel (``rb::flash_dq_kernel``,
    ``rb::flash_dkv_kernel``) and padded head dim from ptxas's report:
    registers, stack, spills.  Fails on a spill at the main path's DM = 64."""
    lines = log.splitlines()
    seen = 0
    for i, line in enumerate(lines):
        found = re.search(r"rb\d+(flash_\w+?_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry" not in line or not found:
            continue
        kernel, dm, rows, tile, threads = found.groups()
        frame, regs = lines[i + 2].strip(), lines[i + 3].strip()
        spill = [int(n) for n in re.findall(r"(\d+) bytes spill", frame)]
        print(f"  ptxas (float32 {kernel} DM={dm}: {rows} rows, tiles of {tile}, {threads} threads): "
              f"{regs.split(': ', 1)[-1]}; {frame}", flush=True)
        seen += 1
        if dm == "64" and any(spill):
            raise RuntimeError(f"float32 {kernel} spills at DM = 64: {frame}")
    if seen != 6:
        raise RuntimeError(f"ptxas reported {seen} float32 backward kernels, not 6 (dq and dk/dv at DM 32, 64, 128)")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    name, cap = torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0)
    print(f"card: {smi}", flush=True)
    print(f"device: {name}, compute capability {cap[0]}.{cap[1]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")

    # 2. build
    build_all()

    # 3. flash kernels against their plain versions
    records = check_kernels(dev)

    # 4. ring kernels against theirs, and their times at their paths' payloads
    check_ring(dev)
    zero1_padded = _flatten_meta(GPT2(MAIN, device="meta", seed=None), ZERO1_WORLD, 8 * 128).padded
    print(f"zero1 payload: {zero1_padded} float32 per rank (the flat master, tile-aligned)", flush=True)
    records["ring_k1a"] = time_ring(dev, "ring_k1a", ENGINE_ELEMS["ring_k1a"])
    records["ring_k1b"] = time_ring(dev, "ring_k1b", zero1_padded)

    # 5. slice 1's main path: DDP with flash attention
    world = build_world_mesh(1)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, MAIN.vocab_size, size=(BATCH, MAIN.max_seq))).to(dev)
    init_state = GPT2(MAIN, device=dev, seed=SEED).to(torch.bfloat16).state_dict()
    for w in fa.KERNELS:
        w.launches = 0
    losses, seconds, one_more_step = train(MAIN, world, init_state, tokens)
    launches = {w.__name__: w.launches for w in fa.KERNELS}
    print(f"main path (flash): losses {losses}", flush=True)
    print(f"main path launches: {launches}", flush=True)
    want = MAIN.n_layer * STEPS
    if any(n != want for n in launches.values()):
        raise RuntimeError(f"expected {want} launches of each kernel, got {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite and falling: {losses}")
    # where the time goes: one more step, after the launch counts were read
    step_s = float(np.mean(seconds[1:]))  # steps after the first, which warms the libraries up
    profile_step("ddp flash", one_more_step, step_s * 1e3)
    del one_more_step
    torch.cuda.empty_cache()
    xla_losses, xla_seconds, _ = train(dataclasses.replace(MAIN, attention="xla"), world, init_state, tokens)
    gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    print(f"reference (xla attention): losses {xla_losses}; max gap {gap:.3e} (tolerance {LOSS_ATOL})",
          flush=True)
    if not gap <= LOSS_ATOL:
        raise RuntimeError("flash and xla attention disagree on the main path")
    destroy_world()
    print(f"main path: step {step_s * 1e3:.2f} ms, {BATCH * MAIN.max_seq / step_s:.1f} tokens/s "
          f"(mean of steps 2-{STEPS}; every step time {[round(s * 1e3, 2) for s in seconds]} ms)",
          flush=True)
    xla_step_s = float(np.mean(xla_seconds[1:]))
    print(f"reference (xla attention): step {xla_step_s * 1e3:.2f} ms, "
          f"{BATCH * MAIN.max_seq / xla_step_s:.1f} tokens/s", flush=True)
    torch.cuda.empty_cache()

    # 6. the ring engine's entry points (the busbw benchmark's door to K1)
    engine_launches = engine_path(dev)
    print(f"engine path launches: {engine_launches}", flush=True)
    if not all(engine_launches.values()):
        raise RuntimeError(f"a ring kernel did not launch on the engine path: {engine_launches}")
    launches["ring_k1a"] = engine_launches["ring_k1a"]
    torch.cuda.empty_cache()

    # 7. slice 2's main path: ZeRO-1 on the ring, world 4 on this card
    z_tokens = torch.from_numpy(
        rng.integers(0, MAIN.vocab_size, size=(ZERO1_WORLD * BATCH, MAIN.max_seq))).to(dev)
    for w in (*fa.KERNELS, *ring.KERNELS):
        w.launches = 0
        getattr(w, "phases", {}).clear()
    z_losses, z_seconds, z_more = train_zero1(dev, init_state, z_tokens)
    z_launches = {w.__name__: w.launches for w in (*fa.KERNELS, *ring.KERNELS)}
    print(f"zero1 path: per-rank losses by step {z_losses}", flush=True)
    print(f"zero1 path launches: {z_launches}; ring_k1b by phase {dict(ring.ring_k1b.phases)}", flush=True)
    if dict(ring.ring_k1b.phases) != {"rs": STEPS, "ag": STEPS} or z_launches["ring_k1a"]:
        raise RuntimeError(f"expected {STEPS} K1b reduce-scatters and all-gathers and no K1a, got "
                           f"{dict(ring.ring_k1b.phases)}, K1a {z_launches['ring_k1a']}")
    want = MAIN.n_layer * ZERO1_WORLD * STEPS
    if any(z_launches[w.__name__] != want for w in fa.KERNELS):
        raise RuntimeError(f"expected {want} launches of each flash kernel, got {z_launches}")
    z_mean = [float(np.mean(step)) for step in z_losses]
    if not np.isfinite(z_losses).all() or not z_mean[-1] < z_mean[0]:
        raise RuntimeError(f"zero1 losses not finite and falling: {z_losses}")
    launches["ring_k1b"] = z_launches["ring_k1b"]
    z_step_s = float(np.mean(z_seconds[1:]))
    # the ring's payload goes to K1b unpadded: no stage padding copy is left
    profile_step("zero1 ring", z_more, z_step_s * 1e3, forbid=("aten::constant_pad_nd",))
    del z_more
    torch.cuda.empty_cache()
    with plain_ring():
        p_losses, p_seconds, _ = train_zero1(dev, init_state, z_tokens)
    z_gap = float(np.abs(np.array(z_losses) - np.array(p_losses)).max())
    print(f"reference (plain ring): per-rank losses by step {p_losses}; max gap {z_gap:.3e} "
          f"(tolerance {ZERO1_LOSS_ATOL})", flush=True)
    if not z_gap <= ZERO1_LOSS_ATOL:
        raise RuntimeError("the ring kernels and the plain ring disagree on the ZeRO-1 path")
    z_tokens_step = ZERO1_WORLD * BATCH * MAIN.max_seq
    print(f"zero1 path: step {z_step_s * 1e3:.2f} ms, {z_tokens_step / z_step_s:.1f} tokens/s global "
          f"(world {ZERO1_WORLD} on one card; mean of steps 2-{STEPS}; every step time "
          f"{[round(s * 1e3, 2) for s in z_seconds]} ms)", flush=True)
    p_step_s = float(np.mean(p_seconds[1:]))
    print(f"reference (plain ring): step {p_step_s * 1e3:.2f} ms, {z_tokens_step / p_step_s:.1f} tokens/s",
          flush=True)
    ring.check_errors()
    torch.cuda.empty_cache()

    # 8. the fused-codec ring kernels against their plain version
    check_fused_ring(dev)

    # 9. slice 3's main path: the engine's compressed ring collectives on the
    # full GPT-2 gradient
    grads = gpt2_gradients(dev, init_state, z_tokens)
    print(f"fused path payload: {grads.shape[1]} float32 a rank ({grads.shape[1] * 4 / 2**20:.1f} MiB), "
          f"the GPT-2's per-rank gradients in ZeRO-1's flat layout", flush=True)
    f_launches = fused_engine_path(dev, grads)
    print(f"fused path launches: {f_launches}", flush=True)
    if not (f_launches["ring_k5a"] and f_launches["ring_k5b"]):
        raise RuntimeError(f"a fused ring kernel did not launch on the fused path: {f_launches}")
    launches.update(ring_k5a=f_launches["ring_k5a"], ring_k5b=f_launches["ring_k5b"])
    records["ring_k5b"] = time_fused(dev, "ring_k5b", grads)
    del grads
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records["ring_k5a"] = time_fused(
        dev, "ring_k5a", torch.randn(ZERO1_WORLD, ENGINE_ELEMS["ring_k1a"], device=dev, generator=gen))
    torch.cuda.empty_cache()

    # 10. training with the codec: ZeRO-1 int8 contributions (on K1b), and
    # DDP with int8 gradients and error feedback
    for w in ring.KERNELS:
        w.launches = 0
        w.phases.clear()
    q_losses, q_seconds, _ = train_zero1(dev, init_state, z_tokens, wire_dtype="int8")
    q_launches = {w.__name__: w.launches for w in ring.KERNELS}
    q_gap = float(np.abs(np.array(q_losses) - np.array(z_losses)).max())
    q_mean = [float(np.mean(step)) for step in q_losses]
    q_step_s = float(np.mean(q_seconds[1:]))
    print(f"zero1 int8: per-rank losses by step {q_losses}; max gap to the uncompressed run {q_gap:.3e}; "
          f"launches {q_launches}, ring_k1b by phase {dict(ring.ring_k1b.phases)}; step {q_step_s * 1e3:.2f} ms, "
          f"{z_tokens_step / q_step_s:.1f} tokens/s global", flush=True)
    if dict(ring.ring_k1b.phases) != {"rs": STEPS, "ag": STEPS} or q_launches["ring_k1a"]:
        raise RuntimeError(f"expected {STEPS} K1b reduce-scatters and all-gathers, got {q_launches}")
    if not np.isfinite(q_losses).all() or not q_mean[-1] < q_mean[0]:
        raise RuntimeError(f"zero1 int8 losses not finite and falling: {q_losses}")
    torch.cuda.empty_cache()
    world = build_world_mesh(1)
    e_losses, e_seconds, _ = train(MAIN, world, init_state, tokens, grad_compress="int8", error_feedback=True)
    destroy_world()
    e_step_s = float(np.mean(e_seconds[1:]))
    print(f"ddp int8 + error feedback: losses {e_losses}; max gap to the uncompressed run "
          f"{max(abs(a - b) for a, b in zip(e_losses, losses)):.3e}; step {e_step_s * 1e3:.2f} ms, "
          f"{BATCH * MAIN.max_seq / e_step_s:.1f} tokens/s", flush=True)
    if not all(np.isfinite(e_losses)) or not e_losses[-1] < e_losses[0]:
        raise RuntimeError(f"ddp int8 losses not finite and falling: {e_losses}")
    ring.check_errors()

    # 11. slice 8's main path: the schedule plane with relay masks
    t11 = time.perf_counter()
    for w in fa.KERNELS:
        w.launches = 0
    s_tokens = torch.from_numpy(
        rng.integers(0, MAIN.vocab_size, size=(SCHEDULE_WORLD * BATCH, MAIN.max_seq))).to(dev)
    s_plan, s_buckets, s_device_ms, s_bound_ms = schedule_world8(dev, init_state, s_tokens)
    del s_tokens
    grads = gpt2_gradients(dev, init_state, z_tokens)
    schedule_world4(dev, grads)
    del grads
    torch.cuda.empty_cache()
    world = build_world_mesh(1)
    c_losses, c_seconds, c_more = train(MAIN, world, init_state, tokens, sync_mode="schedule")
    s_launches = {w.__name__: w.launches for w in fa.KERNELS}
    profile_step("ddp schedule plane", c_more, float(np.mean(c_seconds[1:])) * 1e3)
    del c_more
    destroy_world()
    c_step_s = float(np.mean(c_seconds[1:]))
    print(f"schedule 11c (DDP sync_mode='schedule', world 1): losses {c_losses}; bit for bit phase 5's "
          f"{'ok' if c_losses == losses else 'FAIL'}; step {c_step_s * 1e3:.2f} ms, "
          f"{BATCH * MAIN.max_seq / c_step_s:.1f} tokens/s", flush=True)
    if c_losses != losses:
        raise RuntimeError(f"the schedule-plane DDP steps differ from phase 5's: {c_losses} vs {losses}")
    c_losses_11 = c_losses
    want = MAIN.n_layer * (SCHEDULE_WORLD + ZERO1_WORLD + STEPS)
    print(f"schedule path launches (11a-c): {s_launches} (each flash kernel {want}: 8 + 4 gradients and 5 steps "
          f"of {MAIN.n_layer} layers); phase 11 {time.perf_counter() - t11:.1f} s", flush=True)
    if any(n != want for n in s_launches.values()):
        raise RuntimeError(f"expected {want} launches of each flash kernel on the schedule path, got {s_launches}")
    ring.check_errors()

    # 12. slice 9's main path: the façade, the bootstrap and the coordinator
    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="adapcc_facade_") as workdir:
        facade_bootstrap(s_buckets, workdir, s_device_ms, s_bound_ms)
        facade_coordinator(s_buckets)
        AdapCC.clear(ALLREDUCE)
        torch.cuda.empty_cache()
        for w in fa.KERNELS:
            w.launches = 0
        n_losses, n_seconds, n_masks, _ = negotiated_ddp(init_state, tokens, workdir)
    n_launches = {w.__name__: w.launches for w in fa.KERNELS}
    n_step_s = float(np.mean(n_seconds[1:]))
    print(f"negotiated 12c (DDP with a coordinator, world 1): losses {n_losses}; bit for bit phase 5's "
          f"{'ok' if n_losses == losses else 'FAIL'}; launches {n_launches}; step {n_step_s * 1e3:.2f} ms, "
          f"{BATCH * MAIN.max_seq / n_step_s:.1f} tokens/s; phase 12 {time.perf_counter() - t12:.1f} s", flush=True)
    if n_losses != losses:
        raise RuntimeError(f"the negotiated DDP steps differ from phase 5's: {n_losses} vs {losses}")
    if n_masks != [[True]] * STEPS:
        raise RuntimeError(f"a sole rank was not active at every step: {n_masks}")
    if any(n != MAIN.n_layer * STEPS for n in n_launches.values()):
        raise RuntimeError(f"expected {MAIN.n_layer * STEPS} launches of each flash kernel in 12c, got {n_launches}")

    # 13. slice 10's main path: accumulation, the overlapped syncs, ZeRO-1
    # without the ring, and checkpoints
    for kname, n in slice10(dev, init_state, tokens, z_tokens, losses, z_losses, c_losses_11).items():
        launches[kname] += n

    # 14. slice 11's main path: the plan tuner on the ring plane, the tuned
    # DDP step and ZeRO-1's tuned chunk
    for kname, n in slice11(dev, init_state, tokens, z_tokens, z_losses, smi).items():
        launches[kname] += n

    # 15. slice 12's main path: the latency plane, the two-level plane and
    # the hier and milp policies
    for kname, n in slice12(dev, s_plan, s_buckets, s_device_ms, s_bound_ms, smi).items():
        launches[kname] += n
    torch.cuda.empty_cache()

    # 16. slice 13's main path: the schedule compiler's IR plane
    for kname, n in slice13(dev, s_buckets, s_device_ms, smi).items():
        launches[kname] += n
    torch.cuda.empty_cache()

    # 17. slice 14's main path: elastic failover and the supervisor
    for kname, n in slice14(dev, init_state, tokens, s_buckets, c_losses_11, smi).items():
        launches[kname] += n
    torch.cuda.empty_cache()

    # 18. slice 15's main path: the online adaptation loop
    for kname, n in slice15(dev, init_state, tokens, z_tokens, s_buckets, c_losses_11, smi).items():
        launches[kname] += n
    del s_buckets
    torch.cuda.empty_cache()

    # 19. slice 16's main path: ZeRO-1's elastic state and the memory-lean
    # GPT-2
    for kname, n in slice16(dev, init_state, tokens, z_tokens, losses, smi).items():
        launches[kname] += n
    del init_state, tokens, z_tokens
    torch.cuda.empty_cache()

    # 20. slice 17's main path: sequence parallelism (ring attention and
    # Ulysses on K2-K4's lse path, the sequence-parallel GPT-2, DP x SP)
    for kname, n in slice17(dev, smi).items():
        launches[kname] += n
    torch.cuda.empty_cache()

    # 21. slice 18's main path: the pipeline-parallel plane (GPT-2 stages
    # through K2-K4, GPipe and 1F1B) and expert parallelism
    for kname, n in slice18(dev, smi).items():
        launches[kname] += n
    torch.cuda.empty_cache()

    # 22. slice 19's main path: serving (KV-cache decode, the continuous
    # batcher, the disaggregated router, serve_gpt2)
    slice19(dev, smi)
    torch.cuda.empty_cache()

    # 23. slice 20's main path: the training workloads (train_gpt2 on the
    # float32 flash kernels, train_ddp's presets, the image models at
    # their published widths, accuracy_benchmark, main_elastic)
    for kname, n in slice20(dev, smi, records).items():
        launches[kname] += n
    torch.cuda.empty_cache()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = [
        {"name": n, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[n], **records[n]}
        for n, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
