#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without one
or when any check fails.  Phases:

1. Card and build: the card's name and power limit, its board power
   before any work (ten ``nvidia-smi`` readings), the torch and CUDA
   versions, then ``nvcc`` builds the five sources of
   ``src/repro_torch/kernels/csrc`` for ``sm_90a``, all started together,
   with the seconds each took; then the count of HGMMA (``wgmma``)
   instructions in each kernel of K4, K3 and K2 and of HMMA (``mma.sync``)
   in K5's (``cuobjdump -sass``): each of K4's four kernels, K3's four bf16
   kernels, K2's eight tensor-core kernels and K5's nine chunk kernels (one
   per head size and chunk) must hold some.
2. Kernels: K1 (paged decode, at the library's own cluster pick whatever
   the autotuner's table says) and K2 (chunked prefill) against their plain
   PyTorch versions on the card, bf16 pools, fp32 and bf16 queries, at the
   head shapes of olmo-1b, mistral-nemo-12b, gemma-7b and qwen3-moe-235b-a22b
   (64 query heads over 4 kv heads, and one rank's 8 over 1 under the
   grouped layout at 8 ranks), block size 32, K1 also at
   hymba-1.5b's (25 over 5 kv heads of 64, window 1024, 4 slots of
   77/300/1100/1400 tokens over 48-block tables),
   random block tables with null padding and ragged lengths, plus one
   sliding-window and one softcap case, and for K2 the short and ragged
   chunks serving runs (C = 1 and 16 at 192, C = 40 at 200) and the
   speculative verify window (C = spec_k + 1 = 5 at 192, 203 and 221).  Each case
   names the kernel it runs (``route``: K2's bf16 pools run on the tensor
   cores; K1 splits each walk over a cluster of up to 8 blocks, ``split``
   the size it picked), reads the max error against ``TOL``, the mean error and
   (reported only) the signed bias, and a control that must fail ``TOL``
   (fp32 queries: q rounded to one bf16 term; bf16 queries: the causal
   mask off by one); K1 and K2 cases also time v1 (the CUDA-core
   yardstick) and the kernel without its cluster split (the cluster size
   the kernel picked beside it), and read the host time of one call for
   both.  Then K3 (flash attention forward)
   at olmo-1b's training shape and GQA, window, softcap, fp32, ragged, head
   dim 80 and 160, no-key (Sq > Skv with a window) and llama-3.2-vision
   (64 query heads over 8 kv heads) cases, each naming
   the kernel its dtype runs (``route``), with SDPA's errors and the
   CUDA-core kernel's time on the bf16 inputs beside the tensor-core
   kernel's, and K4 (FP8 GEMM) at the forward and backward shapes of
   olmo-1b's training step, at one rank's shapes of its sharded step (TP=2:
   the column and row slices of the FFN, down's dx on the transposed slice;
   DP=2: half the rows) and a ragged case, each with a control (the
   plain GEMM without its last 32 k-elements), ``torch._scaled_mm``'s error
   and the wrapper's layout copies.  One JSON line per case with the error, the kernel's,
   the plain version's and the library's time, and the case's bound.  K3
   is also run on the model's strided layout, and each K3 case computes a
   control (the plain version with one fault) that its checks must reject.
   Kernel times are device times: the timed calls are queued behind a
   device sleep, so the host's enqueue does not set them.  Each kernel's
   row also reads ``kernel_enqueue_ms``, the calls timed back to back with
   nothing queued ahead, where a wrapper slower on the host than its
   kernel on the device sets the time, as on the serving path (the
   ``kernels`` line's ``enqueue_ms``).  K2's bound on the tensor cores
   counts its bf16 products at the bf16 rate, two terms of fp32 q and of P.
2b. Tools (``tools_sweep``, ``tools_serving``, ``tools_dryrun``): (a) right
   after phase 2, ``repro_torch.kernels.autotune.tune_case`` at three of
   the kernel phase's K1/K2 shapes on its inputs (olmo-1b's heads, 16 over
   16 of 128, qwen3-moe's 64 over 4, hymba-1.5b's 25 over 5 of 64 under its
   window of 1024 over 48-block tables; fp32 queries, bf16 pools, block
   32): decode over every K1 cluster split (0, the library's pick, 1, 2, 4,
   8) and ``"prefill1"`` (K2 at C = 1), K2's 128-token chunk after 192 over
   every split (0 to 4), each candidate's device time beside the library's
   pick, each held to ``TOL`` against its plain version with
   ``kernel_control`` as the control that must fail; the winners are
   written to a temporary user cache (``$REPRO_TORCH_AUTOTUNE_CACHE``),
   which must pass ``check_determinism``.  (b) After phase 5b, the serving
   phase's prompts under that table in the legacy and the fused walk:
   tokens equal to the untuned legacy run's up to near-ties, and K1/K2
   launched as the table says (``"prefill1"``: K2 in place of K1).  (c)
   The dry run on the meta device (``repro_torch.launch.dryrun``):
   olmo-1b's ``train_4k``, ``prefill_32k`` and ``decode_32k`` cells at full
   width, and the same three cells as one rank of the 256-device mesh
   (``mesh="single"``: its collectives, ``collective_s`` and the rank's
   peak, reported only), on the host while ``nvcc`` builds; after phase 7
   the train phase's own step (fp8, 4 x 2048) costed the same way: its roofline bound
   must not exceed the measured step time, and its peak memory estimate
   must lie within ``PEAK_MEM_REL`` of ``torch.cuda.max_memory_allocated()``
   over one step of the same run (the step before the eval).
3. Serving: the engine serves 8 greedy requests on the full-width olmo-1b
   (random weights from a seed) with bf16 pools, block size 32, 4 slots,
   a 128-token prefill budget and the prefix cache.  The launch counters
   are set to 0 just before the run and read just after.
4. Kernel path against plain path at full width: two prefill chunks and a
   decode step on olmo-1b with ``attn_impl="kernel"`` and ``"plain"``.
5. Profile: one 4-slot decode step of olmo-1b, its wall time, its device
   time by kernel under ``torch.profiler`` and the device's idle share.
5b. Fused serving: the serving phase's engine, prompts and settings with
   ``fused=True``: each tick one CUDA-graph replay (``serving/graphs.py``)
   and one host sync.  The same engine first serves prompts from another
   seed, untimed, which captures the (rows, width) buckets the traffic
   uses; then the timed run reads TTFT, TPOT, tokens/s, dispatches and
   host syncs per step, the graphs captured in each run and their capture
   time, the graph pool's bytes and peak memory, and the K1/K2 launches
   the replays ran (their counts set to 0 just before the timed run).  It
   fails unless every request finishes by length, the replays ran K1 and
   K2, and a step takes at most 1.5 dispatches.  Each request's tokens are
   held against the serving phase's: at the first position where they
   differ, the legacy tokens' top-2 logit gap there (recomputed through
   ``prefill_step``) must be below ``PATH_TOL``, a near-tie, since mixed
   ticks run decode rows through K2 rather than K1.
5c. Fused profile: one fused pure-decode tick (staging, replay, one host
   sync) at the profile phase's lengths, its wall time and, under
   ``torch.profiler``, its device time, idle share and the launches the
   profiler sees, beside the eager ``decode_step`` and the eager tick
   (``decode_step``, argmax, host sync) in the same run.
5d. Speculative serving (``spec_k = 4``), the serving phase's engine,
   prompts and settings in four runs: (a) the legacy walk with the n-gram
   drafter; (b) the same with ``fused=True`` after an untimed run of
   prompts from another seed; (c) the legacy walk with the target as its
   own drafter on the first two prompts; (d) its control, a half-depth
   draft of random weights from another seed, on the same two.  Each reads
   TTFT, TPOT, output tokens/s, steps, dispatches and host syncs a step,
   acceptance rate, tokens per verify, drafted and accepted tokens and the
   K1/K2 launches (counts set to 0 just before each timed run), (b) also
   its graphs and their pool.  It fails unless every request finishes by
   length, K2 ran in every run (in (b) inside replays) and K1 in neither
   (a) nor (b), (b) takes at most 1.5 dispatches a step and captures no
   graph while timed, the tokens of (a)-(c) differ from the serving
   phase's only at near-ties, and (c) accepts at least 0.8 of its drafts
   while (d) accepts fewer.
5e. Speculative rollback: one verify step of 4 slots at the profile
   phase's lengths whose drafts cannot match (each slot's least likely
   token),
   eagerly and as one replay of the fused spec graph: the rejected rows
   must read zero, the history must be unchanged and the committed row
   within one bf16 spacing (of its largest element) of what a plain
   decode step writes; the pools with no rollback and with the rollback
   one lane early are the controls that must fail.
5f. KV-cache tiers: ``kv_quant_read`` holds the plain dequantizing read
   of int8 and e4m3 pools (quantized pools have no kernel, as in the JAX
   package) against K1 and K2 over fp32 pools that hold the same
   dequantized rows, at the kernel phase's olmo-1b shapes, within
   ``TOL[fp32]``, with scales one token row off as the control, and times
   both; ``serving_quantized`` serves the serving phase's prompts with
   ``quantize_kv="int8"`` and ``"fp8"`` in both walks (no K1/K2 launch;
   the fused tokens within near-ties of the legacy run's; pool bytes,
   TTFT, TPOT, decode ticks and agreement with the bf16 run read) and
   profiles an eager quantized decode step; ``serving_tiered`` serves two
   rounds of 8 prompts that share 256-token prefixes round to round over
   48 usable blocks, with the host spill tier (also with a restore budget
   of 32 blocks a pass), with dropped evictions and without a prefix cache
   (legacy walk; tokens must be equal), and with
   and without the tier in the fused walk (within near-ties), gated on
   spills, restores and spill-tier hits; ``spill_restore`` sends one block
   of a full-width bf16 pool through host memory and back into another
   block (rows and K2 over it bit-equal; a restore into the neighbouring
   block is the control) and times the copies.
5g. Fig. 9 (``fig9``): ``repro_torch.benchmarks.llm_inference``'s
   closed-loop arms at full width: the dense slot cache (4 slots,
   max_seq 512) against the paged pool at the same cache bytes (block 32,
   64 blocks, 16 slots) on 16 requests of 64-320 prompt tokens and 32 new
   tokens; the shared-system-prompt A/B (a 96-token system prompt, 8-token
   tails, prefix cache off / on); speculative decoding off / n-gram /
   self-draft on the repetitive-suffix prompts; a profiled run of each
   cache kind (``profile=True``) and the fused arm (legacy and fused).
   Each arm prints TTFT and TPOT p50/p99, output tokens/s, decode steps
   and tick, ``peak_active``, cache bytes, peak blocks, prefill tokens,
   hit rate, acceptance, tokens per verify, joules per token (the H100
   power model of ``core.telemetry``) and the profiled phases' seconds;
   then one 4-slot decode step over the dense ring and over the paged
   pools under ``torch.profiler``, as the profile phase.
   It fails unless the dense cache has ``models.cache_bytes`` and the
   paged one no more, dense and paged (and fused and legacy) tokens agree
   up to near-ties (``FIG9_TIE_TOL``; a dense engine whose admitted rings
   sit one slot off is the control that must differ away from one), the
   prefix cache at least halves prefill tokens, the
   self-draft emits more than one token per slot-step, no block stays in
   use, K1 and K2 ran, profiling leaves the tokens as they were and the
   requests' joules sum to the engine's.
5h. Front-ends (``frontend``, ``router``), each on fresh fused engines with
   the serving_fused phase's settings.  ``frontend``: ``serve_http`` on a
   loopback port over an ``AsyncEngine`` (its steps on one stepping
   thread) serves the serving phase's 8 prompts to 8 concurrent SSE
   clients (32 new tokens), one ``"stream": false`` request and one
   client that drops its socket after its first token, while ``/stats``,
   ``/metrics`` and ``/healthz`` are polled as the engine captures its
   graphs; then a graceful drain with requests in flight.  It reads the
   clients' TTFT and TPOT (from the frames' arrival), the engine's,
   dispatches a step, mixed and decode ticks, graphs, K1/K2 launches in
   replays and the stepping thread, and fails unless every stream is contiguous and ends by
   length, the tokens equal the serving phase's up to near-ties, the
   dropped request is cancelled, polls answer 200, ``/healthz`` and a new
   request get 503 while draining, no block stays in use and one thread
   ran every step.  ``router``: the Fig. 9 harness's ``run_router`` (1
   replica; 2 with affinity; 2 random; 2 with replica 0 crashed mid-run)
   on tenant prompts with 96-token system prompts, with the reference's
   gates and tokens up to near-ties; a router that resumes a failed-over
   request one position off is the control the token gate must reject;
   then a 2-replica router behind ``serve_http`` serves 4 SSE requests.
   Each arm reads modelled and wall tokens/s, hit rate, failovers,
   retries, replica states and peak memory.
5h2. Tensor-parallel serving (``tp_serving``): two gloo ranks on the one
   card (``launch.mesh.run_ranks``, ``backend="gloo"``: every collective
   staged through host memory), each drawing the weights from ``SEED`` and
   keeping its slice (``parallel.sharding.shard_params``).  olmo-1b at
   full width and depth serves the serving phase's prompts (legacy walk,
   bf16 pools, K1/K2 on each rank's 8 of 16 kv heads): tokens equal on both
   ranks and to the serving phase's up to near-ties, each rank's K1/K2
   launches 16 a step or chunk, 34 collectives a model call, pool bytes
   half of TP=1's, global cache bytes equal; TP=2 logits (fp32 pools) within
   1e-4 of TP=1's, and two controls that must part from them (``b_down``
   counted on both ranks; rank 1 reading rank 0's pool slice); K1 timed at
   the local heads on each rank in turn; one all-reduce timed on card and
   host tensors.  mistral-nemo-12b at full width, 4 of 40 layers (4 of 8
   kv heads a rank, the 131072-entry vocab split in two), served at TP=1 on
   rank 0 first, then at TP=2, with the same gates.  ``fused=True`` on the
   gloo group must raise.  The times are gloo's through host memory with
   both ranks' contexts on one card: not NCCL, not NVLink.
5h3. Replicas of tensor-parallel engines (``replicas_tp``): four gloo ranks
   on the one card, two replicas of TP=2 olmo-1b engines at full width and
   depth (``make_replica_meshes(2, 2)``; legacy walk, bf16 pools, K1/K2 on
   each rank's 8 of 16 kv heads) behind the router on rank 0, which leads
   replica 0 and drives replica 1's lead through a
   ``serving.remote.RemoteEngine``, on the router phase's 16 prompts (8
   tenants, 2 requests each, 96-token system prompts, 12 new tokens):
   an affinity arm, then replica 0 crashed halfway through the steps it
   ran there (its requests resume on replica 1 with their delivered tokens
   seeded), each with tokens equal to the router phase's TP=1 fleet up to
   near-ties, no request lost, replica 0 dead after its crash, and every
   rank's K1/K2 launches 16 a decode step or chunk of its engine; the
   control, the crash under a stand-in that never sends the resume's seed
   to the lead, must fail the token gate.  The times are gloo's through
   host memory, four ranks' contexts on one card.
5i. The moe family, once olmo-1b's serving weights are freed, on
   qwen3-moe-235b-a22b at full width (d_model 4096, 64 heads over 4 kv
   heads, qk_norm, 128 experts, top 8, expert width 1536, vocab 151936
   untied) cut from 94 layers to 4: 44.8 GB of random fp32 weights from
   the seed.  ``moe_path``, before the model loads: one layer's
   ``moe_ffn`` on a 128-token chunk from the seed at the published
   capacity factor 1.25 (12 slots an expert) against the same function in
   float64 (its router too) on the card: the share of pairs dropped, the
   routing sets and drop masks (equal up to the first token whose set
   differs at a near tie, an 8th/9th probability gap under
   ``MOE_TIE_GAP``), the error on the tokens before it against
   ``MOE_REL_TOL`` and a control (priority counted from the last token)
   that must exceed it; ``moe_ffn``'s device time at T = 128 and T = 4
   against its bound (every expert weight read once).  ``moe_serving``:
   the serving phase's prompts and settings in five runs: (a) legacy and
   fused at capacity factor 16, where no pair can be dropped, (b) fused
   with n-gram speculation at 16, (c) legacy and fused at 1.25 (the fused
   one after an untimed run that captures its buckets).  (a) and (b) must
   equal the legacy tokens up to near-ties; (c) is reported (TTFT, TPOT,
   decode and mixed ticks, pool bytes, tokens differing from (a) and
   between the walks).  Every run must finish every request by length
   with K1 once a layer a decode step and K2 once a layer a chunk (in the
   fused walk: each decode graph holds one K1 a layer, each mixed graph
   one K2 a layer); where the autotuner's table says ``"prefill1"`` for
   the engine's shapes (the in-repo entry for qwen3-moe's 16 query heads
   per kv head), K2 stands in for K1.  ``profile_moe``: one fused decode tick and one eager
   decode step at 1.25 under ``torch.profiler`` against the bound of every
   weight the tick reads, and the four layers' ``moe_ffn`` alone on the
   tick's rows against its experts' bound.  The moe weights are freed
   before hymba.
5j. The hybrid family on hymba-1.5b at full width and depth (32 layers,
   d_model 1600, 1.59 B random fp32 parameters from the seed).
   ``hybrid_path``: 4 prompts of 77/300/1100/1400 tokens prefilled (each
   alone, as the engine admits) into bf16 pools, then 4 decode steps
   with ``attn_impl="kernel"`` (K1, one launch a layer a step) and
   ``"plain"``, logits within ``PATH_TOL``; the state check over fp32
   caches (the last decode step against a whole-prompt prefill of the
   same context within ``STATE_TOL``; the control, the conv state zeroed
   before that step, must exceed it).  ``hybrid_serving``: the serving
   phase's 8 prompts and one of 1100 tokens (32 new each) on the paged
   cache (bf16 pools, block 32, 4 slots, max_seq 1536: K1 once a layer a
   decode step, no block left) and on the dense slot cache (no K1; its
   tokens equal the paged run's up to near-ties), with TTFT, TPOT and the
   decode step; then one decode step under ``torch.profiler`` against the
   bound of the weights, the visible K/V and the states.  hymba's weights
   are freed before llama-3.2-vision.
5k. The vlm family on llama-3.2-vision-90b at full width (d_model 8192, 64
   query heads over 8 kv heads, d_ff 28672, vocab 128256), depth cut to 10
   of 100 layers (2 groups of 4 self + 1 cross: 10.66 B random fp32
   parameters, 42.6 GB), every cross layer's two tanh gates set to 1.0
   (random init leaves them at 0, the cross layers then the identity).
   ``vlm_path``: two 64-token prompts with random image tokens (2, 1600,
   8192), each prefilled alone into an fp32 slot cache, then 8
   teacher-forced decode steps, each step's logits against ``forward``'s
   within ``VLM_PATH_TOL``; the control (every cross layer's cached ck
   zeroed) must exceed it; the prefill's peak memory.  ``vlm_serving``:
   the serving phase's 8 prompts (32 new each) on an engine asked for the
   paged cache, which the vlm family serves on the dense slot cache (bf16,
   4 slots, max_seq 1024, zero image tokens as the engine feeds; no kernel
   launch, no slot left with history), every served token the argmax of a
   teacher-forced ``forward`` up to a near tie, a control engine whose
   admitted rings sit one slot off that must fail it, TTFT, TPOT, and one
   decode step under ``torch.profiler`` against the bound of its weights
   (but the embedding table) and K/V.  ``vlm_eval``: the eval (phase 8)
   on a synthetic 2 x 2048-token batch with random image tokens, K3 once a
   self layer (8), beside the forward's bound.  The weights are freed
   before training.
6. Train: FP8 training of olmo-1b at full width and depth (fp32 master
   weights, bf16 compute, K4 for every projection GEMM, remat per block),
   4 steps of 4 x 2048 tokens from random weights (seed 0), with the loss,
   time, tokens/s and K4 launches of every step, peak memory and model
   FLOP/s.  The counters are set to 0 just before the steps.
7. Train path (``train_path_phase``, the gate every train path shares):
   one more step from the same state with K4 in which every K4 call is
   held against the plain GEMM, with a control (the plain GEMM without its
   last 32 k-elements), on its own operands; and steps with the plain
   GEMM, a control (here the plain GEMM with its inverse scale rounded to
   bf16) and an order probe (the plain GEMM's sums in another order),
   compared with the kernel step by loss, gradient norm and two updated
   tensors, against limits that the control must fail.  Each step is read
   by ``step_readings`` through the train step's own ``grads_of``, with
   the update applied to clones of the two tensors only, so the state is
   left as it was and is not copied.
8. Eval, after one kernel step on the gate's batch (the gate leaves the
   state as it was): ``loss_fn`` with ``attn_impl="flash"`` (K3) against
   ``"torch"`` under ``torch.no_grad()`` on the train batch, each timed
   once cold and once warm, and a control (attention that also sees the next key) that
   the limits must reject.
9. Train profile: one train step without and one under ``torch.profiler``:
   wall time, device time by kernel and the device's idle share.
9b. Facility (``facility``), the JAX package's ``tests/test_system.py``
   scenario on the card, once the olmo-1b training state is freed: tenants
   "research" and "serving" under IAM (isolation checked), a
   ``QoS.TRAINING`` job admitted by the scheduler, and olmo-1b at full
   width cut to 4 of 16 layers (371.5 M parameters, 4.46 GB a save) trained
   with fp8 (K4) on 4 x 2048 tokens a step under the fault-tolerant runner:
   a clean run of 8 steps with synchronous saves every 3, the same run from
   a fresh state with the job's second node failing at step 5 (restore from
   step 3, 2 steps replayed), a control whose restore hands back
   ``opt.step`` one ahead, and an asynchronous save followed by one
   in-place step, then ``wait()`` and a restore.  It fails unless the
   recovered run is bit-exact with the clean run (every loss ``==``, every
   leaf equal) and the control is not, the snapshot equals its pre-step
   clone, every step launched K4 ``4 x layers x sites`` times, the effective
   PUE stays under 1.1 and the ledger charged energy.  The serving tenant
   then serves the serving phase's prompts on the clean and the recovered
   parameters (K1/K2 counted, tokens equal, no block left).  Saves go to a
   fresh temporary directory on the machine's local disk (its free space
   read first; deleted at the end), which is not the facility's ClusterStor
   or VAST: it prints each save's wall and GB/s there, the restore's wall,
   the modelled lustre and vast seconds, ``cadence_advice`` from the
   measured step and the step ms.
9b2. Sharded and FSDP training (``sharded_train``), once the facility's
   state is freed: two gloo ranks on the one card (``launch.mesh.run_ranks``,
   ``backend="gloo"``: every collective staged through host memory), each
   drawing olmo-1b's state from the seed (full width, 4 of 16 layers, fp8
   through K4 on every projection, bf16 compute, remat full, 4 x 2048
   tokens, warmup 0).  Rank 0 first runs the one-rank step (2 steps, then 2
   on the shrink's 2-row batches) as the reference.  Then 2 steps at
   ``(1, 2)`` (tensor parallelism) and at ``(2, 1)`` (FSDP and data
   parallelism), each rank cutting its slices out of the full state
   (``parallel.sharding.shard_state``): each step's wall time, the
   training collectives' calls and bytes (``TRAIN_COLLECTIVES``), the K4
   launches and ``max_memory_allocated`` of each rank; each rank's
   parameter slices against the reference's (sent once a mesh:
   ``reference_slices``, ``mesh_param_gaps``), losses and gradient norms
   within ``SHARD_LIMITS``, and a control for each, the same steps from
   the same state (the copy-to-model backward without its all-reduce;
   FSDP's gather backward keeping the rank's own gradient slice unsummed),
   that must fail them.  Last, ``plan_resize`` to one rank,
   ``make_elastic_mesh`` and ``reshard_state`` move the ``(2, 1)`` state
   onto rank 0 alone (bit for bit), which takes 2 steps on
   ``resize_batch``'s batches held to the reference's.  Every rank must
   launch K4 112 times a step (4 a site a layer).  ``tools_dryrun_mesh``
   then costs the same three runs on meta as rank 0 of a fake world of two
   (``launch.dryrun.cost_rank``): each collective's calls and operand bytes
   a step must equal what each rank counted, exactly.  The times are gloo's
   through host memory with both ranks' contexts on one card: not NCCL,
   not NVLink.  Between the two meshes, the sequence-parallel arm
   (``ParallelConfig(sequence_parallel=True)`` at ``(1, 2)``: the residual
   stream between the sublayers split over the two ranks, each sublayer's
   input gathered over seq and its output reduce-scattered) takes the same
   2 steps, held to the reference and to the TP arm's slices and metrics
   within ``SHARD_LIMITS``; its control, ``reduce_scatter_seq`` as a plain
   slice of each rank's partial output, must fail them (olmo-1b's LayerNorm
   has no scale, so a dropped norm-scale sum cannot show here: the CPU test
   holds that control on a variant with RMS norms).  It prints the
   gathers' and reduce-scatters' calls and bytes a step against TP's
   all-reduces, and the step peak a rank against TP's.  Then the sharded
   eval with sequence parallelism (K3 at 8 of 16 heads a rank over the
   gathered sequence, flash against torch with the next-key control, the
   loss against rank 0's one-rank eval of the same state and batch).
9b3. Sharded training of the moe, hybrid and audio families
   (``sharded_families``), after ``sharded_train``: two gloo ranks on the
   one card, fp8 through K4 on each rank's local slices, bf16 compute,
   remat full, warmup 0, 2 steps an arm: qwen3-moe-235b-a22b at full width
   cut to 1 of 94 layers (2 x 2048 tokens; at ``(1, 2)`` only: 64 experts,
   32 query heads over 2 kv heads and half the vocab a rank), hymba-1.5b
   and hubert-xlarge at full width cut to 2 layers (4 x 2048 tokens, frames
   for hubert; at ``(1, 2)`` and ``(2, 1)``).  Each arm is held to the
   one-rank step of the same run, which rank 0 runs first with nothing
   else on the card and keeps on the host; each rank then draws its slices
   leaf by leaf from the seed (``init_train_state(rules=, mesh=)``: the
   full qwen3-moe state, 44.8 GB, is never held twice).  It prints each
   mesh's step wall against the one-rank step, the collectives and their
   bytes a step, K4 launches and layout copies, state bytes and step peak a
   rank, the readings against the reference and, at ``(1, 2)``, the gap
   between the model ranks' copies of every replicated leaf
   (``FAMILY_LIMITS``: ``SHARD_LIMITS`` and a gap of 0), and a control's
   (moe: the gates' ``copy_to_model`` left out; hybrid: the FFN input's ``copy_to_model`` moved to
   the block input; audio at ``(2, 1)``: FSDP's gather backward without
   the data sum), and for moe the pairs routed and dropped, the pairs a
   near tie flipped against the one-rank run, the aux losses and the
   router's and the moe norm's own readings (``group_readings``).  It fails when the ranks' metrics differ, an
   arm parts from the reference, a control passes, or a rank's K4
   launches differ from ``4 x layers x len(fp8_sites)`` a step.
9b4. Sharded training of the ssm and vlm families (``sharded_ssm_vlm``,
   ``ssm_vlm_arms``), in the same spawn and by the same rules, without
   fp8: rwkv6-7b cut to 4 of 32 layers (4 x 2048, fp32 at lr 1e-5, the
   reasons at ``SSM_RATE``) at ``(1, 2)``, its time mix whole on every
   rank, with a control (the channel mix's ``copy_to_model`` moved to the
   block input) and a sharded eval through K5 held per layer against the
   chunked scan; llama-3.2-vision cut to one group of a self and the cross
   layer (1 x 2048, 1600 image tokens a row, the gates opened) at
   ``(1, 2)``, with a control (the cross query's ``copy_to_model`` left
   out) and a sharded eval through K3 at the local heads.  Each eval is
   held to the one-rank eval (``shard_eval_gates``).
9b5. The grouped attention layout (``grouped_heads``): qwen3-moe-235b-a22b
   at full width cut to 1 of 94 layers on eight gloo ranks at ``(1, 8)``,
   where its 64 query heads split 8 a rank and its 4 kv heads do not
   divide the axis: each rank holds every kv head's wk / wv and attends
   over its GQA group's (``parallel.sharding.attention_layout``).  (a)
   Four of the router phase's tenant prompts, 12 new tokens, at capacity
   factor 16, served by a TP=1 engine on rank 0's full weights, then by
   the TP=8 engine on each rank's slices (drawn leaf by leaf from the
   seed): tokens equal on every rank and to TP=1's up to at most one near
   tie, pools of one kv head (1 / 4 of TP=1's bytes, TP=1's global cache
   bytes), K1/K2 once a layer a decode step or chunk as the autotuner's
   table says for the local heads, 2 collectives a layer and 2 a model
   call, and one prompt's prefill and decode logits on fp32 pools within
   ``TP_LOGIT_TOL`` of TP=1's, the control (rank r's kv head taken as ``r
   % KV``) outside.  (b) and (c): the train arm (``family_arm``, 2 x 2048,
   fp8 through K4, AdamW moments in bf16 (``GROUPED_RUN``), 2 steps
   against the one-rank steps that rank 0 runs first alone,
   ``FAMILY_LIMITS`` over the attention, router and norm leaves, wk / wv's
   own readings reported, the same control outside them) with the sharded
   eval through K3 on 8 query heads over one kv head, held to the one-rank
   eval within ``SHARDED_EVAL_LIMITS``.
9c. Fig. 8 (``mlperf``): ``repro_torch.benchmarks.mlperf_train.run()`` on the
   card, bert-large at full width and depth, 448 x 512 tokens a step as 14
   microbatches of 32 (fp32 master, bf16 compute, remat full, no fp8), one
   warm and three timed steps: its rows in the reference's
   ``name,us_per_call,derived`` format, step seconds, tokens/s, model
   TFLOP/s against 989, the analytical roofline step and peak memory.  It
   fails unless every loss and gradient norm is finite and the rate is 0
   at step 0 (warmup) and above 0 after.
9d-9f. The remaining training forwards (``moe_train``, ``hybrid_train``,
   ``audio_train``), each model alone on the card: qwen3-moe-235b-a22b at
   full width cut from 94 layers to 1 (3.73 B parameters with its untied
   embedding and head; 2 x 2048 tokens, two routed groups at C = 160),
   hymba-1.5b and hubert-xlarge at full width cut to 8 of 32 and 16 of 48
   layers (4 x 2048 tokens, frames for hubert), each with fp8 (K4 in the attention projections, and
   in the MLP of hymba and hubert), bf16 compute and ``remat="full"``: 3
   steps with the loss, aux loss (qwen3-moe's load-balance loss), time and
   K4 launches of every step and peak memory; then the train path's gate
   (phase 7) from the state the steps reached; then the eval (phase 8) through K3 against
   ``"torch"`` (the bidirectional hubert's control: attention without the
   softmax's row-sum division) beside the forward's bound
   (``forward_bound``); then one more step under ``torch.profiler``
   (device time by kind).  The gates' control is the K4 calls' own (the
   last 32 k-elements dropped), their limits ``FAMILY_PATH_LIMITS``.
   The K3 cases of phase 2 include the three models' heads at these
   shapes, the K4 cases their projections.
10. Kernels K6 (BabelStream) and K5 (RWKV6 WKV scan), run after phase 2:
   copy, mul, add and triad at n = 2^27 in fp32 and bf16, bit-equal to
   their plain versions, and dot on non-negative inputs, each beside its
   PyTorch call; K5 at rwkv6-7b's eval shape, at a small shape and with
   fast decay, against its plain version and the sequential oracle (max
   and mean error), with v1 (the yardstick) timed and checked beside it.
   Each check computes a control (triad with the scalar left unrounded,
   dot without its last tile, the scan with the decay one step late) that
   it must reject.
11. BabelStream: ``repro_torch.benchmarks.babelstream.run()``, the entry
   point of the paper's Fig. 10, on the card in fp32 (the counters set to 0
   just before, read just after) and in bf16.
11b. Fig. 11 (``cloverleaf``): ``repro_torch.benchmarks.cloverleaf.run()``
   at the reference's 256^2, 512^2 and 1024^2 grids and at 16384^2 (1 GiB,
   past the L2 cache): each step's time against its bytes at 3.35 TB/s,
   each size's first step held against the float64 step, and a control
   (the rows edge-padded instead of wrapped) that the check must reject.
   ``cloverleaf_ranks``: ``run(ranks=(2, 4))`` at the reference's sizes on 2
   and 4 gloo ranks of the one card, one world of 4 (each rank's row block,
   the halo rows sent to the neighbouring ranks with ``batch_isend_irecv``
   through host memory): each rank's first step bit for bit against its
   rows of the one-device step, and the control (each rank wrapping its own
   rows) must differ; every rank's time a step.
   ``figures``: ``repro_torch.benchmarks.fp8_gemm.run()`` and
   ``paged_attention.run()`` at their default sweeps, each K4 and K1 row
   checked against its plain version with a control that must fail.
12. RWKV eval, once the olmo-1b state is freed: rwkv6-7b at full width and
   depth (random fp32 weights from seed 0, bf16 compute), ``loss_fn`` on
   4 x 2048 synthetic tokens under ``torch.no_grad()`` with
   ``wkv_impl="kernel"`` (K5, one launch per layer) and ``"chunked"``,
   with a chaos probe (1e-6 noise on the plain scan's outputs); then every
   layer, in bf16 and in fp32 compute, on the chunked forward's own input
   with K5, the chunked scan and a control (the late-decay scan) that the
   limits must reject.  ``rwkv_serving`` then serves the same weights: the
   serving phase's 8 prompts on an engine asked for the paged cache, which
   the ssm family turns into the dense slot cache (no kernel launch: the
   chunked scan gives the state K5 does not), TTFT, TPOT, a decode step's
   profile against its bound, and the state check (the control: the WKV
   state zeroed).

It then prints one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Every time is measured on the card in
this run; every bound is computed from this run's inputs against the
H100 SXM's published peaks.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 on the CUDA cores (the kernels' math)
# H100 SXM special-function units: 16 exponentials per SM per clock, 132 SMs
# at the 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
FP8_FLOPS_PER_S = 1979e12  # H100 SXM dense fp8 tensor cores
BLOCK_SIZE = 32
SEED = 0

# error tolerances against the plain version.  Both read the same bf16 K/V
# and compute in fp32, so with fp32 queries only the summation order
# differs; with bf16 queries both round the output to bf16, 2^-7 relative.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# logits of the full-width model, kernel path against plain path: each
# layer's K/V is rounded to bf16 from activations that differ in the last
# fp32 bits, so a few elements per layer move by one bf16 ulp, and this
# compounds over 16 layers; logits have a standard deviation near 1
PATH_TOL = 2e-2

# (model, H, KV, hd) head shapes of the three dense configurations and the
# moe phases' qwen3-moe (16 query heads per kv head)
HEAD_SHAPES = [("olmo-1b", 16, 16, 128), ("mistral-nemo-12b", 32, 8, 128), ("gemma-7b", 16, 16, 256),
               ("qwen3-moe-235b-a22b", 64, 4, 128)]
DECODE_LENS = [77, 160, 291, 352]  # four slots, as the serving phase decodes
PREFILL_START, PREFILL_C = 192, 128  # one 128-token chunk after 192 tokens of history
NB = 16  # table width: max_seq 512 / block size 32
# hymba-1.5b's decode shapes: 25 query heads over 5 kv heads of 64 (five
# query rows per kv head), a window of 1024 that the last two slots outrun,
# a table of 48 blocks (max_seq 1536)
HYMBA_ARCH = "hymba-1.5b"
HYMBA_LENS = [77, 300, 1100, 1400]
HYMBA_NB = 48
HYMBA_WINDOW = 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for ``nbytes`` moved and ``flops``
    done at ``rate``."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


CLOCK_HZ = 1.98e9  # H100 SXM boost clock: a device sleep of n cycles lasts at least n / CLOCK_HZ s


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, by CUDA events.
    The calls are queued behind a device sleep longer than their host time,
    so the events time the device's work back to back, not the host's
    enqueue (``enqueue_ms`` and ``host_us`` read that)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(CLOCK_HZ * min(1.5 * iters * host_s + 1e-3, 0.5)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``iters`` calls issued back to back by the
    host, by CUDA events with nothing queued ahead: the device time where
    the device is the slower side, else the host's rate of issue, which is
    what a caller such as the serving loop pays per call."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int = 20, warmup: int = 3) -> dict:
    """A kernel's two readings: device time (``kernel_ms``) and the time per
    call at the host's rate of issue (``kernel_enqueue_ms``)."""
    return {"kernel_ms": timed_ms(fn, iters, warmup), "kernel_enqueue_ms": enqueue_ms(fn, iters, warmup)}


def host_us(fn, iters: int = 30) -> float:
    """Median host time of one ``fn(i)`` call with the device idle: the
    wrapper's checks, allocation, argument packing and launch."""
    walls = []
    for i in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * float(np.median(walls))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_case(kind, H, KV, hd, q_dtype, window, softcap, device, layers=16, seed=0, C=PREFILL_C, start=PREFILL_START,
                lens=DECODE_LENS, nb=NB):
    """Inputs of one case.  ``layers`` pools are made so that timing loops
    can read a different layer's pool each call, as the model does; their
    total exceeds the 50 MB L2 cache.  Decode: one slot per length of
    ``lens`` over tables of ``nb`` blocks.  Prefill: one C-token chunk at
    ``start``."""
    g = torch.Generator().manual_seed(seed)
    B = len(lens) if kind == "decode" else 1
    N = 1 + B * nb + 2
    last = [n - 1 for n in lens] if kind == "decode" else [start + C - 1]
    tbl = (torch.randperm(N - 1, generator=g)[: B * nb] + 1).reshape(B, nb).to(torch.int32)
    for b in range(B):
        tbl[b, last[b] // BLOCK_SIZE + 1 :] = 0  # null padding past the live blocks
    pools = [torch.randn((layers, N, BLOCK_SIZE, KV, hd), generator=g).to(torch.bfloat16) for _ in range(2)]
    if kind == "decode":
        q = torch.randn((B, H, hd), generator=g)
        lens = torch.tensor(lens, dtype=torch.int32)
    else:
        q = torch.randn((B, C, H, hd), generator=g)
        lens = torch.tensor([start], dtype=torch.int32)
    to = lambda t: t.to(device)  # noqa: E731
    return dict(
        kind=kind, H=H, KV=KV, hd=hd, window=window, softcap=softcap, q=to(q.to(q_dtype)), C=C, start=start,
        k=to(pools[0]), v=to(pools[1]), tbl=to(tbl), lens=to(lens), layers=layers,
    )


def case_work(c) -> tuple[int, int]:
    """(bytes, multiply-adds of one product) the case needs: each input read
    once, each output written once, K/V only at the positions some query
    can see; Q K^T and P V each take the multiply-adds returned."""
    H, KV, hd, w = c["H"], c["KV"], c["hd"], c["window"]
    q_bytes = c["q"].numel() * c["q"].element_size()
    kv_row = KV * hd * c["k"].element_size() * 2  # K and V of one position
    meta = c["tbl"].numel() * 4 + c["lens"].numel() * 4
    if c["kind"] == "decode":
        vis = [min(n, w) if w else n for n in c["lens"].tolist()]
        kv_rows, pairs = sum(vis), sum(vis)
    else:
        start, C = c["start"], c["C"]
        lo = max(0, start - w + 1) if w else 0
        kv_rows = start + C - lo
        pairs = sum(min(start + i + 1, w) if w else start + i + 1 for i in range(C))
    return 2 * q_bytes + kv_rows * kv_row + meta, pairs * H * hd


def library_call(c, attend):
    """``F.scaled_dot_product_attention`` on the gathered, head-expanded view
    of every layer (built here, outside the timing), or None when SDPA
    cannot compute the function (softcap).  Used only as a yardstick."""
    if c["softcap"]:
        return None
    from repro_torch.kernels.paged_attention_ref import gather_blocks

    q, qpk = c["q"], c["H"] // c["KV"]
    S = c["tbl"].shape[1] * BLOCK_SIZE
    kv_pos = torch.arange(S, device=q.device)
    if c["kind"] == "decode":
        qq = q[:, :, None]  # (B, H, 1, hd)
        q_pos = (c["lens"].long() - 1)[:, None]  # (B, 1)
    else:
        qq = q.transpose(1, 2)  # (B, H, C, hd)
        q_pos = c["lens"].long()[:, None] + torch.arange(c["C"], device=q.device)[None]  # (B, C)
    ok = kv_pos[None, None] <= q_pos[..., None]
    if c["window"]:
        ok &= (q_pos[..., None] - kv_pos[None, None]) < c["window"]
    mask = ok[:, None]  # (B, 1, Sq, S)
    views = [
        [gather_blocks(pool[layer], c["tbl"]).to(q.dtype).repeat_interleave(qpk, dim=2).transpose(1, 2) for pool in (c["k"], c["v"])]
        for layer in range(c["layers"])
    ]
    ref = attend(0)

    def call(i):
        k, v = views[i % c["layers"]]
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)

    out = call(0)
    out = out[:, :, 0] if c["kind"] == "decode" else out.transpose(1, 2)
    return call, float((out.float() - ref.float()).abs().max())


# K1 / K2 cases: model, (H, KV, hd), q dtype, window, softcap, and for K2
# the chunk (C, start): the three head shapes in both q dtypes, a sliding
# window and a softcap case at the serving chunk, then the short and
# ragged chunks serving runs (C = 1 and 16 at 192; C = 40 at 200, rows not
# a multiple of 64 and a start inside a block)
KERNEL_CASES = [(m, (H, KV, hd), dt, 0, 0.0) for (m, H, KV, hd) in HEAD_SHAPES for dt in (torch.float32, torch.bfloat16)]
KERNEL_CASES += [("mistral-nemo-12b", (32, 8, 128), torch.float32, 32, 0.0), ("gemma-7b", (16, 16, 256), torch.float32, 0, 30.0)]
# one rank's heads of qwen3-moe under the grouped layout at 8 ranks: 8 query heads over one kv head
KERNEL_CASES += [("qwen3-moe-235b-a22b/tp8", (8, 1, 128), dt, 0, 0.0) for dt in (torch.float32, torch.bfloat16)]
PREFILL_CASES = [(*case, (PREFILL_C, PREFILL_START)) for case in KERNEL_CASES]
PREFILL_CASES += [("olmo-1b", (16, 16, 128), torch.float32, 0, 0.0, chunk) for chunk in ((1, 192), (16, 192), (40, 200))]
# the speculative verify window, C = spec_k + 1 = 5: at a block's first
# position, mid-block, and across a block edge
PREFILL_CASES += [("olmo-1b", (16, 16, 128), torch.float32, 0, 0.0, (5, start)) for start in (192, 203, 221)]
# K1 at hymba-1.5b's heads under its window (its decode lengths: DECODE_SHAPES)
KERNEL_CASES += [(HYMBA_ARCH, (25, 5, 64), dt, HYMBA_WINDOW, 0.0) for dt in (torch.float32, torch.bfloat16)]
DECODE_SHAPES = {HYMBA_ARCH: (HYMBA_LENS, HYMBA_NB)}  # the others: DECODE_LENS over NB blocks


def case_bound(c, route: str) -> tuple[float, str]:
    """The case's bound on its route.  The CUDA-core kernels do the two
    products in fp32 at the fp32 rate; the tensor-core route does them as
    bf16 products at the bf16 rate, Q K^T once per bf16 term of q (two for
    fp32 queries) and P V once per term of P (two)."""
    nbytes, macs = case_work(c)
    if route == "tensor_cores_bf16":
        q_terms = 2 if c["q"].dtype == torch.float32 else 1
        return bound(nbytes, 2 * macs * (q_terms + 2), BF16_FLOPS_PER_S)
    return bound(nbytes, 2 * macs * 2, FP32_FLOPS_PER_S)


def kernel_control(c, plain, kw):
    """The plain version with one fault, which the limit must reject: for
    fp32 queries q rounded to one bf16 term (what the tensor-core route
    would read without its split), for bf16 queries the causal mask off by
    one (each row also sees q_pos + 1)."""
    if c["q"].dtype == torch.float32:
        return "q_bf16", plain(c["q"].bfloat16().float(), c["k"][0], c["v"][0], c["tbl"], c["lens"], **kw)
    return "mask_plus_one", plain(c["q"], c["k"][0], c["v"][0], c["tbl"], c["lens"] + 1, **kw)


def k1(q, k_pool, v_pool, block_tables, seq_lens, **kw):
    """K1 at the library's own cluster pick, whatever the autotuner's table
    says for these shapes (its ``"prefill1"`` would run K2)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import paged_attention as K

    return K.launch_decode(q, k_pool, v_pool, block_tables, seq_lens, **kw, tuned=autotune.DEFAULT_CONFIG)


def kernel_phase(device) -> dict:
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels.flash_attention_ref import flash_errors
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

    fns = {"decode": (k1, paged_attention_plain), "prefill": (K.paged_prefill_attention, paged_prefill_attention_plain)}
    main = {}  # per kernel: the serving path's case (olmo-1b, fp32 queries, the 128-token chunk)
    hymba = {}  # K1 at hymba-1.5b's heads, by q dtype
    for kind in ("decode", "prefill"):
        kernel, plain = fns[kind]
        cases = KERNEL_CASES if kind == "decode" else PREFILL_CASES
        for seed, (model, (H, KV, hd), dt, window, cap, *chunk) in enumerate(cases):
            C, start = chunk[0] if chunk else (PREFILL_C, PREFILL_START)
            lens, nb = DECODE_SHAPES.get(model, (DECODE_LENS, NB)) if kind == "decode" else (DECODE_LENS, NB)
            c = kernel_case(kind, H, KV, hd, dt, window, cap, device, seed=seed, C=C, start=start, lens=lens, nb=nb)
            kw = dict(softcap=cap, window=window)

            def run(fn, i, c=c, kw=kw, **extra):
                layer = i % c["layers"]
                return fn(c["q"], c["k"][layer], c["v"][layer], c["tbl"], c["lens"], **kw, **extra)

            out, ref = run(kernel, 0), run(plain, 0)
            torch.cuda.synchronize()
            errs = flash_errors(out, ref)
            control_name, control_out = kernel_control(c, plain, kw)
            control = flash_errors(control_out, ref)
            del out, control_out
            tol = TOL[dt]
            lib = library_call(c, lambda i: run(plain, i))
            route = K.DECODE_ROUTE if kind == "decode" else K.prefill_route(dt, c["k"].dtype)
            bound_ms, bound_by = case_bound(c, route)
            row = {
                "phase": "kernel", "kernel": f"paged_{kind}", "model": model, "q_dtype": str(dt).replace("torch.", ""),
                "route": route,
                "window": window, "softcap": cap, "max_abs_err": errs["max_abs"], "tol": tol,
                "mean_rel": errs["mean_rel"], "mean_bias": errs["mean_bias"],  # the bias is reported only
                "control": control_name, "control_max_abs_err": control["max_abs"],
                **kernel_times(lambda i: run(kernel, i)),
                "plain_ms": timed_ms(lambda i: run(plain, i)),
                "library_ms": timed_ms(lib[0]) if lib else None,
                "library_max_abs_err": lib[1] if lib else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if kind == "prefill":
                cuda_cores, launch = K.paged_prefill_attention_cuda_cores, K._prefill_launch
                split = K._prefill_split(c["q"], c["k"][0], c["tbl"], softcap=cap, window=window)
                row.update(C=C, start=start)
            else:
                cuda_cores, launch = K.paged_attention_cuda_cores, K._decode_launch
                split = K._decode_split(c["q"], c["k"][0], c["tbl"], window=window)
                row.update(lens=lens, table_blocks=nb)
            v1_err = float((run(cuda_cores, 0).float() - ref.float()).abs().max())
            row.update(
                split=split,
                # the kernel without the cluster split, and v1 (the yardstick) on the same inputs
                split1_ms=timed_ms(lambda i: run(launch, i, split=1)),
                cuda_cores_ms=timed_ms(lambda i: run(cuda_cores, i)), cuda_cores_max_abs_err=v1_err,
                host_us=host_us(lambda i: run(kernel, i)), cuda_cores_host_us=host_us(lambda i: run(cuda_cores, i)),
            )
            emit(row)
            del ref
            if not errs["max_abs"] < tol:
                fail(f"{row['kernel']} {model} {row['q_dtype']} window={window} softcap={cap}: err {errs['max_abs']} >= {tol}")
            if not control["max_abs"] > tol:
                fail(f"{row['kernel']} {model} {row['q_dtype']}: the control {control_name} passes "
                     f"({control['max_abs']} <= {tol}), which then proves nothing")
            if not row["cuda_cores_max_abs_err"] < tol:
                fail(f"paged_{kind}_cuda_cores {model} {row['q_dtype']}: err {row['cuda_cores_max_abs_err']} >= {tol}")
            if model == "olmo-1b" and dt == torch.float32 and f"paged_{kind}" not in main:
                main[f"paged_{kind}"] = row
            if model == HYMBA_ARCH:
                hymba[row["q_dtype"]] = row
            del c
    return main, hymba


# ---------------------------------------------------------------------------
# phase 2b: the tools — K1/K2's autotuner, serving under its table, the dry run
# ---------------------------------------------------------------------------

# the kernel phase's own K1/K2 shapes: (model, (H, KV, hd), decode lengths, table width, window)
TOOLS_SHAPES = [("olmo-1b", (16, 16, 128), DECODE_LENS, NB, 0),
                ("qwen3-moe-235b-a22b", (64, 4, 128), DECODE_LENS, NB, 0),
                (HYMBA_ARCH, (25, 5, 64), HYMBA_LENS, HYMBA_NB, HYMBA_WINDOW)]
TOOLS_ITERS = 20
# the dry run's peak memory against the card's for the same step
PEAK_MEM_REL = 0.2


def tools_sweep_phase(device, cache_dir) -> dict:
    """``kernels.autotune.tune_case`` on the card at ``TOOLS_SHAPES``: for
    decode every K1 split and ``"prefill1"`` (K2 at C = 1), for K2's
    128-token chunk after 192 every split, on the kernel phase's inputs
    (fp32 queries, bf16 pools, 16 layers of pools).  ``tune_case`` holds
    each candidate to ``TOL`` against the plain version (it raises
    otherwise); here ``kernel_control`` on the same inputs must fail it.
    The winners go to a user cache in ``cache_dir``, which must pass
    ``check_determinism``."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

    plains = {"decode": paged_attention_plain, "prefill": paged_prefill_attention_plain}
    table, rows = {}, {}
    for seed, (model, (H, KV, hd), lens, nb, window) in enumerate(TOOLS_SHAPES):
        inputs = {kind: kernel_case(kind, H, KV, hd, torch.float32, window, 0.0, device, seed=100 + seed, lens=lens,
                                    nb=nb) for kind in ("decode", "prefill")}
        won = autotune.tune_case(len(lens), nb, BLOCK_SIZE, H, KV, hd, "bfloat16", TOOLS_ITERS, device,
                                 window=window, inputs=inputs)
        controls = {}
        for kind, c in inputs.items():
            name, out = kernel_control(c, plains[kind], dict(softcap=0.0, window=window))
            ref = plains[kind](c["q"], c["k"][0], c["v"][0], c["tbl"], c["lens"], window=window)
            controls[kind] = {"control": name, "max_abs_err": float((out.float() - ref.float()).abs().max())}
        key = autotune.cache_key(hd, BLOCK_SIZE, nb, torch.bfloat16, H // KV)
        table[key] = {knob: won[knob] for knob in ("decode_kernel", "decode_split", "prefill_split")}
        lib = won["library"]
        row = {
            "phase": "tools_sweep", "model": model, "key": key, "winner": table[key],
            "decode_ms": won["decode_s"] * 1e3, "prefill_ms": won["prefill_s"] * 1e3,
            "library": {"decode_ms": lib["decode_s"] * 1e3, "decode_split": lib["decode_split"],
                        "prefill_ms": lib["prefill_s"] * 1e3, "prefill_split": lib["prefill_split"]},
            "decode_gain": lib["decode_s"] / won["decode_s"], "prefill_gain": lib["prefill_s"] / won["prefill_s"],
            "candidates": {kind: {name: {"ms": r["s"] * 1e3, "max_abs_err": r["max_abs_err"]} for name, r in rows_.items()}
                           for kind, rows_ in won["candidates"].items()},
            "tol": TOL[torch.float32], "controls": controls,
        }
        emit(row)
        rows[model] = row
        errs = [r["max_abs_err"] for rows_ in won["candidates"].values() for r in rows_.values()]
        if not max(errs) < TOL[torch.float32]:
            fail(f"tools_sweep {model}: a candidate's error {max(errs)} >= {TOL[torch.float32]}")
        for kind, ctl in controls.items():
            if not ctl["max_abs_err"] > TOL[torch.float32]:
                fail(f"tools_sweep {model} {kind}: the control {ctl['control']} passes ({ctl['max_abs_err']}), "
                     "which then proves nothing")
        del inputs
    path = os.path.join(cache_dir, "cuda_autotune.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    os.environ[autotune.CACHE_ENV] = path
    try:
        autotune.check_determinism()  # raises on an invalid or unstable table
        tuned = {model: autotune.get_config(hd, BLOCK_SIZE, nb, torch.bfloat16, H // KV)
                 for model, (H, KV, hd), _, nb, _ in TOOLS_SHAPES}
    finally:
        del os.environ[autotune.CACHE_ENV]
        autotune.load_table(refresh=True)
    if tuned != {r["model"]: r["winner"] for r in rows.values()}:
        fail(f"tools_sweep: the tuned cache reads {tuned}, not the winners")
    out = {"phase": "tools_table", "path": path, "table": table}
    emit(out)
    return {"rows": rows, "path": path, "table": table}


def tools_serving_phase(cfg, params, device, legacy_tokens, sweep, max_new_tokens=32) -> dict:
    """The serving phase's prompts on olmo-1b under the tuned table, in the
    legacy and the fused walk: tokens equal to the untuned legacy run's up
    to near-ties, every request by length, and K1/K2 launched as the table
    says (``"prefill1"``: K2 in place of K1)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    tuned = sweep["rows"][cfg.name]["winner"]
    prompts = serving_prompts(cfg, SEED)
    L = cfg.num_layers
    out = {"phase": "tools_serving", "model": cfg.name, "tuned": tuned}
    os.environ[autotune.CACHE_ENV] = sweep["path"]
    autotune.load_table(refresh=True)
    try:
        for walk in ("legacy", "fused"):
            eng = InferenceEngine(cfg, params, max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128,
                                  cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, device=device,
                                  fused=walk == "fused")
            reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
            K.reset_launches()
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s = eng.stats()
            launches = dict(K.LAUNCHES)
            replays = dict(eng._graphs.launches) if walk == "fused" else None
            tokens = [list(r.generated) for r in reqs]
            found = []
            same = same_up_to_ties(cfg, params, device, prompts, tokens, legacy_tokens, found)
            out[walk] = {"wall_s": wall, "decode_steps": s["decode_steps"], "prefill_chunks": s["prefill_chunks"],
                         "eager_launches": launches, "replay_launches": replays,
                         "tpot_p50_s": float(np.median([r.tpot for r in reqs])), "same_up_to_ties": same,
                         "differences": found[0]}
            if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
                fail(f"tools_serving {walk}: requests did not all finish by length")
            if not same:
                fail(f"tools_serving {walk}: tokens under the tuned table differ from the untuned run's away "
                     f"from a near-tie: {found[0]}")
            if walk == "legacy":
                k1, k2 = s["decode_steps"] * L, s["prefill_chunks"] * L
                expect = ({"paged_decode": 0, "paged_prefill": k1 + k2} if tuned["decode_kernel"] == "prefill1"
                          else {"paged_decode": k1, "paged_prefill": k2})
                if {k: launches[k] for k in expect} != expect:
                    fail(f"tools_serving legacy: launches {launches}, the table {tuned} gives {expect}")
            elif not replays["paged_prefill"] > 0 or (replays["paged_decode"] > 0) == (
                    tuned["decode_kernel"] == "prefill1"):
                fail(f"tools_serving fused: replays launched {replays} under {tuned}")
            del eng
    finally:
        del os.environ[autotune.CACHE_ENV]
        autotune.load_table(refresh=True)
    emit(out)
    return out


DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")


def dryrun_cells(name: str = "olmo-1b") -> tuple[dict, dict]:
    """``launch.dryrun.run_cell`` for the model's three cells at full width
    on the meta device, on one card and as one rank of the 256-device mesh
    (reported only): host work alone, which ``main`` runs while ``nvcc``
    builds the kernels."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import cell_rows, markdown_table

    cells = {"one_card": {}, "single": {}}
    for mesh, results in cells.items():
        for shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(name, shape, verbose=False, mesh=mesh)
            results[f"{name}|{shape}"] = rec
            emit({"phase": "tools_dryrun_cell", **rec})
        print(markdown_table(cell_rows(results)), flush=True)
    return cells["one_card"], cells["single"]


def tools_dryrun_phase(cfg, train, state, batch, step_mem, cells) -> dict:
    """The train phase's own step costed on the meta device (olmo-1b fp8 at
    TRAIN_B x TRAIN_S, ``train_run_config``): its roofline bound must not
    exceed the step time this run measured, and its peak estimate must lie
    within ``PEAK_MEM_REL`` of ``max_memory_allocated`` over one step
    (``step_mem``, read around ``train_step_5``); beside it the cells of
    ``dryrun_cells``."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import storage_bytes

    results, on_mesh = cells
    rec = dryrun.cost_step(cfg, train_run_config("kernel"), ShapeConfig("train_phase", TRAIN_S, TRAIN_B, "train"))
    bound_s = max(rec["roofline"].values())
    step_s = train["step_ms_mean_steps_1_3"] / 1e3
    est, peak = rec["memory"]["peak_estimate_bytes"], step_mem["max_allocated"]
    inputs = storage_bytes((state, batch))
    out = {"phase": "tools_dryrun", "model": cfg.name, "cells": {k: {f: v.get(f) for f in (
               "per_device_flops", "per_device_hbm_bytes", "roofline", "dominant", "useful_ratio", "memory", "fp8",
               "trace_s")} for k, v in results.items()},
           "single": {k: {f: v.get(f) for f in ("n_devices", "per_device_flops", "per_device_hbm_bytes", "roofline",
                                                 "dominant", "memory", "collectives", "rank_trace_s")}
                      for k, v in on_mesh.items()},
           "train_step": rec, "bound_s": bound_s, "step_s": step_s, "step_over_bound": step_s / bound_s,
           "peak_estimate_bytes": est, "max_allocated_bytes": peak, "peak_rel_err": (est - peak) / peak,
           "allocated_before_step": step_mem["before"], "step_input_bytes": inputs}
    emit(out)
    if not bound_s <= step_s:
        fail(f"tools_dryrun: the dry run's bound {bound_s} s exceeds the measured step {step_s} s")
    if not abs(est - peak) <= PEAK_MEM_REL * peak:
        fail(f"tools_dryrun: peak estimate {est} B is not within {PEAK_MEM_REL} of max_memory_allocated {peak} B")
    return out


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------


def serving_prompts(cfg, seed) -> list[list[int]]:
    """8 prompts of 64-320 tokens that share a 64-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
    lengths = [64, 96, 128, 160, 192, 224, 288, 320]
    return [prefix + [int(t) for t in rng.integers(0, cfg.vocab_size, n - 64)] for n in lengths]


def serving_phase(cfg, params, device, max_new_tokens=32) -> dict:
    from repro_torch.kernels import paged_attention as K
    from repro_torch.utils.tree import tree_leaves
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device,  # outside the vocab: every request runs to length
    )
    prompts = serving_prompts(cfg, SEED)
    # warm-up on a separate engine (library handles, allocator), not counted
    warm = InferenceEngine(cfg, params, **kw)
    warm.submit(prompts[0][:48], max_new_tokens=2)
    warm.run_until_drained()
    del warm

    eng = InferenceEngine(cfg, params, **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    K.reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    s = eng.stats()
    L = cfg.num_layers
    first_tokens = sum(1 for e in eng.tracer.events if e.name == "first_token")
    if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
        fail(f"requests did not all finish by length: {[(r.finish_reason, len(r.generated)) for r in reqs]}")
    if not (launches["paged_decode"] > 0 and launches["paged_prefill"] > 0):
        fail(f"a kernel was not launched on the main path: {launches}")
    if launches["paged_prefill"] != s["prefill_chunks"] * L or launches["paged_decode"] != s["decode_steps"] * L:
        fail(f"launches {launches} != {s['prefill_chunks']} chunks / {s['decode_steps']} decode steps x {L} layers")
    if first_tokens != len(reqs):
        fail(f"{first_tokens} first tokens from the prefill path for {len(reqs)} requests")
    if s["alloc_blocks_in_use"] != 0 or s["prefix_hit_tokens"] <= 0:
        fail(f"blocks in use {s['alloc_blocks_in_use']}, prefix hit tokens {s['prefix_hit_tokens']}")
    decode_tokens = s["tokens_out"] - len(reqs)  # the first tokens come from prefill
    h_decode = eng.metrics.histogram("engine_decode_seconds")
    tick_tokens, tick_s = decode_ticks(eng)
    out = {
        "phase": "serving", "model": cfg.name, "params": sum(t.numel() for t in tree_leaves(params)),
        "requests": len(reqs), "tokens_out": s["tokens_out"], "decode_steps": s["decode_steps"],
        "prefill_chunks": s["prefill_chunks"], "prefill_tokens": s["prefill_tokens"],
        "prefix_hit_tokens": s["prefix_hit_tokens"], "alloc_blocks_in_use": s["alloc_blocks_in_use"],
        "launches": launches, "wall_s": wall,
        "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
        "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
        "decode_step_p50_s": h_decode.percentile(50),
        "step_p50_s": eng.metrics.histogram("engine_step_seconds").percentile(50),
        "decode_tok_s": decode_tokens / h_decode.sum,
        "decode_tick_tok_s": tick_tokens / tick_s,
        "output_tok_s": s["tokens_out"] / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "dispatches_per_step": s["dispatches_per_step"], "host_syncs_per_step": s["host_syncs_per_step"],
        "cache_bytes": s["cache_bytes"], "pool_bytes": pool_bytes(eng),
    }
    emit(out)
    return out, [list(r.generated) for r in reqs]


def decode_ticks(eng, since: float = float("-inf")) -> tuple[int, float]:
    """(decode tokens, seconds) of the engine steps that decoded, started
    at ``since`` or later on the engine's clock, from the tracer's step
    spans (a first token is not a decode token)."""
    if eng.tracer.dropped:
        fail(f"the tracer dropped {eng.tracer.dropped} events")
    steps = [e for e in eng.tracer.events if e.name == "step" and e.ts >= since and e.args.get("produced", 0) > 0]
    return sum(e.args["produced"] for e in steps), sum(e.dur for e in steps)


def tick_kinds(eng, since: float) -> dict:
    """Count, summed and median wall of the fused engine's ticks since
    ``since``: mixed ticks (a prefill chunk rode in them) and pure-decode
    ticks, from the tracer's step spans and chunk instants."""
    events = [e for e in eng.tracer.events if e.ts >= since]
    chunks = [e.ts for e in events if e.name == "prefill_chunk"]
    out = {"mixed": [], "decode": []}
    for e in events:
        if e.name == "step":
            out["mixed" if any(e.ts <= t <= e.ts + e.dur for t in chunks) else "decode"].append(e.dur)
    return {k: {"ticks": len(v), "wall_s": sum(v), "wall_ms_p50": float(np.median(v)) * 1e3 if v else None}
            for k, v in out.items()}


def context_logits(cfg, params, device, context, quantize_kv=False) -> torch.Tensor:
    """The logits after ``context``, (V,), through one ``prefill_step``
    (bf16 pools, or quantized ones); for a family without chunked prefill
    (hybrid, ssm) through one whole-prompt ``prefill``."""
    from repro_torch.models import init_paged_cache, prefill, prefill_step, supports_chunked_prefill

    if not supports_chunked_prefill(cfg):
        lg, _ = prefill(cfg, params, {"tokens": torch.tensor([context], dtype=torch.int32, device=device)})
        return lg[0]
    nb = -(-len(context) // BLOCK_SIZE)
    cache = init_paged_cache(cfg, 1 + nb, BLOCK_SIZE, 1, nb, torch.bfloat16, quantized=quantize_kv, device=device)
    row = torch.arange(1, 1 + nb, dtype=torch.int32, device=device)[None]
    tok = torch.tensor([context], dtype=torch.int32, device=device)
    lg, _ = prefill_step(cfg, params, cache, tok, torch.zeros(1, dtype=torch.int32, device=device), row)
    return lg[0]


def top2_gap(cfg, params, device, context, quantize_kv=False) -> float:
    """The top-2 logit gap after ``context`` (``context_logits``)."""
    top = torch.topk(context_logits(cfg, params, device, context, quantize_kv), 2).values
    return float(top[0] - top[1])


def differences(cfg, params, device, reqs, legacy_tokens, quantize_kv=False, tol=PATH_TOL) -> list[dict]:
    """Each request whose tokens differ from the legacy run's: the first
    position where they do and the legacy tokens' top-2 logit gap there
    (through pools of the run's kind), a near-tie when it is below
    ``tol``."""
    differ = []
    for i, (r, ref) in enumerate(zip(reqs, legacy_tokens)):
        j = next((j for j, (a, b) in enumerate(zip(r.generated, ref)) if a != b), None)
        if j is not None:
            gap = top2_gap(cfg, params, device, r.prompt + ref[:j], quantize_kv)
            differ.append({"request": i, "position": j, "legacy_top2_gap": gap, "near_tie": gap < tol})
    return differ


def serving_fused_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """The serving phase's run with ``fused=True``: one graph replay and one
    host sync a tick on the card."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device, fused=True,
    )
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, **kw)
    # untimed: prompts of the same lengths from another seed capture the
    # buckets the timed traffic uses; their prefix shares no block with it
    for p in serving_prompts(cfg, SEED + 1):
        eng.submit(p, max_new_tokens=max_new_tokens)
    eng.run_until_drained()
    graphs = eng._graphs
    s0 = eng.stats()
    captured_warm, capture_s_warm = graphs.captures, graphs.capture_s
    replay_launches = dict(graphs.launches)
    since = eng.tracer.now()

    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in serving_prompts(cfg, SEED)]
    K.reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)  # eager calls: the warm-up runs of keys captured in this run
    replayed = {k: v - replay_launches[k] for k, v in graphs.launches.items()}
    s = eng.stats()
    steps = s["decode_steps"] - s0["decode_steps"]
    dispatches = s["dispatches_total"] - s0["dispatches_total"]
    syncs = s["host_syncs_total"] - s0["host_syncs_total"]
    tick_tokens, tick_s = decode_ticks(eng, since)
    differ = differences(cfg, params, device, reqs, legacy_tokens)
    out = {
        "phase": "serving_fused", "model": cfg.name, "requests": len(reqs),
        "tokens_out": s["tokens_out"] - s0["tokens_out"], "decode_steps": steps, "wall_s": wall,
        "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
        "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
        "decode_tick_p50_s": eng.metrics.histogram("engine_decode_seconds").percentile(50),
        "decode_tok_s": tick_tokens / tick_s,
        "output_tok_s": (s["tokens_out"] - s0["tokens_out"]) / wall,
        "dispatches_per_step": dispatches / steps, "host_syncs_per_step": syncs / steps,
        "ticks": tick_kinds(eng, since),
        "graphs_captured": {"warm": captured_warm, "timed": graphs.captures - captured_warm},
        "graph_pool_bytes_by_key": {str(k): g.pool_bytes for k, g in graphs._graphs.items()},  # in capture order
        "capture_s": {"warm": capture_s_warm, "timed": graphs.capture_s - capture_s_warm},
        "graph_pool_bytes": graphs.pool_bytes(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "replay_launches": replayed, "eager_launches": launches,
        "requests_differing": len(differ), "differences": differ,
    }
    emit(out)
    if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
        fail(f"fused requests did not all finish by length: {[(r.finish_reason, len(r.generated)) for r in reqs]}")
    if not (replayed["paged_decode"] > 0 and replayed["paged_prefill"] > 0):
        fail(f"the fused run's graph replays ran no K1 or no K2: {replayed}")
    if out["dispatches_per_step"] > 1.5:
        fail(f"fused run: {out['dispatches_per_step']} dispatches a step (at most 1.5)")
    if not all(d["near_tie"] for d in differ):
        fail(f"fused tokens differ from the legacy run's away from a near-tie: {differ}")
    return out


def profile_fused_phase(cfg, params, device, ticks=5) -> dict:
    """One fused pure-decode tick at the profile phase's lengths beside the
    eager ``decode_step`` and the eager tick (``profile_ticks``)."""
    out = {"phase": "profile_fused", **profile_ticks(cfg, params, device, ticks)}
    emit(out)
    return out


def profile_ticks(cfg, params, device, ticks=5, names=("fused_tick", "eager_step", "eager_tick")) -> dict:
    """One fused pure-decode tick at the profile phase's lengths, as the
    engine runs it (stage the inputs, replay the decode graph, one host
    sync), beside the eager ``decode_step`` and the eager tick
    (``decode_step``, argmax, one host sync), in the same run, as ``names``
    selects: wall per call with no profiler, then device time, idle share,
    the launches the profiler sees and the top kernels by device time."""
    from repro_torch.models import decode_step
    from repro_torch.serving import InferenceEngine

    B = len(DECODE_LENS)
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=NB * BLOCK_SIZE, block_size=BLOCK_SIZE,
                          cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, device=device, fused=True)
    eng.tbl[:] = np.arange(1, 1 + B * NB).reshape(B, NB)
    eng._tbl_dirty = True
    eng._sync_tables()
    pos = np.array([n - 1 for n in DECODE_LENS], np.int32)
    inputs = dict(tokens=np.zeros((B, 1), np.int32), pos=pos, temps=np.zeros(B, np.float32),
                  top_ks=np.zeros(B, np.int32), room=np.full(B, 2, np.int32))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos_d = torch.from_numpy(pos).to(device)

    def fused_tick():
        eng._host_fetch(eng._graphs.run(("decode", B), eng._fused_decode_fn, inputs))

    def eager_step():
        decode_step(cfg, params, eng.cache, tok, pos_d)

    def eager_tick():
        logits, _ = decode_step(cfg, params, eng.cache, tok, pos_d)
        eng._host_fetch(torch.argmax(logits, dim=-1))

    out = {"model": cfg.name, "what": "4 slots, bf16 pools, fp32 weights"}
    calls = {"fused_tick": fused_tick, "eager_step": eager_step, "eager_tick": eager_tick}
    for name in names:
        fn = calls[name]
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
        by_name, launches, _, _ = profiled(fn, ticks)
        busy = sum(by_name.values())
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy if by_name else None,
            "idle_share": 1.0 - busy / wall_ms if by_name else None, "device_launches": launches,
            "paged_decode_ms": sum(v for k, v in by_name.items() if "paged_decode_kernel" in k),
            "top_kernels_ms": [[k[:90], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]],
        }
    out["graphs_captured"] = eng._graphs.captures
    out["graph_kernels_seen_one_by_one"] = out["fused_tick"]["device_launches"] >= out["eager_step"]["device_launches"]
    return out


# ---------------------------------------------------------------------------
# phase 5d: speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_ACCEPTANCE = 0.8  # the self-draft must reach it; a draft of unrelated weights must not


def serving_spec_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """The serving phase's engine, prompts and settings with
    ``spec_decode`` and ``spec_k = 4``, four runs: (a) the legacy walk with
    the n-gram drafter; (b) the same with ``fused=True``, after an untimed
    run of prompts from another seed that captures the buckets; (c) the
    legacy walk with the target as its own drafter on the first two
    prompts; (d) its control, a ``make_draft_config`` draft of random
    weights from another seed, on the same two.  Each run first serves an
    untimed warm-up on its own engine; its readings are the timed run's."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.spec_decode import make_draft_config

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device, spec_k=SPEC_K,
    )
    prompts = serving_prompts(cfg, SEED)
    dcfg = make_draft_config(cfg)
    runs = {
        "a_legacy_ngram": (dict(spec_decode="ngram"), prompts),
        "b_fused_ngram": (dict(spec_decode="ngram", fused=True), prompts),
        "c_legacy_self_draft": (dict(spec_decode="draft", draft_cfg=cfg, draft_params=params), prompts[:2]),
        "d_control_draft": (
            dict(spec_decode="draft", draft_cfg=dcfg, draft_params=init_params(dcfg, SEED + 7, device=device)),
            prompts[:2],
        ),
    }
    out = {"phase": "serving_spec", "model": cfg.name, "spec_k": SPEC_K, "draft_model": dcfg.name}
    for name, (extra, ps) in runs.items():
        eng = InferenceEngine(cfg, params, **kw, **extra)
        warm = serving_prompts(cfg, SEED + 1)
        for p in warm if eng.fused else [warm[0][:48]]:
            eng.submit(p, max_new_tokens=max_new_tokens if eng.fused else 8)
        eng.run_until_drained()
        graphs = eng._graphs
        captured_warm = graphs.captures if graphs is not None else 0
        replay_before = dict(graphs.launches) if graphs is not None else {}
        s0 = eng.stats()
        counts0 = (eng.spec_emitted, eng.spec_slot_steps)
        since = eng.tracer.now()
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in ps]
        K.reset_launches()  # this run's main path starts here
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = dict(K.LAUNCHES)
        s = eng.stats()
        d = {k: s[k] - s0[k] for k in ("decode_steps", "dispatches_total", "host_syncs_total", "tokens_out",
                                        "drafted_tokens", "accepted_tokens", "verify_tokens", "spec_steps")}
        emitted, slot_steps = eng.spec_emitted - counts0[0], eng.spec_slot_steps - counts0[1]
        replayed = {k: v - replay_before[k] for k, v in graphs.launches.items()} if graphs is not None else {}
        row = {
            "requests": len(reqs), "wall_s": wall,
            "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
            "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
            "output_tok_s": d["tokens_out"] / wall, "steps": d["decode_steps"],
            "step_s": wall / d["decode_steps"],
            "ticks": tick_kinds(eng, since),  # "decode": steps with no prefill chunk
            "dispatches_per_step": d["dispatches_total"] / d["decode_steps"],
            "host_syncs_per_step": d["host_syncs_total"] / d["decode_steps"],
            "acceptance_rate": d["accepted_tokens"] / d["drafted_tokens"] if d["drafted_tokens"] else 0.0,
            "tokens_per_verify": emitted / slot_steps if slot_steps else 0.0,
            "drafted_tokens": d["drafted_tokens"], "accepted_tokens": d["accepted_tokens"],
            "verify_passes": slot_steps, "verify_tokens": d["verify_tokens"], "spec_steps": d["spec_steps"],
            "eager_launches": eager, "replay_launches": replayed or None,
            "k2_launches": eager["paged_prefill"] + replayed.get("paged_prefill", 0),
            "k1_launches": eager["paged_decode"] + replayed.get("paged_decode", 0),
            "differences": differences(cfg, params, device, reqs, legacy_tokens[: len(reqs)]),
        }
        if graphs is not None:
            row.update(
                graphs_captured={"warm": captured_warm, "timed": graphs.captures - captured_warm},
                graph_keys=[str(k) for k in graphs._graphs],
                graph_pool_bytes_by_key={str(k): g.pool_bytes for k, g in graphs._graphs.items()},
                graph_pool_bytes=graphs.pool_bytes(),
            )
        out[name] = row
        emit({"phase": "serving_spec", "run": name, **row})
        if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
            fail(f"spec run {name}: requests did not all finish by length: "
                 f"{[(r.finish_reason, len(r.generated)) for r in reqs]}")
        if row["k2_launches"] <= 0 or (graphs is not None and replayed["paged_prefill"] <= 0):
            fail(f"spec run {name}: K2 did not run on the verify path: eager {eager}, replays {replayed}")
        if name[0] in "ab" and row["k1_launches"]:
            fail(f"spec run {name}: K1 ran ({row['k1_launches']} launches) though every step verifies")
        if graphs is not None:
            if row["dispatches_per_step"] > 1.5:
                fail(f"spec run {name}: {row['dispatches_per_step']} dispatches a step (at most 1.5)")
            if row["graphs_captured"]["timed"]:
                fail(f"spec run {name}: {row['graphs_captured']['timed']} graphs captured in the timed run")
        if name[0] in "abc" and not all(x["near_tie"] for x in row["differences"]):
            fail(f"spec run {name}: tokens differ from the legacy run's away from a near-tie: {row['differences']}")
        del eng, graphs
        torch.cuda.empty_cache()
    out["k2_launches"] = {name: out[name]["k2_launches"] for name in runs}
    if not out["c_legacy_self_draft"]["acceptance_rate"] >= SPEC_ACCEPTANCE:
        fail(f"self-draft acceptance {out['c_legacy_self_draft']['acceptance_rate']} < {SPEC_ACCEPTANCE}")
    if not out["d_control_draft"]["acceptance_rate"] < SPEC_ACCEPTANCE:
        fail(f"the control draft's acceptance {out['d_control_draft']['acceptance_rate']} reaches "
             f"{SPEC_ACCEPTANCE}, which then proves nothing")
    return out


# a committed row against the plain path's: each layer's K/V row is rounded
# to bf16 from activations that differ in the last fp32 bits, so a few
# elements may move by one bf16 spacing; the limit is one spacing of the
# row's largest element (2^-7 of it)
COMMITTED_REL = 2.0**-7


def rollback_readings(pools, history, reference, starts, cut, tbl) -> dict:
    """Per verify window of one step: the rejected rows [start + cut,
    start + spec_k + 1) must read zero, the history [0, start) must be
    bit-equal to the pools before the step, and the committed rows [start,
    start + cut) must agree with what the plain path wrote (``reference``):
    max |a - b| over each (layer, position) row, divided by the row's
    largest |b|, at most ``COMMITTED_REL``."""
    rejected, history_diff, committed = 0.0, 0.0, 0.0
    for b, (st, c) in enumerate(zip(starts, cut)):
        pos = torch.arange(st + c, st + SPEC_K + 1, device=tbl.device)
        for name in ("k", "v"):
            pool = pools[name]
            rows = pool[:, tbl[b, pos // BLOCK_SIZE].long(), pos % BLOCK_SIZE]
            rejected = max(rejected, float(rows.float().abs().max()))
            old = torch.arange(st, device=tbl.device)
            idx = (tbl[b, old // BLOCK_SIZE].long(), old % BLOCK_SIZE)
            history_diff = max(history_diff, float((pool[:, idx[0], idx[1]].float()
                                                    - history[name][:, idx[0], idx[1]].float()).abs().max()))
            new = torch.arange(st, st + c, device=tbl.device)
            idx = (tbl[b, new // BLOCK_SIZE].long(), new % BLOCK_SIZE)
            a, ref = pool[:, idx[0], idx[1]].float(), reference[name][:, idx[0], idx[1]].float()  # (L, c, KV, hd)
            row_err = (a - ref).abs().amax(dim=(2, 3)) / ref.abs().amax(dim=(2, 3))
            committed = max(committed, float(row_err.max()))
    return {"rejected_max_abs": rejected, "history_max_diff": history_diff, "committed_max_rel": committed}


def rollback_passes(r: dict) -> bool:
    return r["rejected_max_abs"] == 0.0 and r["history_max_diff"] == 0.0 and r["committed_max_rel"] <= COMMITTED_REL


def spec_rollback_phase(cfg, params, device) -> dict:
    """One verify step of 4 slots whose drafts cannot match (each slot's
    least likely token after its last committed one, by the plain path's
    logits), at the profile phase's lengths on full-width olmo-1b: so every
    window accepts nothing and rolls back its last ``spec_k`` lanes.  Run eagerly as the
    legacy walk calls it (``verify_step``, ``spec_accept``,
    ``truncate_block_rows``) and as the fused walk's spec graph (captured
    on a first call, then replayed on the restored pools and read).  Two
    controls must fail the readings: the pools after the verify pass with
    no rollback, and with the rollback one lane early (from ``start``,
    which also zeroes the committed row)."""
    from repro_torch.models import decode_step, prefill_step, verify_step
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.kvcache import truncate_block_rows
    from repro_torch.serving.sampler import spec_accept

    B, W = len(DECODE_LENS), SPEC_K + 1
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=NB * BLOCK_SIZE, block_size=BLOCK_SIZE,
                          cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, device=device, fused=True,
                          spec_decode="ngram", spec_k=SPEC_K)
    eng.tbl[:] = np.arange(1, 1 + B * NB).reshape(B, NB)
    eng._tbl_dirty = True
    eng._sync_tables()
    tbl = eng.cache["tbl"]
    rng = np.random.default_rng(SEED + 3)
    starts = [n - 1 for n in DECODE_LENS]  # the windows cross block edges at 159 and 351
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    for b, n in enumerate(starts):  # the history, through the prefill path
        hist = torch.tensor(rng.integers(0, cfg.vocab_size, n)[None], dtype=torch.int32, device=device)
        prefill_step(cfg, params, eng.cache, hist, zero, tbl[b : b + 1])
    history = {n: eng.cache[n].clone() for n in ("k", "v")}
    last = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    start = np.array(starts, np.int32)
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731

    # the plain path's rows: one decode step of the last token, plain
    # attention; its least likely token is each slot's draft
    reference = {n: history[n].clone() for n in ("k", "v")}
    ref_logits, _ = decode_step(cfg, params, {**reference, "tbl": tbl}, dev(last[:, None]), dev(start), attn_impl="plain")
    tokens = np.repeat(ref_logits[:, : cfg.vocab_size].argmin(-1).int().cpu().numpy()[:, None], W, axis=1)
    tokens[:, 0] = last

    # eager, as the legacy walk's _spec_step
    for n in ("k", "v"):
        eng.cache[n].copy_(history[n])
    logits, _ = verify_step(cfg, params, eng.cache, dev(tokens), dev(start), tbl)
    no_rollback = {n: eng.cache[n].clone() for n in ("k", "v")}
    early = truncate_block_rows({n: t.clone() for n, t in no_rollback.items()}, tbl, dev(start), dev(start + W), span=W)
    valid = torch.ones((B, SPEC_K), dtype=torch.bool, device=device)
    temps, top_ks = torch.zeros(B, device=device), torch.zeros(B, dtype=torch.int32, device=device)
    n_acc, _ = spec_accept(logits, dev(tokens[:, 1:]), None, valid, temps, top_ks, eng._gen)
    cut_eager = (n_acc + 1).cpu().tolist()
    truncate_block_rows(eng.cache, tbl, dev(start) + n_acc + 1, dev(start + W), span=W)
    torch.cuda.synchronize()
    eager = rollback_readings(eng.cache, history, reference, starts, cut_eager, tbl)

    # the fused walk's spec graph: the capture's call, then a replay
    inputs = dict(
        tokens=tokens, start=start, widths=np.full(B, W, np.int32), tbl=eng.tbl.astype(np.int32),
        temps=np.zeros(B, np.float32), top_ks=np.zeros(B, np.int32), sample_lane=np.zeros(B, np.int32),
        room=np.full(B, W + 1, np.int32), drafts=tokens[:, 1:].copy(), valid=np.ones((B, SPEC_K), np.int32),
        roll_end=start + W,
    )
    key = ("mixed", B, W, "spec")
    for _ in range(2):
        for n in ("k", "v"):
            eng.cache[n].copy_(history[n])
        packed = eng._graphs.run(key, eng._fused_mixed_fn, inputs)
        torch.cuda.synchronize()
    cut_graph = packed[2].cpu().tolist()
    graph = rollback_readings(eng.cache, history, reference, starts, cut_graph, tbl)
    controls = {name: rollback_readings(pools, history, reference, starts, cut_eager, tbl)
                for name, pools in (("no_rollback", no_rollback), ("one_lane_early", early))}
    out = {
        "phase": "spec_rollback", "model": cfg.name, "starts": starts, "spec_k": SPEC_K,
        "cut_eager": cut_eager, "cut_graph": cut_graph, "eager": eager, "graph": graph,
        "graph_replays": eng._graphs.replays, "graph_launches": dict(eng._graphs.launches),
        "limit_committed_rel": COMMITTED_REL, "controls": controls,
    }
    emit(out)
    if out["graph_launches"]["paged_prefill"] != 2 * cfg.num_layers:
        fail(f"spec rollback: the two replays ran {out['graph_launches']} K2 launches, not 2 x {cfg.num_layers}")
    if cut_eager != [1] * B or cut_graph != [1] * B:
        fail(f"spec rollback: a draft that cannot match was accepted: cut {cut_eager} / {cut_graph}")
    if not rollback_passes(eager) or not rollback_passes(graph):
        fail(f"spec rollback: eager {eager}, graph {graph}")
    for name, r in controls.items():
        if rollback_passes(r):
            fail(f"spec rollback: the control {name} passes {r}, which then proves nothing")
    return out


# ---------------------------------------------------------------------------
# phase 5f-5i: the KV-cache tiers (quantized pools, host spill tier)
# ---------------------------------------------------------------------------


def quantized_case(c, mode) -> dict:
    """A kernel case's K/V, drawn again in fp32 and quantized by the port's
    ``quantize`` (``mode``: int8 or fp8): the codes and scales of each
    layer, and fp32 pools that hold the same dequantized rows."""
    from repro_torch.serving.kvquant import quantize

    g = torch.Generator(device=c["q"].device).manual_seed(11)
    out = {}
    for name in ("k", "v"):
        codes, scale = quantize(torch.randn(c[name].shape, generator=g, device=c["q"].device), mode)
        out[name], out[f"{name}_scale"], out[f"{name}_fp32"] = codes, scale, codes.float() * scale
    return out


def kv_quant_read_phase(device) -> dict:
    """The read path of quantized pools, which have no kernel (as in the
    JAX package): the plain dequantizing read of int8 and e4m3 pools against
    K1 and K2 over fp32 pools holding the same dequantized rows, at the
    kernel phase's olmo-1b shapes (4 slots at ``DECODE_LENS``; one 128-token
    chunk after 192 tokens), fp32 queries.  The arithmetic differs only in
    summation order, so ``TOL[fp32]`` holds; scales shifted by one token row
    are the control that must exceed it.  Times are device times."""
    from repro_torch.kernels import paged_attention as K

    (_, H, KV, hd) = HEAD_SHAPES[0]
    out = {"phase": "kv_quant_read", "model": "olmo-1b", "tol": TOL[torch.float32]}
    for kind, plain, kernel in (("decode", K.paged_attention_quantized, K.paged_attention),
                                ("prefill", K.paged_prefill_attention_quantized, K.paged_prefill_attention)):
        c = kernel_case(kind, H, KV, hd, torch.float32, 0, 0.0, device, layers=4)
        for mode in ("int8", "fp8"):
            p = quantized_case(c, mode)

            def run_plain(i, p=p, c=c, shift=0):
                layer = i % c["layers"]
                ks = torch.roll(p["k_scale"][layer], shift, dims=1) if shift else p["k_scale"][layer]
                return plain(c["q"], p["k"][layer], p["v"][layer], ks, p["v_scale"][layer], c["tbl"], c["lens"])

            def run_kernel(i, p=p, c=c):
                layer = i % c["layers"]
                return kernel(c["q"], p["k_fp32"][layer], p["v_fp32"][layer], c["tbl"], c["lens"])

            ref = run_kernel(0)
            err = float((run_plain(0).float() - ref.float()).abs().max())
            control = float((run_plain(0, shift=1).float() - ref.float()).abs().max())
            row = {
                "kind": kind, "mode": mode, "max_abs_err": err, "control": "scales_one_row_off",
                "control_max_abs_err": control, "plain_ms": timed_ms(run_plain),
                "kernel_fp32_pools_ms": timed_ms(run_kernel),
            }
            out[f"{kind}_{mode}"] = row
            emit({"phase": "kv_quant_read", **row})
            if not err < TOL[torch.float32]:
                fail(f"kv_quant_read {kind} {mode}: the plain read is {err} from K1/K2 (>= {TOL[torch.float32]})")
            if not control > TOL[torch.float32]:
                fail(f"kv_quant_read {kind} {mode}: the control passes ({control}), which then proves nothing")
            del p
        del c
    return out


def pool_bytes(eng) -> int:
    """Device bytes of the engine's pools and scale leaves (no table)."""
    return sum(t.numel() * t.element_size() for n, t in eng.cache.items() if n != "tbl")


def serving_quantized_phase(cfg, params, device, legacy_tokens, bf16_pool_bytes, max_new_tokens=32) -> dict:
    """The serving phase's prompts and settings with ``quantize_kv="int8"``
    and ``"fp8"``, in the legacy and the fused walk (the fused engine first
    serves prompts from another seed, untimed, to capture its buckets).
    Quantized pools read through the plain path, so K1 and K2 must not run;
    the fused run's tokens must equal the legacy run's up to near-ties.
    Agreement with the bf16 legacy run is reported, not gated: random
    weights make near-ties, and int8 / e4m3 rows move logits more than a
    bf16 rounding does."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device,  # attn_impl="kernel": quantized pools must not reach K1/K2
    )
    prompts = serving_prompts(cfg, SEED)
    head = cfg.head_dim
    out = {"phase": "serving_quantized", "model": cfg.name, "bf16_pool_bytes": bf16_pool_bytes,
           "predicted_pool_ratio": (head + 4) / (2 * head)}
    for mode in ("int8", "fp8"):
        runs = {}
        for fused in (False, True):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng = InferenceEngine(cfg, params, quantize_kv=mode, fused=fused, **kw)
            if not any("no kernel" in str(w.message) for w in caught):
                fail(f"serving_quantized {mode}: no warning that quantized pools read plain under attn_impl='kernel'")
            warm = serving_prompts(cfg, SEED + 1)
            for p in warm if fused else [warm[0][:48]]:
                eng.submit(p, max_new_tokens=max_new_tokens if fused else 2)
            eng.run_until_drained()
            graphs = eng._graphs
            s0 = eng.stats()
            replay_before = dict(graphs.launches) if graphs is not None else {}
            captured_warm = graphs.captures if graphs is not None else 0
            since = eng.tracer.now()
            reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
            K.reset_launches()  # this run's main path starts here
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eager = dict(K.LAUNCHES)
            replayed = {k: v - replay_before[k] for k, v in graphs.launches.items()} if graphs is not None else {}
            s = eng.stats()
            steps = s["decode_steps"] - s0["decode_steps"]
            tick_tokens, tick_s = decode_ticks(eng, since)
            runs[fused] = reqs
            differ = differences(cfg, params, device, reqs, legacy_tokens)
            row = {
                "mode": mode, "fused": fused, "requests": len(reqs), "wall_s": wall,
                "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
                "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
                "decode_tick_p50_s": float(np.median([e.dur for e in eng.tracer.events
                                                      if e.name == "step" and e.ts >= since
                                                      and e.args.get("produced", 0) > 0])),
                "decode_tok_s": tick_tokens / tick_s, "output_tok_s": (s["tokens_out"] - s0["tokens_out"]) / wall,
                "dispatches_per_step": (s["dispatches_total"] - s0["dispatches_total"]) / steps,
                "cache_bytes": s["cache_bytes"], "pool_bytes": pool_bytes(eng),
                "pool_ratio_to_bf16": pool_bytes(eng) / bf16_pool_bytes,
                "alloc_blocks_in_use": s["alloc_blocks_in_use"],
                "eager_launches": eager, "replay_launches": replayed or None,
                "graphs_captured_timed": graphs.captures - captured_warm if graphs is not None else None,
                "requests_equal_to_bf16": len(reqs) - len(differ),
                "tokens_before_first_difference": [d["position"] for d in differ],
                "differences_from_bf16": differ,  # each with the bf16 run's top2_gap there
            }
            out[f"{mode}_{'fused' if fused else 'legacy'}"] = row
            emit({"phase": "serving_quantized", **row})
            if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
                fail(f"serving_quantized {mode} fused={fused}: requests did not all finish by length: "
                     f"{[(r.finish_reason, len(r.generated)) for r in reqs]}")
            if s["alloc_blocks_in_use"] != 0:
                fail(f"serving_quantized {mode} fused={fused}: {s['alloc_blocks_in_use']} blocks still in use")
            k1k2 = eager["paged_decode"] + eager["paged_prefill"] + sum(replayed.values())
            if k1k2:
                fail(f"serving_quantized {mode} fused={fused}: K1/K2 ran on quantized pools: {eager} {replayed}")
            del eng, graphs
            torch.cuda.empty_cache()
        # mixed ticks run decode rows through other shapes than the legacy
        # walk: held to the legacy run's tokens up to near-ties, as serving_fused
        differ = differences(cfg, params, device, runs[True], [list(r.generated) for r in runs[False]], mode)
        out[f"{mode}_fused_vs_legacy"] = differ
        if not all(x["near_tie"] for x in differ):
            fail(f"serving_quantized {mode}: the fused run's tokens differ from the legacy run's away from a near-tie: "
                 f"{differ}")
    for mode in ("int8", "fp8"):  # where an eager quantized decode step's time goes
        out[f"{mode}_decode_step_profile"] = profile_phase(cfg, params, device, quantize_kv=mode)
    if out["int8_legacy"]["pool_bytes"] != out["fp8_legacy"]["pool_bytes"]:
        fail(f"serving_quantized: int8 pools {out['int8_legacy']['pool_bytes']} B, fp8 {out['fp8_legacy']['pool_bytes']}")
    emit({"phase": "serving_quantized", "summary": {k: v for k, v in out.items() if not isinstance(v, dict)}})
    return out


TIER_GROUPS, TIER_PREFIX, TIER_TAIL = 8, 256, 32  # 8 prefixes of 8 full blocks, a 32-token tail each
TIER_NUM_BLOCKS = 49  # 48 usable blocks of 4 MiB: round 1's chains must leave the card
TIER_SPILL_BYTES = 512 << 20


def since_counts(h, counts0):
    """The observations of histogram ``h`` made after its bucket counts read
    ``counts0``, as a histogram of its own (min and max stay ``h``'s)."""
    from repro_torch.serving.metrics import Histogram

    d = Histogram(h.name, buckets=h.bounds)
    d.counts = [a - b for a, b in zip(h.counts, counts0)]
    d.count, d.min, d.max = sum(d.counts), h.min, h.max
    return d


def time_calls(eng) -> dict:
    """Time, on the host clock, each call of the engine's spill-tier steps
    (the gather at evict time, the spill pool's put and pop, the restore
    pass), by wrapping them on this engine instance; returns the dict the
    seconds add up in.  The calls run as before."""
    acc: dict[str, float] = {}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return call

    eng.run_restores = timed("restore_pass", eng.run_restores)
    if eng.spill is not None:
        eng.prefix._fetch = timed("gather", eng.prefix._fetch)
        eng.spill.put = timed("spill_put", eng.spill.put)
        eng.spill.pop = timed("spill_pop", eng.spill.pop)
    eng.scheduler._admit = timed("admit", eng.scheduler._admit)
    return acc


def tier_rounds(cfg, seed) -> list[list[list[int]]]:
    """Two rounds of 8 prompts: round 2 resubmits round 1's 8 prefixes with
    new tails."""
    rng = np.random.default_rng(seed)
    prefixes = [[int(t) for t in rng.integers(0, cfg.vocab_size, TIER_PREFIX)] for _ in range(TIER_GROUPS)]
    return [[p + [int(t) for t in rng.integers(0, cfg.vocab_size, TIER_TAIL)] for p in prefixes] for _ in range(2)]


def serving_tiered_phase(cfg, params, device, max_new_tokens=32) -> dict:
    """Tiered traffic on full-width olmo-1b: two rounds of 8 prompts that
    share, round to round, a 256-token prefix, against 48 usable blocks, so
    round 1's chains leave the card.  Arms: ``spill`` (512 MiB host tier,
    pool-native bytes), ``drop`` (evictions drop) and ``uncached`` (no
    prefix cache), and ``spill_budget_32`` (the tier with a restore budget
    of 32 blocks a pass in place of 4), in the legacy walk, and ``spill``
    and ``drop`` in the fused walk, each after an untimed pass of the same
    traffic from another seed.  A prefill budget of 0 puts every prompt through the same chunks
    (256, then 32) in every arm, so the legacy arms compute every K/V row
    alike and their tokens must be equal.  The fused arms' mixed ticks
    batch rows differently, so their tokens are held to the legacy spill
    arm's up to near-ties, as the serving_fused phase holds its own.
    Round 2's readings also split its time: each request's TTFT, the
    scheduler steps, the restore passes' seconds, and the spills and
    evictions its admissions caused."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=0, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device, num_blocks=TIER_NUM_BLOCKS,
    )
    arms = {
        "spill": dict(spill_bytes=TIER_SPILL_BYTES),
        "drop": {},
        "uncached": dict(prefix_cache=False),
        # every swap-in of the 4 slots' admissions in one restore pass,
        # where the default budget (4 blocks) takes 2 passes a request
        "spill_budget_32": dict(spill_bytes=TIER_SPILL_BYTES, restore_budget=32),
        "spill_fused": dict(spill_bytes=TIER_SPILL_BYTES, fused=True),
        "drop_fused": dict(fused=True),
    }
    rounds = tier_rounds(cfg, SEED)
    out = {"phase": "serving_tiered", "model": cfg.name, "num_blocks": TIER_NUM_BLOCKS,
           "spill_bytes": TIER_SPILL_BYTES, "prefix_tokens": TIER_PREFIX, "tail_tokens": TIER_TAIL}
    tokens = {}
    for arm, extra in arms.items():
        eng = InferenceEngine(cfg, params, **kw, **extra)
        if eng.fused:  # untimed: the same traffic from another seed captures the buckets
            for prompts in tier_rounds(cfg, SEED + 1):
                for p in prompts:
                    eng.submit(p, max_new_tokens=max_new_tokens)
                eng.run_until_drained()
        graphs = eng._graphs
        s0 = eng.stats()
        replay_before = dict(graphs.launches) if graphs is not None else {}
        captured_warm = graphs.captures if graphs is not None else 0
        restore_wait = eng.metrics.histogram("engine_restore_wait_seconds")
        wait0 = list(restore_wait.counts)
        host_s = time_calls(eng)
        K.reset_launches()  # this arm's main path starts here
        reqs, walls, starts = [], [], []
        for r_i, prompts in enumerate(rounds):
            starts.append(eng.tracer.now())
            host_s.clear()  # each round's own
            t0 = time.perf_counter()
            reqs.append([eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts])
            eng.run_until_drained()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if r_i == 0:
                s_mid = eng.stats()
        eager = dict(K.LAUNCHES)
        replayed = {k: v - replay_before[k] for k, v in graphs.launches.items()} if graphs is not None else {}
        s = eng.stats()
        d = lambda key, a=s, b=s0: a.get(key, 0) - b.get(key, 0)  # noqa: E731
        r2_hit, r2_prefill = d("prefix_hit_tokens", s, s_mid), d("prefill_tokens", s, s_mid)
        tokens[arm] = [list(r.generated) for rr in reqs for r in rr]
        waits = since_counts(restore_wait, wait0)
        r2_events = [e for e in eng.tracer.events if e.ts >= starts[1]]
        row = {
            "arm": arm, "fused": eng.fused, "wall_s": walls,
            "round2_ttft_p50_s": float(np.median([r.ttft for r in reqs[1]])),
            "round1_ttft_p50_s": float(np.median([r.ttft for r in reqs[0]])),
            "round2_ttft_s": [r.ttft for r in reqs[1]],  # in submission order
            "round2_steps": sum(e.name == "step" for e in r2_events),
            "round2_restore_s": sum(e.dur for e in r2_events if e.name == "restore"),
            "round2_spills": sum(e.name == "spill" for e in r2_events),
            "round2_evictions": sum(e.name == "evict" for e in r2_events),
            "round2_first_step_s": next((e.dur for e in r2_events if e.name == "step"), None),
            "round2_host_s": dict(host_s),  # wall of the tier's calls: gather, spill put, pop, restore pass
            "tpot_p50_s": float(np.median([r.tpot for rr in reqs for r in rr])),
            "prefill_tokens": d("prefill_tokens"), "round2_prefill_tokens": r2_prefill,
            "prefix_hit_tokens": d("prefix_hit_tokens"),
            "round2_prefix_hit_rate": r2_hit / (r2_hit + r2_prefill) if r2_hit + r2_prefill else 0.0,
            "prefix_hit_rate": s.get("prefix_hit_rate"),
            "evictions_spilled": d("alloc_evictions_spilled"), "evictions_dropped": d("alloc_evictions_dropped"),
            "restores": d("restores"), "restores_pending": s.get("restores_pending"),
            "spill_hit_tokens": d("spill_hit_tokens"), "spill_bytes_used": s.get("spill_bytes_used"),
            "spill_blocks": s.get("spill_blocks"), "spill_staged": s.get("spill_staged"),
            "spill_drops": s.get("spill_drops"),
            "restore_wait_p50_s": waits.percentile(50), "restore_waits": waits.count,
            "alloc_blocks_in_use": s["alloc_blocks_in_use"],
            "eager_launches": eager, "replay_launches": replayed or None,
            "k1_launches": eager["paged_decode"] + replayed.get("paged_decode", 0),
            "k2_launches": eager["paged_prefill"] + replayed.get("paged_prefill", 0),
            "graphs_captured_timed": graphs.captures - captured_warm if graphs is not None else None,
        }
        out[arm] = row
        emit({"phase": "serving_tiered", **row})
        if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for rr in reqs for r in rr):
            fail(f"serving_tiered {arm}: requests did not all finish by length")
        if s["alloc_blocks_in_use"] != 0:
            fail(f"serving_tiered {arm}: {s['alloc_blocks_in_use']} blocks still in use")
        if row["k2_launches"] <= 0 or row["k1_launches"] <= 0:
            fail(f"serving_tiered {arm}: K1/K2 did not both run: eager {eager}, replays {replayed}")
        if arm.startswith("spill"):
            if not (row["evictions_spilled"] > 0 and row["restores"] > 0 and row["spill_hit_tokens"] > 0):
                fail(f"serving_tiered {arm}: the tier did not work: {row}")
            if row["restores_pending"] != 0:
                fail(f"serving_tiered {arm}: {row['restores_pending']} restores still pending")
        if arm.startswith("drop") and row["evictions_dropped"] <= 0:
            fail(f"serving_tiered drop: no eviction, so round 1's chains never left the card: {row}")
        if eng.fused:
            flat = [r for rr in reqs for r in rr]
            differ = differences(cfg, params, device, flat, tokens["spill"])
            row["differences_from_legacy_spill"] = differ
            if not all(x["near_tie"] for x in differ):
                fail(f"serving_tiered: fused spill tokens differ from the legacy spill arm's away from a near-tie: "
                     f"{differ}")
        del eng, graphs
        torch.cuda.empty_cache()
    for arm in ("drop", "uncached", "spill_budget_32"):
        differ = [i for i, (a, b) in enumerate(zip(tokens["spill"], tokens[arm])) if a != b]
        out[f"requests_differing_spill_vs_{arm}"] = differ
        if differ:
            fail(f"serving_tiered: the spill arm's tokens differ from the {arm} arm's in requests {differ}")
    out["fused_requests_differing"] = {arm: len(out[arm]["differences_from_legacy_spill"])
                                       for arm in ("spill_fused", "drop_fused")}
    emit({"phase": "serving_tiered", "summary": {k: v for k, v in out.items() if k not in arms}})
    return out


def spill_restore_phase(cfg, device, iters=10) -> dict:
    """One block of a full-width olmo-1b bf16 pool through the host tier:
    gathered, put with ``staging_depth=0`` (so it reaches host memory),
    popped and restored into another block: the rows must be bit-equal
    (``"cache"`` mode), and K2 over a table that points at the restored
    block must give the output of K2 over the original, bit for bit.  The
    control restores into the neighbouring block, which the same checks
    must reject.  Times (host clock, the card synchronized): the gather and
    device-to-host copy of one block, and a 4-block restore from host
    memory, as the engine's restore pass runs it (the copies to the card,
    the stack, one in-place scatter)."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import init_paged_cache
    from repro_torch.serving import SpillPool, gather_block_rows, restore_block_rows

    N = 1 + NB + 8
    cache = init_paged_cache(cfg, N, BLOCK_SIZE, 1, NB, torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g, device=device))
    src, dst = 3, NB + 2  # dst lies outside the table's blocks 1..NB
    control = {n: t.clone() for n, t in cache.items()}
    pool = SpillPool(1 << 30, mode="cache", staging_depth=0)
    h = pool.put(gather_block_rows(cache, src))
    on_host = all(t.device.type == "cpu" for t in pool._payload[h].values())
    rows = pool.pop(h)

    def restore(c, block):
        restore_block_rows(c, torch.tensor([block], dtype=torch.int32, device=device),
                           {n: t.to(device)[:, None] for n, t in rows.items()})

    restore(cache, dst)
    restore(control, dst + 1)  # the control: into the neighbouring block
    torch.cuda.synchronize()

    def readings(c) -> dict:
        H, hd = cfg.num_heads, cfg.head_dim
        q = torch.randn((1, PREFILL_C, H, hd), generator=torch.Generator(device=device).manual_seed(5), device=device)
        start = torch.tensor([PREFILL_START], dtype=torch.int32, device=device)
        base = torch.arange(1, 1 + NB, dtype=torch.int32, device=device)[None]
        moved = base.clone()
        moved[0, src - 1] = dst
        before = dict(K.LAUNCHES)
        outs = [K.paged_prefill_attention(q, c["k"][l], c["v"][l], t, start) for l in (0, cfg.num_layers - 1)
                for t in (base, moved)]
        K.LAUNCHES.update(before)  # check launches, not the main path's
        return {
            "rows_equal": all(torch.equal(c[n][:, dst], c[n][:, src]) for n in ("k", "v")),
            "k2_equal": all(torch.equal(outs[i], outs[i + 1]) for i in (0, 2)),
        }

    sound, ctrl = readings(cache), readings(control)

    def wall(fn) -> float:
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    payload_bytes = sum(t.numel() * t.element_size() for t in rows.values())
    host = [{n: t.clone() for n, t in rows.items()} for _ in range(4)]
    blocks4 = torch.tensor([NB + 1, NB + 2, NB + 3, NB + 4], dtype=torch.int32, device=device)
    d2h_ms = wall(lambda: pool._compress(gather_block_rows(cache, src)))
    restore4_ms = wall(lambda: restore_block_rows(
        cache, blocks4, {n: torch.stack([p[n].to(device) for p in host], dim=1) for n in rows}))
    staged4_ms = wall(lambda: restore_block_rows(
        cache, blocks4, {n: torch.stack([cache[n][:, src]] * 4, dim=1) for n in rows}))
    out = {
        "phase": "spill_restore", "model": cfg.name, "block_bytes": payload_bytes, "on_host": on_host,
        "sound": sound, "control": ctrl,
        "gather_d2h_one_block_ms": d2h_ms, "d2h_gb_s": payload_bytes / d2h_ms / 1e6,
        "restore_4_blocks_from_host_ms": restore4_ms, "h2d_gb_s": 4 * payload_bytes / restore4_ms / 1e6,
        "restore_4_blocks_on_device_ms": staged4_ms,
    }
    emit(out)
    if not on_host:
        fail("spill_restore: the payload never reached host memory")
    if not (sound["rows_equal"] and sound["k2_equal"]):
        fail(f"spill_restore: the round trip is not exact: {sound}")
    if ctrl["rows_equal"] or ctrl["k2_equal"]:
        fail(f"spill_restore: the control (a restore into the neighbouring block) passes {ctrl}")
    return out


# ---------------------------------------------------------------------------
# phase 5g: the Fig. 9 harness at full width
# ---------------------------------------------------------------------------

FIG9_DENSE_BATCH, FIG9_MAX_SEQ, FIG9_PAGED_BATCH = 4, 512, 16  # paged: 4 x 512 / 32 = 64 blocks
FIG9_SHARED = dict(n=16, system_len=96, tail=8)  # a 3-block system prompt, 8-token tails
JOULES_REL = 1e-9  # per-request joules against the engine's: float sums of the same terms
# dense against paged tokens: a first difference must sit at a top-2 gap
# below this.  The dense prefill attends its fp32 K/V unrounded while the
# paged chunks attend bf16 rows, so near-ties flip.  Readings on an H100
# 80GB HBM3 at 700 W: the sound walks differ at gaps up to 0.011; the
# control (each admitted ring shifted one slot) differs at gaps far above
# the limit (PERF.md, PR 21)
FIG9_TIE_TOL = 2e-2
FIG9_CONTROL_NEW = 8  # the control's tokens: its fault shows from the second token on


def ring_one_slot_off(engine_cls):
    """The control of the dense-against-paged gate: a dense engine whose
    admission leaves each prompt's K/V one ring slot late (positions
    unchanged), so every decode step reads its neighbour's keys."""

    class RingOneSlotOff(engine_cls):
        def _admit_blocking(self, req, slot):
            admitted = super()._admit_blocking(req, slot)
            for name in ("k", "v"):
                if "self" in self.cache:  # the vlm layout: (G, g, B, W, KV, hd) rings
                    leaf = self.cache["self"][name]
                    leaf[:, :, slot] = leaf[:, :, slot].roll(1, dims=2)
                else:
                    self.cache[name][:, slot] = self.cache[name][:, slot].roll(1, dims=1)
            return admitted

    return RingOneSlotOff


def fig9_readings(s: dict) -> dict:
    """What ``fig9`` prints of one harness arm's stats."""
    keys = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "tok_per_s", "wall_s", "decode_steps",
            "decode_tick_p50_s", "tokens_out", "peak_active", "cache_bytes", "alloc_peak_in_use", "alloc_capacity",
            "alloc_blocks_in_use", "prefill_tokens", "prefix_hit_tokens", "prefix_hit_rate", "acceptance_rate",
            "accepted_per_step", "drafted_tokens", "accepted_tokens", "energy_joules", "joules_per_token",
            "request_joules", "dispatches_per_step", "host_syncs_per_step", "profile_s")
    return {k: s[k] for k in keys if k in s}


def fig9_phase(cfg, params, device, max_new_tokens=32) -> dict:
    """``repro_torch.benchmarks.llm_inference``'s closed-loop arms at full
    width: dense (4 slots, max_seq 512) against paged at the same cache
    bytes (block 32, 64 blocks, 16 slots) on 16 requests of 64-320 prompt
    tokens; the shared-system-prompt A/B (prefix cache off / on, 4 slots,
    prefill budget 128); speculative decoding off / n-gram / self-draft on
    the repetitive-suffix prompts (``spec_k = 4``, 24 new tokens).  Then
    one profiled run of each cache kind on the first arms' prompts, and the
    fused arm (legacy and fused engines, each after a warm-up round) on the
    shared prompts.  bf16 caches, an ``eos_token`` outside the vocab.

    Gates: the dense cache is ``models.cache_bytes(cfg, 4, 512, bf16)`` and
    the paged one no larger; dense and paged tokens equal up to near-ties
    (``differences``), as the fused arm's against its legacy run; cached
    prefill tokens at most half the uncached, hit rate above 0; the
    self-draft emits more than one token per slot-step; no block in use
    after any drain; the control (a dense engine whose admitted rings sit
    one slot off) differs from the dense tokens away from a near-tie; K1 and K2 ran; the profiled runs' tokens equal the
    unprofiled runs'; per-request joules sum to the engine's.  The n-gram
    arm's acceptance is a reading: random weights need not continue the
    pattern."""
    from types import SimpleNamespace

    from repro_torch.benchmarks import llm_inference as bench
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import cache_bytes
    from repro_torch.serving import InferenceEngine

    prompts = serving_prompts(cfg, SEED) + serving_prompts(cfg, SEED + 2)
    shared = bench.shared_prefix_prompts(**FIG9_SHARED)
    sizes = dict(
        device=device, cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, max_seq=FIG9_MAX_SEQ,
        block_size=BLOCK_SIZE,
    )
    K.reset_launches()  # the harness's closed-loop arms start here
    arms = bench.closed_loop(
        cfg, params, dense_batch=FIG9_DENSE_BATCH, paged_batch=FIG9_PAGED_BATCH, prompts=prompts,
        max_new=max_new_tokens, shared=shared, shared_budget=128, spec_k=SPEC_K, **sizes,
    )
    launches = dict(K.LAUNCHES)
    dense_kw, paged_kw = bench.dense_paged_kwargs(
        dense_batch=FIG9_DENSE_BATCH, paged_batch=FIG9_PAGED_BATCH, **sizes)
    control = bench.drive(ring_one_slot_off(InferenceEngine)(cfg, params, **dense_kw), prompts,
                          max_new=FIG9_CONTROL_NEW)  # the control of the dense-against-paged gate
    for kind, kw in (("dense", dense_kw), ("paged", paged_kw)):  # the same arms, profiled
        arms[f"{kind}_profiled"] = bench.drive(InferenceEngine(cfg, params, profile=True, **kw), prompts,
                                               max_new=max_new_tokens)
    # where a decode tick's time goes, the dense ring against the paged pools
    decode_profiles = {kind: profile_phase(cfg, params, device, cache_kind=kind) for kind in ("dense", "paged")}
    fused_kw = dict(max_batch=bench.SHARED_BATCH, cache_kind="paged", prefix_cache=True, prefill_budget=128, **sizes)
    fused = {label: bench.fused_arm(cfg, params, shared, fused=f, **fused_kw)
             for label, f in (("legacy", False), ("fused", True))}

    out = {"phase": "fig9", "model": cfg.name, "requests": len(prompts), "max_new_tokens": max_new_tokens,
           "launches": launches, "decode_step_profiles": decode_profiles}
    for name, s in arms.items():
        out[name] = fig9_readings(s)
        emit({"phase": "fig9", "arm": name, **out[name]})
    for label, a in fused.items():
        row = {k: v for k, v in a.items() if k != "tokens"}
        out[f"fused_arm_{label}"] = row
        emit({"phase": "fig9", "arm": f"fused_arm_{label}", **row, "model_step_s_is": bench.MODELLED})

    as_reqs = lambda ps, toks: [SimpleNamespace(prompt=p, generated=t) for p, t in zip(ps, toks)]  # noqa: E731
    dense, paged = arms["dense"], arms["paged"]
    out["dense_vs_paged"] = differences(cfg, params, device, as_reqs(prompts, paged["tokens"]), dense["tokens"],
                                        tol=FIG9_TIE_TOL)
    out["control_vs_dense"] = differences(cfg, params, device, as_reqs(prompts, control["tokens"]),
                                          dense["tokens"], tol=FIG9_TIE_TOL)
    out["fused_vs_legacy"] = differences(cfg, params, device, as_reqs(shared, fused["fused"]["tokens"]),
                                         fused["legacy"]["tokens"])
    expect_bytes = cache_bytes(cfg, FIG9_DENSE_BATCH, FIG9_MAX_SEQ, torch.bfloat16)
    emit({"phase": "fig9", "summary": {
        "launches": launches, "dense_cache_bytes": dense["cache_bytes"], "expected_dense_cache_bytes": expect_bytes,
        "paged_cache_bytes": paged["cache_bytes"], "peak_active": {"dense": dense["peak_active"],
                                                                   "paged": paged["peak_active"]},
        "dense_vs_paged": out["dense_vs_paged"], "fused_vs_legacy": out["fused_vs_legacy"],
        "tie_limit": FIG9_TIE_TOL, "control": "ring_one_slot_off", "control_vs_dense": out["control_vs_dense"],
        "ngram_acceptance_rate": arms["spec_ngram"].get("acceptance_rate"),
        "ngram_tokens_per_verify": arms["spec_ngram"].get("accepted_per_step"),
    }})
    if dense["cache_bytes"] != expect_bytes or paged["cache_bytes"] > dense["cache_bytes"]:
        fail(f"fig9: cache bytes dense {dense['cache_bytes']} (expected {expect_bytes}), paged {paged['cache_bytes']}")
    for name, s in arms.items():
        if not all(r == "length" for r in s["finish_reasons"]):
            fail(f"fig9 {name}: requests did not all finish by length: {s['finish_reasons']}")
        if s.get("alloc_blocks_in_use", 0) != 0:
            fail(f"fig9 {name}: {s['alloc_blocks_in_use']} blocks in use after the drain")
        if abs(s["request_joules"] - s["energy_joules"]) > JOULES_REL * s["energy_joules"] or s["energy_joules"] <= 0:
            fail(f"fig9 {name}: requests' joules {s['request_joules']} against the engine's {s['energy_joules']}")
    for kind in ("dense", "paged"):
        if arms[f"{kind}_profiled"]["tokens"] != arms[kind]["tokens"]:
            fail(f"fig9: the profiled {kind} run's tokens differ from the unprofiled run's")
    if not all(d["near_tie"] for d in out["dense_vs_paged"] + out["fused_vs_legacy"]):
        fail(f"fig9: tokens differ away from a near-tie: {out['dense_vs_paged']} {out['fused_vs_legacy']}")
    if all(d["near_tie"] for d in out["control_vs_dense"]):
        fail(f"fig9: the control (rings one slot off) passes the tie gate: {out['control_vs_dense']}")
    cached, uncached = arms["prefix_cached"], arms["prefix_uncached"]
    if not (2 * cached["prefill_tokens"] <= uncached["prefill_tokens"] and cached["prefix_hit_rate"] > 0):
        fail(f"fig9: cached prefill tokens {cached['prefill_tokens']} against {uncached['prefill_tokens']}, "
             f"hit rate {cached['prefix_hit_rate']}")
    if not arms["spec_draft"]["accepted_per_step"] > 1.0:
        fail(f"fig9: the self-draft emits {arms['spec_draft']['accepted_per_step']} tokens per slot-step")
    if not (launches["paged_decode"] > 0 and launches["paged_prefill"] > 0):
        fail(f"fig9: the paged arms launched no K1 or no K2: {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 5h: the always-on front-ends
# ---------------------------------------------------------------------------

# the serving_fused phase's engine settings
FRONTEND_ENGINE = dict(max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128,
                       cache_dtype=torch.bfloat16, fused=True, attn_impl="kernel")
ROUTER_SYSTEM_LEN = 3 * BLOCK_SIZE  # the harness's tenant system prompts: 3 full blocks
POLL_S = 0.05  # the frontend phase's /stats, /metrics and /healthz polls


def same_up_to_ties(cfg, params, device, prompts, tokens, reference, found=None) -> bool:
    """Token identity on the card: every request's tokens as many as the
    reference's and equal to them, or first different where the
    reference's top-2 logit gap is below ``PATH_TOL`` (``differences``).
    ``found`` collects each call's differences."""
    from types import SimpleNamespace

    reqs = [SimpleNamespace(prompt=p, generated=t) for p, t in zip(prompts, tokens)]
    differ = differences(cfg, params, device, reqs, reference)
    if found is not None:
        found.append(differ)
    lengths = len(tokens) == len(reference) and all(len(a) == len(b) for a, b in zip(tokens, reference))
    return lengths and all(d["near_tie"] for d in differ)


def seed_one_off(router_cls):
    """The control of the failover gate: a router whose resume seeds the
    delivered tokens one position late (the prompt's last token first, the
    last delivered token left out), so a failed-over request continues
    from a context shifted by one."""

    class SeedOneOff(router_cls):
        def _place(self, rreq, rep):
            super()._place(rreq, rep)
            if rreq.generated:
                rreq.engine_req.generated = [rreq.prompt[-1]] + rreq.generated[:-1]

    return SeedOneOff


async def read_response(reader, t0: float, *, on_first=None, drop_after_first=False) -> dict:
    """One HTTP response: its status and either its SSE frames (event,
    data, seconds since ``t0``) or its body (JSON or text)."""
    import asyncio

    head = (await reader.readuntil(b"\r\n\r\n")).decode()
    out = {"status": int(head.split(" ", 2)[1])}
    if "text/event-stream" not in head:
        body = (await reader.read()).decode()
        out["body"] = json.loads(body) if "application/json" in head else body
        return out
    out["frames"] = []
    while True:
        try:
            block = (await reader.readuntil(b"\n\n")).decode()
        except asyncio.IncompleteReadError:
            return out  # the stream ended without a done frame
        fields = dict(ln.split(": ", 1) for ln in block.strip().split("\n"))
        out["frames"].append((fields["event"], json.loads(fields["data"]), time.perf_counter() - t0))
        if fields["event"] == "token" and len(out["frames"]) == 1 and on_first is not None:
            on_first()
        if fields["event"] == "done" or drop_after_first:
            return out


async def send(reader, writer, method: str, path: str, payload=None, **kw) -> dict:
    """Send one request on an open connection and read its response."""
    t0 = time.perf_counter()
    body = json.dumps(payload).encode() if payload is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    try:
        return await read_response(reader, t0, **kw)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def http_call(port: int, method: str, path: str, payload=None, **kw) -> dict:
    import asyncio

    return await send(*await asyncio.open_connection("127.0.0.1", port), method, path, payload, **kw)


def stream_readings(r: dict) -> dict:
    """Tokens of one SSE response, whether its token frames are contiguous
    by ``index``, its done frame, and the client's TTFT and TPOT from the
    frames' arrival times."""
    tokens, times = [], []
    contiguous = r["status"] == 200
    for event, data, t in r.get("frames", []):
        if event == "token":
            contiguous &= data["index"] == len(tokens)
            tokens += data["tokens"]
            times += [t] * len(data["tokens"])
    frames = r.get("frames", [])
    done = frames[-1][1] if frames and frames[-1][0] == "done" else None
    return {"tokens": tokens, "contiguous": contiguous, "done": done, "ttft_s": times[0] if times else None,
            "tpot_s": (times[-1] - times[0]) / (len(times) - 1) if len(times) > 1 else None}


async def serve_and_drive(engine, prompts, max_new: int, *, whole=None, dropped=None, poll=False) -> dict:
    """``serve_http`` over ``engine`` on a loopback port, driven by one SSE
    client per prompt, all at once, plus optionally a ``"stream": false``
    request of ``whole``, a client that closes its socket after the first
    token frame of ``dropped``, and ``/stats``, ``/metrics`` and
    ``/healthz`` polls every ``POLL_S``.  Once every SSE client has its
    first token the service is told to shut down (``shutdown_event``): on
    two connections opened before, a ``/healthz`` probe and a new request
    are sent once the drain began."""
    import asyncio

    from repro_torch.serving.http import serve_http

    stop = asyncio.Event()
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.create_task(serve_http(engine, port=0, shutdown_event=stop, drain_timeout_s=300.0,
                                            on_ready=ready.set_result))
    front = await ready
    port = front.port
    all_first = asyncio.Event()
    firsts = []

    def first():
        firsts.append(time.perf_counter())
        if len(firsts) == len(prompts):
            all_first.set()

    polls = []

    async def poller():
        while True:
            for path in ("/stats", "/metrics", "/healthz"):
                if stop.is_set():
                    return
                try:
                    r = await http_call(port, "GET", path)
                except ConnectionError:
                    return  # the acceptor closed
                graphs = r["body"].get("graphs_captured", 0) if path == "/stats" else None
                polls.append({"path": path, "status": r["status"], "graphs_captured": graphs,
                              "draining": front.async_engine.draining})
            await asyncio.sleep(POLL_S)

    t0 = time.perf_counter()
    polling = asyncio.create_task(poller()) if poll else None
    gen = "/v1/generate"
    clients = [asyncio.create_task(http_call(port, "POST", gen, {"prompt": p, "max_new_tokens": max_new},
                                             on_first=first)) for p in prompts]
    extra = {}
    if whole is not None:
        extra["whole"] = asyncio.create_task(http_call(
            port, "POST", gen, {"prompt": whole, "max_new_tokens": max_new, "stream": False}))
    if dropped is not None:
        extra["dropped"] = asyncio.create_task(http_call(
            port, "POST", gen, {"prompt": dropped, "max_new_tokens": max_new}, drop_after_first=True))
    await all_first.wait()
    probes = [await asyncio.open_connection("127.0.0.1", port) for _ in range(2)]
    stop.set()
    while not front.async_engine.draining:
        await asyncio.sleep(0.001)
    inflight = sum(not c.done() for c in clients)
    healthz = await send(*probes[0], "GET", "/healthz")
    late = await send(*probes[1], "POST", gen, {"prompt": prompts[0][:8], "max_new_tokens": 2})
    streams = await asyncio.gather(*clients)
    extra = {k: await t for k, t in extra.items()}
    if polling is not None:
        await polling
    await server
    return {"streams": [stream_readings(r) for r in streams], "extra": extra, "polls": polls,
            "healthz_draining": healthz, "late_submission": late, "inflight_at_drain": inflight,
            "wall_s": time.perf_counter() - t0, "async_engine": front.async_engine}


def frontend_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """The serving phase's 8 prompts through the HTTP/SSE service
    (``serve_http`` over an ``AsyncEngine`` over a fresh fused engine with
    ``serving_fused``'s settings), 8 concurrent SSE clients, one
    ``"stream": false`` request of the first prompt, one client that drops
    its socket after its first token, ``/stats``, ``/metrics`` and
    ``/healthz`` polls while the engine captures its graphs, then a
    graceful drain with requests still in flight.

    Gates: every stream's token frames are contiguous by ``index`` and end
    in ``done`` after 32 tokens by length; the streams' tokens (and the
    whole request's) equal the serving phase's up to near-ties; the dropped
    client's request finishes ``"cancelled"``; every poll before the drain
    answers 200 and some ``/stats`` poll lands between the first and the
    last capture; while draining, ``/healthz`` and a new request get 503
    on connections opened before it; after the drain no block is in use
    and allocations equal frees; every step ran on one stepping thread,
    gone after the drain; the replays ran K1 and K2."""
    import asyncio
    import gc

    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    prompts = serving_prompts(cfg, SEED)
    dropped = serving_prompts(cfg, SEED + 3)[0]
    gc.collect()  # what earlier phases left in cycles, out of this phase's peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, eos_token=cfg.padded_vocab, device=device, **FRONTEND_ENGINE)
    K.reset_launches()  # the main path's run starts here
    run = asyncio.run(serve_and_drive(eng, prompts, max_new_tokens, whole=prompts[0], dropped=dropped, poll=True))
    eager = dict(K.LAUNCHES)  # the captures' warm-up runs
    aeng = run.pop("async_engine")
    graphs = eng._graphs
    s = eng.stats()
    streams = run["streams"]
    whole = run["extra"]["whole"]
    dropped_reasons = [r.finish_reason for r in eng.done if r.prompt == dropped]
    by_id = {r.req_id: r for r in eng.done}
    served = [by_id[st["done"]["req_id"]] for st in streams if st["done"]]  # the SSE clients' requests
    found = []
    sound = same_up_to_ties(cfg, params, device, prompts + prompts[:1],
                            [st["tokens"] for st in streams] + [whole["body"]["tokens"]],
                            legacy_tokens + legacy_tokens[:1], found)
    stats_polls = [p for p in run["polls"] if p["path"] == "/stats"]
    during_capture = sum(0 < p["graphs_captured"] < graphs.captures for p in stats_polls)
    before_drain = sorted({p["status"] for p in run["polls"] if not p["draining"]})
    out = {
        "phase": "frontend", "model": cfg.name, "clients": len(prompts), "max_new_tokens": max_new_tokens,
        "wall_s": run["wall_s"],
        "client_ttft_p50_s": float(np.median([st["ttft_s"] for st in streams])),
        "client_tpot_p50_s": float(np.median([st["tpot_s"] for st in streams])),
        "engine_ttft_p50_s": float(np.median([r.ttft for r in served])),
        "engine_tpot_p50_s": float(np.median([r.tpot for r in served])),
        "dispatches_per_step": s["dispatches_per_step"], "host_syncs_per_step": s["host_syncs_per_step"],
        "ticks": tick_kinds(eng, float("-inf")),
        "graphs_captured": graphs.captures, "capture_s": graphs.capture_s,
        "replay_launches": dict(graphs.launches), "eager_launches": eager,
        "step_threads": sorted(aeng.step_threads), "stepping_thread_shut_down": aeng._executor is None,
        "polls": len(run["polls"]), "stats_polls_during_capture": during_capture,
        "poll_statuses_before_drain": before_drain,
        "inflight_at_drain": run["inflight_at_drain"],
        "healthz_draining": run["healthz_draining"], "late_submission": run["late_submission"],
        "dropped_finish": dropped_reasons, "whole": {k: v for k, v in whole["body"].items() if k != "tokens"},
        "done_reasons": [st["done"]["reason"] if st["done"] else None for st in streams],
        "alloc_blocks_in_use": s["alloc_blocks_in_use"], "allocs": s["alloc_total_allocs"],
        "frees": s["alloc_total_frees"], "requests_aborted": s["requests_aborted"],
        "differences": found[0], "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    if not all(st["contiguous"] and st["done"] and st["done"]["reason"] == "length"
               and len(st["tokens"]) == max_new_tokens for st in streams):
        fail(f"frontend: a stream is not contiguous or did not end by length: {out['done_reasons']}")
    if whole["status"] != 200 or whole["body"]["reason"] != "length" or not sound:
        fail(f"frontend: tokens differ from the serving phase's away from a near-tie: {found}")
    if dropped_reasons != ["cancelled"]:
        fail(f"frontend: the dropped client's request finished {dropped_reasons}")
    if before_drain != [200] or during_capture < 1:
        fail(f"frontend: polls answered {before_drain}, {during_capture} /stats polls between captures")
    if run["healthz_draining"]["status"] != 503 or run["late_submission"]["status"] != 503:
        fail(f"frontend: while draining /healthz gave {run['healthz_draining']}, a new request "
             f"{run['late_submission']}")
    if s["alloc_blocks_in_use"] != 0 or s["alloc_total_allocs"] != s["alloc_total_frees"]:
        fail(f"frontend: {s['alloc_blocks_in_use']} blocks in use after the drain, "
             f"{s['alloc_total_allocs']} allocs against {s['alloc_total_frees']} frees")
    if len(aeng.step_threads) != 1 or "MainThread" in aeng.step_threads or aeng._executor is not None:
        fail(f"frontend: steps ran on {aeng.step_threads}")
    if not (graphs.launches["paged_decode"] > 0 and graphs.launches["paged_prefill"] > 0):
        fail(f"frontend: the graph replays ran no K1 or no K2: {graphs.launches}")
    del eng, aeng, graphs  # the engine and its graphs hold cycles
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_launches(rows) -> dict:
    """K1/K2 launches of the router arms' replicas: eager calls (the
    captures' warm-ups) and graph replays, summed over replicas and arms."""
    out = {"eager": {}, "replays": {}}
    for row in rows:
        for rid, stats in row["per_replica"].items():
            for name, n in row["replica_launches"][rid].items():
                out["eager"][name] = out["eager"].get(name, 0) + n
            for name, n in stats.get("graph_launches", {}).items():
                out["replays"][name] = out["replays"].get(name, 0) + n
    return out


def router_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """``repro_torch.benchmarks.llm_inference.run_router`` at full width
    with ``serving_fused``'s engine settings: 1 replica, 2 with affinity,
    2 with random routing, 2 with replica 0 crashed halfway through the
    affinity arm's steps, on the harness's tenant prompts with 3-block (96
    token) system prompts.  Its gates are the reference's with token
    identity up to near-ties (``same_up_to_ties``): no lost request, at
    least one failover, replica 0 dead, affinity's hit rate above random's
    and the modelled scaling (on the virtual clock, where replicas run in
    parallel; on one card they step in turns, so no wall-clock scaling is
    claimed).  The control: the failover arm again under a router that
    resumes one position off (``seed_one_off``), which the token gate must
    reject.  Then a 2-replica ``Router`` behind ``serve_http`` serves 4 SSE
    requests (two prompt families, one a replica), drained gracefully."""
    import asyncio
    import gc

    from repro_torch.benchmarks import llm_inference as bench
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import FaultPlan, ManualClock, Router

    prompts = bench.tenant_prompts(system_len=ROUTER_SYSTEM_LEN)
    kw = dict(FRONTEND_ENGINE, eos_token=cfg.padded_vocab)
    found = []

    def same(tokens, reference):
        return same_up_to_ties(cfg, params, device, prompts, tokens, reference, found)

    K.reset_launches()  # the router arms start here
    rows = bench.run_router(cfg, params, device=device, prompts=prompts, same_tokens=same, **kw)
    launches = fleet_launches(rows)  # the replicas' own: the token checks' K2 calls are not counted
    arms = {r["name"].removeprefix("llm_inference_router_"): r for r in rows}
    keys = ("tok_per_s", "wall_tok_per_s", "wall_s", "makespan_s", "prefix_hit_rate", "failovers", "retries",
            "replica_states", "requests_done", "requests_failed", "tokens_out", "prefill_tokens", "peak_mem_bytes",
            "replica_steps", "crash_at_step")
    out = {"phase": "router", "model": cfg.name, "requests": len(prompts), "time_base": rows[0]["time_base"],
           "arms": {name: {k: r.get(k) for k in keys} for name, r in arms.items()},
           "speedup_vs_single_modelled": arms["affinity"]["speedup_vs_single"],
           "wall_speedup_vs_single": arms["affinity"]["wall_tok_per_s"] / arms["single"]["wall_tok_per_s"],
           "launches": launches, "differences": found}
    for name, r in out["arms"].items():
        emit({"phase": "router", "arm": name, **r})

    # the control: the failover arm resumed one position off
    clock = ManualClock()
    control = bench.make_router(cfg, params, 2, clock=clock, router_cls=seed_one_off(Router), device=device,
                                fault_plans={0: FaultPlan(crash_at_step=arms["failover"]["crash_at_step"])}, **kw)
    cs, control_tokens = bench.drive_router(control, clock, prompts)
    del control
    gc.collect()
    torch.cuda.empty_cache()
    control_found = []
    control_passes = same_up_to_ties(cfg, params, device, prompts, control_tokens, arms["single"]["tokens"],
                                     control_found)
    out["control"] = {"failovers": cs["failovers"], "differences": control_found[0], "passes": control_passes}

    # the --replicas 2 --http path: a fleet behind the HTTP/SSE service
    http_prompts = serving_prompts(cfg, SEED)[:2] + serving_prompts(cfg, SEED + 2)[:2]
    fleet = bench.make_router(cfg, params, 2, clock=None, device=device, **kw)
    K.reset_launches()  # the fleet's service starts here
    run = asyncio.run(serve_and_drive(fleet, http_prompts, max_new_tokens))
    aeng = run.pop("async_engine")
    fs = fleet.stats()
    http_launches = fleet_launches([{"per_replica": fs["per_replica"],
                                     "replica_launches": {r.id: r.launches for r in fleet.replicas}}])
    http_found = []
    http_sound = same_up_to_ties(cfg, params, device, http_prompts[:2], [st["tokens"] for st in run["streams"][:2]],
                                 legacy_tokens[:2], http_found)
    out["http"] = {
        "requests": len(http_prompts), "wall_s": run["wall_s"],
        "client_ttft_p50_s": float(np.median([st["ttft_s"] for st in run["streams"]])),
        "client_tpot_p50_s": float(np.median([st["tpot_s"] for st in run["streams"]])),
        "done_reasons": [st["done"]["reason"] if st["done"] else None for st in run["streams"]],
        "replica_states": fs["replica_states"], "failovers": fs["failovers"],
        "served_per_replica": {i: s["requests_done"] for i, s in fs["per_replica"].items()},
        "blocks_in_use": {i: s["alloc_blocks_in_use"] for i, s in fs["per_replica"].items()},
        "launches": http_launches, "step_threads": sorted(aeng.step_threads),
        "healthz_draining": run["healthz_draining"], "inflight_at_drain": run["inflight_at_drain"],
        "differences": http_found[0],
    }
    del fleet, aeng
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "router", "summary": {k: v for k, v in out.items() if k != "arms"}})
    out["tokens"] = {name: r["tokens"] for name, r in arms.items()}  # replicas_tp's reference
    if control_passes or cs["failovers"] < 1:
        fail(f"router: the control (resume one position off) passes the token gate: {out['control']}")
    h = out["http"]
    if not all(st["contiguous"] and st["done"] and st["done"]["reason"] == "length" for st in run["streams"]):
        fail(f"router http: a stream is not contiguous or did not end by length: {h['done_reasons']}")
    if not http_sound:
        fail(f"router http: tokens differ from the serving phase's away from a near-tie: {http_found}")
    if set(h["replica_states"].values()) != {"healthy"} or min(h["served_per_replica"].values()) < 1:
        fail(f"router http: replicas {h['replica_states']}, served {h['served_per_replica']}")
    if any(h["blocks_in_use"].values()) or run["healthz_draining"]["status"] != 503 or len(h["step_threads"]) != 1:
        fail(f"router http: blocks {h['blocks_in_use']}, healthz while draining {run['healthz_draining']}, "
             f"threads {h['step_threads']}")
    for what, counts in (("arms", launches), ("http", http_launches)):
        if not (counts["replays"].get("paged_decode", 0) > 0 and counts["replays"].get("paged_prefill", 0) > 0):
            fail(f"router {what}: the graph replays ran no K1 or no K2: {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 5h2: tensor-parallel serving, two gloo ranks on the one card
# ---------------------------------------------------------------------------

TP = 2
TP_NEMO = "mistral-nemo-12b"
TP_NEMO_LAYERS = 4  # of 40: full width (8 kv heads, 4 a rank) and the 131072-entry vocab over two ranks
# the serving phase's engine; its prompts; eos outside the vocab
TP_ENGINE = dict(max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16)
# logits of TP=2 against TP=1 on fp32 pools, relative to the largest logit:
# the same products with the head, hidden and vocab sums split in two and
# added in another order
TP_LOGIT_TOL = 1e-4
TP_BIAS_STD = 0.5  # the bias control's FFN biases: large enough to move every logit


def tp_prompt_cache(cfg, params, mesh, prompt, kv_heads):
    """One prompt through ``prefill_step`` into fresh fp32 pools of
    ``kv_heads`` heads (on the params' device), then one decode step on a
    copy of them: (prefill logits, decode logits, the pools after the
    prefill, the decoded token)."""
    from repro_torch.models import decode_step, init_paged_cache, prefill_step

    dev = params["embed"]["tok"].device
    nb = -(-(len(prompt) + 1) // BLOCK_SIZE)
    cache = init_paged_cache(cfg, 1 + nb, BLOCK_SIZE, 1, nb, torch.float32, device=dev, kv_heads=kv_heads)
    cache["tbl"][0] = torch.arange(1, 1 + nb, dtype=torch.int32, device=dev)
    tok = torch.tensor([prompt], dtype=torch.int32, device=dev)
    lp, _ = prefill_step(cfg, params, cache, tok, torch.zeros(1, dtype=torch.int32, device=dev), cache["tbl"], mesh=mesh)
    nxt = torch.argmax(lp, dim=-1).int()[:, None]
    ld, _ = decode_step(cfg, params, {k: v.clone() for k, v in cache.items()}, nxt,
                        torch.tensor([len(prompt)], dtype=torch.int32, device=dev), mesh=mesh)
    return lp[0], ld[0], cache, nxt


def with_biases(cfg, params, seed=SEED):
    """``params`` of ``cfg.replace(use_bias=True)``: zero attention biases
    and FFN biases ``b_up``, ``b_down`` drawn from ``seed`` (the same on every
    rank)."""
    dev = params["embed"]["tok"].device
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    blocks = []
    for p in params["blocks"]:
        a, m = dict(p["attn"]), dict(p["mlp"])
        H, hd, D = a["wo"].shape
        KV = a["wk"].shape[1]
        a.update(bq=torch.zeros((H, hd), device=dev), bk=torch.zeros((KV, hd), device=dev),
                 bv=torch.zeros((KV, hd), device=dev), bo=torch.zeros((D,), device=dev))
        m.update(b_up=TP_BIAS_STD * torch.randn((m["w_down"].shape[0],), generator=g, device=dev),
                 b_down=TP_BIAS_STD * torch.randn((D,), generator=g, device=dev))
        blocks.append(dict(p, attn=a, mlp=m))
    return dict(params, blocks=blocks)


def rel_gap(a, ref) -> float:
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def tp_k1_times(mesh, cfg, device) -> dict:
    """K1 at this rank's local heads on the kernel phase's decode inputs
    (fp32 queries, bf16 pools), timed while the other rank waits."""
    from repro_torch.kernels.flash_attention_ref import flash_errors
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain

    H, KV = cfg.num_heads // TP, cfg.num_kv_heads // TP
    c = kernel_case("decode", H, KV, cfg.head_dim, torch.float32, 0, 0.0, device, seed=mesh.get_local_rank("model"))

    def run(fn, i):
        layer = i % c["layers"]
        return fn(c["q"], c["k"][layer], c["v"][layer], c["tbl"], c["lens"])

    err = flash_errors(run(k1, 0), run(paged_attention_plain, 0))["max_abs"]
    out = {"shape": [H, KV, cfg.head_dim], "max_abs_err": err}
    for turn in range(TP):
        torch.distributed.barrier()
        if turn == mesh.get_local_rank("model"):
            out.update(kernel_times(lambda i: run(k1, i)), plain_ms=timed_ms(lambda i: run(paged_attention_plain, i)))
            out["bound_ms"], out["bound_by"] = case_bound(c, "cuda_cores_fp32")
        torch.cuda.synchronize()
    torch.distributed.barrier()
    return out


def tp_collective_ms(mesh, device, shape=(4, 2048), iters=50) -> dict:
    """Host wall time of one all-reduce on the model group (gloo), of a
    decode step's activation (4 slots x olmo-1b's width, fp32) on the card
    and of the same tensor on the CPU: what staging through host memory,
    with both ranks' contexts on one card, adds to gloo's own exchange."""
    from repro_torch.parallel.collectives import all_reduce

    out = {"shape": list(shape)}
    for where in (device, torch.device("cpu")):
        x = torch.ones(shape, device=where)
        for _ in range(5):
            all_reduce(x, mesh)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            all_reduce(x, mesh)
        torch.cuda.synchronize()
        out[f"{where.type}_ms"] = 1e3 * (time.perf_counter() - t0) / iters
    return out


def tp_serve(cfg, params, mesh, prompts, max_new_tokens, device) -> dict:
    """The serving phase's run on one engine (one rank's under ``mesh``):
    a warm-up request, then the prompts with every counter set to 0 just
    before.  Rank 0 drives, the other rank follows."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.parallel import collectives as C
    from repro_torch.serving import InferenceEngine

    kw = dict(TP_ENGINE, eos_token=cfg.padded_vocab, device=device, mesh=mesh)
    rank = mesh.get_local_rank("model") if mesh is not None else 0
    warm = InferenceEngine(cfg, params, **kw)
    if rank == 0:
        warm.submit(prompts[0][:48], max_new_tokens=2)
        warm.run_until_drained()
        warm.stop_followers()
    else:
        warm.follow()
    del warm
    eng = InferenceEngine(cfg, params, **kw)
    K.reset_launches()
    C.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
        eng.run_until_drained()
        eng.stop_followers()
    else:
        eng.follow()
        reqs = sorted(eng.done, key=lambda r: r.req_id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats()
    return {
        "tokens": [list(r.generated) for r in reqs], "reasons": [r.finish_reason for r in reqs],
        "launches": dict(K.LAUNCHES), "collectives": dict(C.COLLECTIVES), "wall_s": wall,
        "decode_steps": s["decode_steps"], "prefill_chunks": s["prefill_chunks"], "tokens_out": s["tokens_out"],
        "step_p50_s": eng.metrics.histogram("engine_step_seconds").percentile(50),
        "decode_step_p50_s": eng.metrics.histogram("engine_decode_seconds").percentile(50),
        "cache_bytes": s["cache_bytes"], "cache_bytes_per_device": s.get("cache_bytes_per_device", s["cache_bytes"]),
        "pool_bytes": pool_bytes(eng), "kv_heads": s.get("kv_heads_per_rank", cfg.num_kv_heads),
        "alloc_blocks_in_use": s["alloc_blocks_in_use"],
    }


def tp_controls(cfg, params, local, mesh, prompt) -> dict:
    """TP=2 logits against TP=1's on fp32 pools, and two controls that must
    part from them: (a) ``b_down`` counted on both ranks (each rank's share
    of the row-parallel sum carries it, so the all-reduce adds it twice),
    on the model with FFN biases; (b) rank 1 attends over rank 0's pool
    slice (its own replaced by a broadcast from rank 0) in one decode
    step.  ``params``: the full tree (rank 0 computes the references)."""
    from repro_torch.models import decode_step
    from repro_torch.parallel.sharding import executed_specs, local_kv_heads, shard_params

    rank = mesh.get_local_rank("model")
    kv = local_kv_heads(cfg, mesh)
    out = {}
    lp, ld, cache, nxt = tp_prompt_cache(cfg, local, mesh, prompt, kv)
    bad = {k: v.clone() for k, v in cache.items()}
    for name in ("k", "v"):  # rank 1's pools replaced by rank 0's slice
        torch.distributed.broadcast(bad[name], src=0)
    lswap, _ = decode_step(cfg, local, bad, nxt, torch.tensor([len(prompt)], dtype=torch.int32, device=nxt.device),
                           mesh=mesh)
    bcfg = cfg.replace(use_bias=True)
    full_b = with_biases(cfg, params)
    spec = executed_specs(bcfg, mesh)["executed"]
    local_b = shard_params(bcfg, full_b, spec, mesh)
    double = dict(local_b, blocks=[dict(p, mlp=dict(p["mlp"], b_down=2 * p["mlp"]["b_down"])) for p in local_b["blocks"]])
    lb = tp_prompt_cache(bcfg, local_b, mesh, prompt, kv)[0]
    lbad = tp_prompt_cache(bcfg, double, mesh, prompt, kv)[0]
    if rank == 0:  # TP=1 on the full weights
        rp, rd, _, _ = tp_prompt_cache(cfg, params, None, prompt, cfg.num_kv_heads)
        rb = tp_prompt_cache(bcfg, full_b, None, prompt, cfg.num_kv_heads)[0]
        out = {"prefill_rel": rel_gap(lp, rp), "decode_rel": rel_gap(ld, rd), "pool_swap_rel": rel_gap(lswap, rd),
               "bias_rel": rel_gap(lb, rb), "bias_on_both_ranks_rel": rel_gap(lbad, rb), "tol": TP_LOGIT_TOL}
    return out


def tp_arms() -> list:
    """(name, config) of the two arms: olmo-1b at full width and depth,
    mistral-nemo-12b at full width cut to ``TP_NEMO_LAYERS`` layers."""
    from repro_torch.configs import get_config

    return [("olmo-1b", get_config("olmo-1b")), (TP_NEMO, get_config(TP_NEMO).replace(num_layers=TP_NEMO_LAYERS))]


def tp_rank(rank, mesh, device_type="cuda", arms=None) -> dict:
    """One rank of ``tp_serving``: each arm's weights drawn from ``SEED``
    on the card (the serving phase's for olmo-1b), this rank's slice of
    them, the refused ``fused=True``, the serving run, and for olmo-1b the
    controls and K1 at the local heads; mistral-nemo's TP=1 reference and
    its tie check run on rank 0 with the full weights."""
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import executed_specs, shard_params
    from repro_torch.serving import InferenceEngine

    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    out = {}
    for name, cfg in arms or tp_arms():
        t0 = time.perf_counter()
        params = init_params(cfg, SEED, device)
        prompts = serving_prompts(cfg, SEED)
        arm = {}
        if rank == 0 and name == TP_NEMO:
            arm["tp1"] = tp_serve(cfg, params, None, prompts, 32, device)
        local = shard_params(cfg, params, executed_specs(cfg, mesh)["executed"], mesh)
        try:
            InferenceEngine(cfg, local, mesh=mesh, fused=True, device=device, **TP_ENGINE)
            arm["fused_refusal"] = None
        except ValueError as e:
            arm["fused_refusal"] = str(e)
        arm["tp2"] = tp_serve(cfg, local, mesh, prompts, 32, device)
        if name != TP_NEMO:
            arm["controls"] = tp_controls(cfg, params, local, mesh, prompts[0])
            arm["k1_local"] = tp_k1_times(mesh, cfg, device)
            arm["all_reduce"] = tp_collective_ms(mesh, device, (TP_ENGINE["max_batch"], cfg.d_model))
        if rank == 0 and name == TP_NEMO:
            found = []
            arm["ties_ok"] = same_up_to_ties(cfg, params, device, prompts, arm["tp2"]["tokens"], arm["tp1"]["tokens"],
                                             found)
            arm["differences"] = found[0]
        arm["seconds"] = time.perf_counter() - t0
        del params, local
        torch.cuda.empty_cache()
        out[name] = arm
    return out


def tp_serving_phase(cfg, params, device, legacy_tokens, serving) -> dict:
    """olmo-1b (full width and depth; its TP=1 run is the serving phase's)
    and mistral-nemo-12b (full width, 4 layers) served by two gloo ranks on
    the one card, each launching K1/K2 on its kv-head slice."""
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(tp_rank, TP, backend="gloo", device="cuda", args=("cuda",), timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"tp_serving: {e}")
    seconds = time.perf_counter() - t0
    found = []
    olmo_ties = same_up_to_ties(cfg, params, device, serving_prompts(cfg, SEED),
                                ranks[0]["olmo-1b"]["tp2"]["tokens"], legacy_tokens, found)
    out = {"phase": "tp_serving", "backend": "gloo", "ranks": TP, "seconds": seconds, "arms": {}, "launches": {}}
    for name, L, tp1 in (("olmo-1b", cfg.num_layers, serving), (TP_NEMO, TP_NEMO_LAYERS, ranks[0][TP_NEMO]["tp1"])):
        arm = [r[name] for r in ranks]
        runs = [a["tp2"] for a in arm]
        tp1_kv = tp1["pool_bytes"]
        out["launches"][name] = [r["launches"] for r in runs]
        out["arms"][name] = {
            "seconds": [a["seconds"] for a in arm],
            "tp1": {k: tp1[k] for k in ("step_p50_s", "decode_step_p50_s", "wall_s", "cache_bytes", "pool_bytes")},
            "tp2": [{k: v for k, v in r.items() if k not in ("tokens", "reasons")} for r in runs],
            "fused_refusal": [a["fused_refusal"] for a in arm],
            "collectives_per_call": [(r["collectives"]["all_reduce"] + r["collectives"]["all_gather"])
                                     / (r["decode_steps"] + r["prefill_chunks"]) for r in runs],
            "ties": found[0] if name == "olmo-1b" else arm[0]["differences"],
        }
        if name == "olmo-1b":
            out["arms"][name].update(controls=arm[0]["controls"], k1_local=[a["k1_local"] for a in arm],
                                     all_reduce=[a["all_reduce"] for a in arm])
        ties_ok = olmo_ties if name == "olmo-1b" else arm[0]["ties_ok"]
        if runs[0]["tokens"] != runs[1]["tokens"]:
            fail(f"tp_serving {name}: the ranks' tokens differ")
        if not ties_ok:
            fail(f"tp_serving {name}: TP=2 tokens differ from TP=1's beyond near-ties: {out['arms'][name]['ties']}")
        for rank, (a, r) in enumerate(zip(arm, runs)):
            if not all(x == "length" for x in r["reasons"]) or r["alloc_blocks_in_use"]:
                fail(f"tp_serving {name} rank {rank}: {r['reasons']}, blocks in use {r['alloc_blocks_in_use']}")
            got = r["launches"]
            if not (got["paged_decode"] == r["decode_steps"] * L > 0 and got["paged_prefill"] == r["prefill_chunks"] * L > 0):
                fail(f"tp_serving {name} rank {rank}: launches {got} != {r['decode_steps']} decode steps / "
                     f"{r['prefill_chunks']} chunks x {L} layers")
            if out["arms"][name]["collectives_per_call"][rank] != 2 * L + 2:
                fail(f"tp_serving {name} rank {rank}: {r['collectives']} is not 2 per layer + 2 a model call")
            if 2 * r["pool_bytes"] != tp1_kv or r["cache_bytes"] != tp1["cache_bytes"]:
                fail(f"tp_serving {name} rank {rank}: pool bytes {r['pool_bytes']} (TP=1 {tp1_kv}), global "
                     f"cache bytes {r['cache_bytes']} (TP=1 {tp1['cache_bytes']})")
            if not (a["fused_refusal"] and "NCCL" in a["fused_refusal"]):
                fail(f"tp_serving {name} rank {rank}: fused=True on a gloo group was not refused")
    c = out["arms"]["olmo-1b"]["controls"]
    if not max(c["prefill_rel"], c["decode_rel"], c["bias_rel"]) < TP_LOGIT_TOL:
        fail(f"tp_serving: TP=2 logits part from TP=1's: {c}")
    if not min(c["pool_swap_rel"], c["bias_on_both_ranks_rel"]) > TP_LOGIT_TOL:
        fail(f"tp_serving: a control passes, which then proves nothing: {c}")
    for r in out["arms"]["olmo-1b"]["k1_local"]:
        if not r["max_abs_err"] < TOL[torch.float32]:
            fail(f"tp_serving: K1 at the local heads {r['shape']}: err {r['max_abs_err']}")
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5h3: replicas of tensor-parallel engines behind the router, four
# gloo ranks on the one card
# ---------------------------------------------------------------------------

REPLICAS = 2
REPLICAS_ENGINE = dict(max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128,
                       cache_dtype=torch.bfloat16, cache_kind="paged", prefix_cache=True, attn_impl="kernel")


def seed_dropping(remote_cls):
    """The control of ``replicas_tp``: a stand-in for the remote replica
    that keeps the failover resume's seed on its mirror and never sends it
    to the lead, whose request starts over; the router then forwards the
    regenerated tokens as fresh ones."""

    class SeedDropping(remote_cls):
        def _seed(self, req_id, tokens):
            pass

    return SeedDropping


def replicas_rank(rank, mesh, device_type="cuda", cfg=None, prompts=None, max_new_tokens=None) -> dict:
    """One of the four ranks of ``replicas_tp``: two replicas of TP=2
    engines (``make_replica_meshes(2, 2)``: ranks 0-1 and 2-3), the router
    on rank 0, which leads replica 0 and drives replica 1's lead (rank 2)
    through a ``RemoteEngine``.  Three arms on the same weights (this
    rank's slice of the seed's): affinity; replica 0 crashed halfway
    through the steps it ran in the affinity arm; the same crash under
    ``seed_dropping`` (the control).  Every rank reads its K1/K2 launches
    and its engine's steps and chunks an arm; rank 0 the tokens, the
    router's counts and the wall."""
    from repro_torch.benchmarks import llm_inference as bench
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as K
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import executed_specs, shard_params
    from repro_torch.serving import FaultPlan, InferenceEngine, ManualClock, Replica, Router
    from repro_torch.serving.remote import RemoteEngine, fleet_group, lead_ranks, serve_remote

    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    cfg = cfg or get_config("olmo-1b")
    prompts = prompts or bench.tenant_prompts(system_len=ROUTER_SYSTEM_LEN)  # the router phase's 16
    max_new_tokens = max_new_tokens or bench.ROUTER_MAX_NEW
    meshes = make_replica_meshes(REPLICAS, TP, backend="gloo", device=device_type)
    fleet = fleet_group(REPLICAS, TP)
    replica, local_rank = divmod(rank, TP)
    params = init_params(cfg, SEED, device)
    local = shard_params(cfg, params, executed_specs(cfg, meshes[replica])["executed"], meshes[replica])
    del params
    torch.cuda.empty_cache()
    kw = dict(REPLICAS_ENGINE, eos_token=cfg.padded_vocab, device=device)
    out, crash_at = {}, None
    for arm in ("affinity", "failover", "control"):
        if arm != "affinity":  # rank 0 knows the crash step: the others take it from it
            box = [crash_at]
            torch.distributed.broadcast_object_list(box, src=0)
            crash_at = box[0]
        K.reset_launches()
        torch.cuda.synchronize()
        if rank == 0:
            clock = ManualClock(tick=1e-4)  # no heartbeat ages with gloo's step times
            remote = seed_dropping(RemoteEngine) if arm == "control" else RemoteEngine
            engines = [InferenceEngine(cfg, local, mesh=meshes[0], clock=clock, **kw)]
            engines += [remote(lead, fleet) for lead in lead_ranks(REPLICAS, TP)[1:]]
            plans = {0: FaultPlan(crash_at_step=crash_at)} if arm != "affinity" else {}
            router = Router([Replica(i, e, clock=clock, fault_plan=plans.get(i)) for i, e in enumerate(engines)],
                            clock=clock, backoff_base_s=1e-4)
            t0 = time.perf_counter()
            reqs = [router.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
            placed = [r.replica_id for r in reqs]
            router.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s = router.stats()
            for e in engines:  # every replica's ranks, the crashed one's too
                e.stop_followers()
            steps = {r.id: r.steps for r in router.replicas}
            if arm == "affinity":
                crash_at = max(steps[0] // 2, 1)
            own = engines[0].stats()
            res = {"tokens": [list(r.generated) for r in reqs], "placed": placed,
                   "finished_on": [r.replica_id for r in reqs], "wall_s": wall, "replica_steps": steps,
                   **{k: s[k] for k in ("requests_done", "requests_failed", "failovers", "retries", "replica_states",
                                        "prefix_hit_rate", "tokens_out")},
                   "tpot_p50_s": {i: st["tpot_p50_s"] for i, st in s["per_replica"].items()},
                   "replica_launches": {r.id: dict(r.launches) for r in router.replicas},
                   "blocks_in_use": {i: st["alloc_blocks_in_use"] for i, st in s["per_replica"].items()}}
            del router, engines
        else:
            eng = InferenceEngine(cfg, local, mesh=meshes[replica], **kw)
            if local_rank == 0:
                serve_remote(eng, fleet)
            else:
                eng.follow()
            own, res = eng.stats(), {}
            del eng
        torch.cuda.synchronize()
        res.update(launches=dict(K.LAUNCHES), decode_steps=own["decode_steps"], prefill_chunks=own["prefill_chunks"],
                   engine_blocks_in_use=own["alloc_blocks_in_use"])
        out[arm] = res
        gc.collect()
        torch.cuda.empty_cache()
    out["crash_at_step"] = crash_at
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    return out


def replicas_tp_phase(cfg, params, device, router) -> dict:
    """Full-width olmo-1b served by two replicas of TP=2 engines on four
    gloo ranks of the one card (``replicas_rank``), on the router phase's
    16 prompts (8 tenants, 2 requests each): the affinity and failover arms'
    tokens must equal the router phase's 2-replica TP=1 tokens (fused
    engines; its affinity arm) up to near-ties, no request may be lost,
    replica 0 must be dead after its crash, every rank must launch K1 and
    K2 (16 a decode step or chunk of its engine), and the control (the
    resume's seed never sent to the lead) must fail the token gate."""
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(replicas_rank, (REPLICAS, TP), backend="gloo", device="cuda", args=("cuda",),
                          timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"replicas_tp: {e}")
    seconds = time.perf_counter() - t0
    from repro_torch.benchmarks import llm_inference as bench

    prompts = bench.tenant_prompts(system_len=ROUTER_SYSTEM_LEN)
    reference = router["tokens"]["affinity"]
    r0 = ranks[0]
    out = {"phase": "replicas_tp", "backend": "gloo", "replicas": REPLICAS, "tp": TP, "ranks": REPLICAS * TP,
           "model": cfg.name, "requests": len(prompts), "seconds": seconds, "crash_at_step": r0["crash_at_step"],
           "launches": [r["affinity"]["launches"] for r in ranks],
           "max_memory_allocated": [r["max_memory_allocated"] for r in ranks], "arms": {}}
    for arm in ("affinity", "failover", "control"):
        found = []
        sound = same_up_to_ties(cfg, params, device, prompts, r0[arm]["tokens"], reference, found)
        out["arms"][arm] = {**{k: v for k, v in r0[arm].items() if k != "tokens"}, "ties_ok": sound,
                            "differences": found[0], "rank_launches": [r[arm]["launches"] for r in ranks],
                            "rank_steps": [(r[arm]["decode_steps"], r[arm]["prefill_chunks"]) for r in ranks]}
    emit(out)
    for arm in ("affinity", "failover"):
        a = out["arms"][arm]
        if not a["ties_ok"]:
            fail(f"replicas_tp {arm}: tokens differ from the router phase's TP=1 fleet beyond near-ties: "
                 f"{a['differences']}")
        if a["requests_done"] != len(prompts) or a["requests_failed"]:
            fail(f"replicas_tp {arm}: done {a['requests_done']}, failed {a['requests_failed']}")
        dead = {0} if arm == "failover" else set()
        if {i for i, st in a["replica_states"].items() if st == "dead"} != dead or (dead and a["failovers"] < 1):
            fail(f"replicas_tp {arm}: replica states {a['replica_states']}, failovers {a['failovers']}")
        if any(n for i, n in a["blocks_in_use"].items() if i not in dead):
            fail(f"replicas_tp {arm}: blocks left in use {a['blocks_in_use']}")
    if set(out["arms"]["affinity"]["placed"]) != {0, 1}:
        fail(f"replicas_tp: a replica took no request: {out['arms']['affinity']['placed']}")
    for rank, (got, (steps, chunks)) in enumerate(zip(out["launches"], out["arms"]["affinity"]["rank_steps"])):
        L = cfg.num_layers
        if not (got["paged_decode"] == steps * L > 0 and got["paged_prefill"] == chunks * L > 0):
            fail(f"replicas_tp rank {rank}: launches {got} != {steps} decode steps / {chunks} chunks x {L} layers")
    c = out["arms"]["control"]
    if c["ties_ok"] or c["failovers"] < 1:
        fail(f"replicas_tp: the control (the resume's seed dropped) passes the token gate: {c['differences']}")
    return out


# ---------------------------------------------------------------------------
# phase 5i: the moe family (qwen3-moe-235b-a22b at full width, 4 layers)
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 4  # of 94: four full-width layers and the untied head are 44.8 GB of fp32 weights
# capacity cannot bind at cf >= num_experts / top_k = 16 (C >= T): the walks must agree there
MOE_CF = 16.0
MOE_PATH_T = 128  # one serving chunk; C = 12 at the published cf 1.25
# moe_ffn in fp32 against the same function in float64, relative to the
# reference's largest output: fp32 products over D = 4096 and F = 1536 are
# good to about 1e-6 of it; the control drops other pairs, whose expert
# outputs are of the output's own size
MOE_REL_TOL = 1e-4
# a near tie: the 8th and 9th router probabilities (float64) closer than
# this; the fp32 router's probabilities (about 1/128) are good to about 1e-8
MOE_TIE_GAP = 1e-7
MOE_ENGINE = dict(max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16)


def with_cf(cfg, cf: float):
    import dataclasses

    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def routing_masks(r) -> tuple[torch.Tensor, torch.Tensor]:
    """(chosen, kept): (T, E) masks of each token's experts and of its pairs
    that fit the capacity, from a one-group ``models.moe.Routing``."""
    chosen = torch.zeros(r.probs.shape[1:], dtype=torch.bool, device=r.probs.device)
    return chosen.scatter(1, r.experts[0], True), chosen.scatter(1, r.experts[0], r.keep[0])


def moe_path_phase(cfg, device) -> dict:
    """One layer's ``moe_ffn`` at full width on a 128-token chunk from the
    seed at cf 1.25, against the same function in float64 (the router in
    float64 too) on the card: the share of pairs dropped, the routing sets
    and drop masks (equal up to the first token whose set differs at a near
    tie, which may shift every later token's slots), the error on the
    tokens before that one, and a control that counts priority in reverse
    token order.  Then
    ``moe_ffn``'s device time at T = 128 and T = 4 against its bound (every
    expert weight read once)."""
    import dataclasses

    from repro_torch.models.layers import materialize
    from repro_torch.models.moe import capacity, moe_ffn, moe_specs, route
    from repro_torch.utils.tree import tree_leaves, tree_map

    m = cfg.moe
    g = torch.Generator(device=device).manual_seed(SEED)
    p = tree_map(lambda s: materialize(s, g, device, torch.float32), moe_specs(cfg))
    T, D = MOE_PATH_T, cfg.d_model
    x = torch.randn((1, T, D), generator=g, device=device)
    out, aux = moe_ffn(cfg, p, x)
    chosen, kept = routing_masks(route(cfg, p["router"], x))
    control = moe_ffn(cfg, p, x.flip(1))[0].flip(1)  # priority counted from the last token
    cfg64 = cfg.replace(moe=dataclasses.replace(m, router_dtype="float64"))  # the router in the compute dtype
    p64 = tree_map(lambda t: t.double(), p)
    ref, aux64 = moe_ffn(cfg64, p64, x.double())
    r64 = route(cfg64, p64["router"], x.double())
    del p64
    torch.cuda.empty_cache()
    chosen64, kept64 = routing_masks(r64)
    top = torch.topk(r64.probs[0], m.top_k + 1, dim=-1).values
    gap = top[:, m.top_k - 1] - top[:, m.top_k]  # (T,) 8th minus 9th probability
    near = (gap < MOE_TIE_GAP).cpu().numpy()
    set_differs = (chosen != chosen64).any(dim=-1).cpu().numpy()
    differ = set_differs | (kept != kept64).any(dim=-1).cpu().numpy()
    first = int(np.argmax(differ)) if differ.any() else T  # routing agrees on the tokens before it
    scale = float(ref.abs().max())

    def err(o) -> float:
        d = (o.double() - ref)[0, :first].abs()
        return float(d.max()) / scale if d.numel() else 0.0

    def bound_of(n_tokens: int) -> tuple[float, str]:
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(p)) + 2 * n_tokens * D * 4
        C = capacity(m, n_tokens)
        flops = 2 * 3 * m.num_experts * C * D * m.expert_d_ff + 2 * n_tokens * D * m.num_experts
        return bound(nbytes, flops, FP32_FLOPS_PER_S)

    x4 = x[:, :4].contiguous()
    times = {}
    for n, xx in ((T, x), (4, x4)):
        b_ms, b_by = bound_of(n)
        times[f"T{n}"] = {"ms": timed_ms(lambda i, xx=xx: moe_ffn(cfg, p, xx), iters=10, warmup=2),
                          "capacity": capacity(m, n), "bound_ms": b_ms, "bound_by": b_by}
    row = {
        "phase": "moe_path", "model": cfg.name, "T": T, "capacity": capacity(m, T),
        "capacity_factor": m.capacity_factor,
        "dropped_share": float(1 - kept.sum() / chosen.sum()), "dropped_share_f64": float(1 - kept64.sum() / chosen64.sum()),
        "near_ties": int(near.sum()), "min_top8_gap": float(gap.min()),
        "tokens_routed_differently": int(differ.sum()), "first_routed_differently": first if first < T else None,
        "first_difference_at_near_tie": bool(first == T or (set_differs[first] and near[first])),
        "tokens_compared": first,
        "max_rel_err": err(out), "tol": MOE_REL_TOL, "control": "priority_reversed",
        "control_max_rel_err": err(control), "ref_max_abs": scale,
        "aux": float(aux), "aux_f64": float(aux64), "finite": bool(torch.isfinite(out).all()),
        "times": times,
    }
    emit(row)
    del p, out, ref, control
    torch.cuda.empty_cache()
    if not row["finite"] or not row["first_difference_at_near_tie"]:
        fail(f"moe_path: routing differs from float64's away from a near tie, or the output is not finite: {row}")
    if not row["max_rel_err"] < MOE_REL_TOL:
        fail(f"moe_path: fp32 moe_ffn differs from float64 by {row['max_rel_err']} of its largest value")
    if not row["dropped_share"] > 0 or not row["control_max_rel_err"] > MOE_REL_TOL:
        fail(f"moe_path: the control (priority reversed) passes or no pair was dropped: {row}")
    return row


class RoutedPairs:
    """Sums the (token, expert) pairs that ``models.moe.route`` routes and
    drops while active, on the device (no host read): for eager runs only,
    since a graph replay calls no Python.  ``record`` also keeps each
    call's (tokens, E) mask of the chosen experts on the host, in call
    order (``flipped_pairs``)."""

    def __init__(self, record: bool = False):
        self.record = record

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.inner = moe, moe.route
        self.pairs, self.dropped, self.chosen = 0, 0, []

        def counting(cfg, router_w, xg):
            r = self.inner(cfg, router_w, xg)
            self.pairs += r.keep.numel()
            self.dropped = self.dropped + (~r.keep).sum()
            if self.record:
                sets = torch.zeros(r.probs.shape, dtype=torch.bool, device=r.probs.device)
                self.chosen.append(sets.scatter_(-1, r.experts, True).reshape(-1, r.probs.shape[-1]).cpu())
            return r

        moe.route = counting
        return self

    def __exit__(self, *exc):
        self.module.route = self.inner
        self.dropped = int(self.dropped)


def moe_arm(cfg, params, device, *, fused, spec_decode="off", warm=False, max_new_tokens=32):
    """One serving run of the serving phase's prompts on the moe model:
    its readings and tokens.  ``warm`` first serves prompts from another
    seed, untimed, which captures the buckets the timed run uses.  Fails
    unless every request finishes by length and each step ran K1 or K2
    once a layer: eagerly (where it also counts the pairs routed and
    dropped), one K1 per layer a decode step and one K2 per
    layer a chunk; in the fused walk, each decode graph holds one K1 per
    layer and each mixed graph one K2 per layer.  Where the autotuner's
    table says ``"prefill1"`` for the engine's shapes, K2 stands in for K1
    in each decode step and graph."""
    import contextlib
    import gc

    from repro_torch.kernels import autotune
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    L = cfg.num_layers
    tuned = autotune.get_config(cfg.head_dim, BLOCK_SIZE, -(-MOE_ENGINE["max_seq"] // BLOCK_SIZE), torch.bfloat16,
                                cfg.num_heads // cfg.num_kv_heads)
    decode_kernel = "paged_prefill" if tuned["decode_kernel"] == "prefill1" else "paged_decode"
    eng = InferenceEngine(cfg, params, eos_token=cfg.padded_vocab, device=device, fused=fused,
                          spec_decode=spec_decode, spec_k=SPEC_K, **MOE_ENGINE)
    if warm:
        for prompt in serving_prompts(cfg, SEED + 1):
            eng.submit(prompt, max_new_tokens=max_new_tokens)
        eng.run_until_drained()
    graphs = eng._graphs
    captures0, capture_s0 = (graphs.captures, graphs.capture_s) if fused else (0, 0.0)
    replay0 = dict(graphs.launches) if fused else {}
    s0, since = eng.stats(), eng.tracer.now()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = [eng.submit(prompt, max_new_tokens=max_new_tokens) for prompt in serving_prompts(cfg, SEED)]
    routed = RoutedPairs() if not fused else contextlib.nullcontext()
    with routed:
        K.reset_launches()  # the run starts here
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = dict(K.LAUNCHES)
    s = eng.stats()
    delta = lambda key: s[key] - s0[key]  # noqa: E731
    out = {
        "walk": "fused" if fused else "legacy", "capacity_factor": cfg.moe.capacity_factor, "spec": spec_decode,
        "wall_s": wall, "tokens_out": delta("tokens_out"), "decode_steps": delta("decode_steps"),
        "prefill_chunks": delta("prefill_chunks"),
        "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
        "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
        "output_tok_s": delta("tokens_out") / wall,
        "dispatches_per_step": delta("dispatches_total") / max(delta("decode_steps"), 1),
        "pool_bytes": pool_bytes(eng), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "eager_launches": eager,
    }
    if fused:
        keys = list(graphs._graphs)
        out.update(
            ticks=tick_kinds(eng, since), graphs_captured=graphs.captures - captures0,
            capture_s=graphs.capture_s - capture_s0, graph_pool_bytes=graphs.pool_bytes(),
            replay_launches={k: v - replay0[k] for k, v in graphs.launches.items()},
            graph_launches={str(k): graphs._graphs[k].launches for k in keys},
        )
        want = {k: {"paged_decode": 0, "paged_prefill": 0, (decode_kernel if k[0] == "decode" else "paged_prefill"): L}
                for k in keys}
        got = {k: {n: graphs._graphs[k].launches[n] for n in ("paged_decode", "paged_prefill")} for k in keys}
        # each capture runs the step twice (an eager warm-up, then the capture itself)
        per_step = got == want and sum(eager[n] for n in ("paged_decode", "paged_prefill")) == 2 * L * out["graphs_captured"]
        ran = out["replay_launches"]
    else:
        out.update(decode_step_p50_s=eng.metrics.histogram("engine_decode_seconds").percentile(50),
                   prefill_chunk_p50_s=eng.metrics.histogram("engine_prefill_chunk_seconds").percentile(50),
                   routed_pairs=routed.pairs, dropped_pairs=routed.dropped)
        k1_steps, k2_chunks = L * out["decode_steps"], L * out["prefill_chunks"]
        per_step = ((eager["paged_decode"], eager["paged_prefill"]) == (k1_steps, k2_chunks) if decode_kernel == "paged_decode"
                    else (eager["paged_decode"], eager["paged_prefill"]) == (0, k1_steps + k2_chunks))
        ran = eager
    if spec_decode != "off":
        out.update(spec_steps=delta("spec_steps"), drafted_tokens=delta("drafted_tokens"),
                   accepted_tokens=delta("accepted_tokens"))
    tokens = [list(r.generated) for r in reqs]
    name = f"moe {out['walk']} cf {cfg.moe.capacity_factor} spec {spec_decode}"
    if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
        fail(f"{name}: requests did not all finish by length: {[(r.finish_reason, len(r.generated)) for r in reqs]}")
    if s["alloc_blocks_in_use"] != 0:
        fail(f"{name}: {s['alloc_blocks_in_use']} blocks still in use")
    out["decode_kernel"] = decode_kernel  # the autotuner's table for the engine's shapes
    if not per_step or ran["paged_prefill"] == 0 or (spec_decode == "off" and ran[decode_kernel] == 0):
        fail(f"{name}: K1/K2 did not run once a layer per step: {out}")
    del eng, graphs
    gc.collect()  # the engine's graphs and their pool go before the next arm
    torch.cuda.empty_cache()
    return out, tokens


def token_differences(tokens, reference) -> dict:
    """Requests and token positions where ``tokens`` differ from
    ``reference``, and each differing request's first such position."""
    first = {i: next(j for j, (a, b) in enumerate(zip(t, r)) if a != b)
             for i, (t, r) in enumerate(zip(tokens, reference)) if t != r}
    positions = sum(sum(a != b for a, b in zip(t, r)) for t, r in zip(tokens, reference))
    return {"requests": len(first), "tokens": positions, "first_position": first}


def moe_serving_phase(cfg, params, device) -> dict:
    """qwen3-moe at full width (4 layers) with the serving phase's traffic:
    (a) legacy and fused at cf 16, where no pair can be dropped: the fused
    tokens equal the legacy's up to near ties (the gate); (b) fused with
    n-gram speculation (``spec_k = 4``) at cf 16, equal to (a) up to near
    ties (the gate); (c) legacy and fused at the published cf 1.25,
    reported: their differences from (a) and from each other are what
    binding capacity does (chunks, verify windows and mixed batches route
    different token sets), beside one 128-token chunk's pairs dropped at
    1.25 and how far that moves its last logits from cf 16's."""
    cfg16 = with_cf(cfg, MOE_CF)
    prompts = serving_prompts(cfg, SEED)
    arms, tokens = {}, {}
    for name, c, kw in (("a_legacy", cfg16, dict(fused=False)), ("a_fused", cfg16, dict(fused=True)),
                        ("b_fused_ngram", cfg16, dict(fused=True, spec_decode="ngram")),
                        ("c_legacy", cfg, dict(fused=False)), ("c_fused", cfg, dict(fused=True, warm=True))):
        arms[name], tokens[name] = moe_arm(c, params, device, **kw)
        emit({"phase": "moe_serving", "arm": name, **arms[name]})
    # what binding capacity does to one chunk: the longest prompt's first
    # 128 tokens in one call at 1.25 and at 16
    chunk = prompts[-1][:MOE_PATH_T]
    with RoutedPairs() as routed:
        lg = context_logits(cfg, params, device, chunk)
    lg16 = context_logits(cfg16, params, device, chunk)
    top = torch.topk(lg16, 2).values
    capacity_effect = {
        "tokens": len(chunk), "dropped_share": routed.dropped / routed.pairs,
        "max_abs_logit_shift": float((lg - lg16).abs().max()), "top2_gap_cf16": float(top[0] - top[1]),
        "logits_std": float(lg16.std()), "same_argmax": bool(lg.argmax() == lg16.argmax()),
    }
    found: list = []
    gates = {
        "a_fused_vs_legacy": same_up_to_ties(cfg16, params, device, prompts, tokens["a_fused"], tokens["a_legacy"], found),
        "b_vs_a": same_up_to_ties(cfg16, params, device, prompts, tokens["b_fused_ngram"], tokens["a_legacy"], found),
    }
    out = {
        "phase": "moe_serving", "model": cfg.name, "layers": cfg.num_layers, "gates": gates,
        "differences": {"a_fused_vs_legacy": found[0], "b_vs_a": found[1]},
        "c_reported": {
            "capacity_effect": capacity_effect,
            "c_legacy_vs_a": token_differences(tokens["c_legacy"], tokens["a_legacy"]),
            "c_fused_vs_a": token_differences(tokens["c_fused"], tokens["a_legacy"]),
            "c_fused_vs_c_legacy": token_differences(tokens["c_fused"], tokens["c_legacy"]),
        },
        "launches": {name: {"eager": arm["eager_launches"], "replays": arm.get("replay_launches")}
                     for name, arm in arms.items()},
        "peak_mem_gb": max(arm["peak_mem_gb"] for arm in arms.values()),
    }
    emit(out)
    if not all(gates.values()):
        fail(f"moe_serving: tokens differ away from a near tie at cf {MOE_CF}: {out['differences']}")
    return out


def profile_moe_phase(cfg, params, device, ticks=5) -> dict:
    """One fused decode tick and one eager decode step of the moe model at
    cf 1.25 (``profile_ticks``), then the four layers' ``moe_ffn`` alone on
    the tick's 4 rows under the profiler: its device time and the part in
    GEMM kernels (the expert products and the router), against the bounds
    (the tick: every weight it reads; the experts: their weights)."""
    from repro_torch.models.moe import moe_ffn
    from repro_torch.utils.tree import tree_leaves

    out = {"phase": "profile_moe", **profile_ticks(cfg, params, device, ticks, names=("fused_tick", "eager_step"))}
    blocks_bytes = sum(t.numel() * t.element_size() for p in params["blocks"] for t in tree_leaves(p))
    expert_bytes = sum(t.numel() * t.element_size() for p in params["blocks"] for n, t in p["moe"].items()
                       if n != "router")
    head_bytes = params["lm_head"].numel() * params["lm_head"].element_size()
    kv_bytes = sum(DECODE_LENS) * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2  # bf16 K and V rows
    out["tick_bound_ms"], out["tick_bound_by"] = bound(blocks_bytes + head_bytes + kv_bytes, 0, FP32_FLOPS_PER_S)
    out["tick_bytes"] = blocks_bytes + head_bytes + kv_bytes
    x = torch.randn((len(DECODE_LENS), 1, cfg.d_model), generator=torch.Generator(device=device).manual_seed(SEED),
                    device=device)

    def ffns():
        for p in params["blocks"]:
            moe_ffn(cfg, p["moe"], x)

    ffns()
    by_name, launches, wall_ms, _ = profiled(ffns, ticks)
    gemm = {k: v for k, v in by_name.items() if "gemm" in k.lower() or "gemv" in k.lower()}
    out["moe_ffn"] = {
        "what": "the 4 layers' moe_ffn on 4 rows", "wall_ms": wall_ms, "device_ms": sum(by_name.values()),
        "gemm_ms": sum(gemm.values()), "device_launches": launches,
        "expert_bound_ms": bound(expert_bytes, 0, FP32_FLOPS_PER_S)[0], "expert_bytes": expert_bytes,
        "top_kernels_ms": [[n[:90], ms] for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5j: the recurrent-state families (hymba-1.5b, rwkv6-7b)
# ---------------------------------------------------------------------------

HYMBA_ENGINE = dict(max_batch=4, max_seq=HYMBA_NB * BLOCK_SIZE, block_size=BLOCK_SIZE, cache_dtype=torch.bfloat16)
HYMBA_LONG = 1100  # the hymba traffic's long prompt: K1's window (1024) binds inside the engine
RWKV_ENGINE = dict(max_batch=4, max_seq=512, cache_dtype=torch.bfloat16)
STATE_STEPS = 4  # decode steps of the state checks; the last one is checked
# The state checks: each slot's last decode logits (prefill of its prompt,
# then STATE_STEPS decode steps over fp32 caches) against a whole-prompt
# prefill of the same context, max |difference| over the logits.  The two
# differ in summation order (the chunked scan against the step recurrence,
# prefill attention against K1 over the pools).  The control zeroes one
# recurrent state before the last step (hymba: the conv state; rwkv: the
# WKV state), which the limit must reject.  On the H100 (PERF.md, PR 24)
# hymba read 1.8e-5 against a control of 3.65; the random-init rwkv6-7b,
# chaotic over 32 layers, read 0.028 against a control of 6.1 (logits'
# standard deviation 0.99).  Each limit lies between the two.
STATE_TOL = {HYMBA_ARCH: 1e-3, "rwkv6-7b": 0.25}


def hymba_prompts(cfg, seed) -> list[list[int]]:
    """One prompt per length of ``HYMBA_LENS``, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in HYMBA_LENS]


def recurrent_cache(cfg, params, device, prompts, dtype):
    """Each prompt prefilled alone (``models.prefill``, as the engine
    admits) into its slot: the hybrid family's K/V grafted into the slot's
    ``HYMBA_NB`` blocks of a paged cache (table published) beside its
    states; the ssm family's states written into a dense slot cache."""
    from repro_torch.models import init_paged_cache, prefill
    from repro_torch.serving.kvcache import graft_prefill_into_blocks, make_engine_cache, write_prefill_into_slot

    B = len(prompts)
    if cfg.family == "hybrid":
        cache = init_paged_cache(cfg, 1 + B * HYMBA_NB, BLOCK_SIZE, B, HYMBA_NB, dtype, device=device)
        cache["tbl"].copy_(torch.arange(1, 1 + B * HYMBA_NB, dtype=torch.int32).reshape(B, HYMBA_NB))
    else:
        cache = make_engine_cache(cfg, B, RWKV_ENGINE["max_seq"], dtype, device=device)
    for slot, p in enumerate(prompts):
        _, raw = prefill(cfg, params, {"tokens": torch.tensor([p], dtype=torch.int32, device=device)})
        if cfg.family == "hybrid":
            blocks = list(range(1 + slot * HYMBA_NB, 1 + (slot + 1) * HYMBA_NB))
            graft_prefill_into_blocks(cfg, cache, raw, blocks, len(p), slot)
        else:
            write_prefill_into_slot(cfg, cache, raw, slot, seq_filled=len(p))
        del raw
    return cache


def state_check(cfg, params, device, prompts, control_leaf) -> dict:
    """The state check (``STATE_TOL``) on fp32 caches: prefill, then
    ``STATE_STEPS`` decode steps fed tokens from the seed, the last one also
    from a copy of the cache with ``control_leaf`` zeroed; each against a
    whole-prompt ``prefill`` of prompt + fed tokens."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import decode_step, prefill

    B = len(prompts)
    rng = np.random.default_rng(SEED + 7)
    fed = torch.tensor(rng.integers(0, cfg.vocab_size, (B, STATE_STEPS)), dtype=torch.int32, device=device)
    cache = recurrent_cache(cfg, params, device, prompts, torch.float32)
    pos0 = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    K.reset_launches()
    for step in range(STATE_STEPS - 1):
        _, cache = decode_step(cfg, params, cache, fed[:, step : step + 1], pos0 + step)
    control = {name: t.clone() for name, t in cache.items()}
    control[control_leaf].zero_()
    last = (fed[:, -1:], pos0 + STATE_STEPS - 1)
    sound, _ = decode_step(cfg, params, cache, *last)
    ctrl, _ = decode_step(cfg, params, control, *last)
    launches = K.LAUNCHES["paged_decode"]
    ref = torch.stack([
        prefill(cfg, params, {"tokens": torch.cat([torch.tensor(p, dtype=torch.int32, device=device), fed[b]])[None]})[0][0]
        for b, p in enumerate(prompts)
    ])
    tol = STATE_TOL[cfg.name]
    out = {
        "what": f"the last of {STATE_STEPS} decode steps after prefill against a prefill of the whole context, fp32 caches",
        "contexts": [len(p) + STATE_STEPS for p in prompts], "max_abs_err": float((sound - ref).abs().max()),
        "control": f"{control_leaf} zeroed before the last step", "control_max_abs_err": float((ctrl - ref).abs().max()),
        "tol": tol, "logits_std": float(ref[:, : cfg.vocab_size].std()), "finite": bool(torch.isfinite(sound).all()),
        "same_argmax": int((sound.argmax(-1) == ref.argmax(-1)).sum()), "k1_launches": launches,
    }
    del cache, control
    return out


def hybrid_path_phase(cfg, params, device) -> dict:
    """hymba-1.5b at full width: four prompts of ``HYMBA_LENS`` (two past
    the window) prefilled into bf16 pools, then ``STATE_STEPS`` decode steps
    under ``attn_impl="kernel"`` (K1, one launch a layer a step) and
    ``"plain"``, logits within ``PATH_TOL``; then the state check."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import decode_step

    prompts = hymba_prompts(cfg, SEED + 3)
    B, L = len(prompts), cfg.num_layers
    fed = torch.tensor(np.random.default_rng(SEED + 5).integers(0, cfg.vocab_size, (B, STATE_STEPS)),
                       dtype=torch.int32, device=device)
    pos0 = torch.tensor(HYMBA_LENS, dtype=torch.int32, device=device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = recurrent_cache(cfg, params, device, prompts, torch.bfloat16)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    logits, launches = {}, {}
    for impl in ("kernel", "plain"):
        cache = {name: t.clone() for name, t in base.items()}
        K.reset_launches()
        logits[impl] = []
        for step in range(STATE_STEPS):
            lg, cache = decode_step(cfg, params, cache, fed[:, step : step + 1], pos0 + step, attn_impl=impl)
            logits[impl].append(lg)
        launches[impl] = K.LAUNCHES["paged_decode"]
        del cache
    del base
    errs = [float((a - b).abs().max()) for a, b in zip(logits["kernel"], logits["plain"])]
    finite = all(bool(torch.isfinite(t).all()) for t in logits["kernel"])
    state = state_check(cfg, params, device, prompts, "conv")
    out = {
        "phase": "hybrid_path", "model": cfg.name, "layers": L, "lens": HYMBA_LENS, "window": cfg.sliding_window,
        "prefill_s": prefill_s, "prefill_peak_mem_gb": prefill_peak,
        "max_abs_err": errs, "tol": PATH_TOL, "finite": finite,
        "logits_std": float(logits["plain"][0][:, : cfg.vocab_size].std()),  # the padded vocab's -1e9 left out
        "k1_launches": launches, "state_check": state,
    }
    emit(out)
    if not finite or max(errs) >= PATH_TOL:
        fail(f"hymba kernel path logits differ from the plain path by {errs} (tol {PATH_TOL}) or are not finite")
    if launches != {"kernel": L * STATE_STEPS, "plain": 0}:
        fail(f"hymba decode launched K1 {launches} times (expected {L * STATE_STEPS} with the kernel, 0 plain)")
    if not state["finite"] or not state["max_abs_err"] < state["tol"] or state["k1_launches"] != L * (STATE_STEPS + 1):
        fail(f"hymba state check: {state}")
    if not state["control_max_abs_err"] > state["tol"]:
        fail(f"the hymba state check's control passes, which then proves nothing: {state}")
    return out


def serve_recurrent(cfg, params, device, prompts, *, max_new_tokens=32, **kw) -> tuple[dict, list]:
    """One timed run of ``prompts`` on a fresh engine (``kw``) after an
    untimed warm-up engine: readings and tokens.  Fails unless every
    request finishes by length with its first token from the prefill."""
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.serving import InferenceEngine

    warm = InferenceEngine(cfg, params, eos_token=cfg.padded_vocab, device=device, **kw)
    warm.submit(prompts[0][:48], max_new_tokens=2)
    warm.run_until_drained()
    del warm
    eng = InferenceEngine(cfg, params, eos_token=cfg.padded_vocab, device=device, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    K.reset_launches()  # the run starts here
    K5.reset_launches()
    K3.reset_launches()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats()
    name = f"{cfg.name} {s['cache_kind']}"
    if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
        fail(f"{name}: requests did not all finish by length: {[(r.finish_reason, len(r.generated)) for r in reqs]}")
    first_tokens = sum(1 for e in eng.tracer.events if e.name == "first_token")
    if first_tokens != len(reqs) or s["prefill_chunks"] != len(reqs):
        fail(f"{name}: {first_tokens} first tokens and {s['prefill_chunks']} prefills for {len(reqs)} requests")
    h_decode = eng.metrics.histogram("engine_decode_seconds")
    out = {
        "cache_kind": s["cache_kind"], "requests": len(reqs), "wall_s": wall, "tokens_out": s["tokens_out"],
        "decode_steps": s["decode_steps"], "prefill_tokens": s["prefill_tokens"], "peak_active": s["peak_active"],
        "ttft_p50_s": float(np.median([r.ttft for r in reqs])), "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
        "ttft_s": [r.ttft for r in reqs], "decode_step_p50_s": h_decode.percentile(50),
        "output_tok_s": s["tokens_out"] / wall, "dispatches_per_step": s["dispatches_per_step"],
        "cache_bytes": s["cache_bytes"], "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {"paged_decode": K.LAUNCHES["paged_decode"], "paged_prefill": K.LAUNCHES["paged_prefill"],
                     "rwkv6_scan": K5.LAUNCHES["rwkv6_scan"], "flash_attention": K3.LAUNCHES["flash_attention"]},
    }
    if s["cache_kind"] == "paged":
        out.update(alloc_blocks_in_use=s["alloc_blocks_in_use"], alloc_peak_in_use=s["alloc_peak_in_use"],
                   block_size=s["block_size"])
    else:  # a slot whose ring holds a position past 0 (an idle row writes position 0) after the drain
        pos = eng.cache["self"]["pos"] if cfg.family == "vlm" else eng.cache.get("pos")
        if pos is not None:
            out["slots_with_history_after_drain"] = sum(int((pos[..., b, :] > 0).any()) for b in range(pos.shape[-2]))
    tokens = [list(r.generated) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return out, tokens


def decode_bound(cfg, params, lens, window=0) -> tuple[float, float]:
    """(bound ms, bytes) of one decode step over ``lens``: every weight read
    once, the bf16 K/V rows a slot's query can see, and each slot's
    recurrent states read and written once (hybrid: conv in fp32 after the
    first step, ssm fp32; ssm: tm_x, cm_x and the WKV state, fp32).  vlm:
    every weight but the embedding table (the step gathers B of its rows),
    the self layers' visible bf16 K/V and each slot's bf16 image K/V."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.utils.tree import tree_leaves

    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    L, B = cfg.num_layers, len(lens)
    if cfg.family == "vlm":
        nbytes -= params["embed"]["tok"].numel() * params["embed"]["tok"].element_size()
        groups = L // cfg.vision.cross_attn_every
        kv_row = 2 * cfg.num_kv_heads * cfg.head_dim * 2  # k and v, bf16
        nbytes += sum(lens) * (L - groups) * kv_row + B * groups * cfg.vision.num_image_tokens * kv_row
    elif cfg.family == "hybrid":
        vis = sum(min(n, window) if window else n for n in lens)
        nbytes += vis * L * 2 * cfg.num_kv_heads * cfg.head_dim * 2
        di, K_, N = ssm_mod.d_inner(cfg), cfg.ssm.conv_width, cfg.ssm.state_size
        nbytes += 2 * B * L * 4 * ((K_ - 1) * di + cfg.num_heads * ssm_mod.head_dim_inner(cfg) * N)
    else:
        H, n = cfg.num_heads, cfg.rwkv.head_size
        nbytes += 2 * B * L * 4 * (2 * cfg.d_model + H * n * n)
    return bound(nbytes, 0, FP32_FLOPS_PER_S)[0], nbytes


def hybrid_serving_phase(cfg, params, device) -> dict:
    """hymba-1.5b on ``InferenceEngine``: the serving phase's 8 prompts and
    one of ``HYMBA_LONG`` tokens (32 new each) on the paged cache (bf16
    pools, block 32, 4 slots, max_seq 1536; K1 one launch a layer a decode
    step, blocks all back after the drain) and on the dense slot cache
    (the same tokens up to near-ties, no K1); then one decode step at
    ``HYMBA_LENS`` profiled against its bound."""
    L = cfg.num_layers
    prompts = serving_prompts(cfg, SEED)
    prompts.append([int(t) for t in np.random.default_rng(SEED + 11).integers(0, cfg.vocab_size, HYMBA_LONG)])
    paged, paged_tokens = serve_recurrent(cfg, params, device, prompts, **HYMBA_ENGINE)
    dense, dense_tokens = serve_recurrent(cfg, params, device, prompts, cache_kind="dense", **HYMBA_ENGINE)
    found: list = []
    tie_gate = same_up_to_ties(cfg, params, device, prompts, dense_tokens, paged_tokens, found)
    prof = profile_phase(cfg, params, device, lens=HYMBA_LENS, nb=HYMBA_NB)
    bound_ms, nbytes = decode_bound(cfg, params, HYMBA_LENS, cfg.sliding_window)
    out = {
        "phase": "hybrid_serving", "model": cfg.name, "paged": paged, "dense": dense,
        "dense_vs_paged": {"same_up_to_ties": tie_gate, "differences": found[0],
                           "tokens": token_differences(dense_tokens, paged_tokens)},
        "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "device_launches_per_step",
                                         "paged_decode_ms", "top_kernels_ms")},
        "step_bound_ms": bound_ms, "step_bytes": nbytes,
    }
    emit(out)
    pl = paged["launches"]
    if pl["paged_decode"] != L * paged["decode_steps"] or pl["paged_decode"] == 0 or pl["paged_prefill"] != 0:
        fail(f"hymba paged serving: K1 did not run once a layer a decode step: {pl}, {paged['decode_steps']} steps")
    if dense["launches"]["paged_decode"] != 0 or dense["cache_kind"] != "dense" or paged["cache_kind"] != "paged":
        fail(f"hymba dense serving ran K1 or the layouts are wrong: {dense}")
    if paged["alloc_blocks_in_use"] != 0:
        fail(f"hymba paged serving left {paged['alloc_blocks_in_use']} blocks in use")
    if not tie_gate:
        fail(f"hymba dense tokens differ from the paged ones away from a near tie: {out['dense_vs_paged']}")
    return out


def rwkv_serving_phase(cfg, params, device) -> dict:
    """rwkv6-7b at full width and depth on ``InferenceEngine`` asked for the
    paged cache, which the ssm family turns into the dense slot cache: the
    serving phase's 8 prompts (32 new each), 4 slots, the chunked scan in
    prefill (no K5, which computes no state) and ``time_mix_step`` in
    decode; one decode step profiled against its bound; the state check."""
    from repro_torch.models import decode_step
    from repro_torch.serving.kvcache import make_engine_cache

    prompts = serving_prompts(cfg, SEED)
    served, _ = serve_recurrent(cfg, params, device, prompts, **RWKV_ENGINE)
    B = RWKV_ENGINE["max_batch"]
    cache = make_engine_cache(cfg, B, RWKV_ENGINE["max_seq"], torch.bfloat16, device=device)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos = torch.tensor([n - 1 for n in DECODE_LENS], dtype=torch.int32, device=device)

    def step():
        decode_step(cfg, params, cache, tok, pos)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    by_name, launches, _, _ = profiled(step, 5)
    busy = sum(by_name.values())
    del cache
    bound_ms, nbytes = decode_bound(cfg, params, DECODE_LENS)
    state = state_check(cfg, params, device, prompts[:B], "state")
    out = {
        "phase": "rwkv_serving", "model": cfg.name, "served": served,
        "profile": {"what": "decode_step, 4 slots, dense slot cache, fp32 weights", "wall_ms": wall_ms,
                    "device_busy_ms": busy if by_name else None,
                    "idle_share": 1.0 - busy / wall_ms if by_name else None, "device_launches_per_step": launches,
                    "top_kernels_ms": [[n[:90], ms] for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]},
        "step_bound_ms": bound_ms, "step_bytes": nbytes, "state_check": state,
    }
    emit(out)
    if served["cache_kind"] != "dense" or any(served["launches"].values()):
        fail(f"rwkv serving: not the dense slot cache, or a kernel ran (K5 computes no state): {served}")
    if not state["finite"] or not state["max_abs_err"] < state["tol"]:
        fail(f"rwkv state check: {state}")
    if not state["control_max_abs_err"] > state["tol"]:
        fail(f"the rwkv state check's control passes, which then proves nothing: {state}")
    return out


# ---------------------------------------------------------------------------
# phase 5k: the vlm family (llama-3.2-vision-90b at full width, 2 of 20 groups)
# ---------------------------------------------------------------------------

VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 10  # of 100: two groups of (4 self + 1 cross), 42.6 GB of fp32 weights
VLM_ENGINE = dict(max_batch=4, max_seq=1024, cache_dtype=torch.bfloat16)
VLM_PATH_PROMPT, VLM_PATH_STEPS = 64, 8  # two prompts, then decode steps
# vlm_path: each decode step's logits (fp32 caches) against the teacher-
# forced forward's at the same position, max |difference|; the two differ
# in summation order only (fp32 throughout, the cross layers' image K/V
# from the same projection).  The control zeroes the cached ck of every
# cross layer, which the limit must reject.  On the H100 (PERF.md, vlm)
# the sound run read 3.2e-5 and the control 1.74e-3 (random image tokens
# give nearly flat attention over 1600 keys, so flattening it moves the
# logits little); the limit lies between the two, a factor 7-8 from each.
VLM_PATH_TOL = 2.5e-4
VLM_EVAL_B, VLM_EVAL_S = 2, 2048


def open_gates(params) -> None:
    """Random init leaves both tanh gates of every cross layer at 0, which
    makes each cross layer the identity: set them to 1.0 (tanh 0.76), in
    place."""
    for group in params["blocks"]:
        group["cross"]["attn"]["gate"].fill_(1.0)
        group["cross"]["gate_mlp"].fill_(1.0)


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def vlm_path_phase(cfg, params, device) -> dict:
    """Two prompts of ``VLM_PATH_PROMPT`` tokens with random image tokens
    (B, 1600, 8192) from the seed, each prefilled alone into its slot of an
    fp32 slot cache, then ``VLM_PATH_STEPS`` decode steps teacher-forced,
    every step's logits (and the prefill's) against ``forward``'s over the
    whole sequence (``VLM_PATH_TOL``); the control decodes with the cached
    ck zeroed."""
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.serving.kvcache import make_engine_cache, write_prefill_into_slot

    B, P, T = 2, VLM_PATH_PROMPT, VLM_PATH_STEPS
    g = torch.Generator(device=device).manual_seed(SEED + 21)
    vis = torch.randn((B, cfg.vision.num_image_tokens, cfg.d_model), generator=g, device=device)
    tokens = torch.tensor(np.random.default_rng(SEED + 22).integers(0, cfg.vocab_size, (B, P + T)),
                          dtype=torch.int32, device=device)
    with torch.no_grad():
        ref = forward(cfg, params, {"tokens": tokens, "vision_tokens": vis})[0]  # (B, P + T, V)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = make_engine_cache(cfg, B, P + T, torch.float32, device=device)
    first = []
    for b in range(B):
        lg, raw = prefill(cfg, params, {"tokens": tokens[b : b + 1, :P], "vision_tokens": vis[b : b + 1]})
        write_prefill_into_slot(cfg, cache, raw, b, seq_filled=P)
        first.append(lg[0])
        del raw
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    control = clone_tree(cache)
    control["cross"]["ck"].zero_()
    errs = [float((torch.stack(first) - ref[:, P - 1]).abs().max())]
    ctrl_errs, finite, argmax_equal = [], True, 0
    for t in range(T):
        tok, pos = tokens[:, P + t : P + t + 1], torch.full((B,), P + t, dtype=torch.int32, device=device)
        lg, cache = decode_step(cfg, params, cache, tok, pos)
        cl, control = decode_step(cfg, params, control, tok, pos)
        errs.append(float((lg - ref[:, P + t]).abs().max()))
        ctrl_errs.append(float((cl - ref[:, P + t]).abs().max()))
        finite = finite and bool(torch.isfinite(lg).all())
        argmax_equal += int((lg.argmax(-1) == ref[:, P + t].argmax(-1)).sum())
    out = {
        "phase": "vlm_path", "model": cfg.name, "layers": cfg.num_layers, "gates": "gate = gate_mlp = 1.0 (tanh 0.76)",
        "what": f"prefill of {P} tokens, then {T} teacher-forced decode steps over fp32 caches, against forward",
        "image_tokens": list(vis.shape), "prefill_s": prefill_s, "prefill_peak_mem_gb": prefill_peak,
        "max_abs_err": errs, "tol": VLM_PATH_TOL, "control": "ck zeroed in every cross layer",
        "control_max_abs_err": ctrl_errs, "finite": finite, "same_argmax": f"{argmax_equal} of {B * T}",
        "logits_std": float(ref[..., : cfg.vocab_size].std()),
    }
    emit(out)
    del cache, control, ref
    torch.cuda.empty_cache()
    if not finite or not max(errs) < VLM_PATH_TOL:
        fail(f"vlm decode differs from the teacher-forced forward: {out}")
    if not min(ctrl_errs) > VLM_PATH_TOL:
        fail(f"the vlm path's control (ck zeroed) passes the limit, which then proves nothing: {out}")
    return out


def teacher_forced_deficits(cfg, params, device, prompts, tokens, tol=PATH_TOL) -> list[dict]:
    """Each served token against one teacher-forced ``forward`` over its
    request's prompt and served tokens (zero image tokens, as the engine
    feeds; fp32): every position whose token is not the forward's argmax,
    with how far its logit sits below the maximum there, a near tie below
    ``tol``."""
    from repro_torch.models import forward

    zeros = torch.zeros((1, cfg.vision.num_image_tokens, cfg.d_model), device=device)
    found = []
    for i, (p, t) in enumerate(zip(prompts, tokens)):
        ctx = torch.tensor([p + t[:-1]], dtype=torch.int32, device=device)
        with torch.no_grad():
            lg = forward(cfg, params, {"tokens": ctx, "vision_tokens": zeros})[0][0, len(p) - 1 :]
        served = torch.tensor(t, device=device)
        deficit = lg.max(-1).values - lg.gather(1, served[:, None].long())[:, 0]
        for j in (deficit > 0).nonzero().flatten().tolist():
            found.append({"request": i, "position": j, "deficit": float(deficit[j]), "near_tie": float(deficit[j]) < tol})
        del lg
    return found


def vlm_serving_phase(cfg, params, device) -> dict:
    """llama-3.2-vision on ``InferenceEngine`` asked for the paged cache,
    which the vlm family serves on the dense slot cache: the serving phase's
    8 prompts (32 new each), 4 slots, a bf16 ring of 1024, zero image tokens
    (the engine's feed; with no K/V biases their projected K/V are zero).
    Every served token equals the teacher-forced forward's argmax up to a
    near tie; the control, an engine whose admitted rings sit one slot off,
    must not.  Then one decode step at ``DECODE_LENS`` profiled against its
    bound."""
    from repro_torch.serving import InferenceEngine

    prompts = serving_prompts(cfg, SEED)
    served, tokens = serve_recurrent(cfg, params, device, prompts, **VLM_ENGINE)
    sound = teacher_forced_deficits(cfg, params, device, prompts, tokens)
    ctrl_eng = ring_one_slot_off(InferenceEngine)(cfg, params, eos_token=cfg.padded_vocab, device=device, **VLM_ENGINE)
    ctrl_reqs = [ctrl_eng.submit(p, max_new_tokens=FIG9_CONTROL_NEW) for p in prompts[:4]]
    ctrl_eng.run_until_drained()
    ctrl_tokens = [list(r.generated) for r in ctrl_reqs]
    del ctrl_eng
    control = teacher_forced_deficits(cfg, params, device, prompts[:4], ctrl_tokens)
    nb = VLM_ENGINE["max_seq"] // BLOCK_SIZE
    prof = profile_phase(cfg, params, device, cache_kind="dense", nb=nb)
    bound_ms, nbytes = decode_bound(cfg, params, DECODE_LENS)
    out = {
        "phase": "vlm_serving", "model": cfg.name, "served": served, "gates": "gate = gate_mlp = 1.0 (tanh 0.76)",
        "teacher_forced": {"tol": PATH_TOL, "differences": sound, "all_near_ties": all(d["near_tie"] for d in sound)},
        "control": {"what": f"each admitted ring one slot off, {FIG9_CONTROL_NEW} new tokens, 4 requests",
                    "differences": control[:8], "count": len(control),
                    "all_near_ties": all(d["near_tie"] for d in control)},
        "profile": {k: prof[k] for k in ("what", "wall_ms", "device_busy_ms", "idle_share", "device_launches_per_step",
                                         "top_kernels_ms")},
        "step_bound_ms": bound_ms, "step_bytes": nbytes,
    }
    emit(out)
    if served["cache_kind"] != "dense" or any(served["launches"].values()):
        fail(f"vlm serving: not the dense slot cache, or a kernel ran: {served}")
    if served["slots_with_history_after_drain"] != 0:
        fail(f"vlm serving left {served['slots_with_history_after_drain']} slots with history after the drain")
    if not out["teacher_forced"]["all_near_ties"]:
        fail(f"vlm served tokens differ from the teacher-forced argmax away from a near tie: {out['teacher_forced']}")
    if not control or out["control"]["all_near_ties"]:
        fail(f"the vlm serving control (rings one slot off) passes the tie gate, which then proves nothing: {out}")
    return out


def vlm_eval_phase(cfg, params, device) -> dict:
    """``eval_phase`` on llama-3.2-vision: a synthetic batch of
    ``VLM_EVAL_B`` x ``VLM_EVAL_S`` tokens with random image tokens, bf16
    compute, K3 (one launch a self layer) against the torch attention, with
    the eval's control; beside it the forward's bound (``bound``: its
    matmul operations at the bf16 peak, the weights but the embedding
    table read once)."""
    from repro_torch.data import synthetic_batch
    from repro_torch.utils.tree import tree_leaves

    batch = synthetic_batch(cfg, step=0, global_batch=VLM_EVAL_B, seq_len=VLM_EVAL_S, seed=SEED, device=device)
    out = eval_phase(cfg, params, batch)
    T, S, N, hd = VLM_EVAL_B * VLM_EVAL_S, VLM_EVAL_S, cfg.vision.num_image_tokens, cfg.head_dim
    weights = sum(t.numel() for t in tree_leaves(params)) - params["embed"]["tok"].numel()
    groups = cfg.num_layers // cfg.vision.cross_attn_every
    # projections and head (2 per weight per token; the image K/V: 2 per
    # wk/wv weight per image token), causal self attention, cross attention
    d_kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    flops = (2 * T * (weights - groups * d_kv) + 2 * VLM_EVAL_B * N * groups * d_kv
             + 4 * hd * cfg.num_heads * VLM_EVAL_B * (S * (S + 1) // 2) * self_attention_layers(cfg)
             + 4 * hd * cfg.num_heads * T * N * groups)
    bound_ms, bound_by = bound(weights * 4, flops, BF16_FLOPS_PER_S)
    out = {"phase": "vlm_eval", "model": cfg.name, "loss": out["loss"], "warm_wall_s": out["warm_wall_s"],
           "k3_launches": out["k3_launches"], "flash_vs_torch": out["flash_vs_torch"],
           "control_vs_torch": out["control_vs_torch"], "forward_tflop": flops / 1e12, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(out)
    del batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path at full width
# ---------------------------------------------------------------------------


def path_phase(cfg, params, device) -> dict:
    from repro_torch.models import decode_step, init_paged_cache, prefill_step

    rng = np.random.default_rng(SEED + 1)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, 2 * PREFILL_C + 1), dtype=torch.int32, device=device)
    B, nb = 4, NB
    row = torch.arange(1, nb + 1, dtype=torch.int32, device=device)[None]
    logits = {}
    for impl in ("kernel", "plain"):
        cache = init_paged_cache(cfg, 1 + B * nb, BLOCK_SIZE, B, nb, torch.bfloat16, device=device)
        outs = []
        for start in (0, PREFILL_C):  # the second chunk attends over the first
            lg, cache = prefill_step(
                cfg, params, cache, tokens[None, start : start + PREFILL_C],
                torch.tensor([start], dtype=torch.int32, device=device), row, attn_impl=impl,
            )
            outs.append(lg)
        cache["tbl"][0] = row[0]  # slot 0 decodes, slots 1-3 stay null
        tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
        tok[0, 0] = tokens[2 * PREFILL_C]
        pos = torch.zeros((B,), dtype=torch.int32, device=device)
        pos[0] = 2 * PREFILL_C
        lg, cache = decode_step(cfg, params, cache, tok, pos, attn_impl=impl)
        outs.append(lg[:1])
        logits[impl] = outs
    errs = [float((a - b).abs().max()) for a, b in zip(logits["kernel"], logits["plain"])]
    finite = all(bool(torch.isfinite(t).all()) for t in logits["kernel"])
    out = {
        "phase": "path", "model": cfg.name, "calls": ["prefill@0", f"prefill@{PREFILL_C}", f"decode@{2 * PREFILL_C}"],
        "max_abs_err": errs, "tol": PATH_TOL, "finite": finite,
        "logits_std": float(logits["plain"][0].std()),
    }
    emit(out)
    if not finite or max(errs) >= PATH_TOL:
        fail(f"kernel path logits differ from plain path by {errs} (tol {PATH_TOL}) or are not finite")
    return out


# ---------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# ---------------------------------------------------------------------------


# record_function spans of the port's code; the profiler puts each on the
# device's timeline too, beside the kernels inside it
SPANS = ("fp8_layout_copy",)


def profiled(fn, steps: int = 1, cpu: bool = True) -> tuple[dict, float, float, dict]:
    """``fn()`` run ``steps`` times under ``torch.profiler``: (device ms by
    kernel name, device launches, wall ms under the profiler, device ms of
    each span of ``SPANS``), each per run.  ``cpu=False`` traces the device
    alone (no spans): a step of tens of thousands of launches then takes
    seconds, not tens of seconds, to read back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict[str, float] = {}
    by_span = dict.fromkeys(SPANS, 0.0)
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / steps
        if e.name in by_span:  # the span's range on the device, not a kernel
            by_span[e.name] += ms
        else:
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            launches += 1
    return by_name, launches / steps, wall_ms, by_span


# kernel kinds by name: cuBLAS's Hopper GEMMs are named nvjet_*, its GEMVs
# gemv*; PyTorch's elementwise kernels (casts and copies among them)
# *elementwise_kernel*
KERNEL_KINDS = {"gemm": ("gemm", "nvjet", "xmma", "cutlass"), "gemv": ("gemv",),
                "elementwise": ("elementwise_kernel",), "softmax": ("softmax",), "indexing": ("index",)}


def ms_by_kind(by_name: dict) -> dict:
    """Device ms summed by ``KERNEL_KINDS``, and the rest."""
    out = {kind: sum(v for k, v in by_name.items() if any(s in k.lower() for s in subs))
           for kind, subs in KERNEL_KINDS.items()}
    out["other"] = sum(by_name.values()) - sum(out.values())
    return out


def profile_phase(cfg, params, device, steps=5, quantize_kv=False, cache_kind="paged", lens=DECODE_LENS, nb=NB) -> dict:
    """The 4-slot decode step at the kernel phase's lengths: host wall time
    per step (no profiler), then device time by kernel under
    ``torch.profiler``.  Idle share = 1 - device busy / wall.  With
    ``quantize_kv`` the pools are int8 / e4m3 and read plain; with
    ``cache_kind="dense"`` the step reads the dense ring cache (4 rows of
    512 slots, each slot's history filled to its length).  ``lens`` and
    ``nb``: the slots' lengths and the table width (hymba: its decode
    shapes, a window the last slots outrun; its states zero; vlm: the
    ring's width is ``nb * BLOCK_SIZE``, its image K/V zero)."""
    from repro_torch.models import decode_step, init_paged_cache
    from repro_torch.serving.kvcache import make_engine_cache

    B = len(lens)
    if cache_kind == "dense":
        cache = make_engine_cache(cfg, B, nb * BLOCK_SIZE, torch.bfloat16, device=device)
        pos_leaf = cache["self"]["pos"] if cfg.family == "vlm" else cache["pos"]  # (..., B, W)
        for b, n in enumerate(lens):
            pos_leaf[..., b, : n - 1] = torch.arange(n - 1, dtype=torch.int32, device=device)
    else:
        cache = init_paged_cache(cfg, 1 + B * nb, BLOCK_SIZE, B, nb, torch.bfloat16, quantized=quantize_kv,
                                 device=device)
        cache["tbl"].copy_(torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=device)

    def step():
        decode_step(cfg, params, cache, tok, pos)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, launches, _, _ = profiled(step, steps)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    layout = "a bf16 ring cache" if cache_kind == "dense" else f"{quantize_kv or 'bf16'} pools"
    out = {
        "phase": "profile", "model": cfg.name,
        "what": f"decode_step, 4 slots, {layout}, fp32 weights",
        "wall_ms": wall_ms, "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / wall_ms if by_name else None,
        "device_launches_per_step": launches,
        "paged_decode_ms": sum(v for k, v in by_name.items() if "paged_decode_kernel" in k),
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2b: K3 and K4 against their plain versions
# ---------------------------------------------------------------------------

# K3 cases: name, (B, H, KV, Sq, Skv, hd), dtype, causal, window, softcap,
# q scale.  The first is the training path's shape (olmo-1b, batch 4 x 2048
# tokens).  The softcap case scales q by 8 so that the scores (standard
# deviation 8) reach the cap: at scale 1 a cap of 30 moves a score by only
# about s^3/2700.  hubert-xlarge (16 heads of 80, a bidirectional encoder)
# and stablelm-12b (32 heads of 160 over 8 kv heads) have head dims that TMA
# pads to a multiple of 64.  The no-key cases (Sq > Skv with a window)
# hold rows >= 256 + 63 that see no key, where the Pallas kernel averages V
# over all keys.
FLASH_CASES = [
    ("olmo-1b", (4, 16, 16, 2048, 2048, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("gqa-32/8", (1, 32, 8, 2048, 2048, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("window-256", (4, 16, 16, 2048, 2048, 128), torch.bfloat16, True, 256, 0.0, 1.0),
    ("gemma-7b-softcap", (1, 16, 16, 2048, 2048, 256), torch.bfloat16, True, 0, 30.0, 8.0),
    ("olmo-1b-fp32", (1, 16, 16, 2048, 2048, 128), torch.float32, True, 0, 0.0, 1.0),
    ("ragged-1000", (2, 16, 16, 1000, 1000, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("hubert-xlarge-hd80", (2, 16, 16, 1500, 1500, 80), torch.bfloat16, False, 0, 0.0, 1.0),
    ("stablelm-12b-hd160", (1, 32, 8, 2048, 2048, 160), torch.bfloat16, True, 0, 0.0, 1.0),
    ("no-key", (1, 4, 2, 512, 256, 128), torch.bfloat16, True, 64, 0.0, 1.0),
    ("no-key-fp32", (1, 4, 2, 512, 256, 128), torch.float32, True, 64, 0.0, 1.0),
    # llama-3.2-vision-90b's self layers at the vlm eval's shape: 8 query
    # heads per kv head
    ("llama-3.2-vision", (2, 64, 8, 2048, 2048, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    # the eval forwards of the moe, hybrid and audio training phases:
    # qwen3-moe's 16 query heads per kv head, hymba's window of 1024 at 25
    # heads over 5, hubert's bidirectional hd 80 (padded to 128 by TMA)
    ("qwen3-moe-235b-a22b", (2, 64, 4, 2048, 2048, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("hymba-1.5b", (4, 25, 5, 2048, 2048, 64), torch.bfloat16, True, 1024, 0.0, 1.0),
    ("hubert-xlarge", (4, 16, 16, 2048, 2048, 80), torch.bfloat16, False, 0, 0.0, 1.0),
]
FAMILY_FLASH_CASES = ("qwen3-moe-235b-a22b", "hymba-1.5b", "hubert-xlarge")
# K3 against its plain version.  Both keep scores and the sums in fp32 and P
# at fp32 accuracy (the bf16 kernel carries P as two bf16 terms, good to
# about 2^-17) and differ only in the order of the sums, far below a bf16
# spacing.  So with bf16 outputs the two roundings differ by at most one
# bf16 spacing of the row's largest |output|, and only where the fp32 values
# straddle a rounding boundary; with fp32 outputs sums of up to 2048 terms
# in another order differ by tens of fp32 spacings of it.  The mean error
# relative to the mean |output| then stays near 1e-6.  The controls,
# computed in every run, are the plain version with P rounded to bf16
# before P.V and, in the softcap case, without the cap; the limits lie
# between the readings of the sound runs and of the controls on the H100
# (PERF.md), and the script fails if a control passes the checks.
FLASH_MAX_SPACINGS = {torch.bfloat16: 1.0, torch.float32: 512.0}
FLASH_MEAN_RTOL = 2e-5

TRAIN_B, TRAIN_S = 4, 2048  # 8192 tokens per step
# K4 cases at M = 8192 tokens: name, (M, K, N), operand dtypes, transposes
D_MODEL, D_FF, M_TOK = 2048, 8192, TRAIN_B * TRAIN_S
GEMM_CASES = [
    ("fwd attn_q/k/v/o", (M_TOK, D_MODEL, D_MODEL), ("e4m3", "e4m3"), (False, False)),
    ("fwd ffn_up/gate", (M_TOK, D_MODEL, D_FF), ("e4m3", "e4m3"), (False, False)),
    ("fwd ffn_down", (M_TOK, D_FF, D_MODEL), ("e4m3", "e4m3"), (False, False)),
    ("bwd dx attn_q/k/v/o: g @ w.T", (M_TOK, D_MODEL, D_MODEL), ("e5m2", "e4m3"), (False, True)),
    ("bwd dw attn_q/k/v/o: x.T @ g", (D_MODEL, M_TOK, D_MODEL), ("e4m3", "e5m2"), (True, False)),
    ("bwd dx ffn_up/gate: g @ w.T", (M_TOK, D_FF, D_MODEL), ("e5m2", "e4m3"), (False, True)),
    ("bwd dw ffn_up/gate: x.T @ g", (D_MODEL, M_TOK, D_FF), ("e4m3", "e5m2"), (True, False)),
    ("bwd dx ffn_down: g @ w.T", (M_TOK, D_MODEL, D_FF), ("e5m2", "e4m3"), (False, True)),
    ("bwd dw ffn_down: x.T @ g", (D_FF, M_TOK, D_MODEL), ("e4m3", "e5m2"), (True, False)),
    ("ragged", (1000, 1000, 1000), ("e4m3", "e4m3"), (False, False)),
    # the projections of the moe, hybrid and audio training phases:
    # qwen3-moe (2 x 2048 tokens, d_model 4096, 64 x 128 query and 4 x 128
    # kv columns), hymba-1.5b (1600, 5 x 64 kv columns, FFN 5504) and
    # hubert-xlarge (1280, FFN 5120)
    ("qwen3-moe fwd attn_q", (4096, 4096, 8192), ("e4m3", "e4m3"), (False, False)),
    ("qwen3-moe fwd attn_k/v", (4096, 4096, 512), ("e4m3", "e4m3"), (False, False)),
    ("hymba fwd attn_k/v", (M_TOK, 1600, 320), ("e4m3", "e4m3"), (False, False)),
    ("hymba fwd ffn_down", (M_TOK, 5504, 1600), ("e4m3", "e4m3"), (False, False)),
    ("hymba bwd dw attn_k/v: x.T @ g", (1600, M_TOK, 320), ("e4m3", "e5m2"), (True, False)),
    ("hubert fwd attn_q/k/v/o", (M_TOK, 1280, 1280), ("e4m3", "e4m3"), (False, False)),
    ("hubert fwd ffn_up", (M_TOK, 1280, 5120), ("e4m3", "e4m3"), (False, False)),
    ("hubert bwd dx ffn_up: g @ w.T", (M_TOK, 5120, 1280), ("e5m2", "e4m3"), (False, True)),
    # olmo-1b's projections on one rank of the sharded_train phase: TP=2
    # (the column slice of up/gate, the row slice of down, down's dx on the
    # transposed slice) and DP=2 (half the rows, the gathered weight)
    ("tp2 fwd ffn_up/gate", (M_TOK, D_MODEL, D_FF // 2), ("e4m3", "e4m3"), (False, False)),
    ("tp2 fwd ffn_down", (M_TOK, D_FF // 2, D_MODEL), ("e4m3", "e4m3"), (False, False)),
    ("tp2 bwd dx ffn_down: g @ w.T", (M_TOK, D_MODEL, D_FF // 2), ("e5m2", "e4m3"), (False, True)),
    ("dp2 fwd ffn_up/gate", (M_TOK // 2, D_MODEL, D_FF), ("e4m3", "e4m3"), (False, False)),
    # one rank's projections in the sharded_families phase at TP=2:
    # qwen3-moe's attn_q (2 x 2048 tokens, 32 of 64 query heads of 128) and
    # hymba's ffn_up (2752 of 5504 columns: N not a multiple of 128)
    ("tp2 qwen3-moe fwd attn_q", (4096, 4096, 4096), ("e4m3", "e4m3"), (False, False)),
    ("tp2 hymba fwd ffn_up/gate", (M_TOK, 1600, 5504 // 2), ("e4m3", "e4m3"), (False, False)),
]
FAMILY_GEMM_CASES = [name for name, *_ in GEMM_CASES if name.split()[0] in ("qwen3-moe", "hymba", "hubert")]
SHARDED_GEMM_CASES = [name for name, *_ in GEMM_CASES if name.split()[0] in ("tp2", "dp2")]
# K4 against its plain version: its products are exact and its sums fp32,
# so only the order of the fp32 sums differs; relative to the output's
# largest magnitude.  The control, computed in every case, is the plain GEMM
# without its last 32 k-elements; the script fails if it passes.  Each case
# also reads torch._scaled_mm's error against the plain version.
GEMM_RTOL = 1e-5


def flash_work(B, H, KV, Sq, Skv, hd, itemsize, causal, window) -> tuple[int, int]:
    """(bytes, operations) of one call: q, k, v read once, the output written
    once; 4 hd operations (QK^T and PV multiply-adds) per visible (query,
    key) pair, and the mean of V over all Skv keys for a row that sees no
    key."""
    r = np.arange(Sq)
    lo = np.maximum(0, r - window + 1) if window else np.zeros_like(r)
    hi = np.minimum(Skv, r + 1) if causal else np.full_like(r, Skv)
    seen = np.maximum(0, hi - lo)
    ops = int(seen.sum()) * 4 * hd + int((seen == 0).sum()) * Skv * hd
    nbytes = (2 * B * H * Sq * hd + 2 * B * KV * Skv * hd) * itemsize
    return nbytes, B * H * ops


def flash_passes(r, dt) -> bool:
    return r["max_spacings"] <= FLASH_MAX_SPACINGS[dt] and r["mean_rel"] <= FLASH_MEAN_RTOL


def finite_or_none(r: dict) -> dict:
    return {k: v if np.isfinite(v) else None for k, v in r.items()}


def flash_phase(device) -> tuple[dict, dict]:
    """Every K3 case against its plain version: (the training path's row,
    every row by case name)."""
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels.flash_attention_ref import flash_attention_plain, flash_attention_split_p, flash_errors

    main, rows = None, {}
    for seed, (name, (B, H, KV, Sq, Skv, hd), dt, causal, window, cap, q_scale) in enumerate(FLASH_CASES):
        g = torch.Generator(device=device).manual_seed(100 + seed)
        q = (q_scale * torch.randn((B, H, Sq, hd), generator=g, device=device)).to(dt)
        k = torch.randn((B, KV, Skv, hd), generator=g, device=device).to(dt)
        v = torch.randn((B, KV, Skv, hd), generator=g, device=device).to(dt)
        kw = dict(causal=causal, window=window, softcap=cap)
        out = K3.flash_attention_bhsd(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        errs = flash_errors(out, ref)
        controls = {"p_bf16": flash_errors(flash_attention_split_p(q, k, v, terms=1, **kw), ref)}
        if cap:
            controls["no_softcap"] = flash_errors(flash_attention_plain(q, k, v, causal=causal, window=window), ref)
        model_layout_equal = None
        if seed == 0:  # the model's (B, S, H, hd) tensors, strided views in the kernel
            qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            model_layout_equal = torch.equal(K3.flash_attention(qm, km, vm, **kw).transpose(1, 2), out)
            del qm, km, vm
        del out
        lib = lib_errors = None
        if not cap:  # SDPA has no softcap
            mask = None
            if window or (causal and Sq != Skv):
                rel = torch.arange(Sq, device=device)[:, None] - torch.arange(Skv, device=device)[None, :]
                mask = (rel >= 0) & (rel < window) if window else rel >= 0

            def lib(i, mask=mask):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                                                      enable_gqa=H != KV)

            lib_errors = finite_or_none(flash_errors(lib(0), ref))
        del ref
        nbytes, flops = flash_work(B, H, KV, Sq, Skv, hd, q.element_size(), causal, window)
        rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
        bound_ms, bound_by = bound(nbytes, flops, rate)
        # the bound counts the head dim's own work; TMA pads it to a
        # multiple of 64, whose products the tensor cores also do
        hd_pad = -(-hd // 64) * 64
        row = {
            "phase": "kernel", "kernel": "flash_attention", "case": name, "shape": [B, H, KV, Sq, Skv, hd],
            "dtype": str(dt).replace("torch.", ""), "route": K3.ROUTES[dt], "causal": causal, "window": window,
            "softcap": cap, "q_scale": q_scale, "max_abs_err": errs["max_abs"], "errors": errs, "controls": controls,
            "library_errors": lib_errors,
            "tol": {"max_spacings": FLASH_MAX_SPACINGS[dt], "mean_rel": FLASH_MEAN_RTOL},
            "model_layout_equal": model_layout_equal,
            **kernel_times(lambda i: K3.flash_attention_bhsd(q, k, v, **kw), iters=10, warmup=2),
            # the CUDA-core kernel (v1) on the same bf16 inputs, the yardstick
            "cuda_cores_ms": (timed_ms(lambda i: K3.flash_attention_cuda_cores(q, k, v, **kw), iters=5, warmup=1)
                              if dt == torch.bfloat16 else None),
            "plain_ms": timed_ms(lambda i: flash_attention_plain(q, k, v, **kw), iters=5, warmup=1),
            "library_ms": timed_ms(lib, iters=10, warmup=2) if lib else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "padded_hd": hd_pad, "bound_padded_ms": bound(nbytes, flops * hd_pad / hd, rate)[0],
        }
        emit(row)
        if not flash_passes(errs, dt):
            fail(f"flash_attention {name}: errors {errs} beyond {row['tol']}")
        passing = [c for c, r in controls.items() if flash_passes(r, dt)]
        if passing:
            fail(f"flash_attention {name}: the controls {passing} pass the checks, which then prove nothing")
        if model_layout_equal is False:
            fail(f"flash_attention {name}: the model layout's output differs from the (B, H, S, hd) one")
        main = main or row
        rows[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    return main, rows


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref|."""
    return float((out - ref).abs().max()) / float(ref.abs().max())


def gemm_phase(device) -> dict:
    from repro_torch.fp8 import FP8_DTYPES, compute_scale, quantize, tensor_amax
    from repro_torch.fp8 import gemm as K4
    from repro_torch.fp8.gemm_ref import fp8_gemm_plain

    rows = {}
    for seed, (name, (M, K, N), (fa, fb), (ta, tb)) in enumerate(GEMM_CASES):
        g = torch.Generator(device=device).manual_seed(200 + seed)
        ops = []
        for shape, fmt, tr in (((M, K), fa, ta), ((K, N), fb, tb)):
            x = torch.randn(shape[::-1] if tr else shape, generator=g, device=device)
            sx = compute_scale(tensor_amax(x), FP8_DTYPES[fmt])
            qx = quantize(x, sx, FP8_DTYPES[fmt])
            ops.append((qx.T if tr else qx, sx))  # a transposed view, as the backward passes it
            del x
        (a, sa), (b, sb) = ops
        copies_before = K4.LAUNCHES["fp8_layout_copy"]
        out = K4.fp8_gemm(a, b, sa, sb)
        copies = K4.LAUNCHES["fp8_layout_copy"] - copies_before
        ref = fp8_gemm_plain(a, b, sa, sb)
        err = float((out - ref).abs().max())
        tol = GEMM_RTOL * float(ref.abs().max())
        # the control: the plain GEMM without its last 32 k-elements
        control = float((fp8_gemm_plain(a[:, : K - 32], b[: K - 32], sa, sb) - ref).abs().max())
        kernel_rel_err = rel_err(out, ref)
        del out
        # the operands as the kernel reads them, made outside the timing, and
        # the wrapper's layout copies on their own
        plan_a, plan_b = K4.layout_plan(a, 1), K4.layout_plan(b, 0)
        ak = K4.kmajor_copy(a, 1, plan_a[1])[:, :K] if plan_a[0] else a
        bk = K4.kmajor_copy(b, 0, plan_b[1])[:, :K].T if plan_b[0] else b

        def layout_copies(i):
            if plan_a[0]:
                K4.kmajor_copy(a, 1, plan_a[1])
            if plan_b[0]:
                K4.kmajor_copy(b, 0, plan_b[1])

        lib = lib_err = None
        if M % 16 == 0 and K % 16 == 0 and N % 16 == 0:  # torch._scaled_mm's shape rule
            a_row, b_col = a.contiguous(), b.T.contiguous().T  # its layouts, made outside the timing
            inv_a, inv_b = 1.0 / sa, 1.0 / sb

            def lib(i):
                return torch._scaled_mm(a_row, b_col, scale_a=inv_a, scale_b=inv_b, out_dtype=torch.float32)

            try:
                lib_err = float((lib(0) - ref).abs().max())
            except RuntimeError:  # an operand-type pair it does not take
                lib = None
        del ref
        bound_ms, bound_by = bound(M * K + K * N + 4 * M * N + 8, 2 * M * N * K, FP8_FLOPS_PER_S)
        row = {
            "phase": "kernel", "kernel": "fp8_gemm", "case": name, "mkn": [M, K, N], "dtypes": [fa, fb],
            "transposed": [ta, tb], "max_abs_err": err, "tol": tol, "control_err": control,
            "rel_err": kernel_rel_err, "library_max_abs_err": lib_err, "layout_copies": copies,
            # the wrapper on the operands as the path passes them, its layout
            # copies included; the kernel alone; the copies alone
            **kernel_times(lambda i: K4.fp8_gemm(a, b, sa, sb), iters=20, warmup=3),
            "kernel_alone_ms": timed_ms(lambda i: K4.fp8_gemm(ak, bk, sa, sb), iters=20, warmup=3),
            "layout_copy_ms": timed_ms(layout_copies, iters=20, warmup=3) if copies else 0.0,
            "plain_ms": timed_ms(lambda i: fp8_gemm_plain(a, b, sa, sb), iters=10, warmup=2),
            "library_ms": timed_ms(lib, iters=20, warmup=3) if lib else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(row)
        if not err <= tol:
            fail(f"fp8_gemm {name}: err {err} > {tol}")
        if control <= tol:
            fail(f"fp8_gemm {name}: the control (the last 32 k dropped) passes, err {control} <= {tol}")
        rows[name] = row
        del a, b, ak, bk, ops
        torch.cuda.empty_cache()
    return rows


def kernel_label(mangled: str) -> str:
    """A readable name for a kernel of K4's, K3's or K1/K2's library: its
    template arguments."""
    import re

    dtype = {"f": "fp32", "13__nv_bfloat16": "bf16"}
    if m := re.search(r"paged_prefill_tc_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled):
        return f"prefill_tensor_cores,q={dtype[m[1]]},hd_pad={m[2]}"
    if m := re.search(r"paged_(prefill_kernel|decode_cuda_cores_kernel)I(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)E",
                      mangled):
        return f"{m[1].split('_')[0]}_cuda_cores,q={dtype[m[2]]},pools={'fp32' if m[3] == 'f' else 'bf16'}"
    if m := re.search(r"paged_decode_kernel_splitI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E",
                      mangled):
        return f"decode_split,q={dtype[m[1]]},pools={'fp32' if m[2] == 'f' else 'bf16'},hd_pad={m[3]},rows={m[4]}"
    if m := re.search(r"wkv6_kernel_chunkILi(\d+)ELi(\d+)E", mangled):
        return f"wkv6_chunk,n={m[1]},chunk={m[2]}"
    if m := re.search(r"wkv6_cuda_cores_kernelILi(\d+)ELi(\d+)E", mangled):
        return f"wkv6_cuda_cores,n={m[1]},chunk={m[2]}"
    if m := re.search(r"fp8_gemm_kernelILb(\d)ELb(\d)E", mangled):
        return f"a_e5m2={m[1]},b_e5m2={m[2]}"
    if m := re.search(r"flash_tc_kernelILi(\d+)E", mangled):
        return f"tensor_cores_bf16,hd_pad={m[1]}"
    if m := re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E", mangled):
        return f"cuda_cores_{'fp32' if m[1] == 'f' else 'bf16'},hd<={64 * int(m[2])}"
    return mangled


def hgmma_counts(lib, op: str = "HGMMA") -> dict:
    """Tensor-core instructions in the SASS of each kernel of a library, by
    ``kernel_label``: HGMMA (warpgroup MMA on fp16/bf16 operands) or, with
    ``op="HMMA"``, the warp-level ``mma.sync`` products."""
    import re

    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split("Function :", 1)[1].strip())
            counts[fn] = 0
        elif fn is not None:
            counts[fn] += bool(re.search(rf"\b{op}\b", line))
    return counts


# ---------------------------------------------------------------------------
# phases 6-9: FP8 training at full width and depth
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
# The train path: one kernel step in which every K4 call is also computed by
# the plain GEMM on the same fp8 operands and held to GEMM_RTOL of its
# output's largest magnitude, as the K4 phase holds its cases, with the same
# control (the plain GEMM without its last 32 k-elements); the script fails
# if the control passes in any call.  Then the whole step against the plain
# step from the same state: the fp8 casts of its activations turn a last-bit
# difference in a GEMM's fp32 sum into a flipped fp8 value, so any kernel
# whose sums run in another order than cuBLAS's moves the loss by about 1e-5
# (PERF.md).  An order probe (the plain GEMM with its sums in another fp32
# order, K split in halves) shows what a sound order reads; the control is
# the plain GEMM with 1/(sa sb) rounded to bf16 (up to 2^-9 off, a fault an
# epilogue could have).  Each limit lies between the kernel's and the
# probe's readings and the control's on the H100 (PERF.md); the script fails
# if the kernel or the probe passes one, or the control passes one.  The
# gradient norm does not separate them (the probe reads above the control)
# and is reported only.  Parameters are compared in units of the step's lr,
# since AdamW moves each by about lr whatever its gradient.
PATH_LIMITS = {"loss_rel": 8e-5, "param_mean_over_lr": 4.3e-3}
# flash against torch attention at full width, bf16: the torch path rounds
# the scores and P to bf16 (as the reference's einsums do), K3 keeps them in
# fp32.  The control is attention that also sees the next key, an off-by-one
# of the causal mask.  Limits set as above.
EVAL_LIMITS = {"loss_diff": 2e-4, "max_logits_diff": 0.5}
# llama-3.2-vision (10 layers, vocab 128256) on the H100 (PERF.md, vlm):
# flash against torch read a loss difference of 2.2e-4 and logits 0.109
# apart, the control 7.9e-4 and 6.14; its loss limit lies between.
EVAL_LIMITS_BY_MODEL = {"llama-3.2-vision-90b": {"loss_diff": 4e-4, "max_logits_diff": 0.5},
                        # hymba-1.5b (32 layers, 4 x 2048, window 1024) on the H100 (PERF.md,
                        # training forwards): flash against torch read a loss difference of 2.5e-4 and
                        # logits 0.125 apart, the control 4.7e-3 and 10.0
                        "hymba-1.5b": {"loss_diff": 1e-3, "max_logits_diff": 0.5}}
# olmo-1b's sharded eval in ``sharded_train`` (4 of 16 layers, 8 of 16 heads a
# rank at (1, 2), 4 x 2048) on the H100 (PERF.md section 6): flash against torch
# read a loss difference of 3.85e-4 and logits 0.086 apart, with and without
# sequence parallelism bit for bit alike (each rank's bf16 partial attention
# outputs are rounded before their sum, which one rank does not do), the
# next-key control 2.19e-3 and 5.11; its loss limit lies between.
SHARDED_EVAL_LIMITS = {"olmo-1b": {"loss_diff": 1e-3, "max_logits_diff": 0.5},
                       # qwen3-moe (1 of 94 layers, 2 x 2048) under the grouped layout (``grouped_heads``: 8 of
                       # 64 query heads over one kv head a rank) on the H100 (PERF.md section 6): flash against
                       # torch read a loss difference of 1.29e-4 on the ranks, the sharded loss 7.0e-5 from the
                       # one-rank eval's, the next-key control's 8.8e-4 from it (one layer's attention moves
                       # the loss little, so olmo-1b's 1e-3 would pass the control); its loss limit lies between
                       "qwen3-moe-235b-a22b": {"loss_diff": 4e-4, "max_logits_diff": 0.5}}


def train_run_config(fp8_gemm="kernel", arch="olmo-1b", global_batch=TRAIN_B):
    from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig

    return RunConfig(
        arch=arch,
        train=TrainConfig(global_batch=global_batch, seq_len=TRAIN_S, warmup_steps=2, total_steps=10),
        parallel=ParallelConfig(remat="full"),
        precision=PrecisionConfig(param_dtype="float32", compute_dtype="bfloat16", fp8=True, fp8_gemm=fp8_gemm),
    )


def train_phase(cfg, device):
    from repro_torch.benchmarks.mlperf_train import FLOPS_FORMULA, model_flops_per_step
    from repro_torch.data import make_batch_fn
    from repro_torch.fp8 import fp8_sites
    from repro_torch.fp8 import gemm as K4
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    run = train_run_config("kernel")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, run, SEED, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, run)
    batch_fn = make_batch_fn(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED, device=device)
    batches = [batch_fn(i) for i in range(TRAIN_STEPS + 1)]
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops_per_step(cfg, tokens, TRAIN_S)
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))  # forward, recompute, dx and dw of every site
    K4.reset_launches()  # the main path's run starts here
    steps = []
    for i in range(TRAIN_STEPS):
        before, copies_before = K4.LAUNCHES["fp8_gemm"], K4.LAUNCHES["fp8_layout_copy"]
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"phase": "train_step", "step": i, "loss": loss, "ms": dt * 1e3, "tokens_per_s": tokens / dt,
               "lr": float(m["lr"]), "grad_norm": float(m["grad_norm"]),
               "k4_launches": K4.LAUNCHES["fp8_gemm"] - before,
               "k4_layout_copies": K4.LAUNCHES["fp8_layout_copy"] - copies_before}
        emit(rec)
        steps.append(rec)
        if not np.isfinite(loss) or rec["k4_launches"] != per_step:
            fail(f"train step {i}: loss {loss}, {rec['k4_launches']} K4 launches (expected {per_step})")
    launches = K4.LAUNCHES["fp8_gemm"]
    steady = steps[1:]  # step 0 builds nothing but warms the allocator
    step_s = float(np.mean([r["ms"] for r in steady])) / 1e3
    out = {
        "phase": "train", "model": cfg.name, "params": sum(t.numel() for t in tree_leaves(state.params)),
        "tokens_per_step": tokens, "steps": TRAIN_STEPS, "init_s": init_s, "k4_launches": launches,
        "k4_layout_copies": K4.LAUNCHES["fp8_layout_copy"],
        "losses": [r["loss"] for r in steps], "step_ms_mean_steps_1_3": step_s * 1e3,
        "tokens_per_s_steps_1_3": tokens / step_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_tflop_per_step": flops / 1e12, "model_tflop_s": flops / step_s / 1e12,
        "bf16_peak_share": flops / step_s / BF16_FLOPS_PER_S,
        "flops_formula": FLOPS_FORMULA,
    }
    emit(out)
    return state, batches[TRAIN_STEPS], out


def gate_picks(cfg) -> dict:
    """The tensors whose updates the gate compares: the first layer's wq and
    the last layer's FFN down projection (moe: its router, whose gradient
    comes through the gates and the load-balance loss; an expert stack is
    3.2 GB a copy)."""
    ffn = ("moe", "router") if cfg.family == "moe" else ("mlp", "w_down")
    return {"blocks.0.attn.wq": ("blocks", 0, "attn", "wq"),
            f"blocks.{cfg.num_layers - 1}.{'.'.join(ffn)}": ("blocks", cfg.num_layers - 1, *ffn)}


def leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def step_readings(cfg, run, state, batch, picks) -> dict:
    """One train step as ``make_train_step`` takes it, through its own
    ``grads_of`` and ``lr_schedule`` and AdamW's clip and update: the loss,
    aux loss, gradient norm, lr and the picked tensors after the update.
    The update is applied to clones of the picked tensors and their moments
    only, so the state is left as it was: the kernel step and its
    references start from one state without a copy of the model's 16 bytes
    a parameter."""
    from repro_torch.optim import AdamWState, adamw_update
    from repro_torch.optim.adamw import clip_scale, clipped, global_norm
    from repro_torch.train.step import grads_of, lr_schedule

    tr = run.train
    if run.parallel.num_microbatches != 1:
        raise ValueError("the gate takes a step of one microbatch")
    grads, ce, aux, _ = grads_of(cfg, run, state, batch)
    norm = global_norm(grads)
    scale = clip_scale(norm, tr.grad_clip)
    picked = {name: clipped(leaf_at(grads, path), scale) for name, path in picks.items()}
    del grads  # the model's gradients go before the picked tensors are copied
    lr = lr_schedule(run)(state.opt.step)
    out = {"loss": float(ce), "aux_loss": float(aux), "grad_norm": float(norm), "lr": float(lr), "params": {}}
    for name, path in picks.items():
        sub = lambda t: {"blocks": [{"x": t}]}  # noqa: E731  (a block leaf: AdamW's rank rule)
        opt = AdamWState(state.opt.step, sub(leaf_at(state.opt.m, path).clone()), sub(leaf_at(state.opt.v, path).clone()))
        new, _, _ = adamw_update(sub(leaf_at(state.params, path).clone()), sub(picked.pop(name)), opt, lr=lr,
                                 beta1=tr.beta1, beta2=tr.beta2, eps=tr.eps, weight_decay=tr.weight_decay)
        out["params"][name] = new["blocks"][0]["x"]
        del opt, new
    return out


def path_readings(r, ref) -> dict:
    lr = ref["lr"]
    diffs = [(r["params"][n] - ref["params"][n]).abs() for n in ref["params"]]
    return {"loss_rel": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm_rel": abs(r["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"]),
            "param_mean_over_lr": float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs) / lr,
            "param_max_over_lr": max(float(d.max()) for d in diffs) / lr}


def within(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= v for k, v in limits.items())


def order_probe(a, b, sa, sb):
    """The plain GEMM with its sums in another fp32 order (K split in halves)."""
    h = a.shape[1] // 2
    return (a[:, :h].float() @ b[:h].float() + a[:, h:].float() @ b[h:].float()) * (1.0 / (sa.float() * sb.float()))


def scale_control(a, b, sa, sb):
    """The plain GEMM with 1/(sa sb) rounded to bf16: up to 2^-9 off."""
    from repro_torch.fp8.gemm_ref import fp8_gemm_plain

    return fp8_gemm_plain(a, b, sa, sb) * ((1 / (sa * sb)).bfloat16().float() * (sa * sb))


def k_tail_control(a, b, sa, sb):
    """The plain GEMM without its last 32 k-elements: a k-tile loop that
    stops short, the K4 calls' own control."""
    from repro_torch.fp8.gemm_ref import fp8_gemm_plain

    return fp8_gemm_plain(a[:, :-32], b[:-32], sa, sb)


def train_path_phase(cfg, state, batch, run_for, control, limits) -> dict:
    """The train path's gate, from ``state``, which it leaves as it was: the
    kernel step (``run_for("kernel")``'s config with every K4 call also held
    against the plain GEMM on its own operands, with ``k_tail_control``),
    and the steps with the plain GEMM, ``control`` and ``order_probe``, each
    read by ``step_readings``; the kernel and the probe must pass
    ``limits`` against the plain step, the control must fail every one."""
    from repro_torch.fp8 import fp8_gemm, fp8_sites
    from repro_torch.fp8.gemm_ref import fp8_gemm_plain

    picks = gate_picks(cfg)
    calls = []

    def checked(a, b, sa, sb):  # K4, the plain GEMM and the call's control on the same operands
        out = fp8_gemm(a, b, sa, sb)
        ref = fp8_gemm_plain(a, b, sa, sb)
        tol = GEMM_RTOL * float(ref.abs().max())
        dropped = k_tail_control(a, b, sa, sb)
        calls.append((float((out - ref).abs().max()), float((dropped - ref).abs().max()), tol,
                      [a.shape[0], a.shape[1], b.shape[1], str(a.dtype).split(".")[1], str(b.dtype).split(".")[1]]))
        return out

    t0 = time.perf_counter()
    r = {name: step_readings(cfg, run_for(gemm), state, batch, picks)
         for name, gemm in (("plain", "plain"), ("control", control), ("probe", order_probe), ("kernel", checked))}
    worst = max(calls, key=lambda c: c[0] / c[2])
    weakest_control = min(calls, key=lambda c: c[1] / c[2])
    out = {"phase": "train_path", "model": cfg.name, "control": control.__name__, "k4_calls": len(calls),
           "worst_call": {"err": worst[0], "tol": worst[2], "mkn_dtypes": worst[3]},
           "weakest_control_call": {"err": weakest_control[1], "tol": weakest_control[2],
                                    "mkn_dtypes": weakest_control[3]},
           "loss": {k: v["loss"] for k, v in r.items()}, "aux_loss": {k: v["aux_loss"] for k, v in r.items()},
           "grad_norm": {k: v["grad_norm"] for k, v in r.items()}, "lr": r["plain"]["lr"],
           "kernel_vs_plain": path_readings(r["kernel"], r["plain"]),
           "control_vs_plain": path_readings(r["control"], r["plain"]),
           "order_probe_vs_plain": path_readings(r["probe"], r["plain"]), "limits": limits,
           "seconds": time.perf_counter() - t0}
    del r
    emit(out)
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))  # forward, recompute, dx and dw of every site
    if len(calls) != per_step:
        fail(f"{cfg.name}: the checked kernel step made {len(calls)} K4 calls, expected {per_step}")
    if worst[0] > worst[2]:
        fail(f"{cfg.name}: a K4 call of the train step differs from the plain GEMM on its operands: {out}")
    if weakest_control[1] <= weakest_control[2]:
        fail(f"{cfg.name}: the control passes a K4 call's limit, which then proves nothing: {out}")
    if not within(out["kernel_vs_plain"], limits):
        fail(f"{cfg.name}: kernel and plain train steps differ: {out}")
    if not within(out["order_probe_vs_plain"], limits):
        fail(f"{cfg.name}: the order probe, a sound order of the sums, fails the train path's limits: {out}")
    for k, limit in limits.items():
        if out["control_vs_plain"][k] <= limit:
            fail(f"{cfg.name}: the control step passes the train path's {k} limit, which then proves nothing: {out}")
    torch.cuda.empty_cache()
    return out


def attention_next_key(q, k, v, *, causal, window, softcap):
    """A control for the eval: causal attention in the model layout that
    also sees the next key (within the model's window, where it has one)."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None] + 1
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=mask, enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def attention_unnormalized(q, k, v, *, causal, window, softcap):
    """A control for a bidirectional eval: attention in the model layout
    whose output misses the softmax's division by its row sum, an epilogue
    fault.  With random weights a bidirectional layer attends almost flat
    over its 2048 frames, so its output is the mean of V, small, and
    subtler faults (a key tile left out, the key heads one off) move the
    loss less than the bf16 roundings do (PERF.md, training forwards)."""
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    rep = qh.shape[1] // kh.shape[1]
    kh, vh = kh.repeat_interleave(rep, 1), vh.repeat_interleave(rep, 1)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(qh.shape[-1])
    return (torch.exp(s - s.amax(-1, keepdim=True)) @ vh).to(q.dtype).transpose(1, 2)


def self_attention_layers(cfg) -> int:
    """The layers whose attention runs K3 in the forward: all but the vlm
    family's cross layers."""
    return cfg.num_layers - (cfg.num_layers // cfg.vision.cross_attn_every if cfg.family == "vlm" else 0)


def eval_phase(cfg, params, batch) -> dict:
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.models import attention, forward
    from repro_torch.train import loss_fn

    def evaluate(impl):
        K3.reset_launches()
        t0 = time.perf_counter()
        loss = float(loss_fn(cfg, params, batch, attn_impl=impl, compute_dtype=torch.bfloat16)[0])
        dt = time.perf_counter() - t0
        launches = K3.LAUNCHES["flash_attention"]
        t0 = time.perf_counter()  # the same forward again, warm
        float(loss_fn(cfg, params, batch, attn_impl=impl, compute_dtype=torch.bfloat16)[0])
        warm = time.perf_counter() - t0
        logits = forward(cfg, params, batch, attn_impl=impl, compute_dtype=torch.bfloat16)[0]
        return {"loss": loss, "wall_s": dt, "warm_wall_s": warm, "k3_launches": launches, "logits": logits}

    def readings(r):
        return {"loss_diff": abs(r["loss"] - ref["loss"]),
                "max_logits_diff": float((r["logits"] - ref["logits"]).abs().max())}

    with torch.no_grad():
        ref = evaluate("torch")
        flash = evaluate("flash")
        finite = bool(torch.isfinite(flash["logits"]).all())
        k3 = attention.flash_attention
        attention.flash_attention = attention_next_key if cfg.causal else attention_unnormalized
        try:
            control = evaluate("flash")
        finally:
            attention.flash_attention = k3
        limits = EVAL_LIMITS_BY_MODEL.get(cfg.name, EVAL_LIMITS)
        out = {"phase": "eval", "loss": {"torch": ref["loss"], "flash": flash["loss"], "control": control["loss"]},
               "wall_s": {"torch": ref["wall_s"], "flash": flash["wall_s"]},
               "warm_wall_s": {"torch": ref["warm_wall_s"], "flash": flash["warm_wall_s"]},
               "k3_launches": flash["k3_launches"],
               "k3_launches_torch": ref["k3_launches"],
               "flash_vs_torch": readings(flash), "control_vs_torch": readings(control), "limits": limits}
        del ref, flash, control
    out["model"] = cfg.name
    emit(out)
    n_self = self_attention_layers(cfg)
    if out["k3_launches"] != n_self or out["k3_launches_torch"] != 0:
        fail(f"flash eval launched K3 {out['k3_launches']} times (expected {n_self}) under flash, "
             f"{out['k3_launches_torch']} under torch")
    if not finite or not within(out["flash_vs_torch"], limits):
        fail(f"flash and torch attention disagree: {out}")
    if within(out["control_vs_torch"], limits):
        fail(f"the control passes the eval's limits, which then prove nothing: {out}")
    torch.cuda.empty_cache()
    return out


def train_profile_phase(cfg, state, batch) -> dict:
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, train_run_config("kernel"))

    def run():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()  # the step's wall time, without the profiler
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches, prof_wall_ms, spans = profiled(run)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    k4_ms = sum(v for k, v in by_name.items() if "fp8_gemm_kernel" in k)
    out = {
        "phase": "train_profile", "model": cfg.name, "what": "one fp8 train step, 4 x 2048 tokens, remat full",
        "wall_ms": wall_ms, "wall_ms_under_profiler": prof_wall_ms, "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / wall_ms if by_name else None,
        "idle_share_under_profiler": 1.0 - busy / prof_wall_ms if by_name else None, "device_launches": int(launches),
        "fp8_gemm_ms": k4_ms, "fp8_gemm_share": k4_ms / busy if by_name else None,
        "fp8_layout_copy_ms": spans["fp8_layout_copy"],
        "top_kernels_ms": [[name[:160], ms] for name, ms in top],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 9b: the facility (tests/test_system.py on the card); 9c: Fig. 8
# ---------------------------------------------------------------------------

FACILITY_LAYERS = 4  # of olmo-1b's 16 at full width: 371.5 M parameters, 4.46 GB a save
FACILITY_STEPS = 8
FACILITY_CKPT_EVERY = 3
FACILITY_FAIL_AT = 5  # the job's second node fails here: the runner restores step 3 and replays 2 steps
GB = 1e9


def facility_manager(directory, *, restore_walls, bump_step=False):
    """A synchronous ``CheckpointManager`` (as the launcher's) that times its
    restores; with ``bump_step`` its restores hand back ``opt.step`` one
    ahead, the control of the bit-exact gate."""
    from repro_torch.checkpoint import CheckpointManager

    class Manager(CheckpointManager):
        def restore(self, like, **kw):
            t0 = time.perf_counter()
            tree, extra = super().restore(like, **kw)
            torch.cuda.synchronize()
            restore_walls.append(time.perf_counter() - t0)
            if bump_step:
                tree = tree._replace(opt=tree.opt._replace(step=tree.opt.step + 1))
            return tree, extra

    return Manager(directory, keep=2, async_save=False)


def counted_steps(step_fn, records):
    """``step_fn`` with each step's wall (ended by a host sync) and K4
    launches appended to ``records``."""
    from repro_torch.fp8 import gemm as K4

    def fn(state, batch):
        before = K4.LAUNCHES["fp8_gemm"]
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        records.append({"ms": (time.perf_counter() - t0) * 1e3, "k4_launches": K4.LAUNCHES["fp8_gemm"] - before})
        return state, m

    return fn


def bit_exact(report, state, ref_report, ref_state) -> bool:
    """The reference's gate (tests/test_fault_tolerance.py): every step's
    loss ``==`` and every leaf of the final state equal."""
    from repro_torch.utils.tree import flatten_with_paths

    a, b = flatten_with_paths(state), flatten_with_paths(ref_state)
    return report.losses == ref_report.losses and [p for p, _ in a] == [p for p, _ in b] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def facility_phase(cfg, device) -> dict:
    """Two tenants under IAM, a training job admitted by the QoS scheduler,
    olmo-1b (full width, depth cut) trained with fp8 under the
    fault-tolerant runner: a clean run, a run whose node fails at step 5,
    a control restoring ``opt.step`` one ahead, an async snapshot that the
    next in-place step must not change; then the serving tenant serves the
    clean and the recovered parameters.  Checkpoints go to a fresh
    temporary directory on this machine's local disk, deleted at the end."""
    import shutil
    import tempfile

    from repro_torch import core
    from repro_torch.checkpoint import TIERS, CheckpointManager
    from repro_torch.data import make_batch_fn
    from repro_torch.fp8 import fp8_sites
    from repro_torch.fp8 import gemm as K4
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import flatten_with_paths, tree_size_bytes

    run = train_run_config("kernel")
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))  # forward, recompute, dx and dw of every site
    batch_fn = make_batch_fn(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED, device=device)
    train_step = make_train_step(cfg, run)

    # the facility: two tenants under IAM, the training job admitted by the scheduler
    cluster = core.Cluster(core.ClusterSpec("phase1-mini", nodes_per_pod=6, num_pods=1))
    iam = core.IAM(clock=lambda: 0.0)
    admin = iam.federated_login("ops@bristol.ac.uk", "uob")
    iam.grant("ops@bristol.ac.uk", core.Role.INFRA_ADMIN)
    tenants = core.TenantManager(cluster, iam)
    tenants.create_tenant("research", quota_nodes=4, admin="alice@inst", token=admin)
    tenants.create_tenant("serving", quota_nodes=2, admin="bob@inst", token=admin)
    tenants.grow_tenant("research", 3, token=admin)
    tenants.grow_tenant("serving", 1, token=admin)
    isolation = tenants.check_isolation()
    sched = core.Scheduler(cluster)
    job = sched.submit(core.Job("llm-train", "research", core.QoS.TRAINING, chips=8, duration=30, checkpoint_interval=5))
    sched.tick(1)
    if isolation or job.state != core.JobState.RUNNING:
        fail(f"facility setup: isolation {isolation}, training job {job.state}")
    failing_node = job.nodes[1]

    def local_cluster():  # the launcher's: two nodes, heartbeats at 0
        c = core.Cluster(core.ClusterSpec("local", nodes_per_pod=2, num_pods=1))
        c.allocate([0, 1], "llm-train")
        for n in c.nodes.values():
            c.heartbeat(n.node_id, 0.0)
        return c

    def runner(directory, cluster, records, restore_walls, bump_step=False):
        return core.FaultTolerantRunner(
            step_fn=counted_steps(train_step, records), init_state=init_train_state(cfg, run, SEED, device),
            batch_fn=batch_fn, cluster=cluster,
            ckpt=facility_manager(directory, restore_walls=restore_walls, bump_step=bump_step),
            job_id="llm-train", checkpoint_every=FACILITY_CKPT_EVERY, ledger=core.EnergyLedger())

    root = tempfile.mkdtemp(prefix="facility_ckpt_")
    try:
        clean_steps = []
        clean = runner(os.path.join(root, "clean"), local_cluster(), clean_steps, [])
        usage = shutil.disk_usage(root)
        ckpt_bytes = tree_size_bytes(clean.state)
        emit({"phase": "facility_disk", "directory": root, "free_gb": usage.free / GB, "total_gb": usage.total / GB,
              "checkpoint_gb": ckpt_bytes / GB, "what": "this machine's local disk, not the facility's ClusterStor "
              "(lustre) or VAST: its GB/s are the local disk's"})
        if usage.free < 3 * ckpt_bytes:
            fail(f"{root} has {usage.free / GB:.1f} GB free, less than three saves of {ckpt_bytes / GB:.2f} GB")

        # the clean run
        K4.reset_launches()
        t0 = time.perf_counter()
        r_clean = clean.run(FACILITY_STEPS)
        clean_wall = time.perf_counter() - t0
        k4_clean = K4.LAUNCHES["fp8_gemm"]
        clean_saves = clean.ckpt.records
        shutil.rmtree(os.path.join(root, "clean"))

        # the faulty run: a fresh state from the seed, on the scheduler's nodes
        faulty_steps, faulty_restores = [], []
        K4.reset_launches()
        faulty = runner(os.path.join(root, "faulty"), cluster, faulty_steps, faulty_restores)
        t0 = time.perf_counter()
        r_faulty = faulty.run(FACILITY_STEPS, failure_schedule={FACILITY_FAIL_AT: failing_node})
        faulty_wall = time.perf_counter() - t0
        k4_faulty = K4.LAUNCHES["fp8_gemm"]
        exact = bit_exact(r_faulty, faulty.state, r_clean, clean.state)
        shutil.rmtree(os.path.join(root, "faulty"))

        # the control: the same failure, restored with opt.step one ahead
        control_steps = []
        K4.reset_launches()
        control = runner(os.path.join(root, "control"), local_cluster(), control_steps, [], bump_step=True)
        r_control = control.run(FACILITY_STEPS, failure_schedule={FACILITY_FAIL_AT: 1})
        k4_control = K4.LAUNCHES["fp8_gemm"]
        control_exact = bit_exact(r_control, control.state, r_clean, clean.state)
        shutil.rmtree(os.path.join(root, "control"))

        # the async snapshot: save the control's state without blocking, one
        # in-place step, then wait
        amgr = CheckpointManager(os.path.join(root, "async"), keep=1, async_save=True)
        state = control.state
        del control
        before = {p: x.clone() for p, x in flatten_with_paths(state)}
        t0 = time.perf_counter()
        amgr.save(state, step=FACILITY_STEPS, block=False)
        snapshot_s = time.perf_counter() - t0
        K4.reset_launches()
        state, m = train_step(state, batch_fn(FACILITY_STEPS))
        float(m["loss"])
        k4_async = K4.LAUNCHES["fp8_gemm"]
        moved = any(not torch.equal(x, before[p]) for p, x in flatten_with_paths(state))
        t0 = time.perf_counter()
        amgr.wait()
        wait_s = time.perf_counter() - t0
        snap, _ = amgr.restore(state)
        snapshot_kept = all(torch.equal(x, before[p]) for p, x in flatten_with_paths(snap))
        async_rec = amgr.records[0]
        amgr.close()
        del snap, before, state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the serving tenant: the serving phase's prompts on the clean and the recovered parameters
    kw = dict(max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
              eos_token=cfg.padded_vocab, device=device)
    prompts = serving_prompts(cfg, SEED)
    served = {}
    for name, params in (("clean", clean.state.params), ("faulty", faulty.state.params)):
        eng = InferenceEngine(cfg, params, **kw)
        reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
        K.reset_launches()
        eng.run_until_drained()
        s = eng.stats()
        served[name] = {"tokens": [list(r.generated) for r in reqs], "launches": dict(K.LAUNCHES),
                        "blocks_in_use": s["alloc_blocks_in_use"], "decode_steps": s["decode_steps"],
                        "prefill_chunks": s["prefill_chunks"],
                        "by_length": all(r.finish_reason == "length" for r in reqs)}
        del eng

    steady = [r["ms"] for r in clean_steps[1:]]  # step 0 warms the allocator
    step_s = float(np.mean(steady)) / 1e3
    ledger = faulty.ledger
    saves = [{"run": run_name, "step": r.step, "gb": r.nbytes / GB, "wall_s": r.wall_seconds,
              "gb_per_s": r.nbytes / r.wall_seconds / GB, "modeled_lustre_s": r.modeled_seconds,
              "modeled_vast_s": TIERS["vast"].write_seconds(r.nbytes)}
             for run_name, recs in (("clean", clean_saves), ("faulty", faulty.ckpt.records)) for r in recs]
    out = {
        "phase": "facility", "model": cfg.name, "layers": cfg.num_layers,
        "params": sum(x.numel() for _, x in flatten_with_paths(clean.state.params)),
        "checkpoint_gb": ckpt_bytes / GB, "tokens_per_step": TRAIN_B * TRAIN_S, "failing_node": failing_node,
        "report": {"steps_run": r_faulty.steps_run, "failures": r_faulty.failures, "restores": r_faulty.restores,
                   "rollback_steps": r_faulty.rollback_steps, "events": r_faulty.events},
        "losses": {"clean": r_clean.losses, "faulty": r_faulty.losses, "control": r_control.losses},
        "bit_exact": exact, "control_bit_exact": control_exact,
        "step_ms_mean_steps_1_7": step_s * 1e3, "step_ms": [r["ms"] for r in clean_steps],
        "k4_launches_per_step": {"clean": [r["k4_launches"] for r in clean_steps],
                                 "faulty": [r["k4_launches"] for r in faulty_steps]},
        "k4_launches": {"clean": k4_clean, "faulty": k4_faulty, "control": k4_control, "async_step": k4_async},
        "run_wall_s": {"clean": clean_wall, "faulty": faulty_wall},
        "saves": saves, "restore_wall_s": faulty_restores, "restore_gb_per_s": [ckpt_bytes / w / GB for w in faulty_restores],
        "async": {"snapshot_s": snapshot_s, "wait_s": wait_s, "write_wall_s": async_rec.wall_seconds,
                  "step_moved_the_state": moved, "snapshot_kept": snapshot_kept},
        "cadence_advice": faulty.ckpt.cadence_advice(step_seconds=step_s, nbytes=ckpt_bytes),
        "energy": ledger.report(), "facility_kwh_unrounded": ledger.facility_kwh(),
        "serving": {k: {f: v[f] for f in ("launches", "blocks_in_use", "decode_steps", "prefill_chunks", "by_length")}
                    for k, v in served.items()},
        "serving_tokens_equal": served["clean"]["tokens"] == served["faulty"]["tokens"],
        "disk": "local disk of the card's machine, not the facility's ClusterStor (lustre) or VAST",
    }
    emit(out)
    if (r_faulty.failures, r_faulty.restores, r_faulty.rollback_steps) != (1, 1, 2) or len(faulty_restores) != 1:
        fail(f"facility: expected 1 failure, 1 restore, 2 steps rolled back: {out['report']}")
    if not exact:
        fail("facility: the recovered run is not bit-exact with the clean run")
    if control_exact:
        fail("facility: the control (opt.step one ahead) passes the bit-exact gate, which then proves nothing")
    if not (moved and snapshot_kept):
        fail(f"facility: the async snapshot did not survive the next in-place step: {out['async']}")
    bad = [r["k4_launches"] for r in clean_steps + faulty_steps + control_steps if r["k4_launches"] != per_step]
    if bad or k4_async != per_step:
        fail(f"facility: K4 launches a step {bad or k4_async}, expected {per_step}")
    if not (out["energy"]["effective_pue"] < 1.1 and ledger.facility_kwh() > 0):
        fail(f"facility: energy report {out['energy']}")
    for name, v in served.items():
        L = cfg.num_layers
        if not (v["by_length"] and v["blocks_in_use"] == 0 and v["launches"]["paged_decode"] == v["decode_steps"] * L
                and v["launches"]["paged_prefill"] == v["prefill_chunks"] * L and v["launches"]["paged_decode"] > 0):
            fail(f"facility: the serving tenant's {name} run: {out['serving'][name]}")
    if not out["serving_tokens_equal"]:
        fail("facility: the serving tenant's tokens differ between the clean and the recovered parameters")
    return out


# ---------------------------------------------------------------------------
# phase 9b2: sharded and FSDP training on two gloo ranks of the one card
# ---------------------------------------------------------------------------

SHARD_STEPS = 2  # an arm's and its control's: the rate is 0 at the first
SHARD_ELASTIC_STEPS = 2
# The sharded steps against the one-rank step in the same run, both with fp8
# through K4 and bf16 compute: the tensor-parallel sums add bf16 partial
# outputs after rounding, FSDP reduce-scatters bf16 and fp32 gradients, and
# the fp8 casts turn a last-bit difference into a flipped fp8 value.  The
# limits are the CPU tests' fp8 ones (tests/test_torch_sharded_train.py):
# losses 2e-3 relative, gradient norms 5e-2, every parameter within 2 lr a
# step and their mean within lr / 5.  The controls must fail one: the
# copy-to-model backward without its all-reduce (TP), FSDP's gather
# backward without the sum over the data ranks (FSDP + DP).
SHARD_LIMITS = {"loss_rel": 2e-3, "grad_norm_rel": 5e-2, "param_max_over_lr_per_step": 2.0, "param_mean_over_lr": 0.2}


@contextmanager
def ranks_allocator():
    """Spawned ranks' allocator: segments that grow in place, so a rank
    near the card's capacity reuses freed blocks across shapes (qwen3-moe's
    first sharded steps took 14.4 and 16.5 s without, 2.0 and 2.8 s with on
    an NVIDIA H100 80GB HBM3 at 700 W: PERF.md section 6).  The variable is read by each rank's allocator at its
    start; this process's own allocator is set already."""
    kept = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if kept is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = kept


def shard_run_config(global_batch=TRAIN_B, seq_len=TRAIN_S, arch="olmo-1b", fp8=True, lr=None,
                     compute_dtype="bfloat16", optimizer_dtype="float32"):
    from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig

    rate = {} if lr is None else {"learning_rate": lr}
    return RunConfig(  # warmup 0: every step moves the parameters
        arch=arch, train=TrainConfig(global_batch=global_batch, seq_len=seq_len, warmup_steps=0, total_steps=10,
                                     **rate),
        parallel=ParallelConfig(remat="full"),
        precision=PrecisionConfig(param_dtype="float32", compute_dtype=compute_dtype, fp8=fp8, fp8_gemm="kernel",
                                  optimizer_dtype=optimizer_dtype),
    )


def param_gaps(pairs) -> tuple[float, float, int]:
    """(largest |a - b|, their sum, elements) over (tensor, reference)
    pairs; ``b`` may lie on the host."""
    top, total, n = 0.0, 0.0, 0
    for a, b in pairs:
        # in slices of 64 M elements: a leaf of qwen3-moe's experts is 3.2 GB
        for sa, sb in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)):
            d = (sa - sb.to(sa.device)).abs_()
            total, top = total + float(d.sum(dtype=torch.float64)), max(top, float(d.max()))
            del d
        n += a.numel()
    return top, total, n


def shard_readings(metrics, ref_metrics, lr: float, gaps) -> dict:
    """Loss and gradient norm (the largest relative gap over the steps)
    against the one-rank run's, and the parameters' ``gaps``
    (``param_gaps``, or ``mesh_param_gaps`` over a mesh: the largest and
    the mean gap, in units of lr)."""
    rel = lambda k: max(abs(m[k] - r[k]) / abs(r[k]) for m, r in zip(metrics, ref_metrics))  # noqa: E731
    top, total, n = gaps
    return {"loss_rel": rel("loss"), "grad_norm_rel": rel("grad_norm"),
            "param_max_over_lr_per_step": top / lr / len(metrics), "param_mean_over_lr": total / n / lr}


def shard_passes(r: dict) -> bool:
    return all(r[k] <= lim for k, lim in SHARD_LIMITS.items())


def shard_control_copy_backward(ctx, g):
    """The TP control: the copy-to-model backward without its all-reduce,
    so a replicated input keeps one rank's partial gradient."""
    return g, None


def shard_control_unsummed_reduce_scatter(ctx, x, group, n):
    """The sequence-parallel control: ``reduce_scatter_seq``'s forward as
    a plain slice of this rank's partial output, without the sum."""
    ctx.group, ctx.n = group, n
    s = x.shape[1] // n
    return x.narrow(1, torch.distributed.get_rank(group) * s, s).contiguous()


def shard_control_unsummed_backward(ctx, g):
    """The FSDP control: the gather's backward keeps this rank's slice of
    its own gradient, not the sum over the data ranks."""
    n = g.shape[ctx.dim] // ctx.n
    return g.narrow(ctx.dim, torch.distributed.get_rank(ctx.group) * n, n).contiguous(), None, None, None


def shard_steps(step, state, batches, mesh=None) -> tuple:
    """(state, metrics, readings) of ``batches`` on this rank: each step's
    wall seconds, the collectives and K4 launches over the steps, the
    state's bytes (params, m, v), the memory allocated before the steps and
    its peak during them."""
    from repro_torch.fp8 import gemm as K4
    from repro_torch.parallel import collectives as C
    from repro_torch.utils.tree import tree_size_bytes

    C.reset_collectives()
    K4.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    metrics, walls = [], []
    for batch in batches:
        if mesh is not None:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})  # the host reads the step's metrics
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    return state, metrics, {
        "wall_s": walls, "collectives": dict(C.TRAIN_COLLECTIVES), "k4": dict(K4.LAUNCHES),
        "state_bytes": sum(tree_size_bytes(t) for t in (state.params, state.opt.m, state.opt.v)),
        "resident_bytes": resident, "max_memory_allocated": peak, "step_peak_above_resident": peak - resident,
    }


def sharded_rank(rank, mesh_tp, device_type="cuda", cfg=None, batch=(TRAIN_B, TRAIN_S)) -> dict:
    """One rank of ``sharded_train``: the one-rank reference (rank 0), the
    TP (1, 2) and FSDP + DP (2, 1) runs from the seed's full state, each
    followed by its control, and the shrink of (2, 1) to (1, 1).  Each run
    is read against the reference's slices (``reference_slices``,
    ``mesh_param_gaps``).  ``device_type``, ``cfg`` and ``batch`` (a smoke
    model on the CPU) serve rehearsals."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_elastic_mesh, plan_resize, reshard_state, resize_batch
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import shard_state, state_shardings, training_rules, unshard_state
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    cfg = cfg or get_config("olmo-1b").replace(num_layers=FACILITY_LAYERS)
    run = shard_run_config(*batch)
    sp_run = dataclasses.replace(run, parallel=dataclasses.replace(run.parallel, sequence_parallel=True))
    runs = {"tp": run, "sp": sp_run, "fsdp_dp": run}
    lr = run.train.learning_rate
    rules = training_rules(run.parallel)
    batches = [synthetic_batch(cfg, step=s, global_batch=batch[0], seq_len=batch[1], seed=SEED, device=device)
               for s in range(SHARD_STEPS + SHARD_ELASTIC_STEPS)]
    meshes = {"tp": mesh_tp, "sp": mesh_tp, "fsdp_dp": make_local_mesh(2, 1, backend="gloo", device=device_type)}
    plan = plan_resize(old_chips=2, new_chips=1, model_parallel=1, global_batch=batch[0])
    full = init_train_state(cfg, run, SEED, device)
    shapes = [t.shape for t in tree_leaves(full.params)]
    out = {"rank": rank}
    ref = {}
    if rank == 0:  # the one-rank run, then 2 steps on the resized batches
        copy = lambda tree: tree_map(torch.clone, tree)  # noqa: E731  (the step updates in place)
        state = full._replace(params=copy(full.params), opt=full.opt._replace(m=copy(full.opt.m), v=copy(full.opt.v)))
        step = make_train_step(cfg, run)
        state, ref["metrics"], got = shard_steps(step, state, batches[:SHARD_STEPS])
        # a copy on the host, which reference_slices sends from (the steps below update in place)
        ref["params"] = [t.to("cpu", copy=True) for t in tree_leaves(state.params)]
        state, m3, _ = shard_steps(step, state, [resize_batch(b, plan) for b in batches[SHARD_STEPS:]])
        ref["elastic_metrics"], ref["elastic_params"] = m3, [t.clone() for t in tree_leaves(state.params)]
        out["one_rank"] = {"metrics": ref["metrics"], **{k: got[k] for k in (
            "wall_s", "state_bytes", "resident_bytes", "max_memory_allocated", "step_peak_above_resident")},
            "k4_a_step": got["k4"]["fp8_gemm"] / SHARD_STEPS}
        del state
        torch.cuda.empty_cache()
        out["one_rank_eval"] = shard_eval("attention", cfg, full.params, batches[0])
    torch.distributed.barrier()
    # each arm, then its control: the same steps from the full state with
    # one collective changed, against the one-rank steps
    controls = {"tp": (C._CopyToModel, "backward", staticmethod(shard_control_copy_backward)),
                "sp": (C._ReduceScatterSeq, "forward", staticmethod(shard_control_unsummed_reduce_scatter)),
                "fsdp_dp": (C._GatherOverData, "backward", staticmethod(shard_control_unsummed_backward))}
    for name, mesh in meshes.items():
        arm_run = runs[name]
        specs = state_shardings(cfg, arm_run, rules, mesh)
        mine = reference_slices(ref.get("params"), specs.params, shapes, mesh)  # once for the arm and its control

        def readings(state, metrics):
            gaps = mesh_param_gaps(state.params, specs.params, mesh, mine, ref.get("params"))
            return shard_readings(metrics, ref["metrics"], lr, gaps) if rank == 0 else None

        state, metrics, got = shard_steps(make_train_step(cfg, arm_run, rules, mesh), shard_state(full, specs, mesh),
                                          batches[:SHARD_STEPS], mesh)
        out[name] = {"metrics": metrics, **got, "mesh": list(mesh.shape), "readings": readings(state, metrics)}
        if name == "tp":  # this rank's slices, which the sequence-parallel arm's share its layout with
            tp_kept = (metrics, [t.clone() for t in tree_leaves(state.params)])
            out["tp"]["eval"] = shard_eval("attention", cfg, shard_state(full, specs, mesh).params, batches[0], mesh)
        if name == "sp":  # against the TP arm: the same slices on every rank, its metrics
            gaps = mesh_param_gaps(state.params, specs.params, mesh, dict(enumerate(tp_kept[1])), None)
            out["sp"]["vs_tp"] = shard_readings(metrics, tp_kept[0], lr, gaps) if rank == 0 else None
            del tp_kept
            out["sp"]["eval"] = shard_eval("attention", cfg, shard_state(full, specs, mesh).params, batches[0], mesh,
                                           sequence_parallel=True)
        if name == "fsdp_dp":  # the shrink's starting point, gathered whole (the moments too) for its bit-exact check
            kept_run = (state, specs, unshard_state(state, specs, mesh))
        del state
        owner, attr, wrong = controls[name]
        kept = owner.__dict__[attr]
        setattr(owner, attr, wrong)
        try:
            state, metrics, _ = shard_steps(make_train_step(cfg, arm_run, rules, mesh),
                                            shard_state(full, specs, mesh), batches[:SHARD_STEPS], mesh)
        finally:
            setattr(owner, attr, kept)
        out[name]["control"] = readings(state, metrics)
        del state, mine
        torch.cuda.empty_cache()
    del full
    # elastic: the (2, 1) run's state onto the surviving rank, then 2 steps on the resized batches
    state, specs, gathered = kept_run
    del kept_run
    new_mesh = make_elastic_mesh(plan)
    new_specs = state_shardings(cfg, run, rules, new_mesh) if new_mesh is not None else None
    state = reshard_state(state, old_specs=specs, old_mesh=meshes["fsdp_dp"], new_specs=new_specs, new_mesh=new_mesh)
    if new_mesh is not None:
        same = all(torch.equal(a, b) for x, y in ((gathered.params, state.params), (gathered.opt.m, state.opt.m),
                                                  (gathered.opt.v, state.opt.v))
                   for a, b in zip(tree_leaves(x), tree_leaves(y)))
        del gathered
        state, metrics, got = shard_steps(make_train_step(cfg, run, rules, new_mesh), state,
                                          [resize_batch(b, plan) for b in batches[SHARD_STEPS:]])
        gaps = param_gaps(zip(tree_leaves(state.params), ref["elastic_params"]))
        out["elastic"] = {"mesh": list(new_mesh.shape), "new_global_batch": plan.new_global_batch,
                          "bit_exact": same, "metrics": metrics, **got,
                          "readings": shard_readings(metrics, ref["elastic_metrics"], lr, gaps)}
    del state
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def sharded_train_phase() -> dict:
    """olmo-1b (full width, 4 of 16 layers, fp8 through K4, remat full, 4 x
    2048) trained on two gloo ranks of the one card at (1, 2), at (1, 2)
    with sequence parallelism (then its sharded eval) and at (2, 1), each
    held to the one-rank step of the same run with a control, then the (2,
    1) state shrunk to one rank (``sharded_rank``)."""
    from repro_torch.configs import get_config
    from repro_torch.fp8 import fp8_sites
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        with ranks_allocator():
            ranks = run_ranks(sharded_rank, 2, backend="gloo", device="cuda", timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"sharded_train: {e}")
    cfg = get_config("olmo-1b").replace(num_layers=FACILITY_LAYERS)
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))  # forward, recompute, dx and dw of every site
    out = {"phase": "sharded_train", "backend": "gloo", "ranks": 2, "seconds": time.perf_counter() - t0,
           "model": cfg.name, "layers": cfg.num_layers, "batch": [TRAIN_B, TRAIN_S], "steps": SHARD_STEPS,
           "limits": SHARD_LIMITS, "one_rank": ranks[0]["one_rank"]}
    for name in ("tp", "sp", "fsdp_dp"):
        arm = [r[name] for r in ranks]
        out[name] = {
            "mesh": arm[0]["mesh"], "step_wall_s": [a["wall_s"] for a in arm],
            "collectives_per_step": [{k: v / SHARD_STEPS for k, v in a["collectives"].items() if v} for a in arm],
            "k4_launches": [a["k4"]["fp8_gemm"] for a in arm], "k4_layout_copies": [a["k4"]["fp8_layout_copy"] for a in arm],
            **{k: [a[k] for a in arm] for k in ("state_bytes", "resident_bytes", "max_memory_allocated",
                                                  "step_peak_above_resident")},
            "losses": [m["loss"] for m in arm[0]["metrics"]], "readings": arm[0]["readings"], "control": arm[0]["control"],
        }
    sp = [r["sp"] for r in ranks]
    out["tp"]["eval"] = [r["tp"]["eval"] for r in ranks]
    out["sp"].update(vs_tp=sp[0]["vs_tp"], eval=[a["eval"] for a in sp], one_rank_eval=ranks[0]["one_rank_eval"],
                     step_peak_against_tp=[a["step_peak_above_resident"] / b["step_peak_above_resident"]
                                           for a, b in zip(sp, (r["tp"] for r in ranks))])
    el = ranks[0].get("elastic")
    out["elastic"] = el and {k: v for k, v in el.items() if k != "metrics"}
    emit(out)  # before the gates, so a failing run still shows its readings
    for name in ("tp", "sp", "fsdp_dp"):
        arm = [r[name] for r in ranks]
        if arm[0]["metrics"] != arm[1]["metrics"]:
            fail(f"sharded_train {name}: the ranks' metrics differ")
        if not shard_passes(arm[0]["readings"]):
            fail(f"sharded_train {name}: the sharded steps part from the one-rank steps: {arm[0]['readings']}")
        if shard_passes(arm[0]["control"]):
            fail(f"sharded_train {name}: the control passes the limits, which then prove nothing: {arm[0]['control']}")
        if out[name]["k4_launches"] != [per_step * SHARD_STEPS] * 2:
            fail(f"sharded_train {name}: K4 launches {out[name]['k4_launches']}, expected {per_step * SHARD_STEPS} a rank")
    if not shard_passes(sp[0]["vs_tp"]):
        fail(f"sharded_train sp: the sequence-parallel steps part from the TP arm's: {sp[0]['vs_tp']}")
    if not all(a["collectives"]["gather_seq"] and a["collectives"]["reduce_scatter_seq"] for a in sp):
        fail(f"sharded_train sp: no sequence collective: {out['sp']['collectives_per_step']}")
    if [(e["loss"], e["flash_vs_torch"]) for e in out["sp"]["eval"]] != [(e["loss"], e["flash_vs_torch"])
                                                                       for e in out["tp"]["eval"]]:
        fail(f"sharded_train sp: the sequence-parallel eval parts from the TP eval: {out['sp']['eval']}")
    shard_eval_gates("sharded_train sp", cfg, out["sp"]["eval"], out["sp"]["one_rank_eval"],
                     SHARDED_EVAL_LIMITS[cfg.name])
    if el is None or "elastic" in ranks[1]:
        fail("sharded_train: the shrink to one rank did not leave rank 0 alone on the new mesh")
    if not (el["bit_exact"] and shard_passes(el["readings"]) and el["k4"]["fp8_gemm"] == per_step * SHARD_ELASTIC_STEPS):
        fail(f"sharded_train elastic: {out['elastic']}")
    return out


def tools_dryrun_mesh_phase(sharded) -> dict:
    """The dry run of ``sharded_train``'s own runs on its meshes: one
    rank's step of olmo-1b (4 layers, fp8, 4 x 2048) traced on meta in a
    fake world of two ranks (``launch.dryrun.cost_rank``) at ``(1, 2)``
    (TP and the SP arm's run) and ``(2, 1)``: each collective's calls and
    operand bytes a step must equal what each rank of ``sharded_train``
    counted (``TRAIN_COLLECTIVES`` over its steps, a step's share),
    exactly; ``collective_s`` at ``NVLINK_BW`` and the rank's estimated
    arguments, temporaries and peak are reported beside the measured step
    peak above the resident state and ``max_memory_allocated``."""
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import NVLINK_BW

    cfg = get_config("olmo-1b").replace(num_layers=FACILITY_LAYERS)
    run = shard_run_config()
    runs = {"tp": (run, (1, 2)),
            "sp": (dataclasses.replace(run, parallel=dataclasses.replace(run.parallel, sequence_parallel=True)), (1, 2)),
            "fsdp_dp": (run, (2, 1))}
    shape = ShapeConfig("sharded_train", TRAIN_S, TRAIN_B, "train")
    out = {"phase": "tools_dryrun_mesh", "model": cfg.name, "layers": cfg.num_layers, "arms": {}}
    for name, (arm_run, (data, model)) in runs.items():
        rec = dryrun.cost_rank(cfg, arm_run, shape, data, model)
        colls = rec["collectives"]
        measured = sharded[name]["collectives_per_step"]
        meta = {**colls["count"], **{k + "_bytes": v for k, v in colls["operand_bytes"].items()}}
        out["arms"][name] = {"mesh": [data, model], "collectives": colls, "measured_per_step": measured,
                             "equal": [m == meta for m in measured],
                             "collective_s": colls["total_operand_bytes"] / NVLINK_BW,
                             "memory": rec["memory"],
                             "measured_step_peak_above_resident": sharded[name]["step_peak_above_resident"],
                             "measured_max_memory_allocated": sharded[name]["max_memory_allocated"],
                             "trace_s": rec["rank_trace_s"]}
    emit(out)
    for name, a in out["arms"].items():
        if not all(a["equal"]):
            fail(f"tools_dryrun_mesh {name}: the meta step's collectives {a['collectives']} are not "
                 f"sharded_train's {a['measured_per_step']}")
    return out


# ---------------------------------------------------------------------------
# phase 9b3: sharded training of the moe, hybrid and audio families
# ---------------------------------------------------------------------------

FAMILY_SHARD_STEPS = 2  # an arm's and its control's: 2 keep the script inside its 1200 s
FAMILY_SHARD_LAYERS = 2  # hymba-1.5b's 32 and hubert-xlarge's 48 cut to 2 (qwen3-moe: MOE_TRAIN_LAYERS)
# The rwkv6-7b arm's run settings, which depart from ``shard_run_config``'s,
# both measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6).
# rwkv6-7b (4 layers, full width, random weights): at the default rate
# (3e-4) its one-rank run read a loss of 11.49, 11.47, then 32.67, so it
# trains at 1e-5.  And its gradient norm moves with any bf16 rounding: in
# one process (tests/bf16_split_probe.py), the channel mix's product summed
# from two halves in bf16, what the (1, 2) split computes, read 28.08
# against 17.44 unsplit and 16.92 in fp32; the (1, 2) arm parted from the
# one-rank run by that 0.615.  The
# JAX package's own split does the same at smoke size: on the CPU its (1, 2)
# step moves the bf16 norm by -9.2% to +1.0% over four batches, its fp32
# norm by 0.04% at most.  So bf16 cannot tell a sound split from a faulty
# one here: the arm computes in fp32.  Its (2, 1) mesh (17-20 s a step
# through gloo on one card in fp32) is left to the CPU tests and the GPU
# test's smoke case (tests/test_torch_cuda_sharded_train.py) for the
# script's time limit.
SSM_RATE = 1e-5
# A tensor-parallel arm's readings add ``replica_gap``: every model rank's
# copy of each replicated leaf against model rank 0's, which must be equal
# (``FAMILY_LIMITS``).  It is what sees the moe arm's control, the gates'
# ``copy_to_model`` left out: at full width from random weights the
# load-balance loss's gradient dominates the router's and the moe layer's
# input's (66% of the pairs dropped at cf 1.25), so on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6) that control moved no reading against
# the one-rank run beyond the sound arm's bf16 noise: the router's and the
# moe norm's AdamW second moments by 0.60-0.68% of themselves against the
# sound arm's 0.37-0.40% (the moe groups' own readings, ``group_readings``,
# reported only).  The copies diverge all the same, since each rank keeps
# its own experts' part.
FAMILY_LIMITS = {**SHARD_LIMITS, "replica_gap": 0.0}


def free_card() -> None:
    """Give the memory of the tensors just dropped back to the card, a
    cyclic collection first (any reference cycle that still holds a
    tensor; ``make_train_step`` imports ``torch._dynamo`` itself, whose
    first import in a step left that step's state in one)."""
    gc.collect()
    torch.cuda.empty_cache()


class Arm(NamedTuple):
    """One arm of the sharded family phases: the config at full width, depth
    cut; sequences of TRAIN_S a step; its meshes; the mesh its control runs
    on; its control (``family_control``), which must fail the limits; its
    eval, None or (the eval of ``shard_eval``, the mesh it runs on);
    ``shard_run_config`` overrides; ``watch``, ``{group: path suffixes}``
    of leaf groups read on their own (``group_readings``, reported only);
    ``unread``, path suffixes of leaves the parameter readings leave out
    (loss and gradient norm still cover them)."""

    cfg: Any
    batch: int
    meshes: tuple
    control_mesh: Any
    control: str
    evaluation: Any = None
    run: Any = None
    watch: Any = None
    unread: tuple = ()


def family_shard_arms() -> dict:
    """name -> ``Arm`` of the moe, hybrid and audio families."""
    from repro_torch.configs import get_config

    return {
        # (1, 2) only: FSDP would gather 2.4 B fp32 expert parameters twice a step
        "moe": Arm(get_config(MOE_ARCH).replace(num_layers=MOE_TRAIN_LAYERS), 2, ((1, 2),), (1, 2),
                   "gates_sum_dropped"),
        "hybrid": Arm(get_config(HYMBA_ARCH).replace(num_layers=FAMILY_SHARD_LAYERS), TRAIN_B, ((1, 2), (2, 1)),
                      (1, 2), "branches_counted_twice"),
        "audio": Arm(get_config("hubert-xlarge").replace(num_layers=FAMILY_SHARD_LAYERS), TRAIN_B, ((1, 2), (2, 1)),
                     (2, 1), "gather_backward_unsummed"),
    }


def family_control(name: str, cfg) -> list:
    """(owner, attribute, replacement) of each change a family control
    makes: the moe gates' ``copy_to_model`` left out (the gates' gradient
    keeps this rank's pairs only); hymba's FFN input ``copy_to_model`` moved to
    the block input (the replicated attention and SSM branches' gradients
    summed over ranks that hold them whole); FSDP's gather backward
    without the sum over the data ranks; rwkv6's channel-mix
    ``copy_to_model`` moved to the block input (the whole time mix's
    gradients summed over ranks that hold them whole); the vlm cross
    layer's query input without its ``copy_to_model`` (the residual keeps
    one rank's heads' part of the cross attention's input gradient); under
    the ``"grouped"`` attention layout, rank r's kv head taken as ``r %
    KV`` rather than its GQA group's ``r // (tp / KV)``."""
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import collectives as C

    if name == "gates_sum_dropped":
        k, inner = cfg.moe.top_k, moe_mod.copy_to_model
        return [(moe_mod, "copy_to_model", lambda x, mesh: x if x.shape[-1] == k else inner(x, mesh))]
    if name == "branches_counted_twice":
        block = model_mod.TRAIN_BLOCKS["hybrid"]

        def summed_input(cfg, p, x, *, mesh=None, **kw):
            return block(cfg, p, C.copy_to_model(x, mesh), mesh=mesh, **kw)

        return [(ffn_mod, "copy_to_model", lambda x, mesh: x),
                (model_mod, "TRAIN_BLOCKS", dict(model_mod.TRAIN_BLOCKS, hybrid=summed_input))]
    if name == "gather_backward_unsummed":
        return [(C._GatherOverData, "backward", staticmethod(shard_control_unsummed_backward))]
    if name == "time_mix_summed_twice":
        from repro_torch.models import rwkv as rwkv_mod

        block = model_mod.TRAIN_BLOCKS["ssm"]

        def summed_block_input(cfg, p, x, *, mesh=None, **kw):
            return block(cfg, p, C.copy_to_model(x, mesh), mesh=mesh, **kw)

        return [(rwkv_mod, "copy_to_model", lambda x, mesh: x),
                (model_mod, "TRAIN_BLOCKS", dict(model_mod.TRAIN_BLOCKS, ssm=summed_block_input))]
    if name == "kv_head_rank_mod_kv":
        from repro_torch.models import attention as attn_mod
        from repro_torch.parallel.sharding import model_rank

        return [(attn_mod, "kv_group", lambda cfg, mesh: model_rank(mesh) % cfg.num_kv_heads)]
    if name == "cross_query_sum_dropped":
        from repro_torch.models import attention as attn_mod

        inner = attn_mod._qkv

        def qkv(cfg, p, x, kv_x=None, fp8=None, mesh=None, sp=False):
            return inner(cfg, p, x, kv_x, fp8, mesh if kv_x is None else None, sp)

        return [(attn_mod, "_qkv", qkv)]
    raise ValueError(name)


class RankView:
    """A mesh seen from another of its ranks: its axes and that rank's
    coordinates, what ``parallel.sharding.shard_tensor`` reads."""

    def __init__(self, mesh, rank: int):
        self.mesh_dim_names, self.shape = mesh.mesh_dim_names, tuple(mesh.shape)
        self.coords = dict(zip(mesh.mesh_dim_names, (mesh.mesh == rank).nonzero()[0].tolist()))

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]


def reference_slices(ref_params, specs, shapes, mesh, skip=()) -> dict:
    """{leaf index: this rank's slice of the reference's leaf} for every
    leaf that ``specs`` shards over ``mesh`` (``shapes``: the leaves' full
    shapes) but the leaf indices ``skip``, on the host: rank 0 holds the
    reference (``ref_params``), cuts every rank's slice and sends the other
    ranks theirs, once for all the runs of a mesh, point to point from host
    memory (no gather of the runs' own slices)."""
    from repro_torch.parallel.sharding import local_shape, shard_tensor
    from repro_torch.utils.tree import tree_leaves

    me, ranks = torch.distributed.get_rank(), mesh.mesh.flatten().tolist()
    out = {}
    for i, (spec, shape) in enumerate(zip(tree_leaves(specs), shapes)):
        local = local_shape(shape, spec, mesh)
        if local == tuple(shape) or i in skip:
            continue
        if me == 0:
            for r in ranks:
                part = shard_tensor(ref_params[i], spec, RankView(mesh, r))
                if r == 0:
                    out[i] = part
                else:
                    torch.distributed.send(part, dst=r)
        else:
            out[i] = torch.empty(local, dtype=torch.float32)
            torch.distributed.recv(out[i], src=0)
    return out


def mesh_param_gaps(params, specs, mesh, mine: dict, ref_params, skip=()) -> tuple[float, float, int]:
    """``param_gaps`` of every leaf but the leaf indices ``skip`` against the
    reference over the mesh: each rank its sharded slices against ``mine``
    (``reference_slices``), rank 0 the leaves no axis shards, which every
    rank holds alike (``replica_gap`` checks it at TP), against its whole
    reference leaf; then the largest and the sums over the ranks."""
    from repro_torch.utils.tree import tree_leaves, tree_map

    me, pairs = torch.distributed.get_rank(), []
    for i, (t, spec) in enumerate(tree_leaves(tree_map(lambda t, s: (t, s), params, specs))):
        if i in mine:
            pairs.append((t, mine[i]))
        elif me == 0 and i not in skip:
            pairs.append((t, ref_params[i]))
    top, total, n = param_gaps(pairs)
    sums = torch.tensor([total, float(n)], dtype=torch.float64)
    top_t = torch.tensor([top], dtype=torch.float64)
    torch.distributed.all_reduce(sums)
    torch.distributed.all_reduce(top_t, op=torch.distributed.ReduceOp.MAX)
    return float(top_t), float(sums[0]), int(sums[1])


def gathered_leaves(tree, specs, mesh, only=None):
    """Each leaf of a params-shaped ``tree`` (or each of the leaf indices
    ``only``) gathered whole over ``mesh``, one at a time (every rank takes
    part in each gather)."""
    from repro_torch.parallel.sharding import unshard_tensor
    from repro_torch.utils.tree import tree_leaves, tree_map

    for i, (t, spec) in enumerate(tree_leaves(tree_map(lambda t, s: (t, s), tree, specs))):
        if only is None or i in only:
            yield unshard_tensor(t, spec, mesh)


def replica_gap(params, specs, mesh) -> float:
    """The largest difference, over the leaves the model axis leaves whole
    and over the ranks, between a rank's copy and the copy of model rank 0
    of its group: 0 when every gradient that reached a replicated leaf was
    summed once over ``"model"`` or computed whole on every rank (trap 1 of
    ``models.moe``), whatever the kernels' summation orders, since each
    partial sum meets an all-reduce before a replicated leaf."""
    from repro_torch.parallel.collectives import model_group
    from repro_torch.utils.tree import tree_leaves, tree_map

    group = model_group(mesh)
    first = torch.distributed.get_global_rank(group, 0)
    top = torch.zeros((), dtype=torch.float64)
    for t, spec in tree_leaves(tree_map(lambda t, s: (t, s), params, specs)):
        if "model" in spec:
            continue
        theirs = t.detach().clone()
        torch.distributed.broadcast(theirs, src=first, group=group)
        top = torch.maximum(top, (t - theirs).abs().max().double().cpu())
    torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
    return float(top)


def group_readings(state, specs, mesh, groups, ref_params, ref_v, lr) -> dict:
    """Each leaf group's own readings against the one-rank run's, the
    largest over the mesh's ranks: a replicated leaf has a copy on every
    rank, each of which must match the reference.  ``<name>_mean_over_lr``
    is the parameters' mean gap in units of lr, ``<name>_v_rel`` the
    relative L1 gap of their AdamW second moments (the gradients'
    squares, which AdamW's update m / sqrt(v) does not normalise away).
    ``ref_params`` and ``ref_v`` hold the reference's leaves of the groups,
    in leaf order, on every rank."""
    watched = sorted(set().union(*groups.values()))
    got = list(gathered_leaves(state.params, specs.params, mesh, set(watched)))
    got_v = list(gathered_leaves(state.opt.v, specs.opt.v, mesh, set(watched)))
    values = []
    for idx in groups.values():
        pick = [j for j, i in enumerate(watched) if i in idx]
        gap = sum(float((got[j] - ref_params[j].to(got[j].device)).abs().sum(dtype=torch.float64)) for j in pick)
        n = sum(got[j].numel() for j in pick)
        num = sum(float((got_v[j] - ref_v[j].to(got_v[j].device)).abs().sum(dtype=torch.float64)) for j in pick)
        den = sum(float(ref_v[j].abs().sum(dtype=torch.float64)) for j in pick)
        values += [gap / n / lr, num / den]
    top = torch.tensor(values, dtype=torch.float64)
    torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
    names = [f"{name}_{what}" for name in groups for what in ("mean_over_lr", "v_rel")]
    return dict(zip(names, top.tolist()))


def flipped_pairs(chosen, ref_chosen) -> int:
    """(token, expert) pairs routed differently from the reference run,
    over the calls both made in the same order."""
    return sum(int((a != b).sum()) for a, b in zip(chosen, ref_chosen)) // 2


class PartClock:
    """Seconds since the last call, by part: ``clock(name)`` closes the
    part ``name`` (``parts``)."""

    def __init__(self):
        self.parts, self.t0 = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        self.parts[name], self.t0 = t - self.t0, t


def fresh_train_state(cfg, run, device, rules=None, mesh=None):
    """The seed's train state (with ``rules`` and a ``mesh``: this rank's
    slices, drawn leaf by leaf), a vlm model's cross gates opened
    (``open_gates``: random init leaves them at 0, the cross layers the
    identity)."""
    from repro_torch.train import init_train_state

    state = init_train_state(cfg, run, SEED, device, rules=rules, mesh=mesh)
    if cfg.family == "vlm":
        open_gates(state.params)
    return state


def family_arm(rank, cfg, B, seq, meshes, control_mesh, control, device, evaluation=None, run_kw=None,
               watch=None, unread=()) -> dict:
    """One arm of ``sharded_families`` on this rank: the one-rank reference
    (rank 0, the other ranks waiting), then each mesh's steps from the
    seed's slices and, on ``control_mesh``, the control's steps.
    ``evaluation``: (an eval of ``shard_eval``, its mesh), run on the
    one-rank model first and on that mesh's slices before their steps,
    from the seed's parameters both.  ``run_kw``: ``shard_run_config``
    overrides.  ``watch``: ``{group: path suffixes}``, leaf groups read on
    their own beside the moe layer's (``group_readings``); ``unread``: path
    suffixes of the leaves the parameter readings leave out."""
    from repro_torch.data import make_batch_fn
    from repro_torch.fp8 import fp8_supported
    from repro_torch.models import param_specs
    from repro_torch.parallel.sharding import state_shardings, training_rules
    from repro_torch.train import make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_paths

    run = shard_run_config(B, seq, cfg.name, fp8=fp8_supported(cfg), **(run_kw or {}))
    lr, rules = run.train.learning_rate, training_rules(run.parallel)
    batch_fn = make_batch_fn(cfg, global_batch=B, seq_len=seq, seed=SEED, device=device)
    batches = [batch_fn(s) for s in range(FAMILY_SHARD_STEPS)]
    moe = cfg.family == "moe"
    out, ref = {}, {}
    paths = ["/".join(map(str, p)) for p in tree_paths(param_specs(cfg))]  # the order of the state's leaves
    shapes = [s.shape for s in tree_leaves(param_specs(cfg))]
    # the moe layer's readings by group: its router (the gates' gradient) and
    # the scale of the norm before it, whose gradient comes through the moe
    # layer alone (the dispatch input's and the router's)
    groups = {"router": {i for i, p in enumerate(paths) if p.endswith("/router")},
              "norm2": {i for i, p in enumerate(paths) if "/norm2/" in p}} if moe else {}
    groups.update({name: {i for i, p in enumerate(paths) if p.endswith(ends)} for name, ends in (watch or {}).items()})
    skip = {i for i, p in enumerate(paths) if unread and p.endswith(tuple(unread))}
    watched = set().union(*groups.values())
    if rank == 0:  # the one-rank run, alone on the card: its readings kept on the host
        clock = PartClock()
        state = fresh_train_state(cfg, run, device)
        clock("init")
        one_eval = shard_eval(evaluation[0], cfg, state.params, batches[0]) if evaluation else None
        clock("eval")
        step = make_train_step(cfg, run)
        with RoutedPairs(record=moe) as routes:
            state, metrics, got = shard_steps(step, state, batches)
        clock("steps")
        ref["metrics"], ref["params"], ref["routes"] = metrics, [t.cpu() for t in tree_leaves(state.params)], routes
        ref["groups"] = ([ref["params"][i] for i in sorted(watched)],
                         [t.cpu() for i, t in enumerate(tree_leaves(state.opt.v)) if i in watched])
        out["one_rank"] = {"metrics": ref["metrics"], **{k: got[k] for k in (
            "wall_s", "state_bytes", "resident_bytes", "max_memory_allocated", "step_peak_above_resident")},
            "k4_a_step": got["k4"]["fp8_gemm"] / len(metrics)}
        if one_eval is not None:
            out["one_rank"]["eval"] = one_eval
        clock("to_host")
        out["one_rank"]["parts_s"] = clock.parts
        if moe:
            out["one_rank"]["routed"] = {"pairs": routes.pairs, "dropped": int(routes.dropped)}
        del state
        # the reference's state is gone before any cyclic collection (make_train_step imports torch._dynamo)
        out["one_rank"]["left_before_collect"] = torch.cuda.memory_allocated()
        free_card()
        out["one_rank"]["left_allocated"] = torch.cuda.memory_allocated()
    shared = [ref.get("groups")]
    torch.distributed.broadcast_object_list(shared, src=0)  # the groups' small reference leaves, to every rank
    for shape, mesh in meshes.items():
        specs = state_shardings(cfg, run, rules, mesh)
        rec = out[f"{shape[0]}x{shape[1]}"] = {"mesh": list(shape)}
        t0 = time.perf_counter()
        mine = reference_slices(ref.get("params"), specs.params, shapes, mesh, skip)  # once for the mesh's runs
        rec["reference_slices_s"] = time.perf_counter() - t0
        for what in ("arm",) + ((control,) if shape == control_mesh else ()):
            changes = family_control(what, cfg) if what != "arm" else []
            kept = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in changes]
            for owner, attr, new in changes:
                setattr(owner, attr, new)
            clock = PartClock()
            try:
                state = fresh_train_state(cfg, run, device, rules, mesh)
                clock("init")
                if what == "arm" and evaluation and evaluation[1] == shape:
                    rec["eval"] = shard_eval(evaluation[0], cfg, state.params, batches[0], mesh)
                    clock("eval")
                with RoutedPairs(record=moe) as routes:
                    state, metrics, got = shard_steps(make_train_step(cfg, run, rules, mesh), state, batches, mesh)
                clock("steps")
            finally:
                for owner, attr, old in kept:
                    setattr(owner, attr, old)
            free_card()  # the steps' cached blocks, before the gathers
            by_group = group_readings(state, specs, mesh, groups, *shared[0], lr) if groups else {}
            if shape[1] > 1:
                by_group["replica_gap"] = replica_gap(state.params, specs.params, mesh)
            gaps = mesh_param_gaps(state.params, specs.params, mesh, mine, ref.get("params"), skip)
            if rank == 0:
                readings = {**shard_readings(metrics, ref["metrics"], lr, gaps), **by_group}
            del state
            free_card()
            clock("readings")
            rec.setdefault("parts_s", {})[what] = clock.parts
            if what == "arm":
                rec.update(metrics=metrics, **got)
                if moe:
                    rec["routed"] = {"pairs": routes.pairs, "dropped": int(routes.dropped)}
                if rank == 0:
                    rec["readings"] = readings
                    if moe:
                        rec["flipped_pairs"] = flipped_pairs(routes.chosen, ref["routes"].chosen)
            elif rank == 0:
                rec["control"] = {"name": what, "readings": readings}
        del mine
    torch.distributed.barrier()
    return out


def family_shard_rank(rank, mesh_tp, device_type="cuda", arms=None, seq=TRAIN_S) -> dict:
    """One rank of ``sharded_families`` (or of ``sharded_ssm_vlm``, whose
    ``arms`` its phase passes): every arm of ``family_shard_arms``
    (``arms``, ``seq`` and ``device_type`` serve rehearsals with smoke
    models on the CPU)."""
    from repro_torch.launch.mesh import make_local_mesh

    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    meshes = {(1, 2): mesh_tp, (2, 1): make_local_mesh(2, 1, backend="gloo", device=device_type)}
    out = {"rank": rank}
    for name, arm in (arms or family_shard_arms()).items():
        t0 = time.perf_counter()
        out[name] = family_arm(rank, arm.cfg, arm.batch, seq, {s: meshes[s] for s in arm.meshes}, arm.control_mesh,
                               arm.control, device, arm.evaluation, arm.run, arm.watch, arm.unread)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def sharded_families_phase() -> tuple[dict, dict]:
    """Every sharded family arm in one spawn of two gloo ranks on the one
    card (``family_shard_rank``): the moe, hybrid and audio families'
    (``family_shard_arms``), then the ssm and vlm families' with their
    sharded evals (``ssm_vlm_arms``), each held to its one-rank step with a
    control.  Returns the ``sharded_families`` and ``sharded_ssm_vlm``
    reports."""
    from repro_torch.launch.mesh import run_ranks

    free_card()  # the memory the earlier phases' tensors left cached
    parent = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    families, ssm_vlm = family_shard_arms(), ssm_vlm_arms()
    try:
        with ranks_allocator():
            ranks = run_ranks(family_shard_rank, 2, backend="gloo", device="cuda", timeout_s=900,
                              args=("cuda", {**families, **ssm_vlm}))
    except (RuntimeError, TimeoutError) as e:
        fail(f"sharded_families: {e}")
    seconds = time.perf_counter() - t0
    return (family_report(ranks, families, seconds, parent_allocated=parent),
            family_report(ranks, ssm_vlm, seconds, parent_allocated=parent, phase="sharded_ssm_vlm"))


def family_report(ranks, arms, seconds, seq=TRAIN_S, parent_allocated=0, phase="sharded_families") -> dict:
    """``sharded_families``' (or ``phase``'s) line from the ranks' results,
    then its gates."""
    from repro_torch.fp8 import fp8_sites, fp8_supported

    out = {"phase": phase, "backend": "gloo", "ranks": len(ranks), "seconds": seconds,
           "steps": FAMILY_SHARD_STEPS, "parent_allocated_bytes": parent_allocated}
    gates = []
    for name, a in arms.items():
        cfg, B, shapes = a.cfg, a.batch, a.meshes
        # forward, recompute, dx and dw of every site; none where the family takes no fp8
        per_step = 4 * cfg.num_layers * len(fp8_sites(cfg)) if fp8_supported(cfg) else 0
        arm = {"model": cfg.name, "layers": cfg.num_layers, "batch": [B, seq], "limits": FAMILY_LIMITS,
               "k4_per_step": per_step, "seconds": [r[name]["seconds"] for r in ranks],
               "one_rank": ranks[0][name]["one_rank"]}
        for shape in shapes:
            key = f"{shape[0]}x{shape[1]}"
            recs = [r[name][key] for r in ranks]
            arm[key] = {
                "step_wall_s": [a["wall_s"] for a in recs],
                "collectives_per_step": [{k: v / FAMILY_SHARD_STEPS for k, v in a["collectives"].items() if v}
                                         for a in recs],
                "k4_launches": [a["k4"]["fp8_gemm"] for a in recs],
                "k4_layout_copies": [a["k4"]["fp8_layout_copy"] for a in recs],
                **{k: [a[k] for a in recs] for k in ("state_bytes", "resident_bytes", "max_memory_allocated",
                                                      "step_peak_above_resident")},
                "losses": [m["loss"] for m in recs[0]["metrics"]], "aux_losses": [m["aux_loss"] for m in recs[0]["metrics"]],
                "readings": recs[0]["readings"], "parts_s": recs[0]["parts_s"],
                "reference_slices_s": recs[0]["reference_slices_s"],
                **{k: recs[0][k] for k in ("control",) if k in recs[0]},
                **({"routed": [a["routed"] for a in recs], "flipped_pairs": recs[0]["flipped_pairs"]}
                   if cfg.family == "moe" else {}),
            }
            if "eval" in recs[0]:
                arm[key]["eval"] = [a["eval"] for a in recs]
            gates.append((name, key, recs, per_step, {k: v for k, v in FAMILY_LIMITS.items() if k in recs[0]["readings"]}))
        out[name] = arm
    emit(out)  # before the gates, so a failing run still shows its readings
    within_limits = lambda r, limits: all(r[k] <= lim for k, lim in limits.items())  # noqa: E731
    for name, key, recs, per_step, limits in gates:
        if any(r["metrics"] != recs[0]["metrics"] for r in recs):
            fail(f"{phase} {name} {key}: the ranks' metrics differ")
        if not within_limits(recs[0]["readings"], limits):
            fail(f"{phase} {name} {key}: the sharded steps part from the one-rank steps: {recs[0]['readings']}")
        if "control" in recs[0] and within_limits(recs[0]["control"]["readings"], limits):
            fail(f"{phase} {name} {key}: the control passes the limits: {recs[0]['control']}")
        if [a["k4"]["fp8_gemm"] for a in recs] != [per_step * FAMILY_SHARD_STEPS] * len(recs):
            fail(f"{phase} {name} {key}: K4 launches {[a['k4']['fp8_gemm'] for a in recs]}, expected "
                 f"{per_step * FAMILY_SHARD_STEPS} a rank")
        if "eval" in recs[0]:
            shard_eval_gates(f"{phase} {name} {key}", arms[name].cfg, [a["eval"] for a in recs],
                             out[name]["one_rank"]["eval"], SHARDED_EVAL_LIMITS.get(arms[name].cfg.name))
    return out


# ---------------------------------------------------------------------------
# phase 9b4: sharded training of the ssm and vlm families
# ---------------------------------------------------------------------------

SSM_SHARD_LAYERS = 4  # rwkv6-7b's 32 cut to 4: 1.42 B parameters, 22.7 GB of fp32 state and gradients
# llama-3.2-vision cut 100 -> 2: one group of a self layer and the cross layer
# (cross_attn_every 2), 3.81 B parameters (61 GB of state and gradients on one
# rank); one group of 4 self layers and the cross layer would be 102 GB
VLM_SHARD_LAYERS = 2
# The vlm arm's batch, 1 x 2048: the dry run on the meta device
# (``launch.dryrun.cost_step``) put the one-rank step's peak at 2 x 2048 at
# 65.39 GB, and the two (1, 2) ranks, which together hold about what that
# step holds plus a second CUDA context and each allocator's cached blocks,
# ran out of the card's 79.18 GiB at 2 x 2048 (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6); the width stays whole.
VLM_SHARD_BATCH = 1


def shard_eval(kind, cfg, params, batch, mesh=None, sequence_parallel=False) -> dict:
    """An eval forward of ``params`` (the one-rank model, or this rank's
    slices on ``mesh``, with ``sequence_parallel`` if asked), bf16, without
    gradients.  ``kind`` ``"wkv"``
    (rwkv6-7b): the loss through K5 and through the control scan
    (``wkv_late_decay``), K5's launches in the first, and per layer K5 and
    the control against the chunked scan (``layer_readings``).
    ``"attention"``: the loss and this rank's logits through the torch
    attention, K3 and the control attention (``attention_next_key``), K3's
    launches, flash and the control against torch (the logits' largest gap
    over the ranks)."""
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.models import attention, forward
    from repro_torch.train import loss_fn

    bf16 = torch.bfloat16
    with torch.no_grad():
        if kind == "wkv":
            control = on_model_layout(wkv_late_decay)
            K5.reset_launches()
            loss = float(loss_fn(cfg, params, batch, wkv_impl="kernel", compute_dtype=bf16, mesh=mesh)[0])
            launches = K5.LAUNCHES["rwkv6_scan"]
            control_loss = float(loss_fn(cfg, params, batch, wkv_impl=control, compute_dtype=bf16, mesh=mesh)[0])
            layers = layer_readings(cfg, params, batch["tokens"], control, bf16, mesh)
            return {"loss": loss, "control_loss": control_loss, "k5_launches": launches,
                    "layers_kernel_vs_chunked": layers["sound"], "layers_control_vs_chunked": layers["control"]}

        def run(impl):
            kw = dict(attn_impl=impl, compute_dtype=bf16, mesh=mesh, sequence_parallel=sequence_parallel)
            K3.reset_launches()
            loss = float(loss_fn(cfg, params, batch, **kw)[0])
            launches = K3.LAUNCHES["flash_attention"]  # one forward's
            return loss, forward(cfg, params, batch, **kw)[0], launches

        loss_torch, ref, _ = run("torch")
        loss_flash, logits, launches = run("flash")
        finite = bool(torch.isfinite(logits).all())
        k3, attention.flash_attention = attention.flash_attention, attention_next_key
        try:
            control_loss, control, _ = run("flash")
        finally:
            attention.flash_attention = k3
        gaps = torch.stack([(logits - ref).abs().max(), (control - ref).abs().max()]).float()
        if mesh is not None:
            torch.distributed.all_reduce(gaps, op=torch.distributed.ReduceOp.MAX)
        del ref, logits, control
    return {"loss": loss_flash, "control_loss": control_loss, "k3_launches": launches, "finite": finite,
            "flash_vs_torch": {"loss_diff": abs(loss_flash - loss_torch), "max_logits_diff": float(gaps[0])},
            "control_vs_torch": {"loss_diff": abs(control_loss - loss_torch), "max_logits_diff": float(gaps[1])}}


def shard_eval_gates(where: str, cfg, evals: list, one: dict, limits=None) -> None:
    """The sharded eval's gates: the ranks read the same losses; K5 or K3
    against the same ranks' plain path within the eval's limits
    (``RWKV_LAYER_LIMITS``, ``EVAL_LIMITS_BY_MODEL``) and the control
    outside them; the loss within the eval's loss limit of the one-rank
    eval's and the control's loss outside it; every rank launches K5 once
    a layer (the whole time mix) or K3 once a self layer."""
    e = evals[0]
    if any((r["loss"], r["control_loss"]) != (e["loss"], e["control_loss"]) for r in evals):
        fail(f"{where} eval: the ranks' losses differ: {evals}")
    if "k5_launches" in e:
        limits, loss_limit = RWKV_LAYER_LIMITS[torch.bfloat16], EVAL_LIMITS["loss_diff"]
        sound, control = e["layers_kernel_vs_chunked"], e["layers_control_vs_chunked"]
        launches, expected = [r["k5_launches"] for r in evals], cfg.num_layers
    else:
        limits = limits or EVAL_LIMITS_BY_MODEL.get(cfg.name, EVAL_LIMITS)
        loss_limit = limits["loss_diff"]
        sound, control = e["flash_vs_torch"], e["control_vs_torch"]
        launches, expected = [r["k3_launches"] for r in evals], self_attention_layers(cfg)
        if not all(r["finite"] for r in evals):
            fail(f"{where} eval: K3's logits are not finite")
    if launches != [expected] * len(evals):
        fail(f"{where} eval: kernel launches {launches}, expected {expected} a rank")
    if not within(sound, limits):
        fail(f"{where} eval: the kernel and the plain path part on the ranks: {sound}")
    if within(control, limits):
        fail(f"{where} eval: the control passes the eval's limits, which then prove nothing: {control}")
    if abs(e["loss"] - one["loss"]) > loss_limit:
        fail(f"{where} eval: the sharded loss {e['loss']} parts from the one-rank eval's {one['loss']}")
    if abs(e["control_loss"] - one["loss"]) <= loss_limit:
        fail(f"{where} eval: the control's loss {e['control_loss']} passes against the one-rank eval's {one['loss']}")


def ssm_vlm_arms() -> dict:
    """name -> ``Arm`` of the ssm and vlm families: rwkv6-7b (4 of 32
    layers, 4 x 2048, fp32 at ``SSM_RATE``, its reasons there) at (1, 2)
    with its control and K5's eval; llama-3.2-vision (one group of a self
    and the cross layer, ``VLM_SHARD_BATCH`` x 2048, 1600 image tokens a
    row, the gates opened) at (1, 2) only, as qwen3-moe: FSDP would move
    tens of GB through gloo a step."""
    from repro_torch.config import VisionConfig
    from repro_torch.configs import get_config

    rwkv = get_config("rwkv6-7b").replace(num_layers=SSM_SHARD_LAYERS)
    vlm = get_config(VLM_ARCH)
    vlm = vlm.replace(num_layers=VLM_SHARD_LAYERS, vision=VisionConfig(num_image_tokens=vlm.vision.num_image_tokens,
                                                                      cross_attn_every=VLM_SHARD_LAYERS))
    return {
        "ssm": Arm(rwkv, TRAIN_B, ((1, 2),), (1, 2), "time_mix_summed_twice", ("wkv", (1, 2)),
                   {"lr": SSM_RATE, "compute_dtype": "float32"}),
        "vlm": Arm(vlm, VLM_SHARD_BATCH, ((1, 2),), (1, 2), "cross_query_sum_dropped", ("attention", (1, 2))),
    }


# ---------------------------------------------------------------------------
# phase 9b5: the "grouped" attention layout, qwen3-moe's query heads split over
# eight gloo ranks on the one card
# ---------------------------------------------------------------------------

# 64 query heads split 8 a rank while the 4 kv heads do not divide the axis:
# two ranks a GQA group, each attending over its group's kv head.  The only
# full-width config whose kv heads fail to divide a model axis one card's
# ranks can reach.
GROUPED_TP = 8
GROUPED_LAYERS = 1  # of 94, as the moe train arm
GROUPED_PROMPTS = 4  # of the router phase's 16 tenant prompts
GROUPED_BATCH = 2  # x TRAIN_S, as the moe train arm
# The arm's AdamW moments, bf16 (in its one-rank reference too): with fp32
# moments the eight ranks ran out of the card's 79.18 GiB in the first
# step's AdamW update, at 2 x 2048 and at 1 x 2048 alike (8.58 and 8.83 GiB
# allocated on a rank beside eight contexts, NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6): a rank's state is 471 M parameters, the widths whole
GROUPED_RUN = {"optimizer_dtype": "bfloat16"}


def grouped_config():
    from repro_torch.configs import get_config

    return get_config(MOE_ARCH).replace(num_layers=GROUPED_LAYERS)  # full width, depth cut


def grouped_arm(cfg) -> Arm:
    """The grouped layout's train arm: ``cfg`` at ``(1, GROUPED_TP)``, its
    control the kv head taken as ``r % KV``, its eval through K3 on 8
    query heads over one kv head a rank, wk / wv's readings reported on
    their own (their gradient sums each rank's fp8 partial: only this
    layout sums it over the model axis).  Its parameter readings leave out
    the experts and the vocab tables, which split over the model axis as
    in ``sharded_families``' moe arm (their reference slices would take 13
    GB through gloo): they read the attention, router and norm leaves,
    whose updates the control moves."""
    return Arm(cfg, GROUPED_BATCH, ((1, GROUPED_TP),), (1, GROUPED_TP), "kv_head_rank_mod_kv",
               ("attention", (1, GROUPED_TP)), GROUPED_RUN, watch={"attn_kv": ("/attn/wk", "/attn/wv")},
               unread=("/moe/w_gate", "/moe/w_up", "/moe/w_down", "embed/tok", "lm_head"))


def grouped_serving(rank, mesh, cfg, prompts, max_new_tokens, device) -> dict:
    """TP serving of ``prompts`` under the grouped layout on this rank: its
    slices drawn leaf by leaf from ``SEED`` (the full weights on rank 0
    only, whose TP=1 engine serves first), the engine run
    (``tp_serve``), then one prompt's prefill and decode logits on fp32
    pools and the same with rank r's kv head taken as ``r % KV`` (the
    control).  Rank 0 holds the TP run's tokens and logits to TP=1's."""
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import attention_layout, executed_specs, local_kv_heads

    t0 = time.perf_counter()
    local = init_params(cfg, SEED, device, shardings=executed_specs(cfg, mesh)["executed"], mesh=mesh)
    attn = local["blocks"][0]["attn"]
    out = {"layout": list(attention_layout(mesh, cfg.num_heads, cfg.num_kv_heads)),
           "shapes": {k: list(attn[k].shape) for k in ("wq", "wk", "wv", "wo")}}
    full = None
    if rank == 0:
        full = init_params(cfg, SEED, device)
        out["tp1"] = tp_serve(cfg, full, None, prompts, max_new_tokens, device)
    torch.distributed.barrier()
    out["tp"] = tp_serve(cfg, local, mesh, prompts, max_new_tokens, device)
    kv = local_kv_heads(cfg, mesh)
    lp, ld, _, _ = tp_prompt_cache(cfg, local, mesh, prompts[0], kv)
    [(owner, attr, control)] = family_control("kv_head_rank_mod_kv", cfg)
    kept = getattr(owner, attr)
    setattr(owner, attr, control)
    try:
        cp, cd, _, _ = tp_prompt_cache(cfg, local, mesh, prompts[0], kv)
    finally:
        setattr(owner, attr, kept)
    if rank == 0:
        rp, rd, _, _ = tp_prompt_cache(cfg, full, None, prompts[0], cfg.num_kv_heads)
        found = []
        out["ties_ok"] = same_up_to_ties(cfg, full, device, prompts, out["tp"]["tokens"], out["tp1"]["tokens"], found)
        out["differences"] = found[0]
        out["logits"] = {"prefill_rel": rel_gap(lp, rp), "decode_rel": rel_gap(ld, rd),
                         "control_prefill_rel": rel_gap(cp, rp), "control_decode_rel": rel_gap(cd, rd),
                         "tol": TP_LOGIT_TOL}
    del full, local, attn
    free_card()
    out["seconds"] = time.perf_counter() - t0
    return out


def grouped_rank(rank, mesh, device_type="cuda", cfg=None, prompts=None, max_new_tokens=None, seq=TRAIN_S,
                 arm=None) -> dict:
    """One rank of ``grouped_heads``: the serving run (``grouped_serving``,
    at capacity factor ``MOE_CF`` so that no pair is dropped), then the
    train arm (``family_arm`` of ``grouped_arm``).  ``device_type``,
    ``cfg``, ``prompts``, ``seq`` and ``arm`` serve rehearsals with a smoke
    model on the CPU."""
    from repro_torch.benchmarks import llm_inference as bench

    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    cfg = cfg or grouped_config()
    prompts = prompts or bench.tenant_prompts(system_len=ROUTER_SYSTEM_LEN)[:GROUPED_PROMPTS]
    out = {"rank": rank,
           "serving": grouped_serving(rank, mesh, with_cf(cfg, MOE_CF), prompts, max_new_tokens or bench.ROUTER_MAX_NEW,
                                      device)}
    arm = arm or grouped_arm(cfg)
    t0 = time.perf_counter()
    out["train"] = family_arm(rank, arm.cfg, arm.batch, seq, {shape: mesh for shape in arm.meshes}, arm.control_mesh,
                              arm.control, device, arm.evaluation, arm.run, arm.watch, arm.unread)
    out["train"]["seconds"] = time.perf_counter() - t0
    return out


def grouped_heads_phase() -> dict:
    """qwen3-moe at full width cut to ``GROUPED_LAYERS`` over ``(1,
    GROUPED_TP)``: eight gloo ranks on the one card, each holding 8 of the
    64 query heads and every kv head's wk / wv, attending over its GQA
    group's kv head (``grouped_rank``)."""
    from repro_torch.launch.mesh import run_ranks

    free_card()
    t0 = time.perf_counter()
    try:
        with ranks_allocator():
            ranks = run_ranks(grouped_rank, (1, GROUPED_TP), backend="gloo", device="cuda", timeout_s=900,
                              args=("cuda",))
    except (RuntimeError, TimeoutError) as e:
        fail(f"grouped_heads: {e}")
    return grouped_report(ranks, grouped_config(), time.perf_counter() - t0)


def grouped_report(ranks, cfg, seconds, seq=TRAIN_S) -> dict:
    """``grouped_heads``' line from the ranks' results, then its gates: the
    layout (8 query heads and every kv head's wk a rank, pools of one kv
    head, 1 / KV of TP=1's pool bytes, TP=1's global cache bytes), tokens
    equal on every rank and to TP=1's up to at most one near tie, every
    request finished by length, K1/K2 once a layer a decode step or chunk
    on every rank as the autotuner's table says for the local heads (its
    ``"prefill1"``: K2 in place of K1), 2 collectives a layer and 2 a model
    call, TP logits within ``TP_LOGIT_TOL`` of TP=1's and the control's
    outside; then the train arm's gates (``family_report``)."""
    from repro_torch.kernels import autotune

    serving = [r["serving"] for r in ranks]
    s0, runs = serving[0], [s["tp"] for s in serving]
    tp1 = s0["tp1"]
    L, H, KV = cfg.num_layers, cfg.num_heads // GROUPED_TP, 1
    tuned = autotune.get_config(cfg.head_dim, BLOCK_SIZE, -(-TP_ENGINE["max_seq"] // BLOCK_SIZE), torch.bfloat16, H // KV)
    decode_kernel = "paged_prefill" if tuned["decode_kernel"] == "prefill1" else "paged_decode"
    out = {"phase": "grouped_heads", "model": cfg.name, "layers": L, "backend": "gloo", "ranks": len(ranks),
           "seconds": seconds, "layout": s0["layout"], "local_shapes": s0["shapes"], "decode_kernel": decode_kernel,
           "serving": {
               "seconds": [s["seconds"] for s in serving],
               "tp1": {k: tp1[k] for k in ("step_p50_s", "decode_step_p50_s", "wall_s", "cache_bytes", "pool_bytes")},
               "tp": [{k: v for k, v in r.items() if k not in ("tokens", "reasons")} for r in runs],
               "launches_per_step": [{k: v / (r["decode_steps"] + r["prefill_chunks"]) for k, v in r["launches"].items()
                                      if v} for r in runs],
               "differences": s0["differences"], "logits": s0["logits"]}}
    train = family_report([{"grouped": r["train"]} for r in ranks], {"grouped": grouped_arm(cfg)}, seconds, seq,
                          phase="grouped_heads_train")
    out["train"] = {k: v for k, v in train["grouped"].items()}
    emit({k: v for k, v in out.items() if k != "train"})  # before the gates, so a failing run shows its readings
    for rank, s in enumerate(serving):
        if s["layout"] != ["grouped", 1] or s["shapes"]["wq"][1] != H or s["shapes"]["wk"][1] != cfg.num_kv_heads:
            fail(f"grouped_heads rank {rank}: layout {s['layout']}, local shapes {s['shapes']}")
    if any(r["tokens"] != runs[0]["tokens"] for r in runs):
        fail("grouped_heads: the ranks' tokens differ")
    if not s0["ties_ok"] or len(s0["differences"]) > 1:
        fail(f"grouped_heads: TP={GROUPED_TP} tokens differ from TP=1's beyond one near tie: {s0['differences']}")
    lg = s0["logits"]
    if not max(lg["prefill_rel"], lg["decode_rel"]) < TP_LOGIT_TOL:
        fail(f"grouped_heads: TP={GROUPED_TP} logits part from TP=1's: {lg}")
    if not min(lg["control_prefill_rel"], lg["control_decode_rel"]) > TP_LOGIT_TOL:
        fail(f"grouped_heads: the control (kv head r % KV) passes, which then proves nothing: {lg}")
    for rank, r in enumerate(runs):
        if not all(x == "length" for x in r["reasons"]) or r["alloc_blocks_in_use"]:
            fail(f"grouped_heads rank {rank}: {r['reasons']}, blocks in use {r['alloc_blocks_in_use']}")
        if r["kv_heads"] != KV or cfg.num_kv_heads * r["pool_bytes"] != tp1["pool_bytes"] \
                or r["cache_bytes"] != tp1["cache_bytes"]:
            fail(f"grouped_heads rank {rank}: {r['kv_heads']} kv heads, pool bytes {r['pool_bytes']} (TP=1 "
                 f"{tp1['pool_bytes']}), global cache bytes {r['cache_bytes']} (TP=1 {tp1['cache_bytes']})")
        steps, chunks = r["decode_steps"], r["prefill_chunks"]
        expect = {"paged_decode": steps * L if decode_kernel == "paged_decode" else 0,
                  "paged_prefill": (chunks + (steps if decode_kernel == "paged_prefill" else 0)) * L}
        if not ({k: r["launches"][k] for k in expect} == expect and steps > 0 and chunks > 0):
            fail(f"grouped_heads rank {rank}: launches {r['launches']}, expected {expect}")
        calls = (r["collectives"]["all_reduce"] + r["collectives"]["all_gather"]) / (steps + chunks)
        if calls != 2 * L + 2:
            fail(f"grouped_heads rank {rank}: {r['collectives']} is not 2 per layer + 2 a model call")
    return out


def mlperf_phase(device) -> dict:
    """Fig. 8: ``repro_torch.benchmarks.mlperf_train.run`` on the card, then
    one more step of the same run from a fresh state under
    ``torch.profiler``: device time by kernel and the idle share against
    the run's step."""
    from repro_torch.benchmarks import mlperf_train
    from repro_torch.data import make_batch_fn
    from repro_torch.train import init_train_state, make_train_step

    rows = mlperf_train.run(device)
    cfg = mlperf_train.full_config()
    run = mlperf_train.run_config(mlperf_train.MLPERF_BATCH, mlperf_train.MLPERF_SEQ, mlperf_train.MLPERF_MICROBATCHES)
    state = init_train_state(cfg, run, SEED, device)
    step = make_train_step(cfg, run)
    batch = make_batch_fn(cfg, global_batch=run.train.global_batch, seq_len=run.train.seq_len, seed=SEED,
                          device=device)(0)

    def one_step():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])

    by_name, launches, prof_wall_ms, _ = profiled(one_step, cpu=False)  # ~99 k launches: the device's events only
    del state, batch
    busy = sum(by_name.values())
    by_kind = ms_by_kind(by_name)
    step_ms = rows[0]["step_seconds"] * 1e3
    emit({"phase": "mlperf_profile", "what": "one Fig. 8 step (448 x 512, 14 microbatches) under torch.profiler",
          "step_ms": step_ms, "wall_ms_under_profiler": prof_wall_ms, "device_busy_ms": busy if by_name else None,
          "idle_share": 1.0 - busy / step_ms if by_name else None, "device_launches": int(launches),
          "ms_by_kind": by_kind, "gemm_share": by_kind["gemm"] / busy if by_name else None,
          "top_kernels_ms": [[k[:160], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]]})
    measured, roofline = rows
    csv = [f"{r['name']},{r['us_per_call']:.1f},{r['derived']}" for r in rows]
    steps = measured["steps"]
    out = {"phase": "mlperf", "rows": csv, "steps": steps, "params": measured["params"],
           "step_s": measured["step_seconds"], "tokens_per_s": measured["tokens_per_s"],
           "model_tflop_s": measured["model_tflop_s"], "bf16_peak_share": measured["bf16_peak_share"],
           "roofline_step_s": roofline["us_per_call"] / 1e6, "peak_mem_gb": measured["peak_mem_gb"],
           "batch": [mlperf_train.MLPERF_BATCH, mlperf_train.MLPERF_SEQ, mlperf_train.MLPERF_MICROBATCHES],
           "flops_formula": mlperf_train.FLOPS_FORMULA}
    emit(out)
    if [r["name"] for r in rows] != ["mlperf_bert_full_h100", "mlperf_bert_full_roofline"] or any(
            len(line.split(",")) != 3 for line in csv):
        fail(f"mlperf: rows not in the reference's name,us_per_call,derived format: {csv}")
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        fail(f"mlperf: a loss or gradient norm is not finite: {steps}")
    if steps[0]["lr"] != 0.0 or not all(s["lr"] > 0 for s in steps[1:]):
        fail(f"mlperf: lr must be 0 at step 0 and above 0 after: {[s['lr'] for s in steps]}")
    return out


# ---------------------------------------------------------------------------
# phases 9d-9f: the moe, hybrid and audio training forwards at full width
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS = 1  # of 94: a layer is 2.49 B parameters (40 GB of training state), the head and embedding 20 GB
FAMILY_STEPS = 3
# arch: (depth, or None for the published one; sequences of TRAIN_S tokens a step)
FAMILY_TRAIN = {
    MOE_ARCH: (MOE_TRAIN_LAYERS, 2),  # two routed groups of 2048 tokens, C = 160
    HYMBA_ARCH: (8, TRAIN_B),  # 8 of 32 layers
    "hubert-xlarge": (16, TRAIN_B),  # 16 of 48 layers
}
# the gate's limits by model: the dense path's PATH_LIMITS unless a model's
# own readings on the H100 (PERF.md, training forwards; kernel and order probe against
# the k-tail control in one run) set others.  hymba-1.5b: loss_rel 1.8e-5 and
# 1.3e-5 against 3.9e-3, param_mean_over_lr 7.3e-3 and 7.2e-3 against 0.101
# (the share of near-zero gradients whose sign a sum order flips is model's
# own).  hubert-xlarge: param_mean_over_lr 2.8e-3 and 2.8e-3 against 0.0236;
# its loss_rel (2.0e-5, 2.4e-5 against 2.4e-5) does not separate them and is
# reported only.  qwen3-moe-235b-a22b holds PATH_LIMITS: 1.5e-6 and 1.5e-6
# against 9.9e-4, 1.1e-3 and 1.5e-3 against 0.024.
FAMILY_PATH_LIMITS: dict = {
    HYMBA_ARCH: {"loss_rel": 8e-5, "param_mean_over_lr": 0.02},
    "hubert-xlarge": {"param_mean_over_lr": 4.3e-3},
}


def forward_bound(cfg, params, B, S) -> tuple[float, str, float]:
    """(bound ms, what bounds it, TFLOP) of one bf16 forward over B x S: every
    weight but the embedding table read once in fp32, against 2 operations a
    projection weight a token (a moe token reaches top_k of the experts),
    the head, and 4 hd operations a visible (query, key) pair of every
    attention head.  The SSD scan's and the norms' operations are not
    counted: a lower bound."""
    from repro_torch.utils.tree import tree_leaves, tree_paths

    T = B * S
    per_token = cfg.d_model * cfg.padded_vocab  # the head
    nbytes = 0
    for path, t in zip(tree_paths(params), tree_leaves(params)):
        if path[:2] == ("embed", "tok") or path[:2] == ("embed", "pos"):
            continue  # rows gathered, not read whole
        nbytes += 4 * t.numel()
        if path[0] != "blocks" and path != ("embed", "frame_proj"):
            continue
        if t.dim() < 2 or path[-1] in ("conv_w", "a_log", "maa_w2"):
            continue  # not a projection
        share = cfg.moe.top_k / cfg.moe.num_experts if path[-2:-1] == ("moe",) and t.dim() == 3 else 1.0
        per_token += share * t.numel()
    _, attn_ops = flash_work(B, 1, 1, S, S, 1, 1, cfg.causal, cfg.sliding_window)  # one head of hd 1
    flops = 2 * T * per_token + attn_ops * cfg.head_dim * cfg.num_heads * self_attention_layers(cfg)
    ms, by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    return ms, by, flops / 1e12


def family_train_phase(cfg, device) -> dict:
    """Train ``cfg`` with fp8 (K4 in every quantized projection), bf16
    compute and ``remat="full"``, ``FAMILY_STEPS`` steps of B x ``TRAIN_S``
    tokens (frames for audio) from random weights; then gate the kernel step
    against the plain-GEMM step from the state the steps reached, every K4
    call of it against the plain GEMM on its operands; then the eval
    forward through K3 against ``"torch"`` (``eval_phase``) beside the
    forward's bound; then one more step under ``torch.profiler``.

    The gate is ``train_path_phase`` with ``k_tail_control``: olmo's
    ``scale_control`` (the inverse scale rounded to bf16) moves these
    models' loss and updates no more than a sound order of the sums does
    (PERF.md, training forwards).  Its limits are ``FAMILY_PATH_LIMITS``, else
    ``PATH_LIMITS``."""
    from repro_torch.data import make_batch_fn
    from repro_torch.fp8 import fp8_sites
    from repro_torch.fp8 import gemm as K4
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    B = FAMILY_TRAIN[cfg.name][1]
    run = train_run_config("kernel", cfg.name, B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, run, SEED, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch_fn = make_batch_fn(cfg, global_batch=B, seq_len=TRAIN_S, seed=SEED, device=device)
    batches = [batch_fn(i) for i in range(FAMILY_STEPS + 1)]
    step = make_train_step(cfg, run)
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))  # forward, recompute, dx and dw of every site
    tokens = B * TRAIN_S
    K4.reset_launches()  # the main path's run starts here
    steps = []
    for i in range(FAMILY_STEPS):
        before = K4.LAUNCHES["fp8_gemm"]
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"phase": "family_train_step", "model": cfg.name, "step": i, "loss": loss,
               "aux_loss": float(m["aux_loss"]), "ms": dt * 1e3, "tokens_per_s": tokens / dt, "lr": float(m["lr"]),
               "grad_norm": float(m["grad_norm"]), "k4_launches": K4.LAUNCHES["fp8_gemm"] - before}
        emit(rec)
        steps.append(rec)
        if not np.isfinite(loss) or rec["k4_launches"] != per_step:
            fail(f"{cfg.name} train step {i}: loss {loss}, {rec['k4_launches']} K4 launches (expected {per_step})")
    k4_launches = K4.LAUNCHES["fp8_gemm"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.mean([r["ms"] for r in steps[1:]]))

    batch = batches[FAMILY_STEPS]
    train_path_phase(cfg, state, batch, lambda gemm: train_run_config(gemm, cfg.name, B), k_tail_control,
                     FAMILY_PATH_LIMITS.get(cfg.name, PATH_LIMITS))
    evaluation = eval_phase(cfg, state.params, batch)
    bound_ms, bound_by, tflop = forward_bound(cfg, state.params, B, TRAIN_S)

    def one_step():  # where a step's time goes: one more kernel step under torch.profiler
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])

    by_name, launches, prof_wall_ms, _ = profiled(one_step, cpu=False)
    busy = sum(by_name.values())
    k4_ms = sum(v for k, v in by_name.items() if "fp8_gemm_kernel" in k)
    profile = {"wall_ms_under_profiler": prof_wall_ms, "device_busy_ms": busy if by_name else None,
               "idle_share": 1.0 - busy / step_ms if by_name else None, "device_launches": int(launches),
               "fp8_gemm_ms": k4_ms, "ms_by_kind": ms_by_kind(by_name),
               "top_kernels_ms": [[n[:120], ms] for n, ms in
                                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]}
    out = {
        "phase": "family_train", "model": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
        "params": sum(t.numel() for t in tree_leaves(state.params)), "tokens_per_step": tokens, "init_s": init_s,
        "steps": FAMILY_STEPS, "losses": [s["loss"] for s in steps], "aux_losses": [s["aux_loss"] for s in steps],
        "step_ms_mean_steps_1_2": step_ms, "tokens_per_s": tokens / step_ms * 1e3, "peak_mem_gb": peak_gb,
        "k4_launches": k4_launches, "k4_per_step": per_step, "profile": profile,
        "eval": {"k3_launches": evaluation["k3_launches"], "loss": evaluation["loss"],
                 "warm_wall_s": evaluation["warm_wall_s"], "flash_vs_torch": evaluation["flash_vs_torch"],
                 "control_vs_torch": evaluation["control_vs_torch"], "limits": evaluation["limits"],
                 "forward_tflop": tflop, "bound_ms": bound_ms, "bound_by": bound_by},
    }
    emit(out)
    del state, batches, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 9g-9h: Fig. 11 (CloverLeaf) and the last figure scripts
# ---------------------------------------------------------------------------

CLOVER_SIZES = (256, 512, 1024)  # the reference's
CLOVER_LARGE = 16384  # 1 GiB a grid: past the 50 MB L2 cache


def cloverleaf_phase(device) -> dict:
    """Fig. 11's ``run()`` at the reference's sizes and at one past the L2
    cache (its float64 check inside), and a control: the step with the rows
    edge-padded, which the float64 check must reject."""
    from repro_torch.benchmarks import cloverleaf

    rows = cloverleaf.run(sizes=CLOVER_SIZES + (CLOVER_LARGE,), iters=10, device=device)
    for r in rows:
        emit({"phase": "cloverleaf", **r})
    g = torch.Generator(device=device).manual_seed(SEED)
    u = torch.randn((1024, 1024), generator=g, device=device)
    rows_edge = torch.cat([u[:1], u, u[-1:]], dim=0)
    wrong = cloverleaf.stencil(torch.cat([rows_edge[:, :1], rows_edge, rows_edge[:, -1:]], dim=1))
    control = cloverleaf.check_step(u, wrong)
    large = next(r for r in rows if r["name"] == f"cloverleaf_{CLOVER_LARGE}x{CLOVER_LARGE}")
    out = {"phase": "cloverleaf", "sizes": list(CLOVER_SIZES) + [CLOVER_LARGE],
           "large_gbps": large["achieved_gbps"], "large_hbm_fraction": large["hbm_fraction"],
           "control_rel_err": control, "limit": cloverleaf.CHECK_RTOL,
           "rows": {r["name"]: {k: r.get(k) for k in ("us_per_call", "bound_us", "achieved_gbps",
                                                     "max_rel_err_vs_float64")} for r in rows}}
    emit(out)
    if control <= cloverleaf.CHECK_RTOL:
        fail(f"cloverleaf: the row-edge control passes the float64 check, which then proves nothing: {out}")
    del u, rows_edge, wrong
    torch.cuda.empty_cache()
    return out


CLOVER_RANKS = (2, 4)


def cloverleaf_ranks_phase(device) -> dict:
    """Fig. 11 over ranks: ``cloverleaf.run(ranks=(2, 4))`` at the reference's
    sizes on 2 and 4 gloo ranks of the one card, one spawn (the halo rows staged
    through host memory): each rank's first step bit for bit against its
    rows of the one-device step on the whole grid, and the control (each
    rank wrapping its own rows) different from it; the slowest rank's time
    a step beside every rank's."""
    from repro_torch.benchmarks import cloverleaf

    out = {"phase": "cloverleaf_ranks", "backend": "gloo", "rows": {}}
    try:
        rows = cloverleaf.run(sizes=CLOVER_SIZES, iters=10, device=device, ranks=CLOVER_RANKS)  # one world of 4
    except (AssertionError, RuntimeError, TimeoutError) as e:
        fail(f"cloverleaf_ranks: {e}")
    for r in rows:
        if "ranks" in r:
            emit({"phase": "cloverleaf_ranks", **r})
            out["rows"][r["name"]] = {k: r[k] for k in ("us_per_call", "rank_us", "achieved_gbps", "bound_us",
                                                        "halo_bytes_per_step", "bit_exact", "control_bit_exact")}
    emit(out)
    if len(out["rows"]) != len(CLOVER_SIZES) * len(CLOVER_RANKS) or not all(r["bit_exact"] for r in out["rows"].values()):
        fail(f"cloverleaf_ranks: a size is missing or not bit-exact: {out['rows']}")
    return out


def figures_phase(device) -> dict:
    """The §1 FP8 GEMM sweep and the §IV.F paged-attention sweep at their
    default sizes: each K4 and K1 row passes its check against the plain
    version, whose control fails (``run`` raises otherwise)."""
    from repro_torch.benchmarks import fp8_gemm, paged_attention

    out = {"phase": "figures", "rows": {}}
    for mod in (fp8_gemm, paged_attention):
        for r in mod.run(device=device):
            emit({"phase": "figures", **r})
            out["rows"][r["name"]] = {k: r.get(k) for k in ("us_per_call", "bound_us", "max_abs_err", "control_err")}
    kernel_rows = [n for n in out["rows"] if n.endswith("_kernel") or "_kernel_" in n]
    if len(kernel_rows) != len(fp8_gemm.SIZES) + len(paged_attention.CASES):
        fail(f"figures: expected a checked kernel row per size and case: {kernel_rows}")
    emit({"phase": "figures", "kernel_rows": len(kernel_rows)})
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: K6 (BabelStream) and K5 (RWKV6 WKV scan) against their plain versions
# ---------------------------------------------------------------------------

STREAM_N = 2**27  # elements: 512 MiB per fp32 array, the paper's BabelStream size
STREAM_KERNELS = ("copy", "mul", "add", "triad", "dot")
# dot on non-negative inputs against its plain version, relative to the
# exact-sign sum sum |a b| (then the sum itself): fp32 sums of 2^27 terms in
# another order stay near 1e-7 of it, and the control, the sum without its
# last tile's partial, is 1/2048 = 4.9e-4 short.  The limit lies between.
DOT_RTOL = 1e-5


def stream_inputs(n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((n,), generator=g, device=device).to(dtype) for _ in range(3)]


def stream_phase(device, n=STREAM_N) -> dict:
    """Each K6 kernel in fp32 and bf16 against its plain version (bit-equal
    but dot), timed beside its PyTorch call; returns the fp32 rows."""
    from repro_torch.kernels import babelstream as K6
    from repro_torch.kernels import babelstream_ref as ref

    rows = {}
    for seed, dt in enumerate((torch.float32, torch.bfloat16)):
        a, b, c = stream_inputs(n, dt, device, 300 + seed)
        aa, ba = a.abs(), b.abs()  # dot: a dropped tile shows against a sum of non-negative terms
        s = ref.round_scalar(0.4, dt)
        dst = torch.empty_like(a)
        calls = {
            "copy": (lambda: K6.stream_copy(a), lambda: ref.copy_ref(a), lambda: dst.copy_(a)),
            "mul": (lambda: K6.stream_mul(c), lambda: ref.mul_ref(c), lambda: torch.mul(c, s)),
            "add": (lambda: K6.stream_add(a, b), lambda: ref.add_ref(a, b), lambda: torch.add(a, b)),
            # one PyTorch call for b + s c: it rounds once in bf16 too, so only its time compares
            "triad": (lambda: K6.stream_triad(b, c), lambda: ref.triad_ref(b, c), lambda: torch.add(b, c, alpha=s)),
            "dot": (lambda: K6.stream_dot(aa, ba), lambda: ref.dot_ref(aa, ba),
                    (lambda: torch.dot(aa, ba)) if dt == torch.float32 else None),
        }
        for name in STREAM_KERNELS:
            kernel, plain, lib = calls[name]
            out, want = kernel(), plain()
            control = None
            if name == "dot":
                err = float((out - want).abs())
                tol = DOT_RTOL * float(want)
                partials = K6.dot_partials(aa, ba)
                control = abs(float(partials[:-1].sum()) - float(want))  # the last tile dropped
                ok, control_ok = err <= tol, control <= tol
            else:
                err = float((out.float() - want.float()).abs().max())
                tol = 0.0
                ok = torch.equal(out, want)
                if name == "triad" and dt == torch.bfloat16:  # the scalar left unrounded
                    unrounded = K6.launch_map("triad", b, c, 0.4)
                    control = int((unrounded != want).sum())
                    control_ok = control == 0
                    del unrounded
            torch.cuda.synchronize()
            flops = {"copy": 0, "mul": n, "add": n, "triad": 2 * n, "dot": 2 * n}[name]
            nbytes = K6.stream_bytes(name, n, a.element_size()) + (4 * (n // K6.DEFAULT_BLOCK) if name == "dot" else 0)
            bound_ms, bound_by = bound(nbytes, flops, FP32_FLOPS_PER_S)
            times = kernel_times(lambda i: kernel())
            kernel_ms = times["kernel_ms"]
            row = {
                "phase": "kernel", "kernel": f"stream_{name}", "n": n, "dtype": str(dt).replace("torch.", ""),
                "bit_equal": None if name == "dot" else ok, "max_abs_err": err, "tol": tol, "control": control,
                **times, "plain_ms": timed_ms(lambda i: plain(), iters=5, warmup=1),
                "library_ms": timed_ms(lambda i: lib()) if lib else None,
                "bound_ms": bound_ms, "bound_by": bound_by, "gbps": nbytes / 1e6 / kernel_ms,
            }
            emit(row)
            del out, want
            if not ok:
                fail(f"stream_{name} {row['dtype']}: error {err} beyond {tol}")
            if control is not None and control_ok:
                fail(f"stream_{name} {row['dtype']}: the control passes the check ({control}), which then proves nothing")
            if dt == torch.float32:
                rows[f"stream_{name}"] = row
        del a, b, c, aa, ba, dst
        torch.cuda.empty_cache()
    return rows


def babelstream_phase(device, n=STREAM_N) -> dict:
    """The Fig. 10 entry point on the card: fp32 (the counted run), then bf16."""
    from repro_torch.benchmarks import babelstream as bench
    from repro_torch.kernels import babelstream as K6

    K6.reset_launches()  # the main path's run starts here
    rows = bench.run(n=n, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    launches = dict(K6.LAUNCHES)
    rows += bench.run(n=n, dtype=torch.bfloat16, device=device)
    for r in rows:
        emit({"phase": "babelstream", **r})
    out = {"phase": "babelstream_launches", "launches": launches}
    emit(out)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"BabelStream's run did not launch {missing}: {launches}")
    torch.cuda.empty_cache()
    return launches


# K5 cases: name, (B, S, H, n), chunk, logw (None: -exp(N(0,1) - 1)).  The
# first is rwkv6-7b's eval shape (4 x 2048 tokens, 64 heads of 64).
WKV_CASES = [
    ("rwkv6-7b", (4, 2048, 64, 64), 64, None),
    ("small", (2, 128, 3, 16), 16, None),
    ("fast-decay", (1, 256, 4, 64), 64, -8.0),
]
# K5 against the plain version and the sequential oracle: all three in fp32,
# the sums in other orders.  Relative to the largest |output|; the control
# (the decay applied one step late in the inter-chunk term) moves whole
# outputs.  The limit lies between the readings (PERF.md).
WKV_RTOL = 1e-4


def wkv_late_decay(r, k, v, logw, u, *, chunk=64):
    """A control: the plain version on (BH, S, n) with r decayed by exp(la)
    in place of exp(la_prev) in the inter-chunk term, the decay applied one
    step late: each chunk's output gains r (exp(la) - exp(la_prev)) @ S0."""
    from repro_torch.kernels.rwkv6_scan_ref import wkv_chunk

    BH, S, n = r.shape
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, S, chunk):
        rr, kk, vv, lw = (x[:, c0 : c0 + chunk].float() for x in (r, k, v, logw))
        out, next_state = wkv_chunk(state, rr, kk, vv, lw, u.float()[:, None, :])
        la = torch.cumsum(lw, dim=1)
        outs.append(out + (rr * (torch.exp(la) - torch.exp(la - lw))) @ state)
        state = next_state
    return torch.cat(outs, dim=1)


def on_model_layout(scan):
    """A scan on (BH, S, n) as a ``wkv_impl``: (B, S, H, n) operands, u (H, n)."""

    def model_scan(r, k, v, logw, u, *, chunk):
        B, S, H, n = r.shape
        to_bh = lambda x: x.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
        out = scan(*(to_bh(x) for x in (r, k, v, logw)), u.expand(B, H, n).reshape(B * H, n), chunk=chunk)
        return out.reshape(B, H, S, n).transpose(1, 2)

    return model_scan


def wkv_work(BH, S, n) -> tuple[int, int, int]:
    """(bytes, fp32 operations, exponentials) that the scan needs in any
    formulation: r, k, v, logw and u read and the output written once; per
    token and head, r read against the state (n^2 multiply-adds) and the
    token's outer product added into it (n^2 multiply-adds, the decay
    folded over a chunk): 4 n^2 operations; one exponential per channel
    (the decay).  K5's chunked form does more: its pairwise scores take
    about L / 2 exponentials per token and channel at chunk L."""
    return 5 * BH * S * n * 4 + BH * n * 4, BH * S * 4 * n * n, BH * S * n


def wkv_bound(BH, S, n) -> tuple[float, str]:
    nbytes, flops, exps = wkv_work(BH, S, n)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, max(flops / FP32_FLOPS_PER_S, exps / EXP_PER_S)
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def wkv_phase(device, cases=WKV_CASES) -> dict:
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain, wkv6_ref

    main = None
    for seed, (name, (B, S, H, n), chunk, logw) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(400 + seed)
        r, k, v = (0.5 * torch.randn((B, S, H, n), generator=g, device=device) for _ in range(3))
        lw = (-torch.exp(torch.randn((B, S, H, n), generator=g, device=device) - 1.0) if logw is None
              else torch.full((B, S, H, n), logw, device=device))
        u = 0.3 * torch.randn((H, n), generator=g, device=device)
        to_bh = lambda x: x.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
        bh = [to_bh(x) for x in (r, k, v, lw)]
        ub = u.expand(B, H, n).reshape(B * H, n)
        with torch.no_grad():
            out = K5.wkv6(r, k, v, lw, u, chunk=chunk)  # the model's layout, strided
            out_bh = to_bh(out)
            plain = wkv6_chunked_plain(*bh, ub, chunk=chunk)
            oracle = wkv6_ref(*bh, ub)
            control = wkv_late_decay(*bh, ub, chunk=chunk)
            layout_equal = torch.equal(K5.wkv6_chunked(*bh, ub, chunk=chunk), out_bh)
            v1 = to_bh(K5.wkv6_cuda_cores(r, k, v, lw, u, chunk=chunk))  # the yardstick
        scale = float(plain.abs().max())
        rel = lambda x, y: float((x - y).abs().max()) / scale  # noqa: E731
        mean_rel = lambda x, y: float((x - y).abs().mean() / plain.abs().mean())  # noqa: E731
        readings = {"vs_plain": rel(out_bh, plain), "vs_oracle": rel(out_bh, oracle),
                    "mean_vs_plain": mean_rel(out_bh, plain), "mean_vs_oracle": mean_rel(out_bh, oracle),
                    "control_vs_plain": rel(control, plain), "control_vs_oracle": rel(control, oracle),
                    "cuda_cores_vs_plain": rel(v1, plain)}
        finite = bool(torch.isfinite(out).all())
        del out, out_bh, plain, oracle, control, v1
        bound_ms, bound_by = wkv_bound(B * H, S, n)
        row = {
            "phase": "kernel", "kernel": "rwkv6_scan", "case": name, "shape_bshn": [B, S, H, n], "chunk": chunk,
            "max_abs_err": readings["vs_plain"] * scale, "max_abs_out": scale, "readings": readings, "tol": WKV_RTOL,
            "finite": finite, "model_layout_equal": layout_equal,
            **kernel_times(lambda i: K5.wkv6(r, k, v, lw, u, chunk=chunk), iters=10, warmup=2),
            "cuda_cores_ms": timed_ms(lambda i: K5.wkv6_cuda_cores(r, k, v, lw, u, chunk=chunk), iters=5, warmup=1),
            "plain_ms": timed_ms(lambda i: wkv6_chunked_plain(*bh, ub, chunk=chunk), iters=3, warmup=1),
            "library_ms": None,  # no single PyTorch call computes the scan
            "bound_ms": bound_ms, "bound_by": bound_by, "work": dict(zip(("bytes", "flops", "exps"), wkv_work(B * H, S, n))),
        }
        emit(row)
        if not finite or readings["vs_plain"] > WKV_RTOL or readings["vs_oracle"] > WKV_RTOL or not layout_equal:
            fail(f"rwkv6_scan {name}: {readings} beyond {WKV_RTOL}, finite {finite}, layouts equal {layout_equal}")
        if readings["cuda_cores_vs_plain"] > WKV_RTOL:
            fail(f"rwkv6_scan_cuda_cores {name}: {readings} beyond {WKV_RTOL}")
        if readings["control_vs_plain"] <= WKV_RTOL or readings["control_vs_oracle"] <= WKV_RTOL:
            fail(f"rwkv6_scan {name}: the late-decay control passes the check ({readings}), which then proves nothing")
        main = main or row
        del r, k, v, lw, u, bh, ub
        torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# phase 12: rwkv6-7b eval at full width and depth
# ---------------------------------------------------------------------------

# K5 against the chunked scan at full width.  The random-init rwkv6-7b is
# chaotic over 32 layers: noise of 1e-6 of every WKV output moves the
# logits by more than the late-decay control does (PERF.md), so the whole
# forward's loss and logits are reported, not held to a limit.  The check
# is per layer: each block gets the chunked forward's input and runs once
# with K5 and once with the chunked scan.  The readings are the largest
# over the layers of mean |difference| / mean |block increment| and of
# max |difference| / max |block increment|.  In bf16 compute (the eval's
# own) the two differ where a WKV output lands on the other side of a bf16
# rounding boundary; in fp32 compute only the scans' summation orders
# differ.  The control is the scan with the decay one step late.  Each
# limit lies between the readings of the sound run and of the control on
# the H100 (PERF.md).
RWKV_LAYER_LIMITS = {
    torch.bfloat16: {"layer_mean_rel": 1e-3, "layer_max_rel": 3.5e-2},
    torch.float32: {"layer_mean_rel": 1e-4, "layer_max_rel": 1e-3},
}
WKV_NOISE = 1e-6  # the chaos probe: relative noise on every plain WKV output


def layer_readings(cfg, params, tokens, control, dtype, mesh=None) -> dict:
    """Per layer, on the chunked forward's own input in ``dtype``: K5 and
    the control scan against the chunked scan (see RWKV_LAYER_LIMITS).
    ``mesh``: a tensor-parallel mesh whose slices ``params`` holds (the
    blocks' channel mixes then sum over it)."""
    from repro_torch.models import embed_input
    from repro_torch.models.blocks import rwkv_block

    limits = RWKV_LAYER_LIMITS[dtype]
    worst = {"sound": dict.fromkeys(limits, 0.0), "control": dict.fromkeys(limits, 0.0)}
    x = embed_input(cfg, params, tokens, None, mesh).to(dtype)
    for p in params["blocks"]:
        ref = rwkv_block(cfg, p, x, wkv_impl="chunked", mesh=mesh)
        inc = (ref.float() - x.float()).abs()
        for name, impl in (("sound", "kernel"), ("control", control)):
            d = (rwkv_block(cfg, p, x, wkv_impl=impl, mesh=mesh).float() - ref.float()).abs()
            w = worst[name]
            w["layer_mean_rel"] = max(w["layer_mean_rel"], float(d.mean() / inc.mean()))
            w["layer_max_rel"] = max(w["layer_max_rel"], float(d.max() / inc.max()))
        x = ref
    return worst


def rwkv_eval_phase(cfg, params, device, batch_size=TRAIN_B, seq=TRAIN_S) -> dict:
    """``params``: the full-width model (``init_params`` from the seed, in
    its own phase), which the rwkv serving phase then serves."""
    from repro_torch.data import make_batch_fn
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain
    from repro_torch.models import forward
    from repro_torch.train import loss_fn
    from repro_torch.utils.tree import tree_leaves

    batch = make_batch_fn(cfg, global_batch=batch_size, seq_len=seq, seed=SEED, device=device)(0)

    def evaluate(impl):
        K5.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(loss_fn(cfg, params, batch, wkv_impl=impl, compute_dtype=torch.bfloat16)[0])
        dt = time.perf_counter() - t0
        launches = K5.LAUNCHES["rwkv6_scan"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        logits = forward(cfg, params, batch, wkv_impl=impl, compute_dtype=torch.bfloat16)[0]
        return {"loss": loss, "wall_s": dt, "k5_launches": launches, "peak_mem_gb": peak, "logits": logits}

    def whole(r):
        return {"loss_diff": abs(r["loss"] - ref["loss"]),
                "max_logits_diff": float((r["logits"] - ref["logits"]).abs().max())}

    with torch.no_grad():
        evaluate("kernel")  # warm-up: library handles, the allocator
        ref = evaluate("chunked")
        kern = evaluate("kernel")
        finite = bool(torch.isfinite(kern["logits"]).all())
        g = torch.Generator(device=device).manual_seed(SEED)

        def noisy(*args, chunk):
            out = wkv6_chunked_plain(*args, chunk=chunk)
            return out * (1 + WKV_NOISE * torch.randn(out.shape, generator=g, device=out.device))

        noise = evaluate(on_model_layout(noisy))
        control = on_model_layout(wkv_late_decay)
        layers = {str(dt).removeprefix("torch."): layer_readings(cfg, params, batch["tokens"], control, dt)
                  for dt in RWKV_LAYER_LIMITS}
        by_name, launches, prof_wall_ms, _ = profiled(lambda: float(loss_fn(cfg, params, batch, wkv_impl="kernel",
                                                                          compute_dtype=torch.bfloat16)[0]))
        busy = sum(by_name.values())
        profile_out = {
            "wall_ms": kern["wall_s"] * 1e3, "wall_ms_under_profiler": prof_wall_ms,
            "device_busy_ms": busy if by_name else None,
            "idle_share": 1.0 - busy / (kern["wall_s"] * 1e3) if by_name else None, "device_launches": int(launches),
            "rwkv6_scan_ms": sum(v for k, v in by_name.items() if "wkv6_kernel" in k),
            "top_kernels_ms": [[name[:90], ms] for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        }
        out = {"phase": "rwkv_eval", "model": cfg.name, "params": sum(t.numel() for t in tree_leaves(params)),
               "tokens": batch_size * seq,
               "loss": {"chunked": ref["loss"], "kernel": kern["loss"]},
               "wall_s": {"chunked": ref["wall_s"], "kernel": kern["wall_s"]},
               "peak_mem_gb": {"chunked": ref["peak_mem_gb"], "kernel": kern["peak_mem_gb"]},
               "k5_launches": kern["k5_launches"], "k5_launches_chunked": ref["k5_launches"],
               "logits_std": float(ref["logits"].std()), "logits_shape": list(kern["logits"].shape),
               "whole_kernel_vs_chunked": whole(kern), "whole_noise_vs_chunked": whole(noise), "wkv_noise": WKV_NOISE,
               "layers_kernel_vs_chunked": {dt: r["sound"] for dt, r in layers.items()},
               "layers_control_vs_chunked": {dt: r["control"] for dt, r in layers.items()},
               "limits": {str(dt).removeprefix("torch."): lim for dt, lim in RWKV_LAYER_LIMITS.items()},
               "profile_kernel_eval": profile_out}
        del ref, kern, noise
    emit(out)
    if out["k5_launches"] != cfg.num_layers or out["k5_launches_chunked"] != 0:
        fail(f"rwkv eval launched K5 {out['k5_launches']} times (expected {cfg.num_layers})")
    if out["logits_shape"] != [batch_size, seq, cfg.padded_vocab]:
        fail(f"rwkv eval logits of shape {out['logits_shape']}")
    for dt, limits in out["limits"].items():
        if not finite or not np.isfinite(out["loss"]["kernel"]) or not within(out["layers_kernel_vs_chunked"][dt], limits):
            fail(f"the K5 and chunked rwkv blocks disagree in {dt}: {out}")
        if within(out["layers_control_vs_chunked"][dt], limits):
            fail(f"the control passes the rwkv eval's {dt} limits, which then prove nothing: {out}")
    del batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    # imported before any output: a copy without the package prints nothing
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.train import make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    idle_w = []  # board power before this run puts work on the card (core.telemetry.CHIP_IDLE_W)
    for _ in range(10):
        idle_w.append(float(subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.split()[0]))
        time.sleep(0.2)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "idle_power_w": idle_w,
          "idle_power_median_w": float(np.median(idle_w))})

    device = resolve_device("cuda")  # also pins fp32 matmuls to full precision
    sources = ["paged_attention.cu", "fp8_gemm.cu", "flash_attention.cu", "babelstream.cu", "rwkv6_scan.cu"]

    def timed_build(src):
        t0 = time.perf_counter()
        lib, log = build.build(src, verbose=True)
        return src, time.perf_counter() - t0, lib, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all started together
        builds = pool.map(timed_build, sources)
        cells = dryrun_cells()  # host work on the meta device meanwhile
        seconds = {"dryrun_cells": time.perf_counter() - t0}
        built = list(builds)
    for src, secs, lib, log in built:
        emit({"phase": "build", "source": src, "seconds": secs, "library": os.path.relpath(lib, ROOT),
              "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln]})
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})
    # K4, K3's bf16 route and K2's bf16-pool route run on the tensor cores:
    # each of K4's four kernels (one per type pair), K3's four bf16 kernels
    # (one per padded head dim) and K2's eight (q dtype x padded head dim)
    # holds HGMMA
    libs = {src: lib for src, _, lib, _ in built}
    hgmma = hgmma_counts(libs["fp8_gemm.cu"])
    emit({"phase": "sass", "source": "fp8_gemm.cu", "hgmma_per_kernel": hgmma})
    if len(hgmma) != 4 or min(hgmma.values()) == 0:
        fail(f"fp8_gemm.cu: K4 needs four kernels that each hold HGMMA: {hgmma}")
    hgmma_k3 = hgmma_counts(libs["flash_attention.cu"])
    emit({"phase": "sass", "source": "flash_attention.cu", "hgmma_per_kernel": hgmma_k3})
    k3_tc = [n for n in hgmma_k3 if n.startswith("tensor_cores_bf16")]
    if len(k3_tc) != 4 or min(hgmma_k3[n] for n in k3_tc) == 0:
        fail(f"flash_attention.cu: K3's bf16 route needs four kernels that each hold HGMMA: {hgmma_k3}")
    # K2's tensor-core route: one kernel per q dtype and padded head dim
    hgmma_k2 = hgmma_counts(libs["paged_attention.cu"])
    emit({"phase": "sass", "source": "paged_attention.cu", "hgmma_per_kernel": hgmma_k2})
    k2_tc = [n for n in hgmma_k2 if n.startswith("prefill_tensor_cores")]
    if len(k2_tc) != 8 or min(hgmma_k2[n] for n in k2_tc) == 0:
        fail(f"paged_attention.cu: K2's tensor-core route needs eight kernels that each hold HGMMA: {hgmma_k2}")

    # K5's chunk kernel takes its products on the tensor cores with mma.sync:
    # each of its nine (head size x chunk) holds HMMA
    hmma_k5 = hgmma_counts(libs["rwkv6_scan.cu"], "HMMA")
    emit({"phase": "sass", "source": "rwkv6_scan.cu", "hmma_per_kernel": hmma_k5})
    k5_tc = [n for n in hmma_k5 if n.startswith("wkv6_chunk,")]
    if len(k5_tc) != 9 or min(hmma_k5[n] for n in k5_tc) == 0:
        fail(f"rwkv6_scan.cu: K5 needs nine chunk kernels that each hold HMMA: {hmma_k5}")

    seconds["build"] = time.perf_counter() - t0  # the dry run's cells inside it

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    main_rows, k1_hymba = phase("kernel_k1_k2", kernel_phase, device)
    tools_dir = tempfile.mkdtemp(prefix="repro_torch_autotune_")  # the tuned table's user cache
    sweep = phase("tools_sweep", tools_sweep_phase, device, tools_dir)
    flash_main, flash_rows = phase("kernel_k3", flash_phase, device)
    gemm_rows = phase("kernel_k4", gemm_phase, device)
    stream_rows = phase("kernel_k6", stream_phase, device)
    wkv_main = phase("kernel_k5", wkv_phase, device)
    stream_launches = phase("babelstream", babelstream_phase, device)
    phase("cloverleaf", cloverleaf_phase, device)
    phase("cloverleaf_ranks", cloverleaf_ranks_phase, device)
    phase("figures", figures_phase, device)

    cfg = get_config("olmo-1b")  # full width and depth
    params = phase("init", init_params, cfg, SEED, device)
    emit({"phase": "init", "model": cfg.name, "seconds": seconds["init"]})
    serving, legacy_tokens = phase("serving", serving_phase, cfg, params, device)
    phase("path", path_phase, cfg, params, device)
    phase("profile", profile_phase, cfg, params, device)
    phase("serving_fused", serving_fused_phase, cfg, params, device, legacy_tokens)
    phase("tools_serving", tools_serving_phase, cfg, params, device, legacy_tokens, sweep)
    shutil.rmtree(tools_dir)
    phase("profile_fused", profile_fused_phase, cfg, params, device)
    spec = phase("serving_spec", serving_spec_phase, cfg, params, device, legacy_tokens)
    phase("spec_rollback", spec_rollback_phase, cfg, params, device)
    phase("kv_quant_read", kv_quant_read_phase, device)
    quantized = phase("serving_quantized", serving_quantized_phase, cfg, params, device, legacy_tokens,
                      serving["pool_bytes"])
    tiered = phase("serving_tiered", serving_tiered_phase, cfg, params, device)
    phase("spill_restore", spill_restore_phase, cfg, device)
    fig9 = phase("fig9", fig9_phase, cfg, params, device)
    frontend = phase("frontend", frontend_phase, cfg, params, device, legacy_tokens)
    router = phase("router", router_phase, cfg, params, device, legacy_tokens)
    tp = phase("tp_serving", tp_serving_phase, cfg, params, device, legacy_tokens, serving)
    replicas = phase("replicas_tp", replicas_tp_phase, cfg, params, device, router)
    del params  # the serving model's memory goes back before the moe model
    torch.cuda.empty_cache()

    moe_cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS)  # full width, depth cut
    phase("moe_path", moe_path_phase, moe_cfg, device)  # before the model: its float64 layer is 19.3 GB
    moe_params = phase("moe_init", init_params, moe_cfg, SEED, device)
    moe = phase("moe_serving", moe_serving_phase, moe_cfg, moe_params, device)
    phase("profile_moe", profile_moe_phase, moe_cfg, moe_params, device)
    del moe_params  # the moe model's memory goes back before hymba
    torch.cuda.empty_cache()

    hymba_cfg = get_config(HYMBA_ARCH)  # full width and depth: 1.59 B parameters, 6.35 GB of fp32
    hymba_params = phase("hymba_init", init_params, hymba_cfg, SEED, device)
    hybrid_path = phase("hybrid_path", hybrid_path_phase, hymba_cfg, hymba_params, device)
    hybrid = phase("hybrid_serving", hybrid_serving_phase, hymba_cfg, hymba_params, device)
    del hymba_params  # hymba's memory goes back before llama-3.2-vision
    torch.cuda.empty_cache()

    vlm_cfg = get_config(VLM_ARCH).replace(num_layers=VLM_LAYERS)  # full width, depth cut to 2 of 20 groups
    vlm_params = phase("vlm_init", init_params, vlm_cfg, SEED, device)
    open_gates(vlm_params)
    phase("vlm_path", vlm_path_phase, vlm_cfg, vlm_params, device)
    vlm_serving = phase("vlm_serving", vlm_serving_phase, vlm_cfg, vlm_params, device)
    vlm_eval = phase("vlm_eval", vlm_eval_phase, vlm_cfg, vlm_params, device)
    del vlm_params  # its memory goes back before training
    torch.cuda.empty_cache()

    state, batch, train = phase("train", train_phase, cfg, device)
    phase("train_path", train_path_phase, cfg, state, batch, train_run_config, scale_control, PATH_LIMITS)
    # the gate leaves the state as it was: one kernel step on its batch brings the eval and the
    # profile to the state their limits and readings were taken at (5 steps)
    torch.cuda.synchronize()
    step_mem = {"before": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()  # the tools phase's dry run holds its estimate to this step's peak
    state = phase("train_step_5", lambda: make_train_step(cfg, train_run_config())(state, batch)[0])
    step_mem["max_allocated"] = torch.cuda.max_memory_allocated()
    phase("tools_dryrun", tools_dryrun_phase, cfg, train, state, batch, step_mem, cells)
    evaluation = phase("eval", eval_phase, cfg, state.params, batch)
    phase("train_profile", train_profile_phase, cfg, state, batch)
    del state, batch  # the olmo-1b training state's memory goes back before the facility and rwkv6-7b
    torch.cuda.empty_cache()
    facility = phase("facility", facility_phase, cfg.replace(num_layers=FACILITY_LAYERS), device)
    torch.cuda.empty_cache()
    sharded = phase("sharded_train", sharded_train_phase)
    torch.cuda.empty_cache()
    phase("tools_dryrun_mesh", tools_dryrun_mesh_phase, sharded)
    sharded_families, sharded_ssm_vlm = phase("sharded_families", sharded_families_phase)
    torch.cuda.empty_cache()
    grouped = phase("grouped_heads", grouped_heads_phase)
    torch.cuda.empty_cache()
    phase("mlperf", mlperf_phase, device)
    torch.cuda.empty_cache()
    # the remaining training forwards, each alone on the card
    family = {}
    for name, arch in (("moe_train", MOE_ARCH), ("hybrid_train", HYMBA_ARCH), ("audio_train", "hubert-xlarge")):
        fcfg = get_config(arch)
        if FAMILY_TRAIN[arch][0]:
            fcfg = fcfg.replace(num_layers=FAMILY_TRAIN[arch][0])  # full width, depth cut
        family[arch] = phase(name, family_train_phase, fcfg, device)
        torch.cuda.empty_cache()

    rwkv_cfg = get_config("rwkv6-7b")  # full width and depth, 30.3 GB of fp32: one load serves both phases
    rwkv_params = phase("rwkv_init", init_params, rwkv_cfg, SEED, device)
    rwkv = phase("rwkv_eval", rwkv_eval_phase, rwkv_cfg, rwkv_params, device)
    rwkv_serving = phase("rwkv_serving", rwkv_serving_phase, rwkv_cfg, rwkv_params, device)
    del rwkv_params
    torch.cuda.empty_cache()
    emit({"phase": "seconds", **seconds})

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src + "paged_attention.cu",
            "replaces": {"paged_decode": "src/repro/kernels/paged_attention.py:149",
                         "paged_prefill": "src/repro/kernels/paged_attention.py:283"}[name],
            "launches": serving["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "enqueue_ms": row["kernel_enqueue_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    gemm_main = gemm_rows["fwd ffn_up/gate"]  # the step's largest forward shape
    stream_lines = {"copy": 60, "mul": 72, "add": 84, "triad": 96, "dot": 108}  # pallas_call sites
    for name, source, replaces, launches, row in (
        ("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:124", evaluation["k3_launches"], flash_main),
        ("fp8_gemm", "fp8_gemm.cu", "src/repro/fp8/gemm.py:91", train["k4_launches"], gemm_main),
        ("rwkv6_scan", "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:85", rwkv["k5_launches"], wkv_main),
        *((f"stream_{k}", "babelstream.cu", f"src/repro/kernels/babelstream.py:{line}", stream_launches[f"stream_{k}"],
           stream_rows[f"stream_{k}"]) for k, line in stream_lines.items()),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "enqueue_ms": row["kernel_enqueue_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for k in kernels:  # K4's time covers its layout copies; the parts beside it
        if k["name"] in ("paged_decode", "paged_prefill"):  # the kernel, v1 and the unsplit kernel beside it
            r = main_rows[k["name"]]
            k.update(kernel=r["route"], cuda_cores_ms=r["cuda_cores_ms"], split=r["split"], split1_ms=r["split1_ms"],
                     host_us=r["host_us"], cuda_cores_host_us=r["cuda_cores_host_us"])
        if k["name"] == "paged_prefill":  # the verify passes of each spec run, its own count
            k["spec_launches"] = spec["k2_launches"]
        if k["name"] in ("paged_decode", "paged_prefill"):  # this slice's runs: each KV-tier arm's own count
            which = "k1_launches" if k["name"] == "paged_decode" else "k2_launches"
            k["tier_launches"] = {arm: tiered[arm][which] for arm in ("spill", "drop", "uncached", "spill_budget_32",
                                                                      "spill_fused", "drop_fused")}
            k["fig9_launches"] = fig9["launches"][k["name"]]  # the Fig. 9 harness's closed-loop arms
            # the front-ends' runs: graph replays and the captures' eager warm-ups
            k["frontend_launches"] = {"replays": frontend["replay_launches"][k["name"]],
                                      "eager": frontend["eager_launches"][k["name"]]}
            k["router_launches"] = {run: {how: counts[how].get(k["name"], 0) for how in ("replays", "eager")}
                                    for run, counts in (("arms", router["launches"]),
                                                        ("http", router["http"]["launches"]))}
            k["moe_launches"] = {arm: {how: (counts[how] or {}).get(k["name"], 0) for how in ("eager", "replays")}
                                 for arm, counts in moe["launches"].items()}  # qwen3-moe's serving arms
            # hymba-1.5b's serving (paged, dense) and path runs, each its own count
            k["hymba_launches"] = {"paged": hybrid["paged"]["launches"][k["name"]],
                                   "dense": hybrid["dense"]["launches"][k["name"]],
                                   "path": hybrid_path["k1_launches"]["kernel"] if k["name"] == "paged_decode" else 0}
            k["rwkv_serving_launches"] = rwkv_serving["served"]["launches"][k["name"]]
            # tensor-parallel serving: each of the two gloo ranks' own launches, by model
            k["tp_launches"] = {arm: [counts[k["name"]] for counts in ranks] for arm, ranks in tp["launches"].items()}
            # replicas of TP=2 engines behind the router: each of the four ranks' own, the affinity arm
            k["tp_launches"]["replicas_tp"] = [counts[k["name"]] for counts in replicas["launches"]]
            # qwen3-moe under the grouped layout: each of the eight ranks' own (8 query heads over one kv head)
            k["tp_launches"]["grouped_heads"] = [r["launches"][k["name"]] for r in grouped["serving"]["tp"]]
            k["vlm_serving_launches"] = vlm_serving["served"]["launches"][k["name"]]  # the dense ring: none
            k["quantized_launches"] = {  # quantized pools read plain: none
                run: quantized[run]["eager_launches"][k["name"]] + (quantized[run]["replay_launches"] or {}).get(k["name"], 0)
                for run in ("int8_legacy", "int8_fused", "fp8_legacy", "fp8_fused")
            }
        if k["name"] in ("paged_decode", "paged_prefill"):  # the autotuner's sweep: each shape's candidates
            kind = "decode" if k["name"] == "paged_decode" else "prefill"
            k["autotune"] = {model: {"winner": r["winner"], "library": r["library"],
                                     "candidates_ms": {n: c["ms"] for n, c in r["candidates"][kind].items()}}
                             for model, r in sweep["rows"].items()}
        if k["name"] == "paged_decode":  # K1 at hymba-1.5b's heads (25 over 5, hd 64, window 1024)
            k["hymba"] = {dt: {f: r[f] for f in ("max_abs_err", "kernel_ms", "kernel_enqueue_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "split", "split1_ms", "cuda_cores_ms")}
                          for dt, r in k1_hymba.items()}
        if k["name"] == "rwkv6_scan":  # v1 beside the chunk-parallel kernels
            k["rwkv_serving_launches"] = rwkv_serving["served"]["launches"]["rwkv6_scan"]  # the chunked scan serves
            # the sharded eval of rwkv6-7b (4 layers, the time mix whole): each gloo rank's launches
            k["sharded_eval_launches"] = [r["k5_launches"] for r in sharded_ssm_vlm["ssm"]["1x2"]["eval"]]
            k.update(cuda_cores_ms=wkv_main["cuda_cores_ms"], mean_rel=wkv_main["readings"]["mean_vs_plain"])
        if k["name"] == "flash_attention":  # the bf16 route's kernel, v1 beside it
            k.update(kernel=flash_main["route"], cuda_cores_ms=flash_main["cuda_cores_ms"])
            # llama-3.2-vision's self layers (64 over 8 kv heads) and its eval's launches
            k["vlm"] = {f: flash_rows["llama-3.2-vision"][f] for f in (
                "shape", "max_abs_err", "kernel_ms", "kernel_enqueue_ms", "cuda_cores_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
            k["vlm_eval_launches"] = vlm_eval["k3_launches"]
            # the sharded eval of llama-3.2-vision (one self layer at 32 over 4 heads a rank): each gloo rank's
            k["vlm_sharded_eval_launches"] = [r["k3_launches"] for r in sharded_ssm_vlm["vlm"]["1x2"]["eval"]]
            k["vlm_serving_launches"] = vlm_serving["served"]["launches"]["flash_attention"]
            # qwen3-moe's sharded eval under the grouped layout (8 query heads over one kv head a rank)
            k["grouped_eval_launches"] = [e["k3_launches"] for e in grouped["train"][f"1x{GROUPED_TP}"]["eval"]]
            # the moe, hybrid and audio eval forwards: their heads and launches
            k["families"] = {arch: {"launches": family[arch]["eval"]["k3_launches"],
                                    **{f: flash_rows[arch][f] for f in (
                                        "shape", "window", "causal", "max_abs_err", "kernel_ms", "kernel_enqueue_ms",
                                        "plain_ms", "bound_ms", "bound_by", "padded_hd", "bound_padded_ms",
                                        "library_ms")}}
                             for arch in FAMILY_FLASH_CASES}
        if k["name"] in ("paged_decode", "paged_prefill"):  # the facility's serving tenant, each parameter set
            k["facility_launches"] = {run: facility["serving"][run]["launches"][k["name"]] for run in ("clean", "faulty")}
        if k["name"] == "fp8_gemm":
            k["facility_launches"] = facility["k4_launches"]  # the facility's runs and the async check's step
            k["family_launches"] = {arch: family[arch]["k4_launches"] for arch in family}  # 3 steps each
            # sharded training: each of the two gloo ranks' launches over 2 steps, by mesh, and the shrink's 2
            k["sharded_launches"] = {**{arm: sharded[arm]["k4_launches"] for arm in ("tp", "fsdp_dp")},
                                     "elastic": sharded["elastic"]["k4"]["fp8_gemm"]}
            # the moe, hybrid and audio families' sharded arms: each rank's launches over 3 steps, by mesh
            k["family_sharded_launches"] = {
                name: {key: arm[key]["k4_launches"] for key in arm if key in ("1x2", "2x1")}
                for name, arm in sharded_families.items() if isinstance(arm, dict) and "k4_per_step" in arm}
            k["family_sharded_launches"]["grouped_heads"] = grouped["train"][f"1x{GROUPED_TP}"]["k4_launches"]
            k["sharded_shapes"] = {n: {f: gemm_rows[n][f] for f in ("mkn", "dtypes", "max_abs_err", "kernel_ms",
                                                                   "kernel_alone_ms", "plain_ms", "bound_ms",
                                                                   "bound_by", "library_ms")}
                                   for n in SHARDED_GEMM_CASES}
            k["family_shapes"] = {n: {f: gemm_rows[n][f] for f in ("mkn", "dtypes", "max_abs_err", "kernel_ms",
                                                                  "kernel_alone_ms", "plain_ms", "bound_ms",
                                                                  "bound_by", "library_ms")}
                                  for n in FAMILY_GEMM_CASES}
            k.update(kernel_alone_ms=gemm_main["kernel_alone_ms"], layout_copy_ms=gemm_main["layout_copy_ms"],
                     layout_copies_per_call=gemm_main["layout_copies"],
                     layout_copies=train["k4_layout_copies"])
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
