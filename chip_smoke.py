#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (distribuuuu_tpu_torch) on one H100.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel of the ported paths from csrc/ (sm_90a),
   one nvcc per source, all at once (csrc/flash_attention.cu, the slowest,
   beside the phases up to ResNet-50's serving and training, which do not
   load it, and joined before the flash kernels), and prints from their
   ``-Xptxas -v``
   output (registers, spills, static shared memory, and any wgmma ptxas
   serialises) each kernel of csrc/conv_epilogue.cu,
   csrc/flash_attention.cu, csrc/group_conv.cu and csrc/decode_attn.cu,
   with their build seconds.
3. Kernel phases: each kernel's wrapper at the shapes its path gives it,
   held against its plain PyTorch version on the card, timed (CUDA
   events) beside its plain version and one library call, with its bound
   (bytes over 3.35 TB/s vs operations over the peak rate of their type):
   conv1x1_bn_act at the ResNet-50 serving shapes (batch 8, 224², bf16),
   at the eval shapes of the trainer (batches 200 and 48) and a small
   ragged f32 shape, each bf16 site with its tile plan, and each model
   and batch summed over one forward (``kernel_forward_total``: the
   kernel's, the plain version's, ``torch.matmul``'s and the bound's
   ms); opt_update over the 161 ResNet-50
   parameter leaves for its four bodies (SGD with an f32 or bf16 trace,
   SGD without momentum, AdamW); the flash-attention forward, dQ and
   dK/dV at the ViT-S/16 shapes [B·6, 196, 64] (train batch 32, serving
   batch 8, eval batch 200, bf16), the ViT-Ti/16 1024² shape
   [4·3, 4096, 64] (bf16, plain and causal), a ragged f32 shape and
   GPT-nano's causal training shape [16·4, 256, 32] (bf16, run zero-padded
   to head dim 64 as the autograd Function pads it; bound and SDPA at
   32), with
   ``F.scaled_dot_product_attention`` (forward; backward) as the library,
   each forward row with its ``fwd_plan``, each backward row with its
   ``bwd_plan``, and a ``flash_backward`` row a
   shape (the fp32 delta reduction, dQ and dK/dV, as the autograd
   Function runs them) against SDPA's whole backward;
   decode_attention at the GPT-nano decode tiles (4 and 32 slots × 256
   positions × 4 heads × 32, bf16), the TPU-side bench shape, a
   bandwidth probe at [8, 16, 4096, 128] (not a model) and a ragged f32
   tile, with SDPA over a length mask as the library, each row with the
   body and plan it ran, the first design's time (``simple_ms``) and the
   launch floors of an empty block and of an empty kernel over the plan's
   clusters.
Every serving bucket, LM decode and prompt tile, train step (one-step and
folded) and synchronous eval step below replays a CUDA graph captured at
its first call (``distribuuuu_tpu_torch/graphs.py``); the launch counts
count replays (a capture launches nothing). The one eager step on the
card is two ranks over gloo (``two_ranks_one_card``), and concurrent
eval's.

4. Serving slices, through ``engine_from_cfg`` on cuda:0 with buckets
   [1, 2, 4, 8] and two bursts of 64 seeded uint8 requests through
   ``submit`` (img/s and latency are the second burst's; the first is
   reported apart), weights from RNG_SEED:
   * ResNet-50 (config/resnet50.yaml, bf16): 33 conv-epilogue launches per
     forward (warm-ups included), logits against the port's f32 CPU run;
   * ViT-S/16 (config/vit_small.yaml, DEVICE.ATTN_IMPL flash, bf16): 12
     flash-forward launches per forward and no backward launch; the
     card's bf16 logits against the port's f32 CPU run, and the same
     weights in f32 on the card (the f32 flash kernel) against the CPU.
5. Training slices, ``trainer.train_model`` on MODEL.DUMMY_INPUT (bf16,
   RNG_SEED 0): one epoch of 64 steps at batch 32 and an eval of 2048
   images at batch 200, then MAX_EPOCH 2, which auto-resumes at epoch 2.
   Checks one opt_update launch per step, a finite loss that falls, and
   the resume point; reports train img/s over the warm steps, the mean
   step time and eval img/s.
   * ResNet-50 (config/resnet50.yaml): 33 conv-epilogue launches per eval
     forward;
   * ViT-S/16 (config/vit_small.yaml, DEVICE.ATTN_IMPL flash): 12 forward,
     12 dQ and 12 dK/dV flash launches per step, 12 forward launches per
     eval forward.
   Then one f32 step of ResNet-50 and one of ViT-S/16 (batch 4, TF32 off)
   on the card and on the port's CPU path (and an f64 step on the CPU as
   the yardstick of f32 rounding) from the same weights, whose updates
   must agree. Then ViT-Ti/16 at 1024² (4096 tokens) under
   DEVICE.ATTN_IMPL auto: one train step at batch 4, every block's
   attention routed to the flash kernels by length.
6. LM generation serving, ``lm.service.engine_from_cfg`` on cuda:0 with
   config/gpt_nano.yaml (bf16, RNG_SEED 0, GENERATE defaults, EOS -1): two
   bursts of 32 greedy requests (prompts of 8–64 tokens, 64 new tokens
   each), then the same at batch tiles up to 32; tokens/s, decode and
   prefill latency, 4 decode_attention launches per decode step (warm-up
   launches reported apart). Checks: f32 greedy streams on the card equal
   the port's CPU engine's; bf16 logits teacher-forced over the CPU's
   streams within SLICE_REL_TOL of the CPU's f32 scale; a sampled request
   replays; one request through the socket protocol. Then the LM plane
   (``lm_plane_phases``):
   * ``lm_pack``: a corpus of LM_CORPUS_MB of seeded word salad packed by
     ``pack_tokens --pack-len 256 --val-frac 0.05`` and verified;
   * ``lm_train``: config/gpt_nano.yaml trained one epoch on the pack
     (bf16, batch 16, AdamW, graphed) and evaluated, dense and under
     DEVICE.ATTN_IMPL flash: train sequences/s and tokens/s, step ms,
     eval tokens/s; one opt_update launch a step; the loss falls over the
     epoch; under flash 4 forward launches a step and an eval forward,
     4 dQ and 4 dK/dV a step (none dense); the two first losses within
     LM_FLASH_LOSS_RTOL; then a ``step_vs_cpu`` row, one f32 AdamW step
     card vs CPU (update L2 within STEP_UPDATE_L2_TOL);
   * ``lm_chunk_prefill``: GENERATE.CHUNK_PREFILL 64: f32 greedy streams
     (TF32 off) identical to the whole-prompt engine's, then 32 bf16
     prompts of 65–192 tokens: tokens/s, the admission (first-token) ms,
     no capture after warm-up, 4 decode_attention launches a step;
   * ``lm_length_classes``: SERVE.LONG_PROMPT_THRESHOLD 128 and
     LONG_MAX_QUEUE 4: long prompts past 4 refused with the class's
     error, short ones admitted, every admitted request completed;
   * ``lm_speculate``: K 4: at f32 a self-draft rejects nothing and a
     draft from RNG_SEED 1 (DRAFT_WEIGHTS) gives the target-only greedy
     streams; in bf16 tokens/s target-only, self-drafted and with the
     seed-1 draft, the acceptance, decode_attention launches a round.
7. RegNet (``DISTRIBUUUU_GROUP_CONV=pallas``): group_conv3x3 against its
   plain version at the stage-3 shapes of regnety_160 (batches 8, 64, 200),
   regnetx_160 and regnety_320 (batch 64), the dx shape (flipped weight),
   a stride-2 shape, a ResNeXt cg=16 shape and a ragged f32 shape, timed
   beside its plain version and ``F.conv2d(groups=G)`` (cuDNN, the
   library), each bf16 row with the wgmma body's tiling (``plan``) and
   its share of the bound; conv1x1_bn_act at regnety_160's and
   regnety_320's 1x1 shapes (batch 8) and regnety_160's at its eval batch
   200 (with the kernel phases of 3). Then regnety_160 (config/regnety_160.yaml, bf16) served
   through ``engine_from_cfg`` as ResNet-50 is (10 group-conv and 36
   conv-epilogue launches per forward; bf16 logits and f32 card logits
   against the port's f32 CPU forward) and trained through
   ``trainer.train_model`` at the yaml's batch 64 for one epoch (10
   forward and 10 dx launches per step, 10 per eval forward; the eval is
   4096 images at batch 200; no resume to epoch 2: ResNet-50 and ViT-S
   hold it); one f32 step card vs CPU at batch 4. Every block's zero-initialised last BN scale is first set to
   seeded N(1, 0.1) values (``MODEL.WEIGHTS``), or the residual branch,
   and with it the kernel, would not reach the logits at init; zeroing
   the grouped weights of the kernel's sites must move the logits.
8. The image zoo, under ``DISTRIBUUUU_GROUP_CONV=pallas`` still (with the
   kernel phases of 3: conv1x1_bn_act at every distinct site of
   efficientnet_b0 at batches 8 and 200, K and N of 16 to 1280, M up to
   2.5M rows, bf16 silu and id, and of botnet50 at batch 8, each forward
   summed): efficientnet_b0 (config/efficientnet_b0.yaml), botnet50
   (config/botnet50.yaml) and densenet121 (config/resnet50.yaml with
   MODEL.ARCH densenet121) served as ResNet-50 is, in bursts of
   ZOO_REQUESTS (32, 34 and 0 conv-epilogue launches per forward, no grouped-conv launch; bf16 logits
   against the port's f32 CPU forward; weights from seed 0 with every BN
   moved off its init stats by ``seeded_bn``; zoo_serve_phase zeroes
   botnet50's attention value weights, which must move its f32 card
   logits); one bf16 forward each of densenet161/169/201 at batch 2
   against the CPU; densenet161's peak
   memory over a bf16 train step at batch 32 (cuDNN's heuristics); the three served archs
   trained one epoch and its eval through ``trainer.train_model`` at their
   yaml's batch (64, 32, 32); one f32 step card vs CPU each (with the
   RegNet's, see 11), efficientnet_b0 with its dropout 0.2 on (the
   host-drawn mask is the same on both).
9. Real images and process groups:
   * ``syncbn_world1``: one f32 ResNet-50 step (batch 8, TF32 off, cuDNN
     deterministic) with ``BN_GROUP 0`` and no process group, then with
     ``MODEL.SYNCBN`` in a one-process NCCL group (``MASTER_ADDR``
     127.0.0.1, a free port): every BatchNorm all-reduces its sums, the
     gradients and metrics are all-reduced, and the two steps must be
     bitwise equal;
   * ``realdata_train``: an ImageFolder of 8 classes, 96 train and 25 val
     JPEGs each (quality 90, sides 300-500, colours by class, seed 0),
     trained through ``trainer.train_model`` with config/resnet50.yaml at
     full width (bf16, batch 32) in that group, ``DATA.BACKEND auto``,
     ``TRAIN.WORKERS`` = the host's cores: 24 steps, then the eval of the
     200 val images. Prints the decode backend, train img/s over steps
     8-24, the share of that window spent waiting for the loader, eval
     img/s, the loader's img/s alone, the dummy-data train img/s of phase
     5 beside them, and the launches of opt_update (one a step) and
     conv1x1_bn_act (33 a forward); with the native decoder built, its
     uint8 batches against PIL's on the same files (at most
     NATIVE_U8_BOUND counts apart);
   * ``shards_train``: that ImageFolder packed by the port's packer
     (``data/shards/pack.py``) at 1/SHARDS_PARTS of the train split's bytes
     a shard (at least SHARDS_MIN_PARTS train shards), ``verify_split`` on
     each split, then trained and evaluated as ``realdata_train`` with
     ``DATA.FORMAT shards`` in the same group: train img/s over steps 8-24
     beside realdata_train's, the loader-wait share, the shard loader's
     img/s alone, eval img/s, the records and bytes read, the launches
     (24 opt_update, 33 conv1x1_bn_act an eval forward); the shard
     loader's first uint8 batch must equal the ImageFolder dataset's batch
     of the same samples, seed and epoch byte for byte;
   * ``shards_exact_resume``: ``train_net`` in subprocesses on the pack
     (this script with ``--counted-train-net``, which counts the launches
     in the subprocess), cuDNN deterministic, all at once: one
     uninterrupted epoch; the epoch preempted by FAULTS.PREEMPT_AT_BATCH
     SHARDS_PREEMPT_AT and rerun, which must log that it continues at the
     next batch, launch opt_update once a batch left, and end with its
     parameters, BN buffers and momentum bitwise the uninterrupted run's;
     FAULTS.TRUNCATE_SHARD on a copy of the pack (the forward-scan recovery
     logged with its counts, the lost records substituted, the epoch
     finished), and the same with DATA.SKIP_CORRUPT False, which must exit
     non-zero. Both phases print their seconds;
   * ``two_ranks_one_card``: two processes share cuda:0 over gloo (this
     script with ``--two-ranks-worker``): ResNet-50, TF32 off, BN params
     seeded away from their init, 16 images a rank, SyncBN and then ghost
     groups of 16, against one process at batch 32 on the card: in f64
     the gradients (all-reduced) and running stats within
     TWO_RANK_F64_TOL of each tensor's largest magnitude; two f32 train
     steps with the ranks bitwise equal and the first loss within
     TWO_RANK_LOSS_RTOL (the updates' L2 and per-tensor differences are
     printed).
10. The rest of the train loop, in one process with no process group:
   * ``train_loop_accum``: an f64 ResNet-50 step at batch 8 with
     GRAD_ACCUM_STEPS 2 and BN_GROUP 4 against the step without accum at
     ghost groups of 4 (parameters and momentum within LOOP_F64_TOL of
     each tensor's scale; the running stats move twice under accum by
     design); the bf16 batch-32 step at accum 1 and 2 over the same 32
     images, step ms and one opt_update launch per optimizer step;
   * ``train_loop_remat``: an f64 step with stages 1-2 recomputed against
     the plain step (cuDNN deterministic; within LOOP_F64_TOL, bitwise
     equality reported), then the graphed bf16 batch-32 step both ways:
     the graph's own memory (the peak ``max_memory_allocated`` of its
     warm-up and capture, and its pool's reserved bytes), each lower under
     remat, and step ms. The fused update has no f64 body: the f64 steps
     apply its plain version;
   * ``train_loop_async_save``: a bf16 train state saved synchronously and
     through the committer: the boundary's blocking time against the
     synchronous save's wall, the payloads bitwise equal, the manifests
     verifying, the steps that overlap the commit against those after;
   * ``train_loop_drills``: ``train_net`` in subprocesses on an ImageFolder
     of its own (8 classes of DRILL_TRAIN and DRILL_VAL JPEGs: DRILL_STEPS
     steps an epoch), cuDNN's heuristics (no autotune), each drill from a
     copy of one epoch-1 checkpoint, the three at once; all of it started
     beside ``shards_exact_resume`` and ``two_ranks_one_card`` (which
     check bits and logs, not times) and joined before
     ``train_loop_accum``: the NaN rollback (FAULTS.NAN_STEP in epoch 2,
     MAX_ROLLBACKS 1: it raises after one rollback, a clean rerun
     finishes), a truncated ckpt_ep_001 and a SIGKILL between its rename
     and its manifest (CHECKPOINT.ASYNC), each walked back over;
   * ``train_loop_concurrent_eval``: two epochs of config/resnet50.yaml
     on that ImageFolder (two eval batches of 100 an epoch), after a
     warm-up run synchronous, then with CONCURRENT_EVAL and
     CHECKPOINT.ASYNC (cuDNN deterministic): the concurrent run's final
     state bitwise the synchronous one's before it, Acc@1 equal, 33 conv-epilogue launches per eval forward, every
     one of a concurrent run's off the default stream, a synchronous
     run's off it only in each eval graph's warm-up (its replays run on
     the default stream; a capture launches nothing), the walls.
11. One graph per step, after the RegNet phases (regnety_160's served
   weights). Before it, the card halves of the f32 steps card vs CPU of
   5, 7 and 8; their CPU halves (the CPU f32 and f64 steps, the checks)
   run in a thread beside ``graph_equal`` and ``recompile_drill``, which
   read no time, and are joined before ``fold_train``:
   * ``graph_equal``: eager (``graphed=False``) against graph, cuDNN
     deterministic: ResNet-50's and regnety_160's served logits bitwise
     at every bucket, GPT-nano's bf16 greedy streams identical, and after
     8 bf16 train steps a side the f32 state (parameters, buffers,
     moments) bitwise equal for ResNet-50 (SGD), ViT-S/16 with flash
     (AdamW: c1 and c2 move every step) and efficientnet_b0 (dropout);
   * ``fold_train``: ResNet-50 (bf16, batch 32) with TRAIN.STEPS_PER_CALL
     4 against the per-step graph over 8 batches, the state bitwise
     equal; then 24 steps of each timed: img/s, step ms, one opt_update
     launch a step;
   * ``recompile_drill``: ``train_model`` (resnet18 at 64², batch 16, one
     epoch of 64 steps) with FAULTS.RECOMPILE_AT_BATCH 40 and
     RECOMPILE_N 12 (and FAULTS.SLOWDOWN_MS 10, see 14) against the run
     without: 12 more captures in the epoch's record, the final
     checkpoint bitwise the clean one.
12. Telemetry on the card (``telemetry_phases``, after the LM plane):
   * ``telemetry_train``: config/resnet50.yaml (bf16, batch 32, dummy
     data) through ``train_model``, two epochs of 64 graphed steps and
     their evals, ``PROF`` over steps 20-24: every record of the rank
     file and metrics.jsonl validates against the port's schema, one
     ``step`` span a step, a ``compile`` record a graph capture,
     ``memstats`` above 0, the ledger's ``cost.*`` of ``train_step`` and
     ``eval_step`` (train FLOPs an image within 10 % of JAX's 24.5 G),
     the profiler's trace names the ``opt_update`` kernel, the port's
     exporter writes a trace; it prints the FLOPs an image, the MFU and
     the roofline against the measured step (epoch 2 between its first
     and last flush), the graphs' memory headroom, the step span's p50
     (the host's dispatch) and the timeline's img/s beside the measured;
   * ``telemetry_neutral``: telemetry on against off: six f32 ResNet-50
     batch-8 steps of ``train_epoch`` (cuDNN deterministic) leave the f32
     state bitwise equal; in turns in one call, graphed ResNet-50 b32
     train img/s, GPT-nano b16 train tokens/s (seeded token rows) and
     served ResNet-50 img/s; one GPT-nano epoch under ``PROF``: the
     train step's device time by kind from the trace;
   * ``telemetry_lm``: GPT-nano served (32 greedy requests x 64 tokens)
     off and on in turns on one engine: tokens/s each way, the streams the
     same, a ``gen.decode`` record a decode step while on, ``lm.tokens``
     at the drain equal to the tokens served; four requests through the
     socket under ``SERVE.TRACE_SAMPLE 1.0``, each one connected
     ``trace.span`` tree from the client edge to the engine.
13. A JAX-trained checkpoint served from a fleet (``slice18_phases``,
   after telemetry):
   * ``orbax_weights``: the committed fixture tests/data/orbax_toy/
     (saved by the JAX package: a narrow RegNetX by its weights-only best
     save and its full save, a narrow GPT) read by ``utils/orbax.py`` with
     no JAX on the host, timed; the RegNet's f32 logits on the card
     within ORBAX_REL_TOL of the JAX forward's scale, the GPT's greedy
     streams through a GenerateEngine on the card JAX's tokens;
   * ``quantize_serve``: config/resnet50.yaml at full width served full
     precision, bf16 and int8 (engines kept, two bursts of 64 a mode, in
     turns): ``rel_logits_delta`` against full precision within
     ``quantize.TOLERANCE``, top-1 agreement, JAX's byte meta, allocated,
     reserved, pool and packed bytes, img/s, p50/p99, 33 conv-epilogue
     launches a forward, every bucket a graph; the int8 logits against
     the port's f32 CPU forward of the packed weights (8 requests);
   * ``fleet_serve``: ``serve_net --fleet 2`` of that int8 ResNet-50 in a
     subprocess (replicas with their own CUDA contexts on this card): 128
     answers through the router against the in-process int8 engine's;
     the fleet's img/s over 16 connections against one replica's, the
     router's added p50; a replica SIGKILLed in a burst: nothing lost,
     the pool back at two; the replicas' conv-epilogue launches from
     their logs; the router's ``fleet.*`` records valid;
   * ``fleet_lm``: ``serve_net --fleet 2 --cfg config/gpt_nano.yaml``
     at f32, weights a ``.pth`` the phase writes, LONG_PROMPT_THRESHOLD
     32, started with the image fleet and run while the killed image
     replica's replacement warms: 16 streamed greedy requests identical
     to one in-process engine's, ``fleet.length_class`` rows for both
     classes, the replicas' decode-attention launches.
14. The live plane (``slice19_phases``, after the fleet):
   * ``monitor_live``: ``python -m distribuuuu_tpu_torch.telemetry.live
     RUN --json-lines --prometheus-port -1 --rules
     config/monitor_rules.yaml`` (``LiveMonitor``) attached before the run
     starts to ``telemetry_train``'s run (a tick every 0.5 s: no alert; its
     last snapshot's steps and graph captures and its snapshots'
     checkpoint saves equal ``telemetry/report.build_report`` of the
     finished run; /metrics scraped once and carrying those totals) and to
     ``recompile_drill``'s storm run (a tick every 0.1 s; that run sleeps
     STORM_SLOWDOWN_MS a batch so its first step and its storm at batch
     RECOMPILE_AT land in different windows: exactly recompile-storm);
   * ``campaign_degrade`` and ``campaign_lm``: both fleets started at
     once (``serve/campaign/fleet.MultiModelFleet``: resnet50 and resnet18
     from config/resnet50.yaml at 224², bf16, with ``serve_campaign``'s
     serving knobs; gpt_nano from config/gpt_nano.yaml at full width with
     its queue, tiles and budgets), then in turn: the warmed premium
     model's closed-loop capacity (CAMPAIGN_CAP_CLIENTS clients through
     the router for CAMPAIGN_CAP_S, CAMPAIGN_PROBES times in a row, their
     median), k = capacity / CAMPAIGN_REF_RPS, the
     card spec of the shipped YAML (``card_spec``: rates times k, the ms
     SLOs and thresholds over k), its replay by the port's
     ``CampaignRunner`` (the degrade payloads uint8 224² npy, as
     fleet_serve sends them; the LM's ``lm_payload_bank``), each phase's
     raised and expected alerts, counts and the open-loop client's send
     lag, each phase's client-side latency tail and this process's
     garbage collections over the replay, the per-model rows, the
     replicas' kernel launches from their logs at the drain. Each must be ``ok`` with a deterministic schedule,
     the shipped schedule's hash JAX's (JAX_SCHEDULE_HASH) and no failed
     request;
   * ``soak_smoke``: ``python -m distribuuuu_tpu_torch.soak --smoke
     --serve --per-class SOAK_PER_CLASS`` on the card: the control and
     nonfinite intervals each raise exactly their alerts, the gate is
     evaluated and passes, the fleet's hot-reload loses no request, the
     monitored control run is bitwise the unmonitored rerun, the training
     runs launch opt_update.
15. The MoE family and the model and expert axes (``slice20_phases``,
    after the live plane):
   * ``moe_vit``: config/vit_tiny_moe.yaml at full width (ViT-Ti/16, 8
     experts top-2 in every 2nd block, 224², batch 32, SGD Nesterov at
     its warm-up rate): MOE_VIT_STEPS graphed f32 steps (TF32 off) from
     one seeded init against the port's CPU f32 run of the same steps
     (run beside the card work), once the first MoE block routed every
     token of the first batch alike on both, losses within
     MOE_VIT_LOSS_RTOL; then bf16 graphed steps: device ms a step (CUDA
     events over MOE_VIT_TIMED replays) and the six MoE layers' share of
     it (their forward and backward on the step's activations, timed
     alone); one opt_update launch a step; one served burst of
     MOE_VIT_REQUESTS through the graphed buckets (img/s, p50/p99), the
     logits against the port's f32 CPU forward;
   * ``moe_gpt``: config/gpt_nano_moe.yaml at MESH.MODEL 1 MESH.EXPERT 1
     trained one epoch (bf16, batch 16, AdamW, graphed) on a generated
     pack of MOE_LM_CORPUS_MB: tokens/s, step ms, one opt_update launch a
     step, the loss falling; greedy f32 streams on the card equal the
     port's CPU engine's (divergence only at a near-tie, as lm_check);
     a bf16 burst's tokens/s with decode_attention once a block a step;
   * ``tp_ep_one_card``: the YAML's own stanza as 4 gloo ranks sharing
     cuda:0 (dp1·tp2·ep2, eager: ``trainer.step_graphed``; the script
     re-run as ``--tp-ep-worker``), ``train_model`` of TP_EP_STEPS f32
     steps on a generated pack against one process on the card from the
     same weights and batches: the losses within TP_EP_LOSS_RTOL, the
     sharded save tensor for tensor within TP_EP_STATE_RTOL of the
     one-process save (the attention's key bias, whose gradient is 0 and
     AdamW's steps noise, within 2·lr·steps) and the two updates' L2
     difference within TP_EP_UPDATE_RTOL, and one process resuming the
     sharded save for a second epoch as it resumes its own.
16. ZeRO on the data axis (``zero_one_card``, its ranks started beside
    ``shards_exact_resume`` and the drills, which check bits, not times):
    two gloo ranks sharing cuda:0 (the script re-run as ``--zero-worker``,
    eager),
    config/resnet50.yaml at full width (f32, SGD Nesterov, ZERO_BATCH a
    rank) at MESH.ZERO 0, 1 and 3 and config/gpt_nano.yaml (f32, AdamW)
    at stage 0 and stage 3 with GATHER_AHEAD -1 and 0, ZERO_STEPS steps
    each from the same seeded weights and batches with cuDNN
    deterministic: every stage and schedule's losses and final state
    (parameters, moments) bitwise stage 0's on each rank; one opt_update
    launch a step on each rank; the data-axis all-gathers within JAX's
    bound; each rank's resting bytes (parameters, gradient buffers,
    moments and ZeRO's shard buffers, between steps) exactly the layout's
    prediction and below stage 0's (0.78 and 0.50 of it for ResNet-50);
    the update over rank 0's
    shards through the kernel bitwise its plain version, timed beside
    its bound and fused torch.optim; the stage-3 run's sharded
    CHECKPOINT.ASYNC save (snapshot, write, barrier s) resumed by one
    process bitwise and served through ``engine_from_cfg`` with
    MODEL.WEIGHTS the directory, f32 logits within ZERO_SERVE_REL_TOL of
    that state's eval forward.
17. Prints the ``{"kernels": [...]}`` line, the card's name and power
    limit, and last ``{"ok": true, "device": {...}}``.

``--profile`` adds ``graph_vs_eager``: the graph against the eager body in
one call, in turns, for a ResNet-50 and a regnety_160 serving forward at
batch 8, a GPT-nano decode step at batch 4 and a ResNet-50 and a
ViT-S/16 train step at batch 32 (host ms, and from torch.profiler traces
device-busy ms, kernels, host-issued launches, idle share), served img/s
and generated tokens/s through engines built both ways; and a
breakdown of a regnety_160 train step at batch 64. Any failed phase exits
non-zero. Exits non-zero, printing no result, without CUDA or outside a
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 CUDA cores
BF16_TOL = 0.0625  # max-abs, pinned as in tests/test_pallas_kernels.py
F32_TOL = 1e-5
# end-to-end bf16 card vs f32 CPU: 50+ layers of bf16 rounding on the card
SLICE_REL_TOL = 0.05  # max |logit diff| / max |CPU logit|
SLICE_TOP1_MIN = 0.9  # share of requests with the same top-1 class
N_REQUESTS = 64
# opt_update against its plain version: bit-equal is expected; the plain
# version's f64 emulation of a fused multiply-add can round twice (about
# once in 2^29 fused operations), which may move a rare element by 1 ulp
OPT_MAX_ULP = 1
OPT_MAX_ULP_ELEMS = 8
OPT_HOLD_CYCLES = 400_000_000  # about 0.2 s at the H100's 1.98 GHz boost clock
# one f32 ResNet-50 step (batch 4, random init, 1000 classes), card vs
# CPU, TF32 off. The gradient at this point is ill-conditioned in f32: the
# CPU's own f32 step differs from its f64 step by about 2 % in the L2 norm
# over all parameters (the phase measures it). So the card's update must
# agree with the CPU's f32 update to 5 % in that norm, and lie no further
# from the f64 update than twice the CPU's f32 update does.
STEP_UPDATE_L2_TOL = 0.05
STEP_F64_RATIO_MAX = 2.0
TRAIN_STEPS_PER_EPOCH = 64
# the dummy val split holds 64 batches of TRAIN.BATCH_SIZE, evaluated at
# TEST.BATCH_SIZE 200: at batch 32, 2048 images in 10 full batches and a
# ragged 48; at regnety_160's batch 64, 4096 images in 20 and a ragged 96
EVAL_FORWARDS = 11
# flash attention against its plain version: max abs error over the
# reference's scale (max(1, max |ref|)); bf16: four bf16 ulps (p and dS are
# rounded at the same points, the sums run in other orders); f32: f32 sums
# in other orders
FLASH_TOL = {"bfloat16": 2 ** -6, "float32": 1e-5}
FLASH_SHAPES = [  # (name, batch, heads, length, head dim, dtype, causal)
    ("vit_s_train_b32", 32, 6, 196, 64, "bfloat16", False),
    ("vit_s_serve_b8", 8, 6, 196, 64, "bfloat16", False),
    ("vit_s_eval_b200", 200, 6, 196, 64, "bfloat16", False),
    ("vit_ti_1024px_b4", 4, 3, 4096, 64, "bfloat16", False),
    ("causal_4096_b4", 4, 3, 4096, 64, "bfloat16", True),
    ("ragged_f32", 2, 3, 150, 64, "float32", False),
    ("gpt_nano_causal_b16", 16, 4, 256, 32, "bfloat16", True),  # head dim 32, run at 64
]
FLASH_KERNELS = {  # kernel -> (source function name, TPU kernel it replaces)
    "forward": ("flash_attention_fwd", "distribuuuu_tpu/ops/flash_attention.py:315"),
    "dq": ("flash_attention_dq", "distribuuuu_tpu/ops/flash_attention.py:359"),
    "dkdv": ("flash_attention_dkdv", "distribuuuu_tpu/ops/flash_attention.py:372"),
}
VIT_DEPTH = 12
# ViT-S serving, card vs the port's f32 CPU forward: bf16 on the card within
# SLICE_REL_TOL of the logit scale; f32 on the card (the f32 flash kernel)
# within VIT_F32_REL_TOL and the same top-1 for VIT_F32_TOP1_MIN of the
# requests (bf16 near-ties between random-init classes may flip top-1)
VIT_F32_REL_TOL = 1e-3
VIT_F32_TOP1_MIN = 0.9
# decode attention against its plain version, of max(1, max |ref|): bf16
# inputs are read exactly by both, so only fp32 summation order differs
DECODE_TOL = {"bfloat16": 2 ** -6, "float32": 1e-5}
DECODE_SHAPES = [  # (name, batch, heads, cache, head dim, dtype, lengths or None: seeded)
    ("gpt_nano_b4_c256", 4, 4, 256, 32, "bfloat16", [0, 37, 128, 255]),
    ("gpt_nano_b32_c256", 32, 4, 256, 32, "bfloat16", None),
    ("bench_b4_h6_c256_d64", 4, 6, 256, 64, "bfloat16", None),
    ("probe_b8_h16_c4096_d128", 8, 16, 4096, 128, "bfloat16", None),  # bandwidth probe
    ("ragged_f32", 3, 2, 96, 32, "float32", [0, 50, 95]),
]
LM_DEPTH = 4  # gpt_nano's blocks: decode_attention launches per decode step
LM_REQUESTS = 32
LM_NEW_TOKENS = 64
LM_BIG_TILES = [1, 2, 4, 8, 16, 32]
LM_F32_PROMPTS = 8
# f32 greedy card vs CPU: a divergence is allowed only at a near-tie whose
# CPU logit gap is below this share of the logit scale
LM_F32_GAP_TOL = 1e-5
# group_conv3x3 against its plain version, of max(1, max |ref|): bf16 is one
# rounding of the output apart (fp32 sums in another order); f32 sums in
# another order
GROUP_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
GROUP_SHAPES = [  # (name, B, H, W, C, G, stride, dtype, flipped weight)
    ("regnety_160_s3_b8", 8, 14, 14, 1232, 11, 1, "bfloat16", False),
    ("regnety_160_s3_b64", 64, 14, 14, 1232, 11, 1, "bfloat16", False),
    ("regnety_160_s3_b200", 200, 14, 14, 1232, 11, 1, "bfloat16", False),
    ("regnetx_160_s3_b64", 64, 14, 14, 896, 7, 1, "bfloat16", False),
    ("regnety_320_s3_b64", 64, 14, 14, 1392, 6, 1, "bfloat16", False),
    ("regnety_160_s3_dx_b64", 64, 14, 14, 1232, 11, 1, "bfloat16", True),
    ("regnety_160_s3_stride2_b64", 64, 28, 28, 1232, 11, 2, "bfloat16", False),
    ("resnext50_s3_cg16_b8", 8, 14, 14, 512, 32, 1, "bfloat16", False),
    ("ragged_f32", 3, 7, 5, 33, 3, 1, "float32", False),
]
REGNET_GROUP_SITES = 10  # regnety_160: the stride-1 blocks of stage 3 (11 blocks) at 14²
REGNET_FUSED_SITES = 36  # conv1 and conv3 of its 18 blocks
REGNET_EVAL_FORWARDS = 21  # 4096 images at batch 200
REGNET_F32_REL_TOL = 1e-3  # f32 card vs f32 CPU logits, of the logit scale


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the run's seconds so far
    (``at_s``), which says where the time limit goes."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def resnet50_sites(batch: int, im: int):
    """(M, K, N, act) of the 33 fused conv-epilogue sites of one
    ResNet-50 forward, in order: per bottleneck conv1 (relu; at the input
    resolution, before the strided 3x3) and conv3 (id), plus the stride-1
    downsample of stage 1 (id). Strided downsamples do not qualify."""
    sites, res, in_ch = [], im // 4, 64
    for stage, (feats, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            sites.append((batch * res * res, in_ch, feats, "relu"))
            res //= stride
            sites.append((batch * res * res, feats, feats * 4, "id"))
            if i == 0 and stride == 1:
                sites.append((batch * res * res, in_ch, feats * 4, "id"))
            in_ch = feats * 4
    return sites


def time_ms(torch, fn, reps: int = 15, warmup: int = 3, hold_cycles: int = 30_000_000) -> float:
    """Median device time of one call: CUDA events around each call, with
    the stream held by a sleep kernel of ``hold_cycles`` clock cycles while
    the host enqueues, so host launch overhead does not enter the device
    time (the hold must outlast the host's enqueueing of all ``reps``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(hold_cycles)
    evs[0].record()
    for i in range(reps):
        fn()
        evs[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1]) for i in range(reps))


def bound(m, k, n, dtype, torch, ce):
    nbytes = ce.pass_bytes(m, k, n, dtype, dtype)
    flops = 2 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


def regnet_sites(arch: str, batch: int, im: int):
    """(M, K, N, act) of the fused conv-epilogue sites of one RegNet
    forward, in order: per block conv1 (relu, at the block's input
    resolution) and conv3 (id, after the stride of conv2)."""
    from distribuuuu_tpu_torch.models import build_model

    model = build_model(arch, device="meta")
    sites, res = [], -(-im // 2)  # after the stride-2 stem
    for stage in model.stages:
        for blk in stage:
            c1, c3 = blk.conv1.conv, blk.conv3.conv
            sites.append((batch * res * res, c1.in_channels, c1.out_channels, "relu"))
            res = -(-res // blk.conv2.conv.stride[0])
            sites.append((batch * res * res, c3.in_channels, c3.out_channels, "id"))
    return sites


def kernel_phase(torch, ce, dev, batch: int = 8, ragged: bool = True, sites=None):
    """conv1x1_bn_act against its plain version at every distinct site
    shape of a ResNet-50 forward at ``batch`` (8: serving; 200 and the
    ragged 48: the trainer's eval), or of ``sites``, and at a ragged f32
    shape."""
    sites = sites or resnet50_sites(batch, 224)
    shapes = {}
    for s in sites:
        shapes[s] = shapes.get(s, 0) + 1
    cases = [(*s, torch.bfloat16, cnt) for s, cnt in shapes.items()]
    if ragged:
        cases.append((50, 48, 96, "silu", torch.float32, 0))  # ragged M, N, K
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    for m, k, n, act, dtype, count in cases:
        x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
        w = (torch.randn(k, n, device=dev, generator=gen) / k ** 0.5).to(dtype)
        a = 1.0 + 0.1 * torch.randn(n, device=dev, generator=gen)
        c = 0.1 * torch.randn(n, device=dev, generator=gen)
        out = ce.conv1x1_bn_act(x, w, a, c, act)
        ref = ce.conv1x1_bn_act_plain(x, w, a, c, act)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        bms, by, nbytes = bound(m, k, n, dtype, torch, ce)
        row = {
            "phase": "kernel", "name": "conv1x1_bn_act", "batch": batch, "M": m, "K": k, "N": n,
            "act": act, "dtype": str(dtype).split(".")[-1], "sites_per_forward": count,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(torch, lambda: ce.conv1x1_bn_act(x, w, a, c, act)),
            "plain_ms": time_ms(torch, lambda: ce.conv1x1_bn_act_plain(x, w, a, c, act)),
            "library_ms": time_ms(torch, lambda: torch.matmul(x, w)),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
        }
        if dtype == torch.bfloat16:  # the TMA/wgmma body's tile and split of K
            row["plan"] = dict(zip(("bm", "bn", "splits", "stages"), ce.plan(m, n, k)))
        emit(row)
        if not err <= tol:
            raise AssertionError(f"conv1x1_bn_act {m}x{k}x{n} {act} {dtype}: "
                                 f"max abs err {err} > {tol}")
        worst = max(worst, err)
        rows.append(row)
    return rows, worst


def forward_total(rows, **key) -> dict:
    """One forward's sum over its sites (``sites_per_forward`` weights) of
    the kernel's, the plain version's and ``torch.matmul``'s times and of
    the per-site bounds."""
    return {"phase": "kernel_forward_total", "name": "conv1x1_bn_act", **key,
            **{k: sum(r[k] * r["sites_per_forward"] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}


def _kernel_name(mangled: str) -> dict:
    """A kernel's name and template arguments from its mangled name (the
    port's kernels sit in an anonymous namespace, ``_ZN<len><namespace>
    <len><name>I<args>E``): ``{"kernel": name, "targs": [...]}``, types
    as ``bf16``/``f16``, integers as ints."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if m is None:
        return {"kernel": mangled, "targs": []}
    rest = mangled[m.end() + int(m.group(1)):]  # past the namespace
    m = re.match(r"(\d+)", rest)
    if m is None:
        return {"kernel": mangled, "targs": []}
    name = rest[m.end():m.end() + int(m.group(1))]
    rest = rest[m.end() + int(m.group(1)):]
    targs = []
    if rest.startswith("I"):
        for tok in re.finditer(r"(^If|13__nv_bfloat16|6__half|Li(\d+)E)",
                               rest[:rest.find("EE") + 2]):
            targs.append("f32" if tok.group(1) == "If" else "bf16" if tok.group(1).startswith("13")
                         else "f16" if tok.group(1).startswith("6") else int(tok.group(2)))
    return {"kernel": name, "targs": targs}


def ptxas_report(log: str) -> list[dict]:
    """Each kernel's registers, spills and static shared memory, and any
    wgmma ptxas serialises, from a build's ``-Xptxas -v`` output
    (``_build.build_logs``)."""
    import re

    kernels, cur, serialized = [], None, []
    for line in log.splitlines():
        if "serialized" in line:  # ptxas: wgmma issued one at a time, and why
            serialized.append(line.strip())
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    for line in serialized:
        m = re.search(r"'(_Z\S+)'", line)
        kernels.append({**(_kernel_name(m.group(1)) if m else {}), "ptxas": line})
    return kernels


def _serve_bursts(engine_from_cfg, images):
    """Build the engine from the global cfg and serve ``images`` twice
    (the first burst meets the threads' first CUDA calls), then drain.
    Returns (engine, build seconds, burst walls, batches, last logits)."""
    import numpy as np

    from distribuuuu_tpu_torch.serve import ServeMetrics

    t_build = time.perf_counter()
    engine = engine_from_cfg()
    t_build = time.perf_counter() - t_build
    engine.start()
    walls, batches = [], 0
    for _ in range(2):
        engine.metrics = ServeMetrics()
        t0 = time.perf_counter()
        futs = [engine.submit(img) for img in images]
        logits = np.stack([f.result(timeout=300) for f in futs])
        walls.append(time.perf_counter() - t0)
        batches += engine.metrics.snapshot()["batches"]
    engine.drain()
    return engine, t_build, walls, batches, logits


def slice_phase(torch, ce, n_requests: int):
    """ResNet-50 serving through the port's engine on cuda:0, checked
    against the port's CPU forward in f32 on the same weights."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    config.reset_cfg()
    config.merge_from_file("config/resnet50.yaml")
    cfg.merge_from_list([
        "DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16",
        "RNG_SEED", 0, "SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8,
        "SERVE.BUCKET_SIZES", [1, 2, 4, 8], "SERVE.MAX_QUEUE", 2 * n_requests,
        "SERVE.MAX_WAIT_MS", 2.0,
    ])
    im = cfg.TRAIN.IM_SIZE
    images = np.random.default_rng(0).integers(0, 256, (n_requests, im, im, 3), np.uint8)

    ce.conv1x1_bn_act.launches = 0
    engine, t_build, walls, batches, logits = _serve_bursts(engine_from_cfg, images)
    launches = ce.conv1x1_bn_act.launches
    wall = walls[-1]
    stats = engine.stats()

    forwards = batches + engine.n_compiles
    sites = sum(u.fused for u in engine.model.conv_units())
    if sites != 33 or launches != 33 * forwards:
        raise AssertionError(
            f"conv epilogue launches {launches} != 33 x {forwards} forwards "
            f"({batches} batches + {engine.n_compiles} warm-ups); "
            f"{sites} fused sites"
        )

    # the same weights through the port on the CPU, in f32
    ref = build_model("resnet50", num_classes=cfg.MODEL.NUM_CLASSES, dtype=torch.float32)
    ref.load_state_dict({k: v.cpu() for k, v in engine.model.state_dict().items()})
    ref.eval()
    with torch.inference_mode():
        cpu = np.concatenate([
            ref(normalize_on_device(torch.from_numpy(images[i:i + 16]))).numpy()
            for i in range(0, n_requests, 16)
        ])
    if logits.shape != (n_requests, cfg.MODEL.NUM_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite "
                             f"{bool(np.isfinite(logits).all())}")
    rel = float(np.abs(logits - cpu).max() / np.abs(cpu).max())
    top1 = float((logits.argmax(1) == cpu.argmax(1)).mean())
    res = {
        "phase": "slice", "arch": cfg.MODEL.ARCH, "dtype": "bfloat16", "im_size": im,
        "requests": n_requests, "batches": stats["batches"], "forwards": forwards,
        "warmups": engine.n_compiles,
        "conv_epilogue_launches": launches, "engine_build_s": t_build,
        "first_burst_wall_s": walls[0], "first_burst_img_per_s": n_requests / walls[0],
        "img_per_s": n_requests / wall, "wall_s": wall,
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "batch_occupancy": stats["batch_occupancy"], "mean_batch_ms": stats["mean_batch_ms"],
        "rel_err_vs_cpu_f32": rel, "rel_tol": SLICE_REL_TOL,
        "top1_agreement": top1, "top1_min": SLICE_TOP1_MIN,
        "logit_scale": float(np.abs(cpu).max()),
    }
    emit(res)
    if not (rel <= SLICE_REL_TOL and top1 >= SLICE_TOP1_MIN):
        raise AssertionError(f"card vs CPU logits: rel err {rel} (tol {SLICE_REL_TOL}), "
                             f"top-1 agreement {top1} (min {SLICE_TOP1_MIN})")
    return launches, engine.model


def _scaled_err(a, b) -> tuple[float, float]:
    """(max abs error, the same over max(1, max |b|))."""
    err = float((a.float() - b.float()).abs().max())
    return err, err / max(1.0, float(b.float().abs().max()))


def flash_kernel_phase(torch, fa, dev):
    """The flash forward, dQ and dK/dV against their plain versions at
    FLASH_SHAPES (the backward kernels on the plain forward's lse and
    delta), each timed beside its plain version and SDPA: forward for the
    forward, its backward (dQ, dK and dV together) for dQ and dK/dV; the
    forward with the shape's ``fwd_plan``, dQ and dK/dV with its
    ``bwd_plan``. Then a ``flash_backward`` row a
    shape: the backward as the autograd Function runs it (the fp32 delta
    reduction, dQ, dK/dV) against SDPA's whole backward, like for like.
    Returns {shape name: {kernel: row}}."""
    F = torch.nn.functional
    out = {}
    for name, b, h, L, d, dt, causal in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(b * h, L, d, device=dev, generator=gen).to(dtype)
                       for _ in range(4))
        scale = d ** -0.5
        # a head dim the kernels do not take runs zero-padded, as _Flash pads it
        dp = fa.kernel_head_dim(dtype, d)
        qk, kk, vk, dok = (F.pad(t, (0, dp - d)).contiguous() if dp != d else t
                           for t in (q, k, v, do))
        o_full, lse = fa.forward_kernel(qk, kk, vk, scale, causal)
        o = o_full[..., :d]
        o_ref, lse_ref = fa.forward_plain(q, k, v, scale, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, scale, causal)
        kargs = (qk, kk, vk, dok, lse_ref, delta, scale, causal)
        dq, (dk, dv) = fa.dq_kernel(*kargs)[..., :d], (t[..., :d] for t in fa.dkdv_kernel(*kargs))
        dq_ref, (dk_ref, dv_ref) = fa.dq_plain(*args), fa.dkdv_plain(*args)
        torch.cuda.synchronize()
        errs = {"forward": [_scaled_err(o, o_ref), _scaled_err(lse, lse_ref)],
                "dq": [_scaled_err(dq, dq_ref)],
                "dkdv": [_scaled_err(dk, dk_ref), _scaled_err(dv, dv_ref)]}
        q4, k4, v4, do4 = (t.view(b, h, L, d) for t in (q, k, v, do))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=scale)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do4,
                                                             retain_graph=True))
        del qg, kg, vg, sdpa
        calls = {
            "forward": (lambda: fa.forward_kernel(qk, kk, vk, scale, causal),
                        lambda: fa.forward_plain(q, k, v, scale, causal), lib_fwd),
            "dq": (lambda: fa.dq_kernel(*kargs), lambda: fa.dq_plain(*args), lib_bwd),
            "dkdv": (lambda: fa.dkdv_kernel(*kargs), lambda: fa.dkdv_plain(*args), lib_bwd),
        }
        # the bound is the work at the model's head dim, not the padded one
        nbytes, ops = fa.pass_bytes(b * h, L, d, dtype), fa.flops(b * h, L, d, causal)
        plan = fa.bwd_plan(L, dp, dtype)._asdict()
        plans = {"forward": fa.fwd_plan(b * h, L, dp, dtype)._asdict(), "dq": plan, "dkdv": plan}
        rows = {}
        for kern, (fn, plain, lib) in calls.items():
            t_bytes = nbytes[kern] / HBM_BYTES_PER_S * 1e3
            t_ops = ops[kern] / PEAK_FLOPS[dt] * 1e3
            row = {
                "phase": "kernel", "name": FLASH_KERNELS[kern][0], "shape": name,
                "B": b, "H": h, "L": L, "D": d, "kernel_D": dp, "dtype": dt, "causal": causal,
                "max_abs_err": max(e for e, _ in errs[kern]),
                "scaled_err": max(r for _, r in errs[kern]), "tol": FLASH_TOL[dt],
                "ms": time_ms(torch, fn),
                "plain_ms": time_ms(torch, plain, reps=5, warmup=1,
                                    hold_cycles=OPT_HOLD_CYCLES),
                "library_ms": lib, "library": "sdpa forward" if kern == "forward"
                else "sdpa backward (dq, dk, dv)",
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes[kern], "flops": ops[kern],
                "plan": plans[kern],
            }
            emit(row)
            if not row["scaled_err"] <= FLASH_TOL[dt]:
                raise AssertionError(f"flash {kern} {name}: error {row['scaled_err']} of "
                                     f"the scale > {FLASH_TOL[dt]}")
            rows[kern] = row

        def backward():  # as _Flash.backward runs it, lse cotangent aside
            dl = (dok.float() * o_full.float()).sum(-1)
            fa.dq_kernel(qk, kk, vk, dok, lse, dl, scale, causal)
            fa.dkdv_kernel(qk, kk, vk, dok, lse, dl, scale, causal)

        # delta reads dO and O and writes [BH, L] fp32 beside the two kernels
        bwd_bytes = nbytes["dq"] + nbytes["dkdv"] + 2 * b * h * L * d * q.element_size() \
            + b * h * L * 4
        t_bytes = bwd_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = (ops["dq"] + ops["dkdv"]) / PEAK_FLOPS[dt] * 1e3
        emit({"phase": "kernel", "name": "flash_backward", "shape": name, "L": L, "D": d,
              "dtype": dt, "causal": causal, "plan": plan, "ms": time_ms(torch, backward),
              "dq_plus_dkdv_ms": rows["dq"]["ms"] + rows["dkdv"]["ms"],
              "library_ms": lib_bwd, "library": "sdpa backward (dq, dk, dv)",
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        out[name] = rows
        del q, k, v, do, o, lse, o_ref, lse_ref, delta, args, dq, dk, dv, dq_ref, dk_ref, dv_ref
        del qk, kk, vk, dok, o_full, kargs
    return out


def vit_slice_phase(torch, fa, dev, n_requests: int):
    """ViT-S/16 serving through the port's engine on cuda:0 with
    DEVICE.ATTN_IMPL flash; 12 flash-forward launches per forward, the
    logits held against the port's f32 CPU forward on the same weights,
    in bf16 (the served run) and in f32 on the card."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    config.reset_cfg()
    config.merge_from_file("config/vit_small.yaml")
    cfg.merge_from_list([
        "DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16",
        "DEVICE.ATTN_IMPL", "flash", "RNG_SEED", 0, "SERVE.DEVICE", 0,
        "SERVE.MAX_BATCH", 8, "SERVE.BUCKET_SIZES", [1, 2, 4, 8],
        "SERVE.MAX_QUEUE", 2 * n_requests, "SERVE.MAX_WAIT_MS", 2.0,
    ])
    im = cfg.TRAIN.IM_SIZE
    images = np.random.default_rng(0).integers(0, 256, (n_requests, im, im, 3), np.uint8)
    fa.reset_launch_counts()
    engine, t_build, walls, batches, logits = _serve_bursts(engine_from_cfg, images)
    counts = fa.launch_counts()
    stats = engine.stats()
    forwards = batches + engine.n_compiles
    depth = len(engine.model.blocks)
    if depth != VIT_DEPTH or counts != {"forward": depth * forwards, "dq": 0, "dkdv": 0}:
        raise AssertionError(f"flash launches {counts} != {depth} x {forwards} forwards "
                             f"({batches} batches + {engine.n_compiles} warm-ups), no backward")

    sd = {k: t.cpu() for k, t in engine.model.state_dict().items()}
    del engine

    def f32_logits(device):
        model = build_model("vit_small", num_classes=cfg.MODEL.NUM_CLASSES,
                            dtype=torch.float32, attn_impl="flash", img_size=im)
        model.load_state_dict(sd)
        model = model.to(device).eval()
        with torch.inference_mode():
            return np.concatenate([
                model(normalize_on_device(torch.from_numpy(images[i:i + 16]).to(device)))
                .cpu().numpy() for i in range(0, n_requests, 16)])

    cpu, card32 = f32_logits(torch.device("cpu")), f32_logits(dev)
    if logits.shape != (n_requests, cfg.MODEL.NUM_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite "
                             f"{bool(np.isfinite(logits).all())}")
    scale = float(np.abs(cpu).max())
    rel, rel32 = (float(np.abs(x - cpu).max() / scale) for x in (logits, card32))
    top1, top1_32 = (float((x.argmax(1) == cpu.argmax(1)).mean()) for x in (logits, card32))
    res = {
        "phase": "slice", "arch": cfg.MODEL.ARCH, "attn_impl": "flash", "dtype": "bfloat16",
        "im_size": im, "requests": n_requests, "batches": stats["batches"],
        "forwards": forwards, "warmups": forwards - batches,
        "flash_launches": counts, "engine_build_s": t_build,
        "first_burst_wall_s": walls[0], "first_burst_img_per_s": n_requests / walls[0],
        "img_per_s": n_requests / walls[-1], "wall_s": walls[-1],
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "batch_occupancy": stats["batch_occupancy"], "mean_batch_ms": stats["mean_batch_ms"],
        "rel_err_vs_cpu_f32": rel, "rel_tol": SLICE_REL_TOL, "top1_agreement": top1,
        "card_f32_rel_err_vs_cpu_f32": rel32, "card_f32_rel_tol": VIT_F32_REL_TOL,
        "card_f32_top1_agreement": top1_32, "card_f32_top1_min": VIT_F32_TOP1_MIN,
        "logit_scale": scale,
    }
    emit(res)
    if not (rel <= SLICE_REL_TOL and rel32 <= VIT_F32_REL_TOL
            and top1_32 >= VIT_F32_TOP1_MIN):
        raise AssertionError(f"ViT card vs CPU logits: bf16 rel err {rel} (tol "
                             f"{SLICE_REL_TOL}); f32 rel err {rel32} (tol {VIT_F32_REL_TOL}), "
                             f"top-1 {top1_32} (min {VIT_F32_TOP1_MIN})")
    return counts["forward"]


def group_kernel_phase(torch, gc, dev):
    """group_conv3x3 against its plain version at GROUP_SHAPES, each timed
    beside its plain version and F.conv2d(groups=G) (cuDNN, benchmark
    mode, never called by the port), with its bound: x read once, the
    weight read once, the output written once over the memory rate vs
    2·9·cg operations per output element over the peak of the dtype. Each
    row names the body that ran (every bf16 row must run ``wgmma``), its
    tiling (``plan``) and the share of the bound it reaches.
    Returns {shape name: row}."""
    F = torch.nn.functional
    rows = {}
    for name, b, h, w, c, g, stride, dt, flipped in GROUP_SHAPES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
        wt = (torch.randn(c, c // g, 3, 3, device=dev, generator=gen) / (9 * c // g) ** 0.5)
        wt = wt.to(dtype).contiguous(memory_format=torch.channels_last)
        if flipped:
            wt = gc.flipped_weight(wt, g)
        body = gc.kernel_body(x, wt, g)
        if dt == "bfloat16" and body != "wgmma":  # every bf16 row is a RegNet or ResNeXt site
            raise AssertionError(f"group_conv3x3 {name}: bf16 runs the {body} body, not wgmma")
        got, ref = gc.group_conv3x3(x, wt, stride, g), gc.group_conv3x3_plain(x, wt, stride, g)
        torch.cuda.synchronize()
        err, scaled = _scaled_err(got, ref)
        xc = x.permute(0, 3, 1, 2)
        bench, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, True
        lib = time_ms(torch, lambda: F.conv2d(xc, wt, None, stride, 1, 1, g))
        torch.backends.cudnn.benchmark = bench
        nbytes = gc.pass_bytes(b, h, w, c, c, c // g, stride, dtype)
        ops = gc.pass_flops(b, h, w, c, c // g, stride)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dt] * 1e3
        row = {
            "phase": "kernel", "name": "group_conv3x3", "shape": name, "B": b, "H": h, "W": w,
            "C": c, "G": g, "cg": c // g, "stride": stride, "dtype": dt, "dx_weight": flipped,
            "max_abs_err": err, "scaled_err": scaled, "tol": GROUP_TOL[dt],
            "ms": time_ms(torch, lambda: gc.group_conv3x3(x, wt, stride, g)),
            "plain_ms": time_ms(torch, lambda: gc.group_conv3x3_plain(x, wt, stride, g),
                                reps=5, warmup=1, hold_cycles=OPT_HOLD_CYCLES),
            "library_ms": lib, "library": "F.conv2d(groups=G), cuDNN",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": ops, "body": body,
            "tiling": gc.plan(b * -(-h // stride) * -(-w // stride), g, c // g, c // g,
                              stride)._asdict() if body == "wgmma" else None,
        }
        row["tflops_per_s"] = ops / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(row)
        if not scaled <= GROUP_TOL[dt]:
            raise AssertionError(f"group_conv3x3 {name}: error {scaled} of the scale > "
                                 f"{GROUP_TOL[dt]}")
        rows[name] = row
        del x, wt, got, ref, xc
    return rows


def regnet_last_bn(torch, model, seed: int = 0) -> None:
    """Set every block's zero-initialised last BN scale (``conv3.bn``) to
    seeded N(1, 0.1), so the residual branch reaches the logits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(".conv3"):
                m.bn.weight.copy_(1.0 + 0.1 * torch.randn(m.bn.weight.shape, generator=gen))


def regnet_kernel_weights(model):
    """The grouped weights of the sites that run the kernel at 224²: the
    stride-1 blocks of stage 3 (14²; stages 1-2 are larger, stage 4 has
    one block, of stride 2)."""
    return [blk.conv2.conv.weight for blk in list(model.s3)[1:]]


def regnet_weights(torch, path: str) -> str:
    """regnety_160 made from RNG_SEED 0 as the trainer makes it, with
    ``regnet_last_bn``; saved to ``path`` for MODEL.WEIGHTS."""
    from distribuuuu_tpu_torch.models import build_model

    model = build_model("regnety_160", num_classes=1000,
                        generator=torch.Generator().manual_seed(0))
    regnet_last_bn(torch, model)
    torch.save(model.state_dict(), path)
    return path


def regnet_slice_phase(torch, ce, gc, dev, n_requests: int, weights: str):
    """regnety_160 serving through the port's engine on cuda:0 (bf16,
    DISTRIBUUUU_GROUP_CONV=pallas, MODEL.WEIGHTS = ``weights``): 10
    group-conv and 36 conv-epilogue launches per forward; the bf16 logits
    and the same weights in f32 on the card held against the port's f32 CPU
    forward; zeroing the grouped weights of the kernel's sites moves the f32
    logits. Returns (group-conv launches, conv-epilogue launches, the
    served model)."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    config.reset_cfg()
    config.merge_from_file("config/regnety_160.yaml")
    cfg.merge_from_list([
        "DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", 0,
        "SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8, "SERVE.BUCKET_SIZES", [1, 2, 4, 8],
        "SERVE.MAX_QUEUE", 2 * n_requests, "SERVE.MAX_WAIT_MS", 2.0, "MODEL.WEIGHTS", weights,
    ])
    im = cfg.TRAIN.IM_SIZE
    images = np.random.default_rng(0).integers(0, 256, (n_requests, im, im, 3), np.uint8)
    ce.conv1x1_bn_act.launches = gc.group_conv3x3.launches = gc.group_conv3x3.launches_dx = 0
    engine, t_build, walls, batches, logits = _serve_bursts(engine_from_cfg, images)
    counts = {"group_conv": gc.group_conv3x3.launches, "group_conv_dx": gc.group_conv3x3.launches_dx,
              "conv_epilogue": ce.conv1x1_bn_act.launches}
    stats = engine.stats()
    forwards = batches + engine.n_compiles
    fused = sum(u.fused for u in engine.model.conv_units())
    want = {"group_conv": REGNET_GROUP_SITES * forwards, "group_conv_dx": 0,
            "conv_epilogue": REGNET_FUSED_SITES * forwards}
    if fused != REGNET_FUSED_SITES or counts != want:
        raise AssertionError(f"regnety_160 serving launches {counts} != {want} ({batches} "
                             f"batches + {engine.n_compiles} warm-ups); {fused} fused sites")
    sd = {k: t.cpu() for k, t in engine.model.state_dict().items()}

    def f32_logits(device, zero=False):
        model = build_model("regnety_160", num_classes=cfg.MODEL.NUM_CLASSES,
                            dtype=torch.float32)
        model.load_state_dict(sd)
        model = model.to(device).eval()
        if zero:
            with torch.no_grad():
                for w in regnet_kernel_weights(model):
                    w.zero_()
        with torch.inference_mode():
            return np.concatenate([
                model(normalize_on_device(torch.from_numpy(images[i:i + 16]).to(device)))
                .cpu().numpy() for i in range(0, n_requests, 16)])

    torch.backends.cudnn.allow_tf32 = False
    cpu, card32, zeroed = (f32_logits(torch.device("cpu")), f32_logits(dev),
                           f32_logits(dev, zero=True))
    if logits.shape != (n_requests, cfg.MODEL.NUM_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite "
                             f"{bool(np.isfinite(logits).all())}")
    scale = float(np.abs(cpu).max())
    rel, rel32, moved = (float(np.abs(x - y).max() / scale)
                         for x, y in ((logits, cpu), (card32, cpu), (zeroed, card32)))
    top1 = float((logits.argmax(1) == cpu.argmax(1)).mean())
    res = {
        "phase": "slice", "arch": cfg.MODEL.ARCH, "group_conv": "pallas", "dtype": "bfloat16",
        "im_size": im, "requests": n_requests, "batches": stats["batches"],
        "forwards": forwards, "warmups": engine.n_compiles, "launches": counts,
        "engine_build_s": t_build, "first_burst_wall_s": walls[0],
        "first_burst_img_per_s": n_requests / walls[0],
        "img_per_s": n_requests / walls[-1], "wall_s": walls[-1],
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "batch_occupancy": stats["batch_occupancy"], "mean_batch_ms": stats["mean_batch_ms"],
        "rel_err_vs_cpu_f32": rel, "rel_tol": SLICE_REL_TOL, "top1_agreement": top1,
        "top1_min": SLICE_TOP1_MIN, "card_f32_rel_err_vs_cpu_f32": rel32,
        "card_f32_rel_tol": REGNET_F32_REL_TOL, "logits_moved_by_zeroed_kernel_weights": moved,
        "logit_scale": scale,
    }
    emit(res)
    if not (rel <= SLICE_REL_TOL and top1 >= SLICE_TOP1_MIN and rel32 <= REGNET_F32_REL_TOL
            and moved > 1e-3):
        raise AssertionError(f"regnety_160 card vs CPU logits: bf16 rel err {rel} (tol "
                             f"{SLICE_REL_TOL}), top-1 {top1}; f32 rel err {rel32} (tol "
                             f"{REGNET_F32_REL_TOL}); zeroed grouped weights moved {moved}")
    return counts["group_conv"], counts["conv_epilogue"], engine.model


def regnet_train_phase(torch, ce, gc, ou, out_dir: str, weights: str):
    """regnety_160 (config/regnety_160.yaml, batch 64, MODEL.WEIGHTS =
    ``weights`` as a warm start) under DISTRIBUUUU_GROUP_CONV=pallas: 10
    forward and 10 dx group-conv launches per step, 10 group-conv and 36
    conv-epilogue launches per eval forward."""
    def reset():
        ou.update.launches = ce.conv1x1_bn_act.launches = 0
        gc.group_conv3x3.launches = gc.group_conv3x3.launches_dx = 0

    def check(launches, steps, evals):
        want = {"group_conv": REGNET_GROUP_SITES * (steps + evals),
                "group_conv_dx": REGNET_GROUP_SITES * steps,
                "conv_epilogue": REGNET_FUSED_SITES * evals}
        got = {k: launches[k] for k in want}
        if evals != REGNET_EVAL_FORWARDS or got != want:
            raise AssertionError(f"regnety_160 launches {got} != {want} ({steps} steps, "
                                 f"{evals} eval forwards, want {REGNET_EVAL_FORWARDS})")

    # one epoch: the resume to epoch 2 is held on ResNet-50 and ViT-S
    return train_phase(torch, out_dir, "config/regnety_160.yaml",
                       ["MODEL.PRETRAINED", True, "MODEL.WEIGHTS", weights], reset,
                       lambda: {"opt_update": ou.update.launches,
                                "group_conv": gc.group_conv3x3.launches,
                                "group_conv_dx": gc.group_conv3x3.launches_dx,
                                "conv_epilogue": ce.conv1x1_bn_act.launches}, check,
                       epochs=(1,))


def resnet50_leaves(torch):
    """The shapes of ResNet-50's parameter leaves, in the model's order."""
    from distribuuuu_tpu_torch.models import build_model

    return [tuple(p.shape) for p in build_model("resnet50", num_classes=1000).parameters()]


OPT_BODIES = {  # name -> (Hyper kwargs, trace dtype)
    "sgd_nesterov_f32": (dict(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), "float32"),
    "sgd_nesterov_bf16": (dict(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), "bfloat16"),
    "sgd_no_momentum": (dict(kind="sgd", wd=5e-5, mom=0.0), None),
    "adamw": (dict(kind="adamw", wd=5e-5), "float32"),
}
OPT_FLOPS_PER_ELEM = {"sgd": 6, "sgd_plain": 4, "adamw": 16}


def _ulps(torch, a, b) -> tuple[int, int]:
    """(max ulp distance, elements that differ) of two same-dtype tensors."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    d = (a.view(view).long() - b.view(view).long()).abs()
    return int(d.max()), int((d != 0).sum())


def opt_kernel_phase(torch, ou, dev, shapes):
    """opt_update against its plain version over the ResNet-50 leaves, for
    every body: one step from the same state (bit-equal expected), then
    the kernel, the plain version and the fused torch.optim step timed
    over one whole step."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, (hkw, mdt) in OPT_BODIES.items():
        h = ou.Hyper(**hkw)

        def rnd(scale, dtype=torch.float32, positive=False):
            out = []
            for s in shapes:
                t = torch.rand(s, device=dev, generator=gen) if positive else \
                    torch.randn(s, device=dev, generator=gen)
                out.append((t * scale).to(dtype))
            return out

        p, g = rnd(0.05), rnd(0.01)
        m = None if mdt is None else rnd(0.01, getattr(torch, mdt))
        v = rnd(1e-4, positive=True) if h.kind == "adamw" else None

        def clone(ts):
            return None if ts is None else [t.clone() for t in ts]

        kp, km, kv = clone(p), clone(m), clone(v)
        scal = ou.staged_scalars(h, 0.1, 5, kp, km)
        table = ou.leaf_table(kp, g, km, kv)
        before = ou.update.launches
        ou.update(kp, g, km, kv, h, scal, table=table)
        ou.update_plain(p, g, m, v, h, scal)
        torch.cuda.synchronize()
        if ou.update.launches != before + 1:
            raise AssertionError(f"opt_update {name}: {ou.update.launches - before} launches")
        worst, n_diff = 0, 0
        for got, want in zip([*kp, *(km or []), *(kv or [])], [*p, *(m or []), *(v or [])]):
            u, n = _ulps(torch, got, want)
            worst, n_diff = max(worst, u), n_diff + n
        nbytes = ou.pass_bytes(p, m, v)
        n_elem = sum(t.numel() for t in p)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_elem * OPT_FLOPS_PER_ELEM[h.body()] / PEAK_FLOPS["float32"] * 1e3

        lib = None
        if mdt != "bfloat16":  # torch.optim has no SGD with a bf16 trace
            lp = [t.clone() for t in kp]
            for t, gt in zip(lp, g):
                t.grad = gt
            lib = (torch.optim.AdamW(lp, lr=0.1, eps=1e-8, weight_decay=5e-5, fused=True)
                   if h.kind == "adamw" else
                   torch.optim.SGD(lp, lr=0.1, momentum=h.mom, nesterov=h.nesterov,
                                   weight_decay=5e-5, fused=True))
        row = {
            "phase": "kernel", "name": "opt_update", "body": name, "leaves": len(shapes),
            "elements": n_elem, "max_ulp": worst, "elements_differing": n_diff,
            "max_abs_err": max(float((a.float() - b.float()).abs().max()) for a, b in
                               zip([*kp, *(km or []), *(kv or [])],
                                   [*p, *(m or []), *(v or [])])),
            # the wrapper checks 161 leaves in Python before each launch (about
            # 1 ms of host time): hold the stream for 20 of them
            "ms": time_ms(torch, lambda: ou.update(kp, g, km, kv, h, scal, table=table),
                          reps=20, hold_cycles=OPT_HOLD_CYCLES),
            "plain_ms": time_ms(torch, lambda: ou.update_plain(p, g, m, v, h, scal),
                                reps=5, warmup=1),
            "library_ms": None if lib is None else time_ms(torch, lib.step, reps=20,
                                                           hold_cycles=OPT_HOLD_CYCLES),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": nbytes,
        }
        emit(row)
        if worst > OPT_MAX_ULP or (worst and n_diff > OPT_MAX_ULP_ELEMS):
            raise AssertionError(f"opt_update {name}: kernel vs plain differ by up to "
                                 f"{worst} ulp in {n_diff} elements")
        rows[name] = row
        del p, g, m, v, kp, km, kv, lib, table
    return rows


def train_phase(torch, out_dir: str, yaml: str, opts: list, reset, read, check,
                epochs=(1, 2)):
    """train_model with ``yaml`` + ``opts`` on dummy data: MAX_EPOCH 1, then
    MAX_EPOCH 2 (auto-resume; ``epochs=(1,)`` runs the first epoch and its
    eval only). ``reset()`` zeroes the launch counters
    just before each run, ``read()`` returns them just after, and
    ``check(launches, steps, eval_forwards)`` raises on a count the path
    must not give. Returns the two runs' reports."""
    import math

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg

    runs = []
    for max_epoch in epochs:
        config.reset_cfg()
        config.merge_from_file(yaml)
        cfg.merge_from_list([
            "MODEL.DUMMY_INPUT", True, "DEVICE.PLATFORM", "auto",
            "DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", 0,
            "OPTIM.MAX_EPOCH", max_epoch, "OUT_DIR", out_dir, *opts,
        ])
        recs = []
        reset()
        t0 = time.perf_counter()
        trainer.train_model(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        if len(recs) != 1 or recs[0]["epoch"] != max_epoch - 1:
            raise AssertionError(f"MAX_EPOCH {max_epoch}: ran epochs "
                                 f"{[r['epoch'] + 1 for r in recs]}, wanted [{max_epoch}]")
        rec = recs[0]
        losses = rec["losses"]
        evals = -(-rec["eval_images"] // cfg.TEST.BATCH_SIZE)
        (d0, t_0), (d1, t_1) = rec["flushes"][0], rec["flushes"][-1]
        res = {
            "phase": "train", "arch": cfg.MODEL.ARCH, "max_epoch": max_epoch,
            "epoch_run": rec["epoch"] + 1, "steps": rec["steps"], "launches": launches,
            "eval_forwards": evals,
            "batch": cfg.TRAIN.BATCH_SIZE, "first_loss": losses[0],
            "loss_first8_mean": statistics.mean(losses[:8]),
            "loss_last8_mean": statistics.mean(losses[-8:]),
            "warm_steps": d1 - d0, "train_img_per_s": (d1 - d0) * cfg.TRAIN.BATCH_SIZE / (t_1 - t_0),
            "mean_step_ms": (t_1 - t_0) / (d1 - d0) * 1e3,
            "eval_images": rec.get("eval_images"), "eval_wall_s": rec.get("eval_wall_s"),
            "eval_img_per_s": rec.get("eval_images", 0) / rec.get("eval_wall_s", float("inf")),
            "acc1": rec.get("acc1"), "wall_s": wall,
        }
        emit(res)
        if rec["steps"] != TRAIN_STEPS_PER_EPOCH or launches["opt_update"] != rec["steps"]:
            raise AssertionError(f"opt_update launches {launches['opt_update']} != steps "
                                 f"{rec['steps']} (want {TRAIN_STEPS_PER_EPOCH})")
        check(launches, rec["steps"], evals)
        if len(losses) != rec["steps"] or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"losses not finite or missing: {losses}")
        if max_epoch == 1 and not res["loss_last8_mean"] < res["loss_first8_mean"]:
            raise AssertionError(f"loss did not fall over the epoch: {losses}")
        runs.append(res)
    return runs


def resnet_train_phase(torch, ce, ou, out_dir: str):
    """ResNet-50: 33 conv-epilogue launches per eval forward."""
    def reset():
        ou.update.launches = ce.conv1x1_bn_act.launches = 0

    def check(launches, steps, evals):
        if evals != EVAL_FORWARDS or launches["conv_epilogue"] != 33 * evals:
            raise AssertionError(f"conv epilogue launches {launches['conv_epilogue']} != 33 x "
                                 f"{evals} eval forwards (want {EVAL_FORWARDS})")

    return train_phase(torch, out_dir, "config/resnet50.yaml", [], reset,
                       lambda: {"opt_update": ou.update.launches,
                                "conv_epilogue": ce.conv1x1_bn_act.launches}, check)


def vit_train_phase(torch, fa, ou, out_dir: str):
    """ViT-S/16 under DEVICE.ATTN_IMPL flash: 12 forward, 12 dQ and 12
    dK/dV launches per step, 12 forward launches per eval forward."""
    def reset():
        ou.update.launches = 0
        fa.reset_launch_counts()

    def check(launches, steps, evals):
        want = {"forward": VIT_DEPTH * (steps + evals), "dq": VIT_DEPTH * steps,
                "dkdv": VIT_DEPTH * steps}
        got = {k: launches[f"flash_{k}"] for k in want}
        if evals != EVAL_FORWARDS or got != want:
            raise AssertionError(f"flash launches {got} != {want} ({steps} steps, "
                                 f"{evals} eval forwards, {VIT_DEPTH} blocks)")

    return train_phase(torch, out_dir, "config/vit_small.yaml", ["DEVICE.ATTN_IMPL", "flash"],
                       reset, lambda: {"opt_update": ou.update.launches,
                                       **{f"flash_{k}": n
                                          for k, n in fa.launch_counts().items()}}, check)


def step_vs_cpu_phase(torch, dev, arch: str = "resnet50", batch: int = 4, tweak=None,
                      reach=None, host=None, hyper=None, lr: float = 0.1,
                      num_classes: int = 1000, defer: bool = False, **model_kw):
    """One f32 train step of ``arch`` (full width, TF32 off) on the card
    and on the port's CPU path, and one f64 step on the CPU, from the same
    weights and batch. The card's update agrees with the CPU's f32 update
    within STEP_UPDATE_L2_TOL, relative in the L2 norm over all
    parameters, and lies within STEP_F64_RATIO_MAX times the CPU f32
    update's distance from the f64 update. ``tweak(model)`` edits the
    weights before the step (the same in all three runs); ``reach(model)``
    names the weights whose zeroing must move the card's train-mode
    logits (on a copy, before the step). ``host`` is the batch (default
    seeded 224² uint8 images), ``hyper`` and ``lr`` the optimizer's
    (default SGD Nesterov at 0.1). With ``defer`` the card's step runs now
    and the function returned runs the two CPU steps and the checks (the
    caller runs it beside phases that read no time); the steps read
    ``RNG_SEED`` and ``DATA.DEVICE_NORMALIZE`` from the global config,
    which those phases leave at 0 and True."""
    import copy

    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    from distribuuuu_tpu_torch.utils.optim import Optimizer

    config.reset_cfg()
    if host is None:
        rng = np.random.default_rng(1)
        host = {"image": torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), np.uint8)),
                "label": torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int32))}
    hyper = hyper or ou.Hyper(kind="sgd", wd=5e-5, mom=0.9, nesterov=True)
    cpu = torch.device("cpu")
    deltas, losses, names = [], [], []
    moved = None

    def one(device, dtype):
        nonlocal moved
        model = build_model(arch, num_classes=num_classes, dtype=dtype,
                            generator=torch.Generator().manual_seed(0), **model_kw)
        if tweak is not None:
            tweak(model)
        model = model.to(device, dtype)
        if reach is not None and device.type == "cuda":
            probe, x = copy.deepcopy(model).train(), trainer.prep_images(
                host["image"].to(device))
            with torch.no_grad():
                full = probe(x)
                for w in reach(probe):
                    w.zero_()
                moved = float((probe(x) - full).abs().max() / full.abs().max())
            if not moved > 1e-3:
                raise AssertionError(f"{arch}: zeroing the kernel's weights moved the "
                                     f"logits by {moved} of their scale")
            del probe
        names[:] = [n for n, _ in model.named_parameters()]
        before = [p.detach().cpu().clone() for p in model.parameters()]
        opt = Optimizer(list(model.named_parameters()), hyper, lr)
        m = trainer.train_step(model.train(), opt, {k: v.to(device) for k, v in host.items()},
                               5)
        losses.append(float(m["loss"]))
        deltas.append([p.detach().cpu().double() - b.double()
                       for p, b in zip(model.parameters(), before)])
        del model, opt

    def l2_rel(xs, ys):
        return float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(xs, ys))
                                / sum((y ** 2).sum() for y in ys)))

    def finish() -> None:
        """The CPU half: its f32 and f64 steps, the comparison, the row."""
        one(cpu, torch.float32)
        one(cpu, torch.float64)
        card, cpu32, cpu64 = deltas
        upd_l2, card_f64 = l2_rel(card, cpu32), l2_rel(card, cpu64)
        cpu_f64 = l2_rel(cpu32, cpu64)
        per_tensor = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                      for a, b in zip(card, cpu32)]
        worst = max(range(len(names)), key=per_tensor.__getitem__)
        res = {"phase": "step_vs_cpu", "arch": arch, "batch": batch, "dtype": "float32",
               "logits_moved_by_zeroed_kernel_weights": moved if reach is not None else None,
               "loss_card": losses[0], "loss_cpu": losses[1], "loss_cpu_f64": losses[2],
               "update_l2_rel_err": upd_l2, "update_l2_tol": STEP_UPDATE_L2_TOL,
               "card_vs_f64_update_l2": card_f64, "cpu_f32_vs_f64_update_l2": cpu_f64,
               "update_rel_err_median_tensor": float(np.median(per_tensor)),
               "update_rel_err_worst_tensor": [names[worst], per_tensor[worst]]}
        emit(res)
        if not (upd_l2 <= STEP_UPDATE_L2_TOL and card_f64 <= STEP_F64_RATIO_MAX * cpu_f64):
            raise AssertionError(f"{arch} f32 step card vs CPU: update L2 rel err {upd_l2} (tol "
                                 f"{STEP_UPDATE_L2_TOL}); from f64: card {card_f64}, CPU f32 "
                                 f"{cpu_f64} (ratio max {STEP_F64_RATIO_MAX})")

    one(dev, torch.float32)
    if defer:
        return finish
    finish()


# the real-data phase's ImageFolder: ImageNet-like JPEGs (quality 90, sides
# drawn in 300-500) of 8 classes, 96 train and 25 val a class, made from
# seed 0 with colours separable by class; trained at resnet50.yaml's batch
# 32 (24 steps) and evaluated at its batch 200 (one forward)
REAL_CLASSES, REAL_TRAIN, REAL_VAL = 8, 96, 25
REAL_STEPS = REAL_CLASSES * REAL_TRAIN // 32
REAL_WINDOW = (8, 24)  # train img/s and the loader's share between these flushes
# the native decoder against PIL on the same files: the resampler's
# bound in uint8 counts (the port's tests hold 3/255 / min(std) normalized)
NATIVE_U8_BOUND = 3
# two ranks on one card against one process at the global batch. In f64
# (one forward and backward: the gradients after the all-reduce and the
# running stats) each tensor within TWO_RANK_F64_TOL of its largest
# magnitude, the bound of tests/test_torch_ddp.py. In f32 (two train steps
# through the fused update) the ranks are bitwise equal and the first
# step's loss is within f32 rounding of the one process's; the updated
# weights are reported, not bounded: after two f32 steps two ranks and
# one process differ by about 0.15 in the L2 norm of the update and up
# to 0.31 of a tensor's largest magnitude, and one process's own f32
# steps and a CPU f64 run of them by up to 0.30 (ReLU and max-pool
# decisions flip on rounding at random init, and the second step carries
# the first's differences), so no f32 bound separates a fault from
# rounding there
TWO_RANK_F64_TOL = 1e-7
TWO_RANK_LOSS_RTOL = 1e-6
TWO_RANK_BATCH, TWO_RANK_STEPS, TWO_RANK_GHOST = 16, 2, 16


def make_image_tree(root: str, seed: int = 0, n_train: int = REAL_TRAIN,
                    n_val: int = REAL_VAL) -> str:
    """``root/{train,val}/cNN/*.jpg``: REAL_CLASSES classes of ``n_train``
    and ``n_val`` JPEGs. Each image is a smooth random field (an 8x8 draw
    resized) blended with its class's colour plus fine noise, so it
    compresses like a photograph and its class shows in its colour."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (REAL_CLASSES, 3))
    jobs = []
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(REAL_CLASSES):
            os.makedirs(os.path.join(root, split, f"c{c:02d}"))
            for i in range(n):
                w, h = (int(v) for v in rng.integers(300, 501, 2))
                jobs.append((os.path.join(root, split, f"c{c:02d}", f"{i:04d}.jpg"), w, h,
                             colours[c], rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                             int(rng.integers(1 << 30))))

    def write(job):
        path, w, h, colour, field, noise_seed = job
        smooth = np.asarray(Image.fromarray(field).resize((w, h), Image.BILINEAR), np.float32)
        noise = np.random.default_rng(noise_seed).normal(0, 8, (h, w, 3))
        arr = 0.5 * smooth + 0.5 * colour + noise
        Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(path, "JPEG", quality=90)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(write, jobs))
    return root


def world1_env() -> None:
    """The environment of a one-process launch, as ``torchrun
    --nproc_per_node 1`` sets it: ``setup_distributed`` joins a group of one."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")


def leave_world1(dist) -> None:
    dist.shutdown_distributed()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(k, None)


def syncbn_world1_phase(torch, dev, batch: int = 8):
    """One f32 ResNet-50 step (full width, TF32 off, cuDNN deterministic)
    with ``BN_GROUP 0`` and no process group, then with ``MODEL.SYNCBN``
    in a one-process NCCL group, whose BatchNorm all-reduces its sums
    and whose gradients and metrics are all-reduced: the two must be
    bitwise equal (the collective runs and is the identity). Leaves the
    group up for the real-data phase."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    from distribuuuu_tpu_torch.parallel import dist
    from distribuuuu_tpu_torch.utils.optim import Optimizer

    rng = np.random.default_rng(3)
    host = {"image": torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int32))}
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def step(opts):
        config.reset_cfg()
        config.merge_from_file("config/resnet50.yaml")
        cfg.merge_from_list(["DEVICE.COMPUTE_DTYPE", "float32", "RNG_SEED", 0,
                             "TRAIN.BATCH_SIZE", batch, *opts])
        model = trainer.build_model_from_cfg().to(dev).train()
        opt = Optimizer(list(model.named_parameters()),
                        ou.Hyper(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), 0.1)
        m = trainer.train_step(model, opt, {k: v.to(dev) for k, v in host.items()}, 5)
        return float(m["loss"]), {k: v.detach().cpu() for k, v in model.state_dict().items()}

    calls = {"n": 0}
    real = torch.distributed.all_reduce

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    try:
        alone = step(["MODEL.BN_GROUP", 0])
        world1_env()
        torch.cuda.set_device(dev)
        dist.setup_distributed("nccl")
        torch.distributed.all_reduce = counted
        try:
            synced = step(["MODEL.SYNCBN", True])
        finally:
            torch.distributed.all_reduce = real
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    differ = [k for k in alone[1] if not torch.equal(alone[1][k], synced[1][k])]
    res = {"phase": "syncbn_world1", "arch": "resnet50", "batch": batch, "dtype": "float32",
           "backend": torch.distributed.get_backend(), "world": dist.get_world_size(),
           "all_reduces_in_step": calls["n"], "loss_alone": alone[0], "loss_syncbn": synced[0],
           "tensors": len(alone[1]), "tensors_not_bitwise_equal": len(differ),
           "bitwise_equal": not differ and alone[0] == synced[0]}
    emit(res)
    if calls["n"] < 53 or not res["bitwise_equal"]:  # 53 BatchNorms, each all-reduces
        raise AssertionError(f"SyncBN at world 1: {calls['n']} all-reduces, not bitwise "
                             f"equal in {differ[:5]} (loss {alone[0]} vs {synced[0]})")
    return res


def realdata_phase(torch, ce, ou, root: str, out_dir: str, dummy_img_per_s: float):
    """``trainer.train_model`` on the ImageFolder at ``root``:
    config/resnet50.yaml at full width (bf16, batch 32), DATA.BACKEND auto,
    TRAIN.WORKERS = the host's cores, in the process group the environment
    names, one epoch of REAL_STEPS steps and the eval of the val split.
    Then the train loader alone, and, when the native decoder builds, its
    uint8 batches against PIL's on the same files."""
    import math

    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import native, trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data import loader as dl
    from distribuuuu_tpu_torch.data.imagefolder import ImageFolderDataset
    from distribuuuu_tpu_torch.parallel import dist

    config.reset_cfg()
    config.merge_from_file("config/resnet50.yaml")
    cfg.merge_from_list([
        "TRAIN.DATASET", root, "TEST.DATASET", root, "DEVICE.PLATFORM", "auto",
        "DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", 0, "OPTIM.MAX_EPOCH", 1,
        "OUT_DIR", out_dir, "DATA.BACKEND", "auto", "TRAIN.WORKERS", os.cpu_count(),
        "TRAIN.PRINT_FREQ", REAL_WINDOW[0],
    ])
    recs = []
    ou.update.launches = ce.conv1x1_bn_act.launches = 0
    t0 = time.perf_counter()
    trainer.train_model(recs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"opt_update": ou.update.launches, "conv_epilogue": ce.conv1x1_bn_act.launches}
    rec = recs[0]
    flush = dict(rec["flushes"])
    (d0, d1) = REAL_WINDOW
    window = flush[d1] - flush[d0]
    evals = -(-rec["eval_images"] // cfg.TEST.BATCH_SIZE)

    loader = dl.construct_train_loader()
    loader.set_epoch(0)
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader)
    loader_s = time.perf_counter() - t0

    res = {
        "phase": "realdata_train", "arch": "resnet50", "world": dist.get_world_size(),
        "dist_backend": torch.distributed.get_backend() if dist.is_initialized() else None,
        "decode_backend": rec["backend"], "workers": cfg.TRAIN.WORKERS,
        "classes": REAL_CLASSES, "train_images": REAL_CLASSES * REAL_TRAIN,
        "val_images": rec["eval_images"], "batch": cfg.TRAIN.BATCH_SIZE, "steps": rec["steps"],
        "window_steps": list(REAL_WINDOW),
        "train_img_per_s": (d1 - d0) * cfg.TRAIN.BATCH_SIZE * dist.get_world_size() / window,
        "mean_step_ms": window / (d1 - d0) * 1e3,
        "loader_wait_share": sum(rec["data_wait_s"][d0:d1]) / window,
        "eval_img_per_s": rec["eval_images"] / rec["eval_wall_s"],
        "loader_img_per_s": n / loader_s, "loader_images": n,
        "dummy_train_img_per_s": dummy_img_per_s,
        "launches": launches, "eval_forwards": evals,
        "first_loss": rec["losses"][0], "last_loss": rec["losses"][-1],
        "acc1": rec["acc1"], "wall_s": wall,
    }
    if native.available():
        worst = []
        for train in (True, False):
            split, im = ("train", 224) if train else ("val", 256)
            kw = dict(im_size=im, train=train, crop_size=None if train else 224, raw_u8=True)
            a, _ = ImageFolderDataset(root, split, backend="native", **kw).load_batch(range(32))
            b, _ = ImageFolderDataset(root, split, backend="pil", **kw).load_batch(range(32))
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            worst.append({"split": split, "max_abs": int(d.max()), "mean_abs": float(d.mean())})
        res["native_vs_pil_u8"] = worst
    else:
        res["native_build_error"] = native.build_error()
    emit(res)
    if not all(math.isfinite(x) for x in rec["losses"]) or len(rec["losses"]) != rec["steps"]:
        raise AssertionError(f"real-data losses not finite or missing: {rec['losses']}")
    if rec["steps"] != REAL_STEPS or launches["opt_update"] != REAL_STEPS:
        raise AssertionError(f"{rec['steps']} steps, {launches['opt_update']} opt_update "
                             f"launches (want {REAL_STEPS} each)")
    if launches["conv_epilogue"] != 33 * evals or not evals:
        raise AssertionError(f"conv epilogue launches {launches['conv_epilogue']} != 33 x "
                             f"{evals} eval forwards")
    if any(w["max_abs"] > NATIVE_U8_BOUND for w in res.get("native_vs_pil_u8", [])):
        raise AssertionError(f"native decoder vs PIL past {NATIVE_U8_BOUND} counts: "
                             f"{res['native_vs_pil_u8']}")
    return res


# the shards phases: the realdata tree packed by the port's packer into
# about SHARDS_PARTS shards a split (at least SHARDS_MIN_PARTS for train),
# trained and evaluated as realdata_train is (with LOOP_OPTS after the
# yaml); then train_net drills on the pack
SHARDS_PARTS, SHARDS_MIN_PARTS = 6, 4
# the exact-resume drill: SIGTERM at this batch of epoch 1; the step of
# that batch still runs (the flag is read at the step boundary, as in the
# JAX package), so the preempted run trains SHARDS_PREEMPT_AT + 1 batches
SHARDS_PREEMPT_AT = 10
SHARDS_TRUNCATE = 1  # the shard FAULTS.TRUNCATE_SHARD cuts


def pack_phase(root: str, out: str) -> dict:
    """Packs the ImageFolder at ``root`` with the port's packer (its
    command line's ``main``) at a target of 1/SHARDS_PARTS of the train
    split's bytes, then ``verify_split`` on each split."""
    from distribuuuu_tpu_torch.data.shards import format as shards_format
    from distribuuuu_tpu_torch.data.shards import pack

    train_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(os.path.join(root, "train")) for f in fs)
    shard_mb = train_bytes / SHARDS_PARTS / (1024 * 1024)
    t0 = time.perf_counter()
    if pack.main(["--src", root, "--out", out, "--shard-mb", f"{shard_mb:.6f}"]) != 0:
        raise AssertionError("the packer failed")
    pack_s = time.perf_counter() - t0
    splits = {}
    for split in ("train", "val"):
        man = shards_format.read_shard_manifest(os.path.join(out, split))
        ok, problems = shards_format.verify_split(os.path.join(out, split))
        splits[split] = {"records": man["num_records"], "shards": len(man["shards"]),
                         "bytes": sum(s["size"] for s in man["shards"]), "verified": ok,
                         "problems": problems}
    res = {"phase": "shards_pack", "target_mb": shard_mb, "pack_s": pack_s, "splits": splits}
    emit(res)
    if not all(s["verified"] for s in splits.values()) \
            or splits["train"]["shards"] < SHARDS_MIN_PARTS:
        raise AssertionError(f"shards pack: {res}")
    return res


def shards_train_phase(torch, ce, ou, root: str, out_dir: str, real: dict) -> dict:
    """``trainer.train_model`` on the pack of the realdata tree
    (``DATA.FORMAT shards``), config/resnet50.yaml at full width (bf16,
    batch 32), DATA.BACKEND auto, TRAIN.WORKERS = the host's cores, in the
    process group the environment names: 24 steps, then the eval of the
    200 val images, measured as realdata_train is and beside its img/s.
    Then the shard train loader alone, and its first batch as uint8 held
    byte for byte against the ImageFolder dataset's batch of the same
    samples, seed and epoch."""
    import math

    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data import loader as dl
    from distribuuuu_tpu_torch.data.imagefolder import ImageFolderDataset
    from distribuuuu_tpu_torch.parallel import dist

    t_phase = time.perf_counter()
    pack_root = os.path.join(out_dir, "pack")
    packed = pack_phase(root, pack_root)
    config.reset_cfg()
    config.merge_from_file("config/resnet50.yaml")
    cfg.merge_from_list([
        "DATA.FORMAT", "shards", "TRAIN.DATASET", pack_root, "TEST.DATASET", pack_root,
        "DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", 0,
        "OPTIM.MAX_EPOCH", 1, "OUT_DIR", os.path.join(out_dir, "out"), "DATA.BACKEND", "auto",
        "TRAIN.WORKERS", os.cpu_count(), "TRAIN.PRINT_FREQ", REAL_WINDOW[0], *LOOP_OPTS,
    ])
    loaders = []
    build = {name: getattr(trainer, name)
             for name in ("construct_train_loader", "construct_val_loader")}
    for name, fn in build.items():  # keep the run's loaders, for their tallies
        setattr(trainer, name, lambda fn=fn: loaders.append(fn()) or loaders[-1])
    recs = []
    ou.update.launches = ce.conv1x1_bn_act.launches = 0
    t0 = time.perf_counter()
    try:
        trainer.train_model(recs)
        torch.cuda.synchronize()
    finally:
        for name, fn in build.items():
            setattr(trainer, name, fn)
    wall = time.perf_counter() - t0
    launches = {"opt_update": ou.update.launches, "conv_epilogue": ce.conv1x1_bn_act.launches}
    rec = recs[0]
    flush = dict(rec["flushes"])
    (d0, d1) = REAL_WINDOW
    window = flush[d1] - flush[d0]
    evals = -(-rec["eval_images"] // cfg.TEST.BATCH_SIZE)
    reads = {split: {"records": ld.dataset.records_read, "bytes": ld.dataset.bytes_read}
             for split, ld in zip(("train", "val"), loaders)}

    loader = dl.construct_train_loader()
    loader.set_epoch(0)
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader)
    loader_s = time.perf_counter() - t0
    loader.set_epoch(0)
    first = next(iter(loader))
    idxs = loader.sampler.indices()[:cfg.TRAIN.BATCH_SIZE]
    folder = ImageFolderDataset(root, "train", im_size=cfg.TRAIN.IM_SIZE, train=True,
                                base_seed=cfg.RNG_SEED, backend=cfg.DATA.BACKEND, raw_u8=True)
    folder.set_epoch_seed(0)
    want, want_labels = folder.load_batch(idxs, n_threads=cfg.TRAIN.WORKERS)
    same = (first["image"].dtype == np.uint8 and np.array_equal(first["image"], want)
            and np.array_equal(first["label"], want_labels))

    res = {
        "phase": "shards_train", "arch": cfg.MODEL.ARCH, "world": dist.get_world_size(),
        "dist_backend": torch.distributed.get_backend() if dist.is_initialized() else None,
        "decode_backend": rec["backend"], "workers": cfg.TRAIN.WORKERS,
        "train_shards": packed["splits"]["train"]["shards"],
        "val_shards": packed["splits"]["val"]["shards"],
        "train_images": packed["splits"]["train"]["records"], "val_images": rec["eval_images"],
        "batch": cfg.TRAIN.BATCH_SIZE, "steps": rec["steps"], "window_steps": list(REAL_WINDOW),
        "train_img_per_s": (d1 - d0) * cfg.TRAIN.BATCH_SIZE * dist.get_world_size() / window,
        "realdata_train_img_per_s": real["train_img_per_s"],
        "mean_step_ms": window / (d1 - d0) * 1e3,
        "loader_wait_share": sum(rec["data_wait_s"][d0:d1]) / window,
        "eval_img_per_s": rec["eval_images"] / rec["eval_wall_s"],
        "loader_img_per_s": n / loader_s, "loader_images": n,
        "realdata_loader_img_per_s": real["loader_img_per_s"], "reads": reads,
        "first_batch_equals_imagefolder_u8": same, "launches": launches, "eval_forwards": evals,
        "first_loss": rec["losses"][0], "last_loss": rec["losses"][-1], "acc1": rec["acc1"],
        "wall_s": wall,
    }
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    if not all(math.isfinite(x) for x in rec["losses"]) or len(rec["losses"]) != rec["steps"]:
        raise AssertionError(f"shards losses not finite or missing: {rec['losses']}")
    if rec["steps"] != REAL_STEPS or launches["opt_update"] != REAL_STEPS:
        raise AssertionError(f"{rec['steps']} steps, {launches['opt_update']} opt_update "
                             f"launches (want {REAL_STEPS} each)")
    if launches["conv_epilogue"] != LOOP_FUSED_SITES * evals or not evals:
        raise AssertionError(f"conv epilogue launches {launches['conv_epilogue']} != "
                             f"{LOOP_FUSED_SITES} x {evals} eval forwards")
    if reads["train"]["records"] < REAL_STEPS * cfg.TRAIN.BATCH_SIZE \
            or reads["val"]["records"] != rec["eval_images"]:
        raise AssertionError(f"records read {reads}")
    if not same:
        raise AssertionError("the shard loader's first uint8 batch differs from the "
                             "ImageFolder's of the same samples")
    return {**res, "pack_root": pack_root}


def counted_train_net(counts_path: str, args: list) -> int:
    """``train_net``'s main on ``args`` in this process (``--counted-train-net
    COUNTS ARGS...``), the launch counts set to 0 just before and written
    to ``COUNTS`` (JSON) after, also when it raises."""
    from distribuuuu_tpu_torch import train_net
    from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou

    ou.update.launches = ce.conv1x1_bn_act.launches = 0
    try:
        train_net.main(args)
    finally:
        with open(counts_path, "w") as f:
            json.dump({"opt_update": ou.update.launches,
                       "conv_epilogue": ce.conv1x1_bn_act.launches}, f)
    return 0


def shards_exact_resume_phase(torch, pack_root: str, work: str) -> dict:
    """``train_net`` subprocesses on the pack, all at once: one
    uninterrupted epoch; the same epoch preempted by FAULTS.PREEMPT_AT_BATCH
    and rerun, which must log that it continues at the next batch, launch
    opt_update once for each batch left, and end bitwise on the
    uninterrupted run's parameters, BN buffers and momentum (cuDNN
    deterministic); FAULTS.TRUNCATE_SHARD on a copy of the pack, whose
    forward-scan recovery is logged with its counts and whose lost records
    are substituted (DATA.SKIP_CORRUPT) as the epoch finishes, and the same
    with DATA.SKIP_CORRUPT False, which must fail-stop."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from distribuuuu_tpu_torch.data.shards import format as shards_format
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    man = shards_format.read_shard_manifest(os.path.join(pack_root, "train"))
    victim = man["shards"][SHARDS_TRUNCATE]
    preempt_opts = ["FAULTS.ENABLED", True, "FAULTS.PREEMPT_EPOCH", 0,
                    "FAULTS.PREEMPT_AT_BATCH", SHARDS_PREEMPT_AT]

    def run(name, *opts, pack=pack_root):
        t0 = time.perf_counter()
        rc, log, launches = _train_net(pack, os.path.join(work, name), "DATA.FORMAT",
                                       "shards", "OPTIM.MAX_EPOCH", 1, "CUDNN.DETERMINISTIC",
                                       True, "CUDNN.BENCHMARK", False, *opts)
        return {"rc": rc, "launches": launches, "seconds": time.perf_counter() - t0}, log

    def straight():
        return run("straight")

    def preempted():
        first, log1 = run("preempted", *preempt_opts)
        if first["rc"] != 0:
            return {"first": first, "log_tail": log1[-3000:]}, ""
        second, log2 = run("preempted")
        return {"first": first, "second": second}, log2

    def truncated(skip):
        copy = os.path.join(work, f"pack_skip{int(skip)}")
        shutil.copytree(pack_root, copy)
        return run(f"truncated_skip{int(skip)}", "FAULTS.ENABLED", True,
                   "FAULTS.TRUNCATE_SHARD", SHARDS_TRUNCATE, "DATA.SKIP_CORRUPT", skip,
                   pack=copy)

    with ThreadPoolExecutor(4) as pool:
        jobs = {"straight": pool.submit(straight), "preempted": pool.submit(preempted),
                "truncated_skip": pool.submit(truncated, True),
                "truncated_failstop": pool.submit(truncated, False)}
        out = {k: f.result() for k, f in jobs.items()}
    runs, logs = {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}

    steps = REAL_STEPS
    done = SHARDS_PREEMPT_AT + 1  # the batch the signal arrives at still trains
    resume_line = f"continuing epoch 1 at batch {done + 1}/{steps}"
    recovered = (f"of {victim['records']} records by forward scan")
    checks = {
        "straight_ok": runs["straight"]["rc"] == 0
        and runs["straight"]["launches"]["opt_update"] == steps,
        "preempted_launches": "second" in runs["preempted"]
        and runs["preempted"]["first"]["launches"]["opt_update"] == done
        and runs["preempted"]["second"]["rc"] == 0
        and runs["preempted"]["second"]["launches"]["opt_update"] == steps - done,
        "resume_logged": resume_line in logs["preempted"],
        "truncated_recovery_logged": recovered in logs["truncated_skip"]
        and "corrupt sample" in logs["truncated_skip"]
        and "epoch 1 done" in logs["truncated_skip"],
        "truncated_skip_ok": runs["truncated_skip"]["rc"] == 0
        and runs["truncated_skip"]["launches"]["opt_update"] == steps,
        "failstop_nonzero": runs["truncated_failstop"]["rc"] != 0
        and "fail-stop" in logs["truncated_failstop"],
    }
    differ, tensors = [], 0
    if checks["straight_ok"] and checks["preempted_launches"]:
        a = torch.load(os.path.join(work, "straight", "checkpoints", "ckpt_ep_000.pth"),
                       weights_only=True)
        b = torch.load(os.path.join(work, "preempted", "checkpoints", "ckpt_ep_000.pth"),
                       weights_only=True)
        pairs = [(f"model/{k}", v, b["model"][k]) for k, v in a["model"].items()]
        pairs += [(f"m/{k}", v, b["opt"]["m"][k]) for k, v in a["opt"]["m"].items()]
        differ = [k for k, x, y in pairs if not torch.equal(x, y)]
        tensors = len(pairs)
        checks["bitwise_equal"] = not differ and a["step"] == b["step"] == steps
    counted = [r for r in (runs["straight"], runs["truncated_skip"],
                           runs["truncated_failstop"], runs["preempted"].get("first"),
                           runs["preempted"].get("second")) if r and r["launches"]]
    launches = {k: sum(r["launches"][k] for r in counted)
                for k in ("opt_update", "conv_epilogue")}
    if not all(checks.values()):
        for k, log in logs.items():
            runs[k]["log_tail"] = log[-1500:]
    res = {"phase": "shards_exact_resume", "arch": LOOP_ARCH, "steps": steps,
           "preempt_at_batch": SHARDS_PREEMPT_AT, "batches_before_preemption": done,
           "truncated_shard": victim["file"], "truncated_shard_records": victim["records"],
           "runs": runs, "checks": checks, "tensors": tensors,
           "tensors_not_bitwise_equal": len(differ), "first_differing": differ[:5],
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    emit(res)
    if not all(checks.values()) or "bitwise_equal" not in checks:
        raise AssertionError(f"shards exact resume: {checks}")
    return res


def seeded_bn(torch, model, seed: int = 0) -> None:
    """Every BatchNorm away from its init, as tests/torch_port_util.
    random_variables sets them (scale about 0.4, bias and mean about
    0.1, variance in 0.5-1.5): at scale 1 / bias 0, and with the
    zero-initialised last BN of each block, a random ResNet-50's f32
    gradient cancels in its deep BN biases, and the comparison would
    measure that cancellation, not the two ranks."""
    from distribuuuu_tpu_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.4 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))


def _two_rank_batches(seed: int = 4):
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 2 * TWO_RANK_BATCH
    return [(rng.integers(0, 256, (n, 224, 224, 3), np.uint8),
             rng.integers(0, 1000, n).astype(np.int32)) for _ in range(TWO_RANK_STEPS)]


def _two_rank_train(torch, dev, bn_group: int, part: slice, steps: int = TWO_RANK_STEPS):
    """``steps`` f32 ResNet-50 train steps on ``part`` of each batch; the
    losses and the state after them on the CPU."""
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    from distribuuuu_tpu_torch.utils.optim import Optimizer

    model = build_model("resnet50", num_classes=1000, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0), bn_group=bn_group)
    seeded_bn(torch, model)
    model = model.to(dev).train()
    opt = Optimizer(list(model.named_parameters()),
                    ou.Hyper(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), 0.1)
    losses = []
    for images, labels in _two_rank_batches()[:steps]:
        batch = {"image": torch.from_numpy(images[part]).to(dev),
                 "label": torch.from_numpy(labels[part]).to(dev)}
        losses.append(float(trainer.train_step(model, opt, batch, 5)["loss"]))
    return losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _two_rank_grads(torch, dev, bn_group: int, part: slice):
    """One f64 forward and backward of ResNet-50 on ``part`` of the first
    batch, the gradients averaged over the process group (when there is
    one), and the running stats; all on the CPU."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.parallel import dist
    from distribuuuu_tpu_torch.utils.metrics import cross_entropy

    model = build_model("resnet50", num_classes=1000, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0), bn_group=bn_group)
    seeded_bn(torch, model)
    model = model.to(dev, torch.float64).train()
    images, labels = _two_rank_batches()[0]
    logits = model(trainer.prep_images(torch.from_numpy(images[part]).to(dev)))
    loss = cross_entropy(logits, torch.from_numpy(labels[part]).to(dev))
    names = [n for n, _ in model.named_parameters()]
    grads = list(torch.autograd.grad(loss, [p for _, p in model.named_parameters()]))
    dist.all_reduce_grads(grads)
    out = {f"grad:{n}": g.detach().cpu() for n, g in zip(names, grads)}
    out.update({f"buffer:{n}": b.detach().cpu() for n, b in model.named_buffers()})
    return out


def two_ranks_worker(out_dir: str) -> int:
    """One rank of ``two_ranks_one_card_phase`` (``--two-ranks-worker``):
    gloo on ``cuda:0``, SyncBN then ghost groups of TWO_RANK_GHOST, each
    in f32 (train steps) and f64 (gradients)."""
    import torch

    from distribuuuu_tpu_torch.parallel import dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.setup_distributed("gloo", timeout_s=600)
    r = dist.get_rank()
    part = slice(r * TWO_RANK_BATCH, (r + 1) * TWO_RANK_BATCH)
    for group in (0, TWO_RANK_GHOST):
        torch.save(_two_rank_train(torch, dev, group, part),
                   os.path.join(out_dir, f"rank{r}_g{group}.pt"))
        torch.save(_two_rank_grads(torch, dev, group, part),
                   os.path.join(out_dir, f"rank{r}_g{group}_f64.pt"))
    dist.shutdown_distributed()
    return 0


def _worst_rel(torch, got: dict, want: dict):
    """(largest |got − want| / max |want| over the floating tensors, its key)."""
    worst, key = 0.0, None
    for k, w in want.items():
        if w.is_floating_point():
            err = float((got[k].double() - w.double()).abs().max()
                        / w.double().abs().max().clamp_min(1e-30))
            if err > worst:
                worst, key = err, k
    return worst, key


def two_ranks_one_card_phase(torch, dev):
    """Two processes share ``cuda:0`` over gloo (NCCL refuses two ranks on
    one card): ResNet-50 with BN params seeded away from their init,
    TWO_RANK_BATCH a rank, SyncBN and then ghost groups of TWO_RANK_GHOST
    (a rank's batch), against one process at the global batch on the card:
    f64 gradients and running stats within TWO_RANK_F64_TOL of each
    tensor's largest magnitude; TWO_RANK_STEPS f32 train steps with the
    two ranks bitwise equal and the first loss within TWO_RANK_LOSS_RTOL
    (the updates' L2 and per-tensor differences are reported)."""
    import shutil
    import socket

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_two_ranks_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "2"}
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--two-ranks-worker", out_dir],
                cwd=here, env={**env, "RANK": str(r), "LOCAL_RANK": "0"}))
        t0 = time.perf_counter()
        full = slice(0, 2 * TWO_RANK_BATCH)
        ref = {g: (_two_rank_train(torch, dev, g, full), _two_rank_grads(torch, dev, g, full))
               for g in (0, TWO_RANK_GHOST)}
        for p in procs:
            if p.wait(timeout=900):
                raise AssertionError(f"two-rank worker exited {p.returncode}")
        wall = time.perf_counter() - t0
        init = _two_rank_train(torch, dev, 0, slice(0, 0), steps=0)[1]
        rows = {}
        for g, ((ref_losses, ref_state), ref_grads) in ref.items():
            (l0, s0), (l1, s1) = (torch.load(os.path.join(out_dir, f"rank{r}_g{g}.pt"),
                                             weights_only=True) for r in range(2))
            g0, g1 = (torch.load(os.path.join(out_dir, f"rank{r}_g{g}_f64.pt"),
                                 weights_only=True) for r in range(2))
            keys = [k for k in ref_state if ref_state[k].is_floating_point()]
            upd = [(s0[k].double() - init[k].double(), ref_state[k].double() - init[k].double())
                   for k in keys]
            f64_worst, f64_key = _worst_rel(torch, g0, ref_grads)
            f32_worst, f32_key = _worst_rel(torch, s0, ref_state)
            rows["syncbn" if g == 0 else f"ghost{g}"] = {
                "f64_worst_rel_err": f64_worst, "f64_worst": f64_key,
                "f64_ranks_not_bitwise_equal": sum(not torch.equal(g0[k], g1[k]) for k in g0),
                "losses_ranks": l0, "losses_one_process": ref_losses,
                "update_l2_rel_err": float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in upd)
                                                      / sum((b ** 2).sum() for _, b in upd))),
                "f32_worst_tensor_rel_err": f32_worst, "f32_worst_tensor": f32_key,
                "ranks_not_bitwise_equal": sum(not torch.equal(s0[k], s1[k]) for k in s0),
                "losses_rank1": l1}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"phase": "two_ranks_one_card", "arch": "resnet50", "dist_backend": "gloo",
           "ranks": 2, "batch_per_rank": TWO_RANK_BATCH, "steps": TWO_RANK_STEPS,
           "f64_tol": TWO_RANK_F64_TOL, "loss_rtol": TWO_RANK_LOSS_RTOL, "wall_s": wall,
           **rows}
    emit(res)
    for name, row in rows.items():
        first = abs(row["losses_ranks"][0] - row["losses_one_process"][0])
        if (row["f64_worst_rel_err"] > TWO_RANK_F64_TOL or row["f64_ranks_not_bitwise_equal"]
                or row["ranks_not_bitwise_equal"] or row["losses_rank1"] != row["losses_ranks"]
                or first > TWO_RANK_LOSS_RTOL * abs(row["losses_one_process"][0])):
            raise AssertionError(f"two ranks on one card, {name}: {row}")
    return res


# ------------------------------------------------------------ the train loop
# an accumulated step against the ghost-group step, and a remat step
# against the plain one, at f64: each parameter, momentum trace (and, for
# remat, running stat) within LOOP_F64_TOL of its tensor's largest
# magnitude. The pairs compute the same means in exact arithmetic; in f64
# they differ only in the order of the sums (remat: not even that)
LOOP_F64_TOL = 1e-10
LOOP_TIMED_STEPS = 12  # bf16 batch-32 steps timed per variant, after 3 warm-up steps
# the drills' own ImageFolder: REAL_CLASSES classes of DRILL_TRAIN and
# DRILL_VAL JPEGs (DRILL_STEPS steps an epoch at batch 32), and cuDNN's
# heuristics (no autotune): they check logs, exit codes and manifests
DRILL_TRAIN, DRILL_VAL = 32, 8
DRILL_STEPS = REAL_CLASSES * DRILL_TRAIN // 32
DRILL_OPTS = ["CUDNN.BENCHMARK", False]
# the rollback drill's NaN: the 7th step of epoch 2 (DRILL_STEPS steps an epoch)
LOOP_NAN_STEP = DRILL_STEPS + 6
# the train loop's model: its yaml and arch, and overrides after the yaml
# (none on the card; a CPU rehearsal shrinks the model and images here)
LOOP_YAML, LOOP_ARCH, LOOP_OPTS = "config/resnet50.yaml", "resnet50", []
LOOP_IM, LOOP_FUSED_SITES = 224, 33  # the input side; conv-epilogue sites a forward


def _loop_batch(torch, batch: int, seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (batch, LOOP_IM, LOOP_IM, 3),
                                                    np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int32))}


def _f64_step(torch, dev, host: dict, bn_group: int, accum: int = 1, remat: bool = False):
    """One f64 ResNet-50 step on the card (BN seeded away from its init):
    ``(loss, parameters, buffers, momentum)`` on the host. The fused
    update has no f64 body, so this step applies its plain version to the
    card's tensors; the kernel's own launches are counted in bf16."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    from distribuuuu_tpu_torch.utils.optim import Optimizer

    class PlainUpdate(Optimizer):
        def apply(self, grads=None, skip=None):
            ou.update_plain(self.params, self.grads if grads is None else grads, self.m,
                            self.v, self.hyper, self.scal, self.row, skip)
            self.row += 1

    model = build_model(LOOP_ARCH, num_classes=1000, dtype=torch.float64, bn_group=bn_group,
                        remat=remat, generator=torch.Generator().manual_seed(0))
    seeded_bn(torch, model)
    model = model.to(dev, torch.float64).train()
    opt = PlainUpdate(list(model.named_parameters()),
                      ou.Hyper(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), 0.1)
    m = trainer.train_step(model, opt, {k: v.to(dev) for k, v in host.items()}, 5, accum=accum)
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    buffers = {n: b.detach().cpu() for n, b in model.named_buffers()}
    trace = {n: t.cpu() for n, t in zip(opt.names, opt.m)}
    return float(m["loss"]), params, buffers, trace


def _worst_rel(torch, got: dict, want: dict):
    """(largest |got − want| / max |want| over the tensors, its name)."""
    worst = (0.0, None)
    for k, y in want.items():
        if y.is_floating_point():
            d = float((got[k].double() - y.double()).abs().max()
                      / y.double().abs().max().clamp_min(1e-300))
            if worst[1] is None or d > worst[0]:
                worst = (d, k)
    return worst


def _bf16_steps(torch, ou, dev, accum: int = 1, remat: bool = False) -> dict:
    """config/resnet50.yaml (bf16, batch 32) through the graphed
    ``trainer.TrainStep`` (accum and remat captured in the step) on one
    seeded batch, after one eager step that warms cuDNN: the graph's own
    memory (the peak of its first call, the eager warm-up on the step's
    side stream and the capture into its pool; and the bytes its pool
    holds for every replay, the reserved memory that call left once the
    side stream's cache is emptied), then 2 replays and LOOP_TIMED_STEPS
    more timed on the host clock (one synchronise at the end), and
    opt_update's launches over them."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    config.reset_cfg()
    config.merge_from_file(LOOP_YAML)
    cfg.merge_from_list(["RNG_SEED", 0, "TRAIN.GRAD_ACCUM_STEPS", accum, "TRAIN.REMAT", remat,
                         *LOOP_OPTS])
    trainer.apply_backend_flags()
    model = trainer.build_model_from_cfg().to(dev).train()
    opt = construct_optimizer(model)
    batch = {k: v.to(dev) for k, v in _loop_batch(torch, cfg.TRAIN.BATCH_SIZE, 6).items()}
    trainer.train_step(model, opt, batch, 5, accum=accum)
    step = trainer.TrainStep(model, opt, 5, "raise", accum, 1, dev,
                             pool=torch.cuda.graph_pool_handle())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step([batch], [False])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved(dev) - reserved
    for _ in range(2):
        step([batch], [False])
    torch.cuda.synchronize()
    ou.update.launches = 0
    t0 = time.perf_counter()
    for _ in range(LOOP_TIMED_STEPS):
        m = step([batch], [False])
    torch.cuda.synchronize()
    res = {"accum": accum, "remat": remat, "batch": cfg.TRAIN.BATCH_SIZE,
           "step_ms": (time.perf_counter() - t0) / LOOP_TIMED_STEPS * 1e3,
           "peak_mem_mb": peak / 2 ** 20, "graph_pool_mb": pool / 2 ** 20,
           "opt_update_launches": ou.update.launches, "steps": LOOP_TIMED_STEPS,
           "loss": float(m[0, 0])}
    del model, opt, batch, step
    torch.cuda.empty_cache()
    return res


def _deterministic(torch):
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    return flags


def loop_accum_phase(torch, ou, dev) -> dict:
    """``TRAIN.GRAD_ACCUM_STEPS``: one f64 ResNet-50 step at batch 8 with
    accum 2 and MODEL.BN_GROUP 4 (micro-batches of 4, one group each)
    against the no-accum step with ghost groups of 4 (the same groups),
    cuDNN deterministic: parameters and momentum within LOOP_F64_TOL
    (the running stats move twice under accum, once without, by design);
    then the bf16 batch-32 step at accum 1 and 2 (the same 32 images a
    step): step ms and one opt_update launch per optimizer step."""
    flags = _deterministic(torch)
    try:
        host = _loop_batch(torch, 8, 5)
        loss_g, params_g, _, trace_g = _f64_step(torch, dev, host, 4)
        loss_a, params_a, _, trace_a = _f64_step(torch, dev, host, 4, accum=2)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    p_err, t_err = _worst_rel(torch, params_a, params_g), _worst_rel(torch, trace_a, trace_g)
    rows = [_bf16_steps(torch, ou, dev, accum=a) for a in (1, 2)]
    res = {"phase": "train_loop_accum", "arch": LOOP_ARCH, "f64_batch": 8, "accum": 2,
           "bn_group": 4, "loss_ghost": loss_g, "loss_accum": loss_a,
           "param_rel_err": list(p_err), "trace_rel_err": list(t_err), "tol": LOOP_F64_TOL,
           "bf16": rows}
    emit(res)
    if not (max(p_err[0], t_err[0]) <= LOOP_F64_TOL
            and abs(loss_a - loss_g) <= LOOP_F64_TOL * abs(loss_g)):
        raise AssertionError(f"accumulated step vs ghost-group step at f64: {res}")
    for r in rows:
        if r["opt_update_launches"] != r["steps"]:
            raise AssertionError(f"opt_update launched {r['opt_update_launches']} times in "
                                 f"{r['steps']} steps at accum {r['accum']}")
    return res


def loop_remat_phase(torch, ou, dev) -> dict:
    """``TRAIN.REMAT``: one f64 ResNet-50 step at batch 8 (one BN group)
    with stages 1-2 recomputed, against the plain step and against the
    plain step run again (cuDNN deterministic): parameters, running stats
    and momentum within LOOP_F64_TOL, bitwise equality reported; then the
    graphed bf16 batch-32 step both ways: step ms, and the graph's peak
    and pool memory, each lower under remat."""
    flags = _deterministic(torch)
    try:
        host = _loop_batch(torch, 8, 7)
        runs = [_f64_step(torch, dev, host, 8, remat=r) for r in (False, False, True)]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    def merged(run):
        return {**{f"p/{k}": v for k, v in run[1].items()},
                **{f"b/{k}": v for k, v in run[2].items()},
                **{f"m/{k}": v for k, v in run[3].items()}}

    plain, again, remat = (merged(r) for r in runs)
    err, rerun_err = _worst_rel(torch, remat, plain), _worst_rel(torch, again, plain)
    bitwise = runs[2][0] == runs[0][0] and all(torch.equal(remat[k], v)
                                               for k, v in plain.items())
    rows = [_bf16_steps(torch, ou, dev, remat=r) for r in (False, True)]
    res = {"phase": "train_loop_remat", "arch": LOOP_ARCH, "f64_batch": 8,
           "loss_plain": runs[0][0], "loss_remat": runs[2][0], "bitwise_equal": bitwise,
           "rel_err": list(err), "plain_rerun_rel_err": list(rerun_err),
           "tol": LOOP_F64_TOL, "bf16": rows,
           "peak_mem_saved_mb": rows[0]["peak_mem_mb"] - rows[1]["peak_mem_mb"],
           "graph_pool_saved_mb": rows[0]["graph_pool_mb"] - rows[1]["graph_pool_mb"]}
    emit(res)
    if err[0] > LOOP_F64_TOL or abs(runs[2][0] - runs[0][0]) > LOOP_F64_TOL * abs(runs[0][0]):
        raise AssertionError(f"remat step vs plain step at f64: {res}")
    if not (rows[1]["peak_mem_mb"] < rows[0]["peak_mem_mb"]
            and rows[1]["graph_pool_mb"] < rows[0]["graph_pool_mb"]):
        raise AssertionError(f"remat did not lower the graphed step's memory: {rows}")
    return res


def loop_async_phase(torch, ou, dev, work: str) -> dict:
    """``CHECKPOINT.ASYNC``: a bf16 ResNet-50 train state (3 steps in) saved
    synchronously and then through the committer: the boundary's blocking
    time against the synchronous save's wall, the payloads bitwise equal
    and both manifests verifying; the steps that overlap the commit (each
    step synchronised) against the steps after it."""
    import statistics as st

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.asyncplane import committer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.resilience import manifest
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    config.reset_cfg()
    config.merge_from_file(LOOP_YAML)
    cfg.merge_from_list(["RNG_SEED", 0, *LOOP_OPTS])
    trainer.apply_backend_flags()
    model = trainer.build_model_from_cfg().to(dev).train()
    opt = construct_optimizer(model)
    batch = {k: v.to(dev) for k, v in _loop_batch(torch, cfg.TRAIN.BATCH_SIZE, 8).items()}

    def step():
        trainer.train_step(model, opt, batch, 5)
        torch.cuda.synchronize()

    ou.update.launches = 0
    for _ in range(3):
        step()

    def state():
        return {"model": model.state_dict(), "opt": opt.state_dict(), "step": opt.count}

    paths = {}
    for mode in (False, True):
        cfg.OUT_DIR, cfg.CHECKPOINT.ASYNC = os.path.join(work, f"async_{mode}"), mode
        t0 = time.perf_counter()
        paths[mode] = ckpt.save_checkpoint(state(), 0, 1.0, is_best=True)
        paths[f"{mode}_s"] = time.perf_counter() - t0
    overlap = []
    while committer.pending_commits() and len(overlap) < 200:
        t0 = time.perf_counter()
        step()
        overlap.append(time.perf_counter() - t0)
    committer.join_commits()
    (_, c0, c1), = committer.commit_windows()[-1:]
    after = []
    for _ in range(LOOP_TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        after.append(time.perf_counter() - t0)
    a = torch.load(paths[True], weights_only=True)
    b = torch.load(paths[False], weights_only=True)
    tensors = [(a["model"][k], v) for k, v in b["model"].items()]
    tensors += [(a["opt"]["m"][k], v) for k, v in b["opt"]["m"].items()]
    differ = sum(not torch.equal(x, y) for x, y in tensors)
    verified = [manifest.verify_checkpoint(p)[0] for mode in (False, True)
                for p in (paths[mode], os.path.join(os.path.dirname(paths[mode]), "best.pth"))]
    res = {"phase": "train_loop_async_save", "arch": LOOP_ARCH,
           "payload_mb": os.path.getsize(paths[False]) / 2 ** 20,
           "sync_save_s": paths["False_s"], "async_blocking_s": paths["True_s"],
           "commit_s": c1 - c0, "steps_overlapping_commit": len(overlap),
           "overlap_step_ms": st.mean(overlap) * 1e3 if overlap else None,
           "after_step_ms": st.mean(after) * 1e3, "opt_update_launches": ou.update.launches,
           "steps": 3 + len(overlap) + len(after), "tensors": len(tensors),
           "tensors_not_bitwise_equal": differ, "manifests_verify": all(verified),
           "meta_equal": (a["step"], a["epoch"], a["best_acc1"]) == (b["step"], b["epoch"],
                                                                     b["best_acc1"])}
    emit(res)
    del model, opt, batch
    torch.cuda.empty_cache()
    if (differ or not res["manifests_verify"] or not res["meta_equal"]
            or res["opt_update_launches"] != res["steps"]):
        raise AssertionError(f"async save vs sync save: {res}")
    return res


def _train_net(root: str, out_dir: str, *opts, timeout: int = 600):
    """``train_net`` with config/resnet50.yaml on the data at ``root`` (an
    ImageFolder, or a pack under ``DATA.FORMAT shards``), one process, no
    process group, through :func:`counted_train_net`: ``(returncode,
    stderr, launches)``, ``launches`` None when the process died before
    writing them."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    os.makedirs(out_dir, exist_ok=True)
    counts = os.path.join(out_dir, f"launches-{time.monotonic_ns()}.json")
    args = [sys.executable, os.path.abspath(__file__), "--counted-train-net", counts,
            "--cfg", LOOP_YAML, "TRAIN.DATASET", root, "TEST.DATASET", root, "RNG_SEED", 0,
            "TRAIN.WORKERS", max(1, (os.cpu_count() or 3) // 3), "OUT_DIR", out_dir,
            *LOOP_OPTS, *opts]
    r = subprocess.run([str(a) for a in args], env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    launches = None
    if os.path.exists(counts):
        with open(counts) as f:
            launches = json.load(f)
    return r.returncode, r.stderr, launches


# drill -> the two runs from a copy of the epoch-1 checkpoint: (options,
# wanted return code, what its log must say)
LOOP_DRILLS = {
    "rollback": [
        (["TRAIN.NONFINITE", "rollback", "TRAIN.MAX_ROLLBACKS", 1, "FAULTS.ENABLED", True,
          "FAULTS.NAN_STEP", LOOP_NAN_STEP], 1,
         ["rolling back to the last intact checkpoint", "rollback budget exhausted",
          "NonFiniteLossError"]),
        ([], 0, ["resumed from", "ckpt_ep_000.pth (epoch 1)", "epoch 2 done"]),
    ],
    "corrupt_truncate": [
        (["FAULTS.ENABLED", True, "FAULTS.CORRUPT_EPOCH", 1, "FAULTS.CORRUPT_MODE",
          "truncate"], 0, ["epoch 2 done"]),
        ([], 0, ["quarantined corrupt checkpoint", "truncated", "walked back over 1",
                 "ckpt_ep_000.pth (epoch 1)", "epoch 2 done"]),
    ],
    "kill_mid_async_save": [
        (["CHECKPOINT.ASYNC", True, "FAULTS.ENABLED", True, "FAULTS.KILL_MID_ASYNC_SAVE", 1],
         -9, []),
        (["CHECKPOINT.ASYNC", True], 0,
         ["no committed manifest", "walked back over 1", "ckpt_ep_000.pth (epoch 1)",
          "epoch 2 done"]),
    ],
}


def loop_drills_phase(work: str) -> dict:
    """The resilience drills of ``train_net`` in subprocesses on an
    ImageFolder of their own (DRILL_TRAIN and DRILL_VAL a class), each from
    a copy of one epoch-1 checkpoint (MAX_EPOCH 2):
    the NaN rollback (NAN_STEP in epoch 2, MAX_ROLLBACKS 1: it raises
    after one rollback, then a clean rerun finishes from ckpt_ep_000), a
    truncated ckpt_ep_001 walked back over, and a SIGKILL between
    ckpt_ep_001.pth's rename and its manifest walked back over. The three
    run at once; each must end with a ckpt_ep_001.pth that verifies."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from distribuuuu_tpu_torch.resilience import manifest

    t0 = time.perf_counter()
    root = make_image_tree(os.path.join(work, "drill_tree"), seed=1, n_train=DRILL_TRAIN,
                           n_val=DRILL_VAL)
    base = os.path.join(work, "drill_base")
    rc, log, _ = _train_net(root, base, "OPTIM.MAX_EPOCH", 1, *DRILL_OPTS)
    if rc != 0:
        raise AssertionError(f"drill base run exited {rc}: {log[-3000:]}")
    base_s = time.perf_counter() - t0

    def drill(name):
        out = os.path.join(work, name)
        shutil.copytree(base, out)
        rows = []
        for opts, want_rc, needles in LOOP_DRILLS[name]:
            t1 = time.perf_counter()
            rc, log, _ = _train_net(root, out, "OPTIM.MAX_EPOCH", 2, *DRILL_OPTS, *opts)
            missing = [n for n in needles if n not in log]
            rows.append({"rc": rc, "want_rc": want_rc, "missing": missing,
                         "seconds": time.perf_counter() - t1})
            if rc != want_rc or missing:
                rows[-1]["log_tail"] = log[-2000:]
                break
        final = os.path.join(out, "checkpoints", "ckpt_ep_001.pth")
        return name, {"runs": rows, "final_verifies": manifest.verify_checkpoint(final)[0],
                      "quarantined": sorted(f for f in os.listdir(os.path.dirname(final))
                                            if ".corrupt" in f)}

    with ThreadPoolExecutor(len(LOOP_DRILLS)) as pool:
        drills = dict(pool.map(drill, LOOP_DRILLS))
    res = {"phase": "train_loop_drills", "arch": LOOP_ARCH, "steps_an_epoch": DRILL_STEPS,
           "base_epoch_s": base_s, "seconds": time.perf_counter() - t0,
           "nan_step": LOOP_NAN_STEP, "drills": drills}
    emit(res)
    for name, d in drills.items():
        if not d["final_verifies"] or any(r["rc"] != r["want_rc"] or r["missing"]
                                          for r in d["runs"]):
            raise AssertionError(f"drill {name} failed: {d}")
    return res


CONC_EVAL_BATCH = 100  # two eval batches of the ImageFolder's 200 val images
CONC_EVAL_RUNS = (False, False, True)  # concurrent? a warm-up, then synchronous, concurrent


def loop_concurrent_eval_phase(torch, ce, ou, root: str, work: str) -> dict:
    """``TRAIN.CONCURRENT_EVAL``: two epochs of config/resnet50.yaml on the
    ImageFolder through ``trainer.train_model``, with cuDNN deterministic:
    a synchronous run to warm up, then synchronous and concurrent (with
    async commits): the concurrent run's final parameters, running stats
    and momentum bitwise the synchronous run's before it, each epoch's Acc@1
    equal; 33 conv-epilogue launches per eval forward (two eval batches of
    CONC_EVAL_BATCH an epoch, so each synchronous eval replays its graph);
    off the default stream, in a concurrent run every one of them (the
    eval's own stream), in a synchronous run the 33 of each eval's warm-up
    call (on the graph's side stream; the capture launches nothing and is
    not counted, the replays run on the default stream); one opt_update
    launch per step; the walls of each mode."""
    import statistics as st

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import graphs, trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt

    kernel, launch = ce.conv1x1_bn_act, ce._launch
    side = {"n": 0}

    def counted(x, *a, **k):  # a real launch off the default stream (a capture's is none)
        if (not graphs.capturing() and torch.cuda.current_stream(x.device)
                != torch.cuda.default_stream(x.device)):
            side["n"] += 1
        return launch(x, *a, **k)

    runs = []
    ce._launch = counted
    try:
        for i, concurrent in enumerate(CONC_EVAL_RUNS):
            config.reset_cfg()
            config.merge_from_file(LOOP_YAML)
            cfg.merge_from_list([
                *LOOP_OPTS, "TRAIN.DATASET", root, "TEST.DATASET", root, "RNG_SEED", 0,
                "OPTIM.MAX_EPOCH", 2, "OUT_DIR", os.path.join(work, f"conc_{i}"),
                "DATA.BACKEND", "auto", "TRAIN.WORKERS", os.cpu_count(),
                "CUDNN.DETERMINISTIC", True, "CUDNN.BENCHMARK", False,
                "TEST.BATCH_SIZE", CONC_EVAL_BATCH,
                "TRAIN.CONCURRENT_EVAL", concurrent, "CHECKPOINT.ASYNC", concurrent])
            recs = []
            ou.update.launches = kernel.launches = side["n"] = 0
            t0 = time.perf_counter()
            trainer.train_model(recs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({
                "concurrent": concurrent, "wall_s": wall, "acc1": [r["acc1"] for r in recs],
                "eval_wall_s": [r["eval_wall_s"] for r in recs],
                "save_s": [r.get("save_s") for r in recs],
                "steps": sum(r["steps"] for r in recs),
                "eval_forwards": sum(-(-r["eval_images"] // cfg.TEST.BATCH_SIZE) for r in recs),
                "launches": {"opt_update": ou.update.launches, "conv_epilogue": kernel.launches,
                             "conv_epilogue_off_default_stream": side["n"]},
                "state": ckpt.load_checkpoint(ckpt.get_checkpoint(1))})
    finally:
        ce._launch = launch
    states = [r.pop("state") for r in runs]
    differ = []
    for c, p in ((2, 1),):  # the concurrent run against the synchronous one before it
        a, b = states[c], states[p]
        pairs = [(f"model/{k}", a["model"][k], v) for k, v in b["model"].items()]
        pairs += [(f"m/{k}", a["opt"]["m"][k], v) for k, v in b["opt"]["m"].items()]
        differ += [k for k, x, y in pairs if not torch.equal(x, y)]
    # the first run warms the process (cuDNN, cuBLAS, the decoder): its wall is left out
    walls = {m: [r["wall_s"] for r in runs[1:] if r["concurrent"] == m] for m in (False, True)}
    res = {"phase": "train_loop_concurrent_eval", "arch": LOOP_ARCH, "epochs": 2,
           "runs": runs, "tensors": len(pairs), "tensors_not_bitwise_equal": len(differ),
           "first_differing": differ[:5], "sync_wall_s": walls[False],
           "concurrent_wall_s": walls[True],
           "wall_saved_s": st.mean(walls[False]) - st.mean(walls[True])}
    emit(res)
    for r in runs:
        # off the default stream: every launch of a concurrent eval; one
        # warm-up forward a synchronous eval (2 epochs, one graph each)
        off = r["launches"]["conv_epilogue"] if r["concurrent"] else LOOP_FUSED_SITES * 2
        if (r["launches"]["conv_epilogue"] != LOOP_FUSED_SITES * r["eval_forwards"]
                or r["eval_forwards"] != 2 * -(-REAL_CLASSES * REAL_VAL // CONC_EVAL_BATCH)
                or r["launches"]["opt_update"] != r["steps"] or r["steps"] != 2 * REAL_STEPS
                or r["launches"]["conv_epilogue_off_default_stream"] != off
                or r["acc1"] != runs[0]["acc1"]):
            raise AssertionError(f"concurrent eval run {r}")
    if differ:
        raise AssertionError(f"concurrent eval vs synchronous: {res}")
    return res


def train_loop_phases(torch, ce, ou, dev, root: str, work: str, drills) -> dict:
    """The rest of the train loop, each phase in turn; ``drills`` is the
    future of ``loop_drills_phase``, which the caller started beside
    shards_exact_resume and two_ranks_one_card, joined before the timed
    phases. Returns the kernel launches its train runs made (the
    accumulated and remat bf16 steps, the async phase's steps, the three
    concurrent-eval runs)."""
    drills.result()
    accum = loop_accum_phase(torch, ou, dev)
    remat = loop_remat_phase(torch, ou, dev)
    saves = loop_async_phase(torch, ou, dev, work)
    conc = loop_concurrent_eval_phase(torch, ce, ou, root, work)
    return {"opt_update": sum(r["opt_update_launches"] for r in accum["bf16"] + remat["bf16"])
            + saves["opt_update_launches"]
            + sum(r["launches"]["opt_update"] for r in conc["runs"]),
            "conv_epilogue": sum(r["launches"]["conv_epilogue"] for r in conc["runs"])}


def _breakdown(torch, prof, iters: int, classify) -> dict:
    """Device time by kind per iteration, kernels per iteration, busy time
    and idle share of the traced window, from a torch.profiler trace."""
    from torch.autograd import DeviceType

    kinds, names, spans, launches = {}, {}, [], 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            launches += "Launch" in e.name  # cudaLaunchKernel(ExC), cuLaunchKernel, cudaGraphLaunch
            continue
        ms = e.time_range.elapsed_us() / 1e3 / iters
        kind = classify(e.name)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + ms
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        raise AssertionError("the profiler recorded no device kernels")
    spans.sort()
    busy, (cur_s, cur_e) = 0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms_by_kind": kinds, "top_kernels_ms": top, "kernels": len(spans) / iters,
            "host_launches": launches / iters,
            "device_busy_ms": busy / 1e3 / iters, "device_idle_share": 1.0 - busy / window}


def _is_conv(name: str) -> bool:
    return any(s in name for s in ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad"))


def _forward_kind(n: str) -> str:
    return ("group_conv" if "gconv_" in n else "conv_epilogue" if "epilogue_gemm" in n
            else "cudnn_conv" if _is_conv(n) else "other")


def _resnet_kind(n: str) -> str:
    return ("opt_update" if "opt_update" in n
            else "cudnn_conv_bwd" if _is_conv(n) and ("dgrad" in n or "wgrad" in n)
            else "cudnn_conv" if _is_conv(n) else "bn_elementwise_other")


def _regnet_kind(n: str) -> str:
    return "group_conv" if "gconv_" in n else _resnet_kind(n)


def _vit_kind(n: str) -> str:
    low = n.lower()
    return ("flash_forward" if "fwd_wgmma" in n
            else "flash_dq" if "dq_wgmma" in n
            else "flash_dkdv" if "dkdv_wgmma" in n
            else "opt_update" if "opt_update" in n
            else "gemm" if any(t in low for t in ("gemm", "nvjet", "cublas", "cutlass"))
            else "patch_conv" if _is_conv(n) else "layernorm_gelu_elementwise_other")


def train_profile_phase(torch, dev, arch: str = "resnet50", batch: int = 32, iters: int = 5,
                        classify=_resnet_kind, **model_kw):
    """Where the time of one bf16 train step of ``arch`` at ``batch`` goes
    (the graphed step, ``trainer.TrainStep``): host wall time
    (synchronised), device time by kind (``classify``), host launches and
    the device's idle share, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    config.reset_cfg()
    model = build_model(arch, num_classes=1000, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0), **model_kw).to(dev).train()
    opt = construct_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = {"image": torch.randint(0, 256, (batch, 224, 224, 3), dtype=torch.uint8, device=dev,
                                generator=gen),
         "label": torch.randint(0, 1000, (batch,), device=dev, generator=gen)}
    step = trainer.TrainStep(model, opt, 5, "raise", 1, 1, dev,
                             pool=torch.cuda.graph_pool_handle())
    for _ in range(3):
        step([b], [False])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step([b], [False])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step([b], [False])
        torch.cuda.synchronize()
    br = _breakdown(torch, prof, iters, classify)
    emit({"phase": "profile_train", "arch": arch, "batch": batch, "iters": iters,
          "dtype": "bfloat16", "step_wall_ms": wall_ms, "img_per_s": batch / wall_ms * 1e3,
          "device_ms_per_step_by_kind": br["device_ms_by_kind"],
          "top_kernels_ms_per_step": br["top_kernels_ms"],
          "kernels_per_step": br["kernels"], "host_launches_per_step": br["host_launches"],
          "device_busy_ms_per_step": br["device_busy_ms"],
          "device_idle_share": br["device_idle_share"]})


def vit_auto_phase(torch, fa, dev, batch: int = 4):
    """ViT-Ti/16 at 1024² (4096 tokens) from config/vit_tiny.yaml under
    DEVICE.ATTN_IMPL auto: two bf16 train steps at ``batch``; the length
    routes every block's attention to the flash kernels (one forward, dQ
    and dK/dV launch per block per step)."""
    import math

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    config.reset_cfg()
    config.merge_from_file("config/vit_tiny.yaml")
    cfg.merge_from_list(["DEVICE.ATTN_IMPL", "auto", "TRAIN.IM_SIZE", 1024,
                         "TRAIN.BATCH_SIZE", batch, "RNG_SEED", 0])
    model = trainer.build_model_from_cfg().to(dev).train()
    opt = construct_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = {"image": torch.randint(0, 256, (batch, 1024, 1024, 3), dtype=torch.uint8,
                                device=dev, generator=gen),
         "label": torch.randint(0, 1000, (batch,), device=dev, generator=gen)}
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(model, opt, b, 5)["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = fa.launch_counts()
    depth = len(model.blocks)
    res = {"phase": "vit_ti_1024px_auto", "arch": cfg.MODEL.ARCH, "attn_impl": "auto",
           "tokens": model.pos_embed.shape[1], "batch": batch, "steps": 2,
           "flash_launches": counts, "losses": losses, "first_step_ms": walls[0],
           "second_step_ms": walls[1],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit(res)
    want = 2 * depth
    if depth != VIT_DEPTH or counts != {"forward": want, "dq": want, "dkdv": want}:
        raise AssertionError(f"auto at {res['tokens']} tokens: flash launches {counts}, want "
                             f"{want} each ({depth} blocks, 2 steps)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ViT-Ti 1024px losses not finite: {losses}")


def decode_kernel_phase(torch, da, dev):
    """decode_attention against its plain version at DECODE_SHAPES, timed
    beside its plain version, its first design (``decode_simple``, the
    ``simple_ms`` of every row) and SDPA over the same length mask, with its
    bound: the live bytes (K and V rows 0..length once, q and lengths read,
    the fp32 out written) over the memory rate, and two launch floors timed
    the same way: an empty block (``floor_ms``) and an empty kernel over the
    plan's grid and clusters (``cluster_floor_ms``). Each row names the body
    and the plan it ran. Returns {shape name: row}."""
    import numpy as np

    F = torch.nn.functional
    SIMPLE = da.DecodePlan("simple", 1, 0, 0)
    out = {}
    for name, b, h, c, d, dt, lengths in DECODE_SHAPES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(b, h, c, d, device=dev, generator=gen).to(dtype) for _ in range(2))
        if lengths is None:
            lengths = np.random.default_rng(0).integers(0, c, b).tolist()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        got = da.decode_attention_kernel(q, k, v, lens, scale)
        ref = da.decode_attention_plain(q, k, v, lens, scale)
        torch.cuda.synchronize()
        err, scaled = _scaled_err(got, ref)
        mask = (torch.arange(c, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        nbytes = da.live_bytes(lengths, h, c, d, dtype)
        live = sum(min(n + 1, c) for n in lengths)
        ops = 4 * h * d * live  # q·k and p·v, a multiply and an add each, fp32
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS["float32"] * 1e3
        row = {
            "phase": "kernel", "name": "decode_attention", "shape": name, "B": b, "H": h,
            "C": c, "D": d, "dtype": dt, "lengths_sum": int(sum(lengths)),
            "max_abs_err": err, "scaled_err": scaled, "tol": DECODE_TOL[dt],
            "ms": time_ms(torch, lambda: da.decode_attention_kernel(q, k, v, lens, scale)),
            "plain_ms": time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lens, scale)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, scale=scale)),
            "library": "sdpa, length mask (returns the compute dtype)",
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "live_bytes": nbytes,
            "tile_bytes": da.pass_bytes(b, h, c, d, dtype),
            "body": da.kernel_body(q, k, v), "plan": da.plan(b, h, c, d, dtype)._asdict(),
            "simple_ms": time_ms(torch, lambda: da.decode_attention_kernel(
                q, k, v, lens, scale, tiling=SIMPLE)),
            "floor_ms": time_ms(torch, lambda: da.launch_floor(dev, 1, 1)),
            "cluster_floor_ms": time_ms(torch, lambda: da.launch_floor(
                dev, b, h, da.plan(b, h, c, d, dtype).splits)),
        }
        row["achieved_gb_per_s"] = nbytes / row["ms"] / 1e6
        emit(row)
        if not scaled <= DECODE_TOL[dt]:
            raise AssertionError(f"decode_attention {name}: error {scaled} of the scale > "
                                 f"{DECODE_TOL[dt]}")
        out[name] = row
        del q, k, v, lens, got, ref, mask
    return out


def _lm_cfg(dtype: str = "bfloat16", tiles=None):
    """config/gpt_nano.yaml as a user serves it, every request to its full
    64 new tokens (EOS off), weights from RNG_SEED 0."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg

    config.reset_cfg()
    config.merge_from_file("config/gpt_nano.yaml")
    cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", dtype,
                         "RNG_SEED", 0, "SERVE.DEVICE", 0, "GENERATE.EOS_ID", -1,
                         "SERVE.MAX_QUEUE", 2 * LM_REQUESTS,
                         *(["GENERATE.BATCH_TILES", tiles] if tiles else [])])
    return cfg


def _lm_prompts(n: int, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(m)).tolist() for m in rng.integers(8, 65, n)]


def _pct(v, q):
    v = sorted(v)
    return v[min(len(v) - 1, int(q * len(v)))] if v else 0.0


def lm_serve_phase(torch, da, tiles=None):
    """GPT-nano generation serving through lm.service.engine_from_cfg on
    cuda:0: two bursts of LM_REQUESTS greedy requests; the second is
    reported. Every decode step launches decode_attention once per block.
    Returns (report, launches of both bursts, the engine, the prompts)."""
    from distribuuuu_tpu_torch.lm import service as lm_service

    cfg = _lm_cfg(tiles=tiles)
    prompts = _lm_prompts(LM_REQUESTS)
    da.reset_launch_counts()
    t_build = time.perf_counter()
    engine = lm_service.engine_from_cfg()
    t_build = time.perf_counter() - t_build
    warm = da.launches
    engine.start()
    bursts, launches = [], 0
    for _ in range(2):
        st0 = engine.stats()
        n_ms0, n_pf0 = len(engine._decode_ms), len(engine._prefill_ms)
        da.reset_launch_counts()
        t0 = time.perf_counter()
        outs = [s.result(timeout=300) for s in [engine.submit(p) for p in prompts]]
        wall = time.perf_counter() - t0
        n = da.launches
        st = engine.stats()
        steps = st["decode_steps"] - st0["decode_steps"]
        tokens = sum(len(o) for o in outs)
        dms, pms = list(engine._decode_ms)[n_ms0:], list(engine._prefill_ms)[n_pf0:]
        bursts.append({"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
                       "decode_steps": steps, "decode_attention_launches": n,
                       "decode_p50_ms": _pct(dms, 0.5), "decode_p99_ms": _pct(dms, 0.99),
                       "decode_mean_ms": sum(dms) / max(1, len(dms)),
                       "prefill_p50_ms": _pct(pms, 0.5), "prefill_p99_ms": _pct(pms, 0.99),
                       "mean_active_slots": (tokens - len(prompts)) / max(1, steps)})
        launches += n
        if tokens != LM_REQUESTS * LM_NEW_TOKENS or n != LM_DEPTH * steps:
            raise AssertionError(f"LM burst: {tokens} tokens (want {LM_REQUESTS} x "
                                 f"{LM_NEW_TOKENS}); decode_attention launches {n} != "
                                 f"{LM_DEPTH} x {steps} decode steps")
    engine.drain()
    res = {"phase": "lm_serve", "arch": cfg.MODEL.ARCH, "dtype": "bfloat16",
           "batch_tiles": engine.batch_tiles, "cache_tiles": engine.cache_tiles,
           "prompt_tiles": engine.prompt_tiles, "warmed_shapes": engine.n_compiles,
           "warmup_decode_attention_launches": warm, "engine_build_s": t_build,
           "requests": LM_REQUESTS, "new_tokens_each": LM_NEW_TOKENS,
           "first_burst": bursts[0], **bursts[1]}
    emit(res)
    return res, launches, engine, prompts


def lm_check_phase(torch, da, dev, engine, prompts):
    """Correctness of the LM path: (1) f32 greedy streams on the card (TF32
    off) equal the port's CPU f32 engine's on the same weights, a
    divergence allowed only at a CPU near-tie below LM_F32_GAP_TOL of the
    logit scale; (2) the served bf16 engine's decoder, teacher-forced over
    the CPU's streams, gives logits within SLICE_REL_TOL of the CPU f32
    scale with top-1 agreement >= SLICE_TOP1_MIN; (3) a sampled request
    replays the same stream; (4) one request through serve_forever and
    generate_request on loopback."""
    import threading

    import numpy as np

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.lm import service as lm_service
    from distribuuuu_tpu_torch.lm.generate import GenerateEngine
    from distribuuuu_tpu_torch.serve import protocol

    cpu = torch.device("cpu")
    sub = prompts[:LM_F32_PROMPTS]
    _lm_cfg("float32")
    streams = []
    for device in (dev, cpu):
        eng = GenerateEngine(trainer.build_model_from_cfg(), device=device).start()
        streams.append([s.result(timeout=300) for s in [eng.submit(p) for p in sub]])
        cpu_model = eng.model
        eng.drain()
    card_streams, cpu_streams = streams
    gaps, same = [], 0
    for p, a, b in zip(sub, card_streams, cpu_streams):
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            same += 1
            continue
        with torch.inference_mode():
            row = cpu_model(torch.tensor([p + b[:k]]))[0, -1]
        gap = float((row[b[k]] - row[a[k]]).abs() / row.abs().max())
        gaps.append({"step": k, "cpu_token": b[k], "card_token": a[k], "rel_logit_gap": gap})
    # (2) bf16 on the card, teacher-forced over the CPU's f32 streams
    rels, agree, total, scale = [], 0, 0, 0.0
    dec = engine.decoder
    for p, toks in zip(sub, cpu_streams):
        seq = p + toks
        with torch.inference_mode():
            want = cpu_model(torch.tensor([seq]))[0, len(p) - 1:len(seq) - 1]
            cache = engine._zero_cache(1, engine.cache_tiles[-1])
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            rows = [dec(torch.tensor([p], device=dev), zero, cache)[0, -1]]
            for i, t in enumerate(toks[:-1]):
                n = torch.tensor([len(p) + i], dtype=torch.int32, device=dev)
                rows.append(dec(torch.tensor([[t]], device=dev), n, cache)[0, -1])
            got = torch.stack(rows).float().cpu()
        scale = max(scale, float(want.abs().max()))
        rels.append(float((got - want).abs().max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        total += len(toks)
    rel = max(rels) / scale
    top1 = agree / total
    # (3) a sampled request, replayed alone
    sample = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7}
    _lm_cfg()
    eng = lm_service.engine_from_cfg().start()
    replay = [eng.submit(prompts[0], sample=sample).result(timeout=300) for _ in range(2)]
    greedy = eng.submit(prompts[0]).result(timeout=300)
    # (4) the socket protocol on loopback
    listener = protocol.open_listener("127.0.0.1", 0)
    port = listener.getsockname()[1]
    stop = threading.Event()
    t = threading.Thread(target=protocol.serve_forever, args=(eng, listener, stop.is_set),
                         daemon=True)
    t.start()
    try:
        frames = list(lm_service.generate_request("127.0.0.1", port, tokens=prompts[1],
                                                  max_new_tokens=16, timeout=120))
    finally:
        stop.set()
        t.join(timeout=60)
    socket_toks = [f["token"] for f in frames if f.get("stream") == "token"]
    res = {"phase": "lm_check", "f32_prompts": len(sub), "f32_streams_equal": same,
           "f32_divergences": gaps, "f32_gap_tol": LM_F32_GAP_TOL,
           "bf16_teacher_forced_rel_err": rel, "rel_tol": SLICE_REL_TOL,
           "bf16_top1_agreement": top1, "top1_min": SLICE_TOP1_MIN,
           "logit_scale": scale, "sampled_replay_equal": replay[0] == replay[1],
           "sampled_differs_from_greedy": replay[0] != greedy,
           "socket_tokens": len(socket_toks), "socket_done": frames[-1].get("reason")}
    emit(res)
    bad = [g for g in gaps if not g["rel_logit_gap"] <= LM_F32_GAP_TOL]
    if bad or not (rel <= SLICE_REL_TOL and top1 >= SLICE_TOP1_MIN):
        raise AssertionError(f"LM card vs CPU: f32 divergences {bad}; bf16 teacher-forced "
                             f"rel err {rel} (tol {SLICE_REL_TOL}), top-1 {top1}")
    if replay[0] != replay[1] or len(replay[0]) != LM_NEW_TOKENS:
        raise AssertionError(f"sampled request did not replay: {replay}")
    if frames[-1].get("stream") != "done" or frames[-1]["tokens"] != socket_toks \
            or len(socket_toks) != 16:
        raise AssertionError(f"generate over the socket: {frames[-1]}")


# ---- the image zoo (slice 14) ---------------------------------------------
ZOO_SERVE = [  # (arch, yaml, extra options, conv-epilogue sites a forward)
    ("efficientnet_b0", "config/efficientnet_b0.yaml", [], 32),
    ("botnet50", "config/botnet50.yaml", [], 34),
    ("densenet121", "config/resnet50.yaml", ["MODEL.ARCH", "densenet121"], 0),
]
ZOO_FORWARD_ARCHS = ("densenet161", "densenet169", "densenet201")  # one bf16 forward each
# batch 2, not 8: with the zoo's phases a run took up to 904 s on the H100
# host (900 s is the aim, 1200 s the limit); this cut drops no check
ZOO_FORWARD_BATCH = 2
ZOO_MEMORY_BATCH = 32  # densenet161's peak memory of a bf16 train step
ZOO_REQUESTS = 32  # requests a burst in zoo_serve (its f32 CPU forward holds the batch)


def efficientnet_sites(batch: int, im: int):
    """(M, K, N, act) of the 32 fused conv-epilogue sites of one
    efficientnet_b0 forward, in order: per block the expand (silu, at the
    block's input resolution; none in block 0) and the project (id, after
    the depthwise conv's stride), then the head (silu)."""
    from distribuuuu_tpu_torch.models import build_model

    model = build_model("efficientnet_b0", device="meta")
    sites, res = [], -(-im // 2)  # after the stride-2 stem
    for stage in model.blocks:
        for blk in stage:
            if len(blk.units) == 3:
                c = blk.units[0].conv
                sites.append((batch * res * res, c.in_channels, c.out_channels, "silu"))
            res = -(-res // blk.conv_dw.stride[0])
            c = blk.units[-1].conv
            sites.append((batch * res * res, c.in_channels, c.out_channels, "id"))
    c = model.head.conv
    sites.append((batch * res * res, c.in_channels, c.out_channels, "silu"))
    return sites


def botnet_sites(batch: int, im: int):
    """(M, K, N, act) of the 34 fused sites of one botnet50 forward: the
    27 of ResNet-50's stages 1-3, then the stack at im/16: block 0's ReLU
    shortcut, and each block's reduce (relu) and last 1x1 (id)."""
    m = batch * (im // 16) ** 2
    stack = [(m, 1024, 2048, "relu")]
    for k in (1024, 2048, 2048):
        stack += [(m, k, 512, "relu"), (m, 512, 2048, "id")]
    return resnet50_sites(batch, im)[:27] + stack


def zoo_kernel_phase(torch, ce, dev):
    """conv1x1_bn_act against its plain version at every distinct site
    of efficientnet_b0 (batches 8 and 200: K and N of 16 to 1280, M up
    to 2.5M rows, silu and id) and of botnet50 (batch 8), each with its
    plan, and a per-forward total of each. Returns (rows of the b0 batch-8
    forward, worst error, the totals)."""
    worst, totals, first = 0.0, [], None
    for arch, batch, sites, n in (("efficientnet_b0", 8, efficientnet_sites(8, 224), 32),
                                  ("efficientnet_b0", 200, efficientnet_sites(200, 224), 32),
                                  ("botnet50", 8, botnet_sites(8, 224), 34)):
        if len(sites) != n:
            raise AssertionError(f"{arch}: {len(sites)} fused sites, not {n}")
        rows, err = kernel_phase(torch, ce, dev, batch, ragged=False, sites=sites)
        worst = max(worst, err)
        totals.append(forward_total(rows, arch=arch, batch=batch))
        emit(totals[-1])
        first = first or rows
        torch.cuda.empty_cache()
    return first, worst, totals


def botnet_values(model):
    """The attention's value weights: zeroing them cuts the MHSA out."""
    return [blk.mhsa.to_v.weight for blk in model.layer4]


def zoo_serve_phase(torch, ce, gc, dev, arch: str, yaml: str, opts: list, sites: int,
                    n_requests: int, weights: str):
    """``arch`` served through the port's engine on cuda:0 (bf16, ``yaml``
    + ``opts``, buckets [1, 2, 4, 8], MODEL.WEIGHTS = ``weights``: seed 0
    with ``seeded_bn``) as ``slice_phase`` serves ResNet-50: ``sites``
    conv-epilogue launches a forward and no grouped-conv launch (the
    script runs this under DISTRIBUUUU_GROUP_CONV=pallas); the bf16
    logits against the port's f32 CPU forward. For botnet50 (its
    zero-initialised last BN scales seeded too) the same weights in f32 on
    the card with the attention's value weights zeroed must move the
    logits. Returns
    (conv-epilogue launches, the report)."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    config.reset_cfg()
    config.merge_from_file(yaml)
    cfg.merge_from_list([
        "DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", 0,
        "SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8, "SERVE.BUCKET_SIZES", [1, 2, 4, 8],
        "SERVE.MAX_QUEUE", 2 * n_requests, "SERVE.MAX_WAIT_MS", 2.0,
        "MODEL.WEIGHTS", weights, *opts,
    ])
    im = cfg.TRAIN.IM_SIZE
    images = np.random.default_rng(0).integers(0, 256, (n_requests, im, im, 3), np.uint8)
    ce.conv1x1_bn_act.launches = gc.group_conv3x3.launches = gc.group_conv3x3.launches_dx = 0
    engine, t_build, walls, batches, logits = _serve_bursts(engine_from_cfg, images)
    counts = {"conv_epilogue": ce.conv1x1_bn_act.launches,
              "group_conv": gc.group_conv3x3.launches + gc.group_conv3x3.launches_dx}
    stats = engine.stats()
    forwards = batches + engine.n_compiles
    fused = sum(u.fused for u in engine.model.conv_units())
    want = {"conv_epilogue": sites * forwards, "group_conv": 0}
    if fused != sites or counts != want:
        raise AssertionError(f"{arch} serving launches {counts} != {want} ({batches} batches "
                             f"+ {engine.n_compiles} warm-ups); {fused} fused sites")
    sd = {k: t.cpu() for k, t in engine.model.state_dict().items()}
    del engine
    cfg.merge_from_list(["DEVICE.COMPUTE_DTYPE", "float32"])

    def f32_logits(device, zero=False):
        model = trainer.build_model_from_cfg()
        model.load_state_dict(sd)
        model = model.to(device).eval()
        if zero:
            with torch.no_grad():
                for w in botnet_values(model):
                    w.zero_()
        with torch.inference_mode():
            return np.concatenate([
                model(normalize_on_device(torch.from_numpy(images[i:i + 16]).to(device)))
                .cpu().numpy() for i in range(0, n_requests, 16)])

    cpu = f32_logits(torch.device("cpu"))
    if logits.shape != (n_requests, cfg.MODEL.NUM_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"{arch}: bad logits: shape {logits.shape}, finite "
                             f"{bool(np.isfinite(logits).all())}")
    scale = float(np.abs(cpu).max())
    rel = float(np.abs(logits - cpu).max() / scale)
    top1 = float((logits.argmax(1) == cpu.argmax(1)).mean())
    moved = None
    if arch == "botnet50":
        card32 = f32_logits(dev)
        moved = float(np.abs(f32_logits(dev, zero=True) - card32).max() / scale)
    res = {
        "phase": f"zoo_serve_{arch}", "arch": arch, "dtype": "bfloat16", "im_size": im,
        "requests": n_requests, "batches": stats["batches"], "forwards": forwards,
        "warmups": forwards - batches, "launches": counts,
        "conv_epilogue_per_forward": counts["conv_epilogue"] / forwards,
        "engine_build_s": t_build, "first_burst_wall_s": walls[0],
        "first_burst_img_per_s": n_requests / walls[0],
        "img_per_s": n_requests / walls[-1], "wall_s": walls[-1],
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "batch_occupancy": stats["batch_occupancy"], "mean_batch_ms": stats["mean_batch_ms"],
        "rel_err_vs_cpu_f32": rel, "rel_tol": SLICE_REL_TOL, "top1_agreement": top1,
        "top1_min": SLICE_TOP1_MIN, "logit_scale": scale,
        "logits_moved_by_zeroed_mhsa_values": moved,
    }
    emit(res)
    if not (rel <= SLICE_REL_TOL and top1 >= SLICE_TOP1_MIN
            and (moved is None or moved > 1e-3)):
        raise AssertionError(f"{arch} card vs CPU logits: rel err {rel} (tol {SLICE_REL_TOL}), "
                             f"top-1 {top1} (min {SLICE_TOP1_MIN}); MHSA values moved {moved}")
    return counts["conv_epilogue"], res


def zoo_forward_phase(torch, ce, dev, arch: str, batch: int = ZOO_FORWARD_BATCH,
                      im: int = 224):
    """One bf16 eval forward of ``arch`` at full width on the card (224²,
    weights from seed 0 with ``seeded_bn``) against the same weights in f32
    on the CPU,
    within SLICE_REL_TOL of the logit scale. Returns the conv-epilogue
    launches."""
    import numpy as np

    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.models import build_model

    model = build_model(arch, num_classes=1000, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    seeded_bn(torch, model)
    ref = build_model(arch, num_classes=1000, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (batch, im, im, 3),
                                                           np.uint8))
    ce.conv1x1_bn_act.launches = 0
    with torch.inference_mode():
        got = model.to(dev).eval()(normalize_on_device(x.to(dev))).float().cpu().numpy()
        cpu = ref.eval()(normalize_on_device(x)).numpy()
    launches = ce.conv1x1_bn_act.launches
    scale = float(np.abs(cpu).max())
    rel = float(np.abs(got - cpu).max() / scale)
    top1 = float((got.argmax(1) == cpu.argmax(1)).mean())
    emit({"phase": "zoo_forward", "arch": arch, "batch": batch, "dtype": "bfloat16",
          "rel_err_vs_cpu_f32": rel, "rel_tol": SLICE_REL_TOL, "top1_agreement": top1,
          "logit_scale": scale, "conv_epilogue_launches": launches})
    want = sum(u.fused for u in model.conv_units())
    if not (np.isfinite(got).all() and rel <= SLICE_REL_TOL and launches == want):
        raise AssertionError(f"{arch} bf16 card vs f32 CPU: rel err {rel} (tol "
                             f"{SLICE_REL_TOL}), launches {launches} != {want}")
    return launches


def zoo_memory_phase(torch, ou, dev, arch: str = "densenet161", batch: int = ZOO_MEMORY_BATCH):
    """Peak ``max_memory_allocated`` of one warm bf16 train step of
    ``arch`` at ``batch`` (224², ghost BN over the batch, cuDNN's
    heuristic algorithms), and its ms.
    The concatenations copy a growing tensor at every dense layer."""
    import numpy as np

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.utils.optim import Optimizer

    model = build_model(arch, num_classes=1000, dtype=torch.bfloat16, bn_group=batch,
                        generator=torch.Generator().manual_seed(0)).to(dev).train()
    opt = Optimizer(list(model.named_parameters()),
                    ou.Hyper(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), 0.1)
    rng = np.random.default_rng(5)
    host = {"image": torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int32))}
    b = {k: v.to(dev) for k, v in host.items()}
    ou.update.launches = 0
    # cuDNN's heuristic algorithms: autotuning densenet161's convs (forward
    # and both backward passes of each) took 30 s of the phase
    bench, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, False
    trainer.train_step(model, opt, b, 5)  # warm-up: the workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    loss = trainer.train_step(model, opt, b, 5)["loss"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    torch.backends.cudnn.benchmark = bench
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"phase": "zoo_memory", "arch": arch, "batch": batch, "dtype": "bfloat16",
           "cudnn_benchmark": False,
           "peak_bytes": peak, "peak_gib": peak / 2 ** 30, "resident_bytes": base,
           "step_ms": ms, "loss": float(loss), "opt_update_launches": ou.update.launches}
    emit(res)
    if ou.update.launches != 2 or not np.isfinite(float(loss)):
        raise AssertionError(f"{arch} memory step: loss {float(loss)}, "
                             f"{ou.update.launches} opt_update launches (want 2)")
    del model, opt, b
    torch.cuda.empty_cache()
    return res


def zoo_train_phase(torch, ce, gc, ou, out_dir: str, arch: str, yaml: str, opts: list,
                    sites: int):
    """``arch`` through ``trainer.train_model`` on dummy data at the yaml's
    batch, one epoch (64 steps) and its eval (bf16): one opt_update
    launch a step, ``sites`` conv-epilogue launches an eval forward, no
    grouped-conv launch (the run is under DISTRIBUUUU_GROUP_CONV=pallas;
    efficientnet_b0's depthwise convs opt out)."""
    def reset():
        ou.update.launches = ce.conv1x1_bn_act.launches = 0
        gc.group_conv3x3.launches = gc.group_conv3x3.launches_dx = 0

    def check(launches, steps, evals):
        want = {"conv_epilogue": sites * evals, "group_conv": 0}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{arch} launches {got} != {want} ({steps} steps, "
                                 f"{evals} eval forwards)")

    return train_phase(torch, out_dir, yaml, opts, reset,
                       lambda: {"opt_update": ou.update.launches,
                                "conv_epilogue": ce.conv1x1_bn_act.launches,
                                "group_conv": gc.group_conv3x3.launches
                                + gc.group_conv3x3.launches_dx}, check, epochs=(1,))


def zoo_weights(torch, arch: str, path: str) -> str:
    """``arch`` as the trainer makes it from RNG_SEED 0, every BN away from
    its init (``seeded_bn``), saved to ``path`` for MODEL.WEIGHTS. At the
    init stats (0 and 1) an eval forward is no network that trains:
    efficientnet_b0's signal shrinks at every depthwise conv (logits about
    1e-14), densenet121's grows (about 4e7), and botnet50's stage-3
    activations of about 100 make its bf16 attention logits round across
    the softmax's argmax (bf16 logits 13 % of their scale from f32 on the
    CPU); the seeded stats keep each about 0.1-0.5 and within 0.3 % in
    bf16. It also makes botnet50's zero-initialised last BN scales
    non-zero, so the attention reaches the logits."""
    from distribuuuu_tpu_torch.models import build_model

    model = build_model(arch, num_classes=1000, generator=torch.Generator().manual_seed(0))
    seeded_bn(torch, model)
    torch.save(model.state_dict(), path)
    return path


def zoo_phases(torch, ce, gc, ou, dev, n_requests: int) -> dict:
    """The image zoo on the card, under DISTRIBUUUU_GROUP_CONV=pallas:
    efficientnet_b0, botnet50 and densenet121 served and trained, the
    three other DenseNets' forwards, densenet161's peak memory (their f32
    steps card vs CPU run with the RegNet's, before graph_equal). Returns
    the launches and reports."""
    import shutil

    out = {"conv_epilogue": 0, "opt_update": 0, "serve": {}, "train": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        t0 = time.perf_counter()
        for arch, yaml, opts, sites in ZOO_SERVE:
            weights = zoo_weights(torch, arch, os.path.join(work, f"{arch}.pth"))
            launches, out["serve"][arch] = zoo_serve_phase(torch, ce, gc, dev, arch, yaml, opts,
                                                           sites, n_requests, weights)
            out["conv_epilogue"] += launches
        for arch in ZOO_FORWARD_ARCHS:
            out["conv_epilogue"] += zoo_forward_phase(torch, ce, dev, arch)
        out["memory"] = zoo_memory_phase(torch, ou, dev)
        emit({"phase": "zoo_serve_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        for arch, yaml, opts, sites in ZOO_SERVE:
            runs = zoo_train_phase(torch, ce, gc, ou, os.path.join(work, f"train_{arch}"), arch,
                                   yaml, opts, sites)
            out["train"][arch] = runs
            out["conv_epilogue"] += sum(r["launches"]["conv_epilogue"] for r in runs)
            out["opt_update"] += sum(r["launches"]["opt_update"] for r in runs)
        emit({"phase": "zoo_train_seconds", "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---- one graph per step (slice 15) ------------------------------------------
GRAPH_EQUAL_STEPS = 8  # train steps a side in graph_equal
GRAPH_EQUAL_TRAIN = [  # (arch, yaml, overrides): SGD, AdamW (c1, c2 move), dropout
    ("resnet50", "config/resnet50.yaml", []),
    ("vit_small", "config/vit_small.yaml", ["DEVICE.ATTN_IMPL", "flash",
                                            "OPTIM.OPTIMIZER", "adamw"]),
    ("efficientnet_b0", "config/efficientnet_b0.yaml", ["TRAIN.BATCH_SIZE", 32]),
]
GRAPH_EQUAL_LM_PROMPTS = 8
FOLD_K, FOLD_CALLS = 4, 6  # fold_train: steps a call, timed calls
RECOMPILE_AT, RECOMPILE_N = 40, 12
STORM_SLOWDOWN_MS = 10.0  # the faulted recompile_drill run's sleep a batch


def _train_cfg(yaml: str, opts: list):
    """``yaml`` as a user trains it, bf16, cuDNN deterministic, seed 0."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg

    config.reset_cfg()
    config.merge_from_file(yaml)
    cfg.merge_from_list(["RNG_SEED", 0, "CUDNN.DETERMINISTIC", True, "CUDNN.BENCHMARK", False,
                         *opts])
    trainer.apply_backend_flags()
    return cfg


def _rand_batches(torch, dev, n: int, batch: int, im: int, classes: int, seed: int = 11):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{"image": torch.randint(0, 256, (batch, im, im, 3), dtype=torch.uint8, device=dev,
                                    generator=gen),
             "label": torch.randint(0, classes, (batch,), dtype=torch.int32, device=dev,
                                    generator=gen)} for _ in range(n)]


def _state(opt, model) -> dict:
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, key in (("m", opt.m), ("v", opt.v)):
        for n, t in zip(opt.names, key or []):
            sd[f"{name}:{n}"] = t.clone()
    return sd


def graph_equal_phase(torch, dev, reg_weights: str) -> dict:
    """Eager against graph on the card (cuDNN deterministic): the served
    logits of ResNet-50 and regnety_160 (under DISTRIBUUUU_GROUP_CONV
    pallas, the served weights) bitwise at every bucket; GPT-nano's bf16
    greedy streams identical; and after GRAPH_EQUAL_STEPS bf16 train steps
    a side the f32 state (parameters, buffers, moments) bitwise equal for
    ResNet-50 (SGD), ViT-S with flash (AdamW) and efficientnet_b0
    (dropout 0.2)."""
    import numpy as np

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.lm import service as lm_service
    from distribuuuu_tpu_torch.serve import engine_from_cfg
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    res, bad = {"phase": "graph_equal"}, []
    t0 = time.perf_counter()
    gc_env = os.environ.get("DISTRIBUUUU_GROUP_CONV")
    for arch, yaml, opts in (("resnet50", "config/resnet50.yaml", []),
                             ("regnety_160", "config/regnety_160.yaml",
                              ["MODEL.WEIGHTS", reg_weights])):
        if arch == "regnety_160":
            os.environ["DISTRIBUUUU_GROUP_CONV"] = "pallas"
        cfg = _train_cfg(yaml, ["SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8,
                                "SERVE.BUCKET_SIZES", [1, 2, 4, 8], *opts])
        im = cfg.TRAIN.IM_SIZE
        imgs = list(np.random.default_rng(5).integers(0, 256, (8, im, im, 3), np.uint8))
        out = {}
        for name in ("graph", "eager"):
            eng = engine_from_cfg(graphed=name == "graph")
            with torch.inference_mode():
                out[name] = {b: eng._run(b, imgs[:b]).float().cpu() for b in eng.buckets}
            eng.drain()
            del eng
        differ = [b for b in out["graph"] if not torch.equal(out["graph"][b], out["eager"][b])]
        res[f"serve_{arch}"] = {"buckets": list(out["graph"]), "not_bitwise": differ}
        bad += [f"serve {arch} bucket {b}" for b in differ]
        if gc_env is None:
            os.environ.pop("DISTRIBUUUU_GROUP_CONV", None)
        else:
            os.environ["DISTRIBUUUU_GROUP_CONV"] = gc_env
    prompts = _lm_prompts(GRAPH_EQUAL_LM_PROMPTS, seed=3)
    streams = {}
    for name in ("graph", "eager"):
        _lm_cfg()
        eng = lm_service.engine_from_cfg(graphed=name == "graph")
        eng.start()
        streams[name] = [s.result(timeout=300) for s in [eng.submit(p) for p in prompts]]
        eng.drain()
        del eng
    res["lm_greedy_streams_equal"] = streams["graph"] == streams["eager"]
    if not res["lm_greedy_streams_equal"]:
        bad.append("gpt_nano greedy streams")
    for arch, yaml, opts in GRAPH_EQUAL_TRAIN:
        cfg = _train_cfg(yaml, opts)
        batches = _rand_batches(torch, dev, GRAPH_EQUAL_STEPS, cfg.TRAIN.BATCH_SIZE,
                                cfg.TRAIN.IM_SIZE, cfg.MODEL.NUM_CLASSES)
        states = {}
        for graph in (True, False):
            model = trainer.build_model_from_cfg().to(dev).train()
            opt = construct_optimizer(model)
            step = trainer.TrainStep(model, opt, 5, "raise", 1, 1, dev, graphed=graph,
                                     pool=torch.cuda.graph_pool_handle() if graph else None)
            losses = [step([b], [False])[0, 0].item() for b in batches]
            states[graph] = (_state(opt, model), losses, opt.count)
            del model, opt, step
        differ = [k for k in states[False][0]
                  if not torch.equal(states[True][0][k], states[False][0][k])]
        res[f"train_{arch}"] = {"optimizer": cfg.OPTIM.OPTIMIZER, "batch": cfg.TRAIN.BATCH_SIZE,
                                "steps": GRAPH_EQUAL_STEPS, "tensors": len(states[False][0]),
                                "not_bitwise": differ[:5], "n_not_bitwise": len(differ),
                                "losses_equal": states[True][1] == states[False][1],
                                "last_loss": states[True][1][-1]}
        if differ or states[True][1] != states[False][1]:
            bad.append(f"train {arch}: {len(differ)} tensors")
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    if bad:
        raise AssertionError(f"graph against eager not bitwise equal: {bad}")
    return res


def fold_train_phase(torch, dev) -> dict:
    """config/resnet50.yaml (bf16, batch 32, cuDNN deterministic) with
    TRAIN.STEPS_PER_CALL FOLD_K against the per-step graph, over 2·FOLD_K
    batches from one seed: the state bitwise equal; then FOLD_CALLS more
    calls of each timed on the host clock: img/s and ms a step."""
    from distribuuuu_tpu_torch import graphs, trainer
    from distribuuuu_tpu_torch.ops import cuda as kernel_tier
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    cfg = _train_cfg("config/resnet50.yaml", ["TRAIN.STEPS_PER_CALL", FOLD_K])
    batch = cfg.TRAIN.BATCH_SIZE
    batches = _rand_batches(torch, dev, 2 * FOLD_K, batch, cfg.TRAIN.IM_SIZE,
                            cfg.MODEL.NUM_CLASSES)
    res, states = {"phase": "fold_train", "arch": "resnet50", "batch": batch,
                   "steps_per_call": FOLD_K}, {}
    for k in (FOLD_K, 1):
        model = trainer.build_model_from_cfg().to(dev).train()
        opt = construct_optimizer(model)
        step = trainer.TrainStep(model, opt, 5, "raise", 1, k, dev,
                                 pool=torch.cuda.graph_pool_handle())
        c0 = graphs.captures
        for i in range(0, len(batches), k):
            step(batches[i:i + k], [False] * k)
        states[k] = _state(opt, model)
        torch.cuda.synchronize()
        before = kernel_tier.launch_counts()["opt_update"]
        t0 = time.perf_counter()
        for _ in range(FOLD_CALLS * FOLD_K // k):
            step(batches[:k], [False] * k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = FOLD_CALLS * FOLD_K
        res[f"k{k}"] = {"captures": graphs.captures - c0, "timed_steps": steps,
                        "step_ms": wall / steps * 1e3, "img_per_s": steps * batch / wall,
                        "opt_update_launches": kernel_tier.launch_counts()["opt_update"] - before}
        del model, opt, step
        torch.cuda.empty_cache()
    differ = [k for k in states[1] if not torch.equal(states[FOLD_K][k], states[1][k])]
    res.update(tensors=len(states[1]), n_not_bitwise=len(differ), not_bitwise=differ[:5])
    emit(res)
    if differ or res[f"k{FOLD_K}"]["opt_update_launches"] != FOLD_CALLS * FOLD_K:
        raise AssertionError(f"fold of {FOLD_K}: {len(differ)} tensors differ from the "
                             f"per-step graph; {res}")
    return res


def recompile_drill_phase(torch, work: str, watch=None) -> dict:
    """``trainer.train_model`` (what train_net runs) on dummy data,
    resnet18 at 64², batch 16, one epoch, cuDNN deterministic, with and
    without FAULTS.RECOMPILE_AT_BATCH RECOMPILE_AT / RECOMPILE_N
    RECOMPILE_N: the faulted epoch records RECOMPILE_N more captures and
    the final checkpoint is bitwise the clean run's. The faulted run also
    sleeps STORM_SLOWDOWN_MS a batch (FAULTS.SLOWDOWN_MS), so its first
    step and its storm land in different windows of a live monitor;
    ``watch(run_dir)``, when given, is attached to it (``LiveMonitor``)."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt
    from distribuuuu_tpu_torch.utils import faults

    out = {}
    t0 = time.perf_counter()
    for fault in (False, True):
        run_dir = os.path.join(work, "fault" if fault else "clean")
        _train_cfg("config/resnet18.yaml", [
            "MODEL.DUMMY_INPUT", True, "TRAIN.IM_SIZE", 64, "TEST.IM_SIZE", 64,
            "TRAIN.BATCH_SIZE", 16, "TEST.BATCH_SIZE", 256, "OPTIM.MAX_EPOCH", 1,
            "TRAIN.WORKERS", 2, "TRAIN.PRINT_FREQ", 16, "OUT_DIR", run_dir,
            *(["FAULTS.ENABLED", True, "FAULTS.RECOMPILE_AT_BATCH", RECOMPILE_AT,
               "FAULTS.RECOMPILE_N", RECOMPILE_N, "FAULTS.SLOWDOWN_MS", STORM_SLOWDOWN_MS]
              if fault else [])])
        faults.reset()
        records = []
        mon = watch(run_dir) if fault and watch is not None else None
        trainer.train_model(records)
        if mon is not None:
            mon.finish()
        payload = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
        out[fault] = (records[0]["captures"], payload["model"], payload["opt"]["m"],
                      payload["step"])
    differ = [k for k in out[False][1] if not torch.equal(out[False][1][k], out[True][1][k])]
    differ += [k for k in out[False][2] if not torch.equal(out[False][2][k], out[True][2][k])]
    res = {"phase": "recompile_drill", "captures_clean": out[False][0],
           "captures_faulted": out[True][0], "recompile_n": RECOMPILE_N,
           "steps": out[True][3], "n_not_bitwise": len(differ), "not_bitwise": differ[:5],
           "seconds": time.perf_counter() - t0}
    emit(res)
    if out[True][0] - out[False][0] != RECOMPILE_N or differ:
        raise AssertionError(f"recompile drill: {res}")
    return res


def graph_vs_eager_profile(torch, dev, path: str, run_eager, run_graph, iters: int,
                           classify, per: int = 1, **extra) -> dict:
    """One path timed and traced both ways in one call, in turns (graph,
    eager, graph, eager): host ms a call (synchronised), and from a
    torch.profiler trace the device-busy ms, kernels, host-issued launches
    and the idle share. ``per`` items (images, tokens) a call give the
    rate."""
    from torch.profiler import ProfilerActivity, profile

    rows = {"graph": [], "eager": []}
    for name in ("graph", "eager", "graph", "eager"):
        fn = run_graph if name == "graph" else run_eager
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        rows[name].append((time.perf_counter() - t0) * 1e3 / iters)
    out = {"phase": "graph_vs_eager", "path": path, "iters": iters, **extra}
    for name, fn in (("graph", run_graph), ("eager", run_eager)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        b = _breakdown(torch, prof, iters, classify)
        host_ms = min(rows[name])
        out[name] = {"host_ms": host_ms, "host_ms_runs": rows[name],
                     "rate_per_s": per / host_ms * 1e3,
                     "device_busy_ms": b["device_busy_ms"], "kernels": b["kernels"],
                     "host_launches": b["host_launches"],
                     "device_idle_share": b["device_idle_share"],
                     "device_ms_by_kind": b["device_ms_by_kind"]}
    emit(out)
    return out


def graph_profile_phases(torch, dev, reg_weights: str) -> None:
    """``--profile``: the five paths of PERF.md graph against eager in one
    call each: ResNet-50 and regnety_160 serving forwards at batch 8 (the
    engine's bucket body), the GPT-nano decode step at batch 4 (cache tile
    256), and the ResNet-50 and ViT-S/16 bf16 train steps at batch 32; then
    served img/s (ResNet-50, 64 requests) and generated tokens/s (GPT-nano,
    32 requests × 64 tokens) through engines built both ways."""
    import functools

    import numpy as np

    from distribuuuu_tpu_torch import graphs, trainer
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.lm import service as lm_service
    from distribuuuu_tpu_torch.serve import engine_from_cfg
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    gc_env = os.environ.get("DISTRIBUUUU_GROUP_CONV")
    for arch, yaml, opts, kind in (
            ("resnet50", "config/resnet50.yaml", [], _forward_kind),
            ("regnety_160", "config/regnety_160.yaml", ["MODEL.WEIGHTS", reg_weights],
             _forward_kind)):
        if arch == "regnety_160":
            os.environ["DISTRIBUUUU_GROUP_CONV"] = "pallas"
        _train_cfg(yaml, opts)
        from distribuuuu_tpu_torch.config import cfg
        from distribuuuu_tpu_torch.utils.weights import load_weights

        model = trainer.build_model_from_cfg()
        if cfg.MODEL.WEIGHTS:
            load_weights(model, cfg.MODEL.WEIGHTS)
        model = model.to(dev).eval().prepare()
        x = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8, device=dev)
        g = graphs.StepGraph(lambda: model(normalize_on_device(x)), {"x": x}, device=dev,
                             pool=torch.cuda.graph_pool_handle())
        with torch.inference_mode():
            graph_vs_eager_profile(torch, dev, f"serve_forward_{arch}", g.body, g, 10, kind,
                                   per=8, arch=arch, batch=8)
        del model, g
        if gc_env is None:
            os.environ.pop("DISTRIBUUUU_GROUP_CONV", None)
        else:
            os.environ["DISTRIBUUUU_GROUP_CONV"] = gc_env
    # the decode step: the served engine's (4, 256) tile, its body and its replay
    _lm_cfg()
    lm_engine = lm_service.engine_from_cfg()
    tile = lm_engine._tile((4, 256))
    tokens = torch.tensor([[1], [2], [3], [4]], dtype=torch.int32)
    lengths = torch.tensor([0, 37, 128, 255], dtype=torch.int32)

    def decode(fn):
        def run():
            tile.inputs["tokens"].copy_(tokens)
            tile.inputs["lengths"].copy_(lengths)
            fn().cpu()
        return run

    low = str.lower
    with torch.inference_mode():
        graph_vs_eager_profile(
            torch, dev, "decode_step_gpt_nano", decode(tile.body), decode(tile), 20,
            lambda n: "decode_attention" if "decode_split" in n or "decode_simple" in n
            else "gemm" if any(t in low(n) for t in ("gemm", "nvjet", "cublas", "cutlass"))
            else "other", per=4, batch=4, cache=256)
    lm_engine.drain()
    del lm_engine, tile
    for arch, yaml, opts, kind in (
            ("resnet50", "config/resnet50.yaml", [], _resnet_kind),
            ("vit_small", "config/vit_small.yaml", ["DEVICE.ATTN_IMPL", "flash"], _vit_kind)):
        cfg = _train_cfg(yaml, opts)
        b = _rand_batches(torch, dev, 1, 32, 224, cfg.MODEL.NUM_CLASSES)
        model = trainer.build_model_from_cfg().to(dev).train()
        opt = construct_optimizer(model)
        steps = {g: trainer.TrainStep(model, opt, 5, "raise", 1, 1, dev, graphed=g,
                                      pool=torch.cuda.graph_pool_handle() if g else None)
                 for g in (True, False)}
        graph_vs_eager_profile(torch, dev, f"train_step_{arch}",
                               lambda: steps[False](b, [False]),
                               lambda: steps[True](b, [False]), 5, kind, per=32, arch=arch,
                               batch=32)
        del model, opt, steps
        torch.cuda.empty_cache()
    # served img/s and tokens/s through engines built both ways, in turns
    rates = {"phase": "graph_vs_eager_serving"}

    for name in ("graph", "eager", "graph", "eager"):
        _train_cfg("config/resnet50.yaml", ["SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8,
                                            "SERVE.BUCKET_SIZES", [1, 2, 4, 8],
                                            "SERVE.MAX_QUEUE", 2 * N_REQUESTS,
                                            "SERVE.MAX_WAIT_MS", 2.0])
        images = np.random.default_rng(0).integers(0, 256, (N_REQUESTS, 224, 224, 3), np.uint8)
        _, _, walls, _, _ = _serve_bursts(
            functools.partial(engine_from_cfg, graphed=name == "graph"), images)
        rates.setdefault(f"resnet50_img_per_s_{name}", []).append(N_REQUESTS / walls[-1])
        _lm_cfg()
        prompts = _lm_prompts(LM_REQUESTS)
        eng = lm_service.engine_from_cfg(graphed=name == "graph")
        eng.start()
        for _ in range(2):
            t0 = time.perf_counter()
            toks = sum(len(s.result(timeout=300)) for s in [eng.submit(p) for p in prompts])
            wall = time.perf_counter() - t0
        eng.drain()
        rates.setdefault(f"gpt_nano_tokens_per_s_{name}", []).append(toks / wall)
    emit(rates)


# ----------------------------------------------------------- the LM plane
# gpt_nano trained on token shards packed from a corpus generated here
# (seeded word salad, LM_CORPUS_MB), then chunked prefill, the length
# classes and speculative decoding served through lm/generate.py

LM_CORPUS_MB = 2.5
LM_WORDS = ("time year people way day man thing woman life child world school state "
            "family student group country problem hand part place case week company "
            "system program question work government number night point home water room "
            "mother area money story fact month lot right study book eye job word business "
            "issue side kind head house service friend father power hour game line end "
            "member law car city community name president team minute idea kid body "
            "information back parent face others level office door health person art war "
            "history party result change morning reason research girl guy moment air "
            "teacher force education the of and to a in is it you that he was for on are "
            "with as his they be at one have this from or had by hot but some what there "
            "we can out other were all your when up use how said an each she which do "
            "their if will way about many then them would write like so these her long "
            "make see him two has look more day could go come did my sound no most who "
            "over know than call first may down been now find any new take get place made "
            "live where after little only round man year came show every good me give our "
            "under very through just form much great think say help low line before turn "
            "cause same mean differ move right boy old too does tell set three want well "
            "also play small end put home read hand port large spell add even land here "
            "must big high such follow act why ask men went light kind off need house").split()
LM_TRAIN_WINDOW = 20  # the first and last LM_TRAIN_WINDOW losses of the epoch, compared
LM_FLASH_LOSS_RTOL = 1e-2  # flash vs dense first-step loss (bf16, one step)
LM_CHUNK = 64
LM_LONG_PROMPTS = (65, 192)  # chunked prefill admits prompts past PROMPT_LEN (64)
LM_LONG_THRESHOLD, LM_LONG_MAX_QUEUE = 128, 4
LM_SPEC_K = 4
LM_SPEC_REQUESTS = 16


def lm_corpus(path: str, seed: int = 0, mb: float = LM_CORPUS_MB) -> dict:
    """A text of ``mb`` MB of seeded word salad over LM_WORDS, one
    document a paragraph (40-400 words each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.asarray(LM_WORDS)
    docs, size = [], 0
    while size < mb * 1e6:
        n = int(rng.integers(40, 400))
        doc = " ".join(words[rng.integers(0, len(words), n)]) + "."
        docs.append(doc)
        size += len(doc) + 2
    with open(path, "w") as f:
        f.write("\n\n".join(docs))
    return {"documents": len(docs), "bytes": os.path.getsize(path)}


def lm_pack_phase(work: str) -> str:
    """``pack_tokens`` over the generated corpus at pack length 256 with a
    5 % val split, then ``--verify``: returns the pack's root."""
    import contextlib
    import io

    from distribuuuu_tpu_torch.data.shards import pack_tokens

    t0 = time.perf_counter()
    src, out = os.path.join(work, "corpus.txt"), os.path.join(work, "tokens")
    corpus = lm_corpus(src)
    t_gen = time.perf_counter() - t0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = pack_tokens.main(["--src", src, "--out", out, "--pack-len", "256",
                               "--val-frac", "0.05"])
    t_pack = time.perf_counter() - t0
    with contextlib.redirect_stdout(buf):
        rc_verify = pack_tokens.main(["--out", out, "--verify"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    splits = {x["split"]: x for x in lines if "sequences" in x}
    verified = [x for x in lines if "ok" in x]
    emit({"phase": "lm_pack", **corpus, "generate_s": t_gen, "pack_s": t_pack,
          "splits": splits, "verify": verified})
    if rc or rc_verify or len(verified) != 2 or not all(x["ok"] for x in verified):
        raise AssertionError(f"token pack failed: rc {rc}, verify rc {rc_verify}: {lines}")
    return out


def lm_train_phase(torch, ou, fa, pack: str, work: str) -> dict:
    """config/gpt_nano.yaml trained one epoch on the pack through
    ``trainer.train_model`` (bf16, batch 16, AdamW, graphed), dense
    (``DEVICE.ATTN_IMPL auto``) and then under ``flash``: train
    sequences/s and tokens/s, step ms, eval tokens/s, one opt_update
    launch a step, the loss falling over the epoch, under flash the
    forward once a block a step and an eval forward, dQ and dK/dV once a
    block a step (none dense), and the two runs' first losses within
    LM_FLASH_LOSS_RTOL. Returns {impl: report}."""
    import math

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import graphs, trainer
    from distribuuuu_tpu_torch.config import cfg

    out = {}
    for impl in ("auto", "flash"):
        config.reset_cfg()
        config.merge_from_file("config/gpt_nano.yaml")
        cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16",
                             "RNG_SEED", 0, "OPTIM.MAX_EPOCH", 1, "TRAIN.DATASET", pack,
                             "TEST.DATASET", pack, "DEVICE.ATTN_IMPL", impl,
                             "TRAIN.PRINT_FREQ", 100, "OUT_DIR",
                             os.path.join(work, f"train_{impl}")])
        ou.update.launches = 0
        fa.reset_launch_counts()
        recs = []
        c0 = graphs.captures
        t0 = time.perf_counter()
        trainer.train_model(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = recs[0]
        launches = {"opt_update": ou.update.launches,
                    **{f"flash_{k}": n for k, n in fa.launch_counts().items()}}
        losses, steps = rec["losses"], rec["steps"]
        evals = -(-rec["eval_images"] // (cfg.TEST.BATCH_SIZE * cfg.LM.SEQ_LEN))
        w = LM_TRAIN_WINDOW
        res = {"phase": "lm_train", "arch": cfg.MODEL.ARCH, "attn_impl": impl,
               "dtype": "bfloat16", "batch": cfg.TRAIN.BATCH_SIZE, "seq_len": cfg.LM.SEQ_LEN,
               "optimizer": cfg.OPTIM.OPTIMIZER, "steps": steps, "eval_forwards": evals,
               "train_seqs_per_s": rec["seqs_per_s"], "train_tokens_per_s": rec["tokens_per_s"],
               "step_ms": rec["step_ms"], "eval_tokens": rec["eval_images"],
               "eval_wall_s": rec["eval_wall_s"],
               "eval_tokens_per_s": rec["eval_images"] / rec["eval_wall_s"],
               "first_loss": losses[0], f"loss_first{w}_mean": statistics.mean(losses[:w]),
               f"loss_last{w}_mean": statistics.mean(losses[-w:]), "eval_loss_acc1": rec["acc1"],
               "captures": graphs.captures - c0, "launches": launches, "wall_s": wall}
        emit(res)
        if launches["opt_update"] != steps or len(losses) != steps \
                or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"lm_train {impl}: opt_update launches "
                                 f"{launches['opt_update']} != {steps} steps, or bad losses")
        if not statistics.mean(losses[-w:]) < statistics.mean(losses[:w]):
            raise AssertionError(f"lm_train {impl}: the loss did not fall: {losses[:w]} ... "
                                 f"{losses[-w:]}")
        want = ({"forward": LM_DEPTH * (steps + evals), "dq": LM_DEPTH * steps,
                 "dkdv": LM_DEPTH * steps} if impl == "flash"
                else {"forward": 0, "dq": 0, "dkdv": 0})
        got = {k: launches[f"flash_{k}"] for k in want}
        if got != want:
            raise AssertionError(f"lm_train {impl}: flash launches {got} != {want}")
        out[impl] = res
    a, b = out["auto"]["first_loss"], out["flash"]["first_loss"]
    if not abs(b - a) <= LM_FLASH_LOSS_RTOL * abs(a):
        raise AssertionError(f"flash first loss {b} vs dense {a}: beyond {LM_FLASH_LOSS_RTOL}")
    return out


def lm_step_vs_cpu_phase(torch, dev, batch: int = 4) -> None:
    """``step_vs_cpu_phase`` for gpt_nano at full width: one f32 AdamW step
    (gpt_nano.yaml's lr and weight decay) over ``batch`` seeded sequences
    of 256 tokens."""
    import numpy as np

    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou

    seq = np.random.default_rng(2).integers(0, 256, (batch, 257)).astype(np.int32)
    step_vs_cpu_phase(torch, dev, "gpt_nano", batch,
                      host={"image": torch.from_numpy(seq[:, :-1]),
                            "label": torch.from_numpy(seq[:, 1:])},
                      hyper=ou.Hyper(kind="adamw", wd=0.01), lr=1e-3, num_classes=320,
                      seq_len=256)


def _lm_engine(torch, dtype: str, graphed=None, **gen):
    """A GenerateEngine of gpt_nano (seed-0 weights) on cuda:0 under
    ``_lm_cfg(dtype)``, the GENERATE/SERVE keys in ``gen`` merged first."""
    from distribuuuu_tpu_torch.lm import service as lm_service

    cfg = _lm_cfg(dtype)
    cfg.merge_from_list([x for kv in gen.items() for x in kv])
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return lm_service.engine_from_cfg(graphed)


def _run_requests(engine, prompts, **kw):
    """Submit every prompt, wait for all: (streams, wall s, first-token
    latencies ms from submit)."""
    t0 = time.perf_counter()
    streams = [engine.submit(p, **kw) for p in prompts]
    iters, first, heads = [iter(s) for s in streams], [], []
    for s, it in zip(streams, iters):  # admitted, so first tokens come, in this order
        heads.append(next(it))
        first.append((time.perf_counter() - s.t_submit) * 1e3)
    outs = [[h, *it] for h, it in zip(heads, iters)]
    return outs, time.perf_counter() - t0, first


def lm_chunk_prefill_phase(torch, da) -> dict:
    """GENERATE.CHUNK_PREFILL LM_CHUNK: (1) f32, TF32 off, greedy streams
    of prompts up to PROMPT_LEN identical to the whole-prompt engine's on
    the same weights; (2) bf16, LM_REQUESTS prompts of LM_LONG_PROMPTS
    tokens (past PROMPT_LEN), each to its full new tokens: tokens/s, the
    admission (first-token) ms, no capture after the warm-up, the
    decode-attention launches (once a block a decode step)."""
    import numpy as np

    from distribuuuu_tpu_torch import graphs

    prompts = _lm_prompts(LM_F32_PROMPTS, seed=5)
    whole = _lm_engine(torch, "float32").start()
    want, _, _ = _run_requests(whole, prompts)
    whole.drain()
    del whole
    chunked = _lm_engine(torch, "float32", **{"GENERATE.CHUNK_PREFILL": LM_CHUNK}).start()
    got, _, _ = _run_requests(chunked, prompts)
    chunked.drain()
    del chunked
    same = sum(a == b for a, b in zip(got, want))
    first_diff = next(([i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)]
                       for i, (a, b) in enumerate(zip(got, want)) if a != b), None)

    rng = np.random.default_rng(6)
    long_prompts = [rng.integers(0, 256, int(n)).tolist()
                    for n in rng.integers(LM_LONG_PROMPTS[0], LM_LONG_PROMPTS[1] + 1,
                                          LM_REQUESTS)]
    eng = _lm_engine(torch, "bfloat16", **{"GENERATE.CHUNK_PREFILL": LM_CHUNK}).start()
    c0 = graphs.captures
    da.reset_launch_counts()
    outs, wall, first = _run_requests(eng, long_prompts)
    launches = da.launches
    st = eng.stats()
    eng.drain()
    tokens = sum(len(o) for o in outs)
    res = {"phase": "lm_chunk_prefill", "chunk": LM_CHUNK,
           "f32_prompts": len(prompts), "f32_identical_streams": same,
           "f32_first_divergence": first_diff,
           "requests": LM_REQUESTS, "prompt_tokens": [min(map(len, long_prompts)),
                                                      max(map(len, long_prompts))],
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "first_token_ms_p50": _pct(first, 0.5), "first_token_ms_p99": _pct(first, 0.99),
           "admit_ms_p50": st["prefill_p50_ms"], "admit_ms_p99": st["prefill_p99_ms"],
           "chunk_prefills": st["chunk_prefills"], "chunk_calls": st["chunk_calls"],
           "decode_steps": st["decode_steps"], "decode_attention_launches": launches,
           "captures_after_warmup": graphs.captures - c0}
    emit(res)
    if same != len(prompts):
        raise AssertionError(f"chunked f32 greedy streams: {same}/{len(prompts)} identical to "
                             f"the whole-prompt engine's (first divergence {first_diff})")
    if tokens != LM_REQUESTS * LM_NEW_TOKENS or res["captures_after_warmup"] \
            or st["chunk_prefills"] != LM_REQUESTS or launches != LM_DEPTH * st["decode_steps"]:
        raise AssertionError(f"chunked bf16 burst: {res}")
    return res


def lm_length_classes_phase(torch, da) -> dict:
    """SERVE.LONG_PROMPT_THRESHOLD LM_LONG_THRESHOLD, LONG_MAX_QUEUE
    LM_LONG_MAX_QUEUE, chunked prefill: a burst of long prompts queued
    before the engine starts is refused past LONG_MAX_QUEUE with the long
    class's error, short prompts keep being admitted around it; then
    every admitted request completes."""
    import numpy as np

    from distribuuuu_tpu_torch.serve.admission import LongQueueFullError

    eng = _lm_engine(torch, "bfloat16", **{"GENERATE.CHUNK_PREFILL": LM_CHUNK,
                                           "SERVE.LONG_PROMPT_THRESHOLD": LM_LONG_THRESHOLD,
                                           "SERVE.LONG_MAX_QUEUE": LM_LONG_MAX_QUEUE,
                                           "SERVE.MAX_QUEUE": 32})
    rng = np.random.default_rng(7)
    decisions, admitted = [], []
    for i in range(16):  # long, long, short, long, ... : 11 long, 5 short
        long_ = i % 3 != 2
        n = int(rng.integers(LM_LONG_THRESHOLD, 193) if long_ else rng.integers(8, 65))
        try:
            admitted.append(eng.submit(rng.integers(0, 256, n).tolist()))
            decisions.append(["long" if long_ else "short", "admitted"])
        except LongQueueFullError as e:
            decisions.append(["long" if long_ else "short", "rejected", e.length_class, str(e)])
    st0 = eng.stats()
    da.reset_launch_counts()
    eng.start()
    outs = [s.result(timeout=300) for s in admitted]
    st = eng.stats()
    eng.drain()
    longs = [d for d in decisions if d[0] == "long"]
    res = {"phase": "lm_length_classes", "threshold": LM_LONG_THRESHOLD,
           "long_max_queue": LM_LONG_MAX_QUEUE, "decisions": decisions,
           "queue_depth_long_before_start": st0["queue_depth_long"],
           "long_admitted": st["long_admitted"], "long_rejected": st["long_rejected"],
           "short_admitted": sum(1 for d in decisions if d[:2] == ["short", "admitted"]),
           "completed": sum(len(o) == LM_NEW_TOKENS for o in outs),
           "decode_attention_launches": da.launches}
    emit(res)
    want = ["admitted"] * LM_LONG_MAX_QUEUE + ["rejected"] * (len(longs) - LM_LONG_MAX_QUEUE)
    if [d[1] for d in longs] != want or res["short_admitted"] != len(decisions) - len(longs) \
            or res["completed"] != len(admitted) \
            or any(d[2] != "long" for d in longs if d[1] == "rejected"):
        raise AssertionError(f"length classes: {res}")
    return res


def lm_speculate_phase(torch, da) -> dict:
    """GENERATE.SPECULATE with K = LM_SPEC_K: (1) f32, TF32 off: a
    self-draft (DRAFT_ARCH gpt_nano from the same seed) rejects no
    proposal (acceptance 1.0) and a draft from RNG_SEED 1 (a ``.pth``
    through DRAFT_WEIGHTS) gives greedy streams identical to the
    target-only engine's; (2) bf16: tokens/s of LM_SPEC_REQUESTS requests
    target-only, self-drafted and with the seed-1 draft, the acceptance
    rates and the decode-attention launches a round."""
    from distribuuuu_tpu_torch.models import build_model

    work = tempfile.mkdtemp(prefix="chip_smoke_spec_")
    try:
        draft = build_model("gpt_nano", num_classes=320, dtype=torch.float32, seq_len=256,
                            generator=torch.Generator().manual_seed(1))
        dpath = os.path.join(work, "draft_seed1.pth")
        torch.save(draft.state_dict(), dpath)
        del draft
        spec = {"GENERATE.SPECULATE.ENABLED": True, "GENERATE.SPECULATE.DRAFT_ARCH": "gpt_nano",
                "GENERATE.SPECULATE.K": LM_SPEC_K, "GENERATE.PROMPT_LEN": 64,
                "GENERATE.MAX_NEW_TOKENS": LM_NEW_TOKENS}
        other = {**spec, "GENERATE.SPECULATE.DRAFT_WEIGHTS": dpath}
        prompts = _lm_prompts(LM_SPEC_REQUESTS, seed=9)
        f32 = {}
        for name, gen in (("target", {}), ("self", spec), ("seed1", other)):
            eng = _lm_engine(torch, "float32", **gen).start()
            outs, _, _ = _run_requests(eng, prompts[:LM_F32_PROMPTS])
            f32[name] = (outs, eng.stats())
            eng.drain()
            del eng
        bf16 = {}
        for name, gen in (("target", {}), ("self", spec), ("seed1", other)):
            eng = _lm_engine(torch, "bfloat16", **gen).start()
            _run_requests(eng, prompts[:2])  # first requests: host paths warm
            st0 = eng.stats()
            da.reset_launch_counts()
            outs, wall, first = _run_requests(eng, prompts)
            st = eng.stats()
            launches = da.launches
            eng.drain()
            del eng
            row = {"tokens": sum(map(len, outs)), "wall_s": wall,
                   "tokens_per_s": sum(map(len, outs)) / wall,
                   "first_token_ms_p50": _pct(first, 0.5),
                   "decode_attention_launches": launches}
            if name != "target":
                d = {k: st[k] - st0[k] for k in ("spec_rounds", "spec_proposed",
                                                  "spec_accepted", "spec_rejected",
                                                  "spec_bonus")}
                row.update(d, acceptance=d["spec_accepted"] / max(
                    1, d["spec_accepted"] + d["spec_rejected"]),
                    launches_per_round=launches / max(1, d["spec_rounds"]))
            else:
                row.update(decode_steps=st["decode_steps"] - st0["decode_steps"])
            bf16[name] = row
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    self_st, seed1_st = f32["self"][1], f32["seed1"][1]
    res = {"phase": "lm_speculate", "k": LM_SPEC_K,
           "f32_self_acceptance": self_st["spec_accepted"] / max(
               1, self_st["spec_accepted"] + self_st["spec_rejected"]),
           "f32_self_rejected": self_st["spec_rejected"],
           "f32_self_streams_identical": sum(a == b for a, b in zip(f32["self"][0],
                                                                    f32["target"][0])),
           "f32_seed1_streams_identical": sum(a == b for a, b in zip(f32["seed1"][0],
                                                                     f32["target"][0])),
           "f32_seed1_acceptance": seed1_st["spec_accepted"] / max(
               1, seed1_st["spec_accepted"] + seed1_st["spec_rejected"]),
           "f32_prompts": LM_F32_PROMPTS, "bf16": bf16,
           "bf16_speedup_self": bf16["self"]["tokens_per_s"] / bf16["target"]["tokens_per_s"],
           "bf16_speedup_seed1": bf16["seed1"]["tokens_per_s"] / bf16["target"]["tokens_per_s"]}
    emit(res)
    n = LM_F32_PROMPTS
    if res["f32_self_rejected"] or res["f32_self_streams_identical"] != n \
            or res["f32_seed1_streams_identical"] != n:
        raise AssertionError(f"speculative decoding: {res}")
    for name in ("self", "seed1"):
        r = bf16[name]
        if r["tokens"] != LM_SPEC_REQUESTS * LM_NEW_TOKENS or not r["spec_rounds"]:
            raise AssertionError(f"speculative bf16 {name}: {r}")
    return res


def lm_plane_phases(torch, ou, fa, da, dev) -> dict:
    """The LM plane's phases in order; returns their launch counts for
    the kernels line."""
    import shutil

    work = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        pack = lm_pack_phase(work)
        train = lm_train_phase(torch, ou, fa, pack, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lm_step_vs_cpu_phase(torch, dev)
    chunk = lm_chunk_prefill_phase(torch, da)
    classes = lm_length_classes_phase(torch, da)
    spec = lm_speculate_phase(torch, da)
    return {"opt_update": sum(r["launches"]["opt_update"] for r in train.values()),
            **{f"flash_{k}": train["flash"]["launches"][f"flash_{k}"]
               for k in ("forward", "dq", "dkdv")},
            "decode_attention": chunk["decode_attention_launches"]
            + classes["decode_attention_launches"]
            + sum(r["decode_attention_launches"] for r in spec["bf16"].values())}


# ------------------------------------------------------------------ telemetry
TEL_EPOCHS = 2  # telemetry_train: the second, steady epoch gives the timeline's img/s
TEL_PROF = (20, 5)  # PROF.START_STEP, PROF.NUM_STEPS of telemetry_train
TEL_TABLE_TRAIN = 3 * 2 * 4.09e9  # JAX's hand table: ResNet-50 train FLOPs an image
TEL_NEUTRAL_STEPS = 6  # f32 ResNet-50 batch-8 steps with telemetry on, then off
# telemetry off/on, in turns: two a side (three until the fleet's phases
# needed the seconds)
TEL_TURNS = (False, True, True, False)
# (steps, PRINT_FREQ) a turn; (40, 10) and (200, 50) until the fleet's phases
TEL_TURN_STEPS = {"resnet50": (30, 10), "gpt_nano": (120, 40)}
TEL_SERVE_REQUESTS = 512  # served ResNet-50 requests a turn
TEL_LM_TRACED = 4  # traced generate requests through the socket
TEL_LM_BURSTS = 2  # bursts of LM_REQUESTS a telemetry_lm turn
TEL_LM_PROF = (50, 10)  # PROF window of the profiled GPT-nano epoch


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _lm_kind(name: str) -> str:
    n = name.lower()
    for kind, keys in (("opt_update", ("opt_update",)), ("flash", ("flash", "fwd_", "dq_", "dkdv")),
                       ("gemm", ("gemm", "xmma", "cutlass", "gemv", "sm90", "matmul", "nvjet")),
                       ("topk (accuracy)", ("topk", "radixsort", "sort")),
                       ("layernorm", ("layer_norm", "layernorm")),
                       ("softmax/loss", ("softmax", "nll", "cross_entropy")),
                       ("reduce", ("reduce",)),
                       ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill"))):
        if any(k in n for k in keys):
            return kind
    return "other"


def _trace_kernels(path: str) -> list:
    """The kernel events (``cat`` ``"kernel"``) of a torch.profiler Chrome
    trace: graph replays' kernels included, when the profiler sees them."""
    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"]


def _device_split(path: str, steps: int, classify) -> dict:
    """Device ms a step by kind from a profiler trace over ``steps``
    steps, the kernels' total, the window's span and its idle share."""
    evs = _trace_kernels(path)
    split: dict = {}
    other: dict = {}
    for e in evs:
        k = classify(e["name"])
        split[k] = split.get(k, 0.0) + e["dur"] / 1e3 / steps
        if k == "other":
            other[e["name"][:80]] = other.get(e["name"][:80], 0.0) + e["dur"] / 1e3 / steps
    busy = sum(split.values())
    span = (max(e["ts"] + e["dur"] for e in evs) - min(e["ts"] for e in evs)) / 1e3 / steps
    return {"kernels_a_step": len(evs) / steps, "device_busy_ms": busy,
            "window_ms_a_step": span, "idle_share": 1.0 - busy / span if span else None,
            "by_kind_ms": {k: round(v, 5) for k, v in sorted(split.items(), key=lambda kv: -kv[1])},
            "top_other_ms": dict(sorted(((k, round(v, 5)) for k, v in other.items()),
                                        key=lambda kv: -kv[1])[:6])}


def telemetry_train_phase(torch, ce, ou, out_dir: str, watch=None) -> dict:
    """config/resnet50.yaml (bf16, batch 32, dummy data) through
    ``trainer.train_model`` with telemetry on: TEL_EPOCHS epochs of 64
    graphed steps and their evals of 2048 images, ``PROF`` over TEL_PROF
    steps of the first. Checks: every record of the rank file and
    metrics.jsonl validates against the port's schema; one ``step`` span a
    step; the ``compile`` records equal the graph captures; ``memstats``
    above 0; the ledger's ``cost.step``, ``cost.roofline`` and
    ``cost.memory`` of ``train_step`` and ``eval_step``, the train FLOPs
    an image within 10 % of JAX's table; the profiler trace parses and
    names the ``opt_update`` kernel; the port's exporter writes a trace
    that parses. Prints the ledger's FLOPs an image and MFU against the
    measured step (epoch 2, between its first and last metric flush),
    the roofline, the headroom, the step span's p50 (the host's dispatch)
    and the timeline's img/s (run_report's) beside the measured img/s.
    ``watch(out_dir)``, when given, is attached to the run (``LiveMonitor``)
    and finished, /metrics scraped, with the run's report."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import graphs, trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.telemetry import costmodel, export, schema

    config.reset_cfg()
    config.merge_from_file("config/resnet50.yaml")
    cfg.merge_from_list(["MODEL.DUMMY_INPUT", True, "DEVICE.PLATFORM", "auto",
                         "DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", 0,
                         "OPTIM.MAX_EPOCH", TEL_EPOCHS, "OUT_DIR", out_dir,
                         "PROF.ENABLED", True, "PROF.START_STEP", TEL_PROF[0],
                         "PROF.NUM_STEPS", TEL_PROF[1]])
    ou.update.launches = ce.conv1x1_bn_act.launches = 0
    c0, recs = graphs.captures, []
    mon = watch(out_dir) if watch is not None else None
    t0 = time.perf_counter()
    trainer.train_model(recs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mon is not None:
        mon.finish(scrape=True)
    launches = {"opt_update": ou.update.launches, "conv_epilogue": ce.conv1x1_bn_act.launches}
    captures = graphs.captures - c0
    rank = _read_jsonl(os.path.join(out_dir, "telemetry", "rank00000.jsonl"))
    metrics = _read_jsonl(os.path.join(out_dir, "metrics.jsonl"))
    for r in rank + metrics:
        schema.validate_record(r)
    steps = sum(r["steps"] for r in recs)
    step_spans = [r for r in rank if r["kind"] == "span" and r["name"] == "step"
                  and r["phase"] == "train"]
    compiles = [r for r in rank if r["kind"] == "compile"]
    mem = [r for r in rank if r["kind"] == "memstats"]
    cost = {(r["kind"], r["label"]): r for r in rank if r["kind"].startswith("cost.")}
    rec = recs[-1]
    (d0, t_0), (d1, t_1) = rec["flushes"][0], rec["flushes"][-1]
    step_s = (t_1 - t_0) / (d1 - d0)
    batch = cfg.TRAIN.BATCH_SIZE
    cs = cost.get(("cost.step", "train_step"), {})
    roof = cost.get(("cost.roofline", "train_step"), {})
    cm = cost.get(("cost.memory", "train_step"), {})
    tl = [r for r in metrics if r["kind"] == "timeline" and r["phase"] == "train"
          and r["epoch"] == TEL_EPOCHS]
    tl_img_s = sum(r["n"] for r in tl) / (max(r["step1"] for r in tl)
                                          - min(r["get0"] for r in tl))
    prof_path = os.path.join(out_dir, "profile", "trace_ep1.json")
    kernels = _trace_kernels(prof_path)
    opt_kernels = sorted({e["name"] for e in kernels if "opt_update" in e["name"]})
    with open(export.export_trace(out_dir)) as f:
        merged = json.load(f)
    flops_img = cs["flops"] / cs["images"] if cs.get("flops") else None
    res = {
        "phase": "telemetry_train", "arch": cfg.MODEL.ARCH, "batch": batch,
        "epochs": TEL_EPOCHS, "steps": steps, "wall_s": wall, "records": len(rank),
        "metrics_records": len(metrics), "step_spans": len(step_spans),
        "captures": captures, "compile_records": len(compiles),
        "compile_s": sum(r["dur_s"] for r in compiles),
        "memstats_bytes_in_use": [r["bytes_in_use"] for r in mem],
        "memstats_peak_bytes": [r["peak_bytes_in_use"] for r in mem],
        "cost_labels": sorted(f"{k}:{lbl}" for k, lbl in cost),
        "flops_per_image": flops_img,
        "flops_vs_table": flops_img / TEL_TABLE_TRAIN if flops_img else None,
        "bytes_per_step": cs.get("bytes_accessed"),
        "measured_step_ms": step_s * 1e3, "measured_img_per_s": batch / step_s,
        "mfu": costmodel.mfu_value(cs.get("flops"), step_s, cs.get("peak_flops")),
        "arithmetic_intensity": roof.get("arithmetic_intensity"),
        "ridge_intensity": roof.get("ridge_intensity"), "bound": roof.get("bound"),
        "graph_peak_bytes": cm.get("total_bytes"), "capacity_bytes": cm.get("capacity_bytes"),
        "headroom_pct": cm.get("headroom_pct"),
        "eval_headroom_pct": cost.get(("cost.memory", "eval_step"), {}).get("headroom_pct"),
        "step_span_p50_ms": statistics.median(r["dur"] for r in step_spans) * 1e3,
        "timeline_img_per_s": tl_img_s,
        "timeline_vs_measured": tl_img_s / (batch / step_s),
        "prof_kernels": len(kernels), "prof_opt_update_kernels": opt_kernels,
        "trace_events": len(merged["traceEvents"]), "launches": launches,
    }
    emit(res)
    want = {("cost.step", "train_step"), ("cost.roofline", "train_step"),
            ("cost.memory", "train_step"), ("cost.step", "eval_step"),
            ("cost.memory", "eval_step")}
    if len(step_spans) != steps or len(compiles) != captures or not captures:
        raise AssertionError(f"telemetry_train: {len(step_spans)} step spans for {steps} "
                             f"steps, {len(compiles)} compile records for {captures} captures")
    if len(mem) != TEL_EPOCHS or not all(r["bytes_in_use"] > 0 for r in mem):
        raise AssertionError(f"telemetry_train: memstats {mem}")
    if not want <= set(cost) or cs.get("source") != "dispatch" \
            or not abs(res["flops_vs_table"] - 1.0) <= 0.10:
        raise AssertionError(f"telemetry_train: ledger {sorted(cost)}, {cs}")
    if not opt_kernels or not merged["traceEvents"]:
        raise AssertionError("telemetry_train: the profiler trace names no opt_update kernel, "
                             "or the merged trace is empty")
    if launches["opt_update"] != steps:
        raise AssertionError(f"telemetry_train: opt_update launches {launches} != {steps}")
    return res


class _TokenRows:
    """Seeded int32 token rows for the loader: ``(inputs, next tokens)``
    of ``seq_len`` each (GPT-nano's train batch without a pack)."""

    BATCH_DTYPE = None

    def __init__(self, n: int, seq_len: int, seed: int = 0):
        import numpy as np

        self.BATCH_DTYPE = np.int32
        self.seq_len = seq_len
        self.rows = np.random.default_rng(seed).integers(0, 256, (n, seq_len + 1)).astype(
            np.int32)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        r = self.rows[int(i)]
        return r[:-1], r[1:]


def _sinks(on: bool, out_dir: str) -> None:
    """Telemetry on (the rank file and metrics.jsonl under ``out_dir``,
    appended) or off, for the global cfg."""
    from distribuuuu_tpu_torch import telemetry
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.utils import jsonlog

    cfg.TELEMETRY.ENABLED = on
    cfg.OUT_DIR = out_dir
    telemetry.setup_from_cfg(cfg)
    if on:
        jsonlog.setup_metrics_log(out_dir)
    else:
        jsonlog.close_metrics_log()


def _train_turns(torch, dev, yaml: str, batch: int, dataset, out_dir: str, opts=()) -> dict:
    """``trainer.train_epoch`` of ``yaml``'s model on ``dataset`` (graphed,
    one runner), telemetry off and on in turns (TEL_TURNS) after an
    untimed epoch: each turn's img/s between its first and last flush."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.data.loader import Loader
    from distribuuuu_tpu_torch.utils.logger import get_logger
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    arch = os.path.basename(yaml).split(".")[0]
    steps, freq = TEL_TURN_STEPS[arch]
    _train_cfg(yaml, ["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16",
                      "TRAIN.PRINT_FREQ", freq, "TRAIN.BATCH_SIZE", batch, *opts])
    model = trainer.build_model_from_cfg().to(dev)
    opt = construct_optimizer(model)
    runner = trainer.TrainStep(model, opt, 5, "raise", 1, 1, dev,
                               pool=torch.cuda.graph_pool_handle())
    loader = Loader(dataset, batch, shuffle=True, drop_last=True, workers=2, seed=0)
    state, logger = {"step": 0}, get_logger()
    rates = {True: [], False: []}
    for i, on in enumerate((False, *TEL_TURNS)):
        _sinks(on, out_dir)
        rec = trainer.train_epoch(loader, model, opt, state, 0, logger, dev, runner)[2]
        (d0, t0), (d1, t1) = rec["flushes"][0], rec["flushes"][-1]
        if i:  # the first epoch captures
            rates[on].append((d1 - d0) * batch / (t1 - t0))
    _sinks(False, out_dir)
    off, on = statistics.mean(rates[False]), statistics.mean(rates[True])
    return {"steps_a_turn": steps, "window_steps": steps - freq, "off": rates[False],
            "on": rates[True], "on_vs_off": on / off}


def telemetry_neutral_phase(torch, ou, dev, work: str) -> dict:
    """Telemetry on against off. (1) config/resnet50.yaml in f32 (TF32
    off, cuDNN deterministic), batch 8, TEL_NEUTRAL_STEPS graphed steps
    of ``trainer.train_epoch`` a side from one seed: the f32 state
    (parameters, buffers, moments) bitwise equal. (2) In turns in this
    call: graphed ResNet-50 bf16 b32 train img/s, GPT-nano bf16 b16 train
    tokens/s (seeded token rows), served ResNet-50 img/s (buckets to 8,
    TEL_SERVE_REQUESTS a turn). (3) One GPT-nano epoch under ``PROF``
    (TEL_LM_PROF): the step's device time by kind from the trace."""
    import numpy as np

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.dummy import DummyDataset
    from distribuuuu_tpu_torch.data.loader import Loader
    from distribuuuu_tpu_torch.serve import ServeMetrics, engine_from_cfg
    from distribuuuu_tpu_torch.utils.logger import get_logger
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    ou.update.launches = 0
    flags = _deterministic(torch)
    states = {}
    try:
        for on in (True, False):
            _train_cfg("config/resnet50.yaml", ["DEVICE.PLATFORM", "auto",
                                                "DEVICE.COMPUTE_DTYPE", "float32",
                                                "TRAIN.BATCH_SIZE", 8, "TRAIN.PRINT_FREQ", 3])
            _sinks(on, os.path.join(work, "neutral"))
            model = trainer.build_model_from_cfg().to(dev)
            opt = construct_optimizer(model)
            loader = Loader(DummyDataset(8 * TEL_NEUTRAL_STEPS, 224, raw_u8=True), 8,
                            shuffle=True, drop_last=True, workers=2, seed=0)
            trainer.train_epoch(loader, model, opt, {"step": 0}, 0, get_logger(), dev)
            torch.cuda.synchronize()
            states[on] = _state(opt, model)
            del model, opt
            torch.cuda.empty_cache()
        _sinks(False, work)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    differ = [k for k in states[True] if not torch.equal(states[True][k], states[False][k])]
    res = {"phase": "telemetry_neutral", "f32_steps": TEL_NEUTRAL_STEPS,
           "tensors": len(states[True]), "n_not_bitwise": len(differ),
           "not_bitwise": differ[:5]}
    del states
    torch.cuda.empty_cache()
    res["resnet50_train_img_per_s"] = _train_turns(
        torch, dev, "config/resnet50.yaml", 32,
        DummyDataset(32 * TEL_TURN_STEPS["resnet50"][0], 224, raw_u8=True),
        os.path.join(work, "turns_resnet50"))
    torch.cuda.empty_cache()
    seq = 256
    lm = _train_turns(torch, dev, "config/gpt_nano.yaml", 16,
                      _TokenRows(16 * TEL_TURN_STEPS["gpt_nano"][0], seq),
                      os.path.join(work, "turns_gpt_nano"))
    lm["tokens_per_s"] = {k: [r * seq for r in lm[k]] for k in ("on", "off")}
    res["gpt_nano_train"] = lm
    torch.cuda.empty_cache()

    # served ResNet-50, the same engine, telemetry off and on in turns
    import distribuuuu_tpu_torch.config as config

    config.reset_cfg()
    config.merge_from_file("config/resnet50.yaml")
    cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16",
                         "RNG_SEED", 0, "SERVE.MAX_QUEUE", TEL_SERVE_REQUESTS,
                         "SERVE.BUCKET_SIZES", [1, 2, 4, 8]])
    images = np.random.default_rng(3).integers(0, 256, (TEL_SERVE_REQUESTS, 224, 224, 3),
                                                dtype=np.uint8)
    serve_dir = os.path.join(work, "serve")
    _sinks(True, serve_dir)
    engine = engine_from_cfg().start()
    rates = {True: [], False: []}
    for i, on in enumerate((False, *TEL_TURNS)):
        _sinks(on, serve_dir)
        engine.metrics = ServeMetrics()
        t0 = time.perf_counter()
        for f in [engine.submit(img) for img in images]:
            f.result(timeout=300)
        if i:
            rates[on].append(len(images) / (time.perf_counter() - t0))
    _sinks(True, serve_dir)
    engine.drain()
    _sinks(False, serve_dir)
    del engine
    torch.cuda.empty_cache()
    res["resnet50_served_img_per_s"] = {"off": rates[False], "on": rates[True],
                                        "on_vs_off": statistics.mean(rates[True])
                                        / statistics.mean(rates[False])}

    # the GPT-nano train step's device time, from one PROF window
    from distribuuuu_tpu_torch.telemetry import schema

    prof_dir = os.path.join(work, "lm_prof")
    steps, _ = TEL_TURN_STEPS["gpt_nano"]
    _train_cfg("config/gpt_nano.yaml", ["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE",
                                        "bfloat16", "TRAIN.PRINT_FREQ", steps,
                                        "PROF.ENABLED", True, "PROF.START_STEP",
                                        TEL_LM_PROF[0], "PROF.NUM_STEPS", TEL_LM_PROF[1],
                                        "OUT_DIR", prof_dir])
    _sinks(True, prof_dir)
    model = trainer.build_model_from_cfg().to(dev)
    opt = construct_optimizer(model)
    loader = Loader(_TokenRows(16 * steps, seq, seed=1), 16, shuffle=True, drop_last=True,
                    workers=2, seed=0)
    trainer.train_epoch(loader, model, opt, {"step": 0}, 0, get_logger(), dev)
    _sinks(False, prof_dir)
    for r in _read_jsonl(os.path.join(prof_dir, "telemetry", "rank00000.jsonl")):
        schema.validate_record(r)
    res["gpt_nano_step_device"] = _device_split(
        os.path.join(prof_dir, "profile", "trace_ep1.json"), TEL_LM_PROF[1], _lm_kind)
    del model, opt
    torch.cuda.empty_cache()
    res["opt_update_launches"] = ou.update.launches
    emit(res)
    if differ:
        raise AssertionError(f"telemetry_neutral: {len(differ)} tensors differ with "
                             f"telemetry on: {differ[:5]}")
    return res


def _trees(recs: list) -> dict:
    """trace id -> its trace.span records."""
    out: dict = {}
    for r in recs:
        if r["kind"] == "trace.span":
            out.setdefault(r["trace"], []).append(r)
    return out


def telemetry_lm_phase(torch, da, out_dir: str) -> dict:
    """GPT-nano served (bf16, config/gpt_nano.yaml, TEL_LM_BURSTS bursts
    of LM_REQUESTS x LM_NEW_TOKENS greedy a turn) with telemetry off and
    on in turns (TEL_TURNS) on one engine: tokens/s each way, every turn's greedy streams the
    same; the ``gen.decode`` records equal the
    engine's decode steps while on (a record inside a graph body would
    fire once, at capture); ``lm.tokens`` at the drain holds every token
    served; then TEL_LM_TRACED requests through the socket under
    ``SERVE.TRACE_SAMPLE 1.0``, each one connected ``trace.span`` tree
    (``client.request`` root, ``engine.request`` under it, its
    ``queue_wait``, ``prefill`` and ``decode_step`` spans under that)."""
    import threading

    from distribuuuu_tpu_torch.lm import service as lm_service
    from distribuuuu_tpu_torch.serve import protocol
    from distribuuuu_tpu_torch.telemetry import schema

    cfg = _lm_cfg("bfloat16")
    cfg.merge_from_list(["SERVE.TRACE_SAMPLE", 1.0])
    _sinks(True, out_dir)
    da.reset_launch_counts()
    engine = lm_service.engine_from_cfg().start()
    prompts = _lm_prompts(LM_REQUESTS, seed=3)
    rates, steps_on, served, streams = {True: [], False: []}, 0, 0, []
    for i, on in enumerate((False, *TEL_TURNS)):
        _sinks(on, out_dir)
        s0 = engine.stats()["decode_steps"]
        t0, tokens = time.perf_counter(), 0
        for _ in range(TEL_LM_BURSTS):
            outs = [s.result(timeout=300) for s in [engine.submit(p) for p in prompts]]
            streams.append(outs)
            tokens += sum(len(o) for o in outs)
        wall = time.perf_counter() - t0
        served += tokens
        steps_on += (engine.stats()["decode_steps"] - s0) if on else 0
        if i:
            rates[on].append(tokens / wall)
    _sinks(True, out_dir)
    s0 = engine.stats()["decode_steps"]
    listener = protocol.open_listener("127.0.0.1", 0)
    stop = threading.Event()
    t = threading.Thread(target=protocol.serve_forever, args=(engine, listener, stop.is_set),
                         daemon=True)
    t.start()
    traced = []
    try:
        for p in prompts[:TEL_LM_TRACED]:
            frames = list(lm_service.generate_request(
                "127.0.0.1", listener.getsockname()[1], tokens=p,
                trace_sample=cfg.SERVE.TRACE_SAMPLE))
            traced.append(frames[-1])
            served += len(frames[-1]["tokens"])
    finally:
        stop.set()
        t.join(60)  # serve_forever drains the engine: lm.tokens lands now
    steps_on += engine.stats()["decode_steps"] - s0
    launches = da.launches
    _sinks(False, out_dir)
    recs = _read_jsonl(os.path.join(out_dir, "telemetry", "rank00000.jsonl"))
    for r in recs:
        schema.validate_record(r)
    decode = sum(1 for r in recs if r["kind"] == "gen.decode")
    last_tokens = [r for r in recs if r["kind"] == "lm.tokens"][-1]
    trees = _trees(recs)
    connected = 0
    for tid, tree in trees.items():
        ids = {r["span"] for r in tree}
        roots = [r for r in tree if r["parent"] == ""]
        names = {r["name"] for r in tree}
        if ([r["name"] for r in roots] == ["client.request"]
                and all(r["parent"] in ids for r in tree if r["parent"])
                and {"engine.request", "queue_wait", "prefill", "decode_step"} <= names):
            connected += 1
    res = {"phase": "telemetry_lm", "arch": cfg.MODEL.ARCH, "requests": LM_REQUESTS,
           "new_tokens_each": LM_NEW_TOKENS, "tokens_per_s_off": rates[False],
           "tokens_per_s_on": rates[True],
           "on_vs_off": statistics.mean(rates[True]) / statistics.mean(rates[False]),
           "decode_steps_on": steps_on, "gen_decode_records": decode,
           "tokens_served": served, "lm_tokens_new_tokens": last_tokens["new_tokens"],
           "traced_requests": len(traced), "trace_ids": len(trees),
           "connected_trees": connected,
           "trace_ids_echoed": sum(1 for f in traced if f.get("trace_id") in trees),
           "streams_identical_on_and_off": all(o == streams[0] for o in streams),
           "decode_attention_launches": launches}
    emit(res)
    if not res["streams_identical_on_and_off"]:
        raise AssertionError("telemetry_lm: the greedy streams differ between turns")
    if decode != steps_on or last_tokens["new_tokens"] != served:
        raise AssertionError(f"telemetry_lm: {decode} gen.decode records for {steps_on} decode "
                             f"steps; lm.tokens {last_tokens['new_tokens']} for {served} served")
    if connected != TEL_LM_TRACED or res["trace_ids_echoed"] != TEL_LM_TRACED:
        raise AssertionError(f"telemetry_lm: {connected} connected trees of "
                             f"{TEL_LM_TRACED} traced requests ({len(trees)} trace ids)")
    return res


def telemetry_phases(torch, ce, ou, da, dev, watch=None) -> dict:
    """The three telemetry phases (``watch`` attached to telemetry_train's
    run); their launch counts for the kernels line."""
    import shutil

    work = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        train = telemetry_train_phase(torch, ce, ou, os.path.join(work, "train"), watch)
        neutral = telemetry_neutral_phase(torch, ou, dev, os.path.join(work, "neutral"))
        lm = telemetry_lm_phase(torch, da, os.path.join(work, "lm"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"opt_update": train["launches"]["opt_update"] + neutral["opt_update_launches"],
            "conv_epilogue": train["launches"]["conv_epilogue"],
            "decode_attention": lm["decode_attention_launches"]}


# -- slice 18: a JAX-trained checkpoint, quantized buckets, the fleet ---------

ORBAX_TOY = "tests/data/orbax_toy"  # written by tests/make_orbax_toy.py with the JAX package
ORBAX_REL_TOL = 1e-3  # the card's f32 logits against JAX's f32 logits, of their scale
QUANT_REQUESTS = 64
QUANT_CPU_CHECK = 8  # int8 card logits of these against the port's f32 CPU forward
FLEET_REQUESTS = 128
FLEET_CLIENTS = 16  # concurrent client connections of a fleet burst
FLEET_SEQ = 32  # sequential requests timing the router's added latency
LM_FLEET_REQUESTS = 16
LM_FLEET_THRESHOLD = 32  # SERVE.LONG_PROMPT_THRESHOLD of the LM fleet: prompts are 8-64


def orbax_weights_phase(torch, da, dev) -> dict:
    """The committed orbax fixture (saved by the JAX package) read on the
    card host with no JAX module loaded: the narrow RegNet from its weights-only and its
    full save, f32 on the card against the JAX forward's logits; the
    narrow GPT's greedy streams through a GenerateEngine on the card
    (decode_attention on every T=1 step) against JAX's tokens."""
    import numpy as np

    from distribuuuu_tpu_torch.lm.generate import GenerateEngine
    from distribuuuu_tpu_torch.models.gpt import GPT
    from distribuuuu_tpu_torch.models.regnet import _regnet
    from distribuuuu_tpu_torch.utils import orbax, weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ORBAX_TOY, "meta.json")) as f:
        meta = json.load(f)
    reads = {}
    for name in ("cnn_best", "cnn_full", "gpt_best"):
        path = os.path.join(ORBAX_TOY, name)
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)
        t0 = time.perf_counter()
        tree = orbax.read_checkpoint(path, keys=orbax.WEIGHT_KEYS)
        dt = time.perf_counter() - t0
        n = sum(a.size for a in _tree_leaves(tree))
        reads[name] = {"dir_bytes": size, "weights": n, "read_s": dt}
    images = np.load(os.path.join(ORBAX_TOY, "cnn_images.npy")).astype(np.float32) / 64.0 - 2.0
    want = np.load(os.path.join(ORBAX_TOY, "cnn_logits.npy"))
    kw = {k: v for k, v in meta["regnet"].items() if k != "num_classes"}
    errs = {}
    for name in ("cnn_best", "cnn_full"):
        model = _regnet(meta["regnet"]["num_classes"], **kw, dtype=torch.float32)
        weights.load_weights(model, os.path.join(ORBAX_TOY, name))
        model = model.to(dev).eval()
        with torch.inference_mode():
            got = model(torch.from_numpy(images).to(dev)).float().cpu().numpy()
        errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
    g = meta["gpt"]
    gpt = weights.load_weights(GPT(**g, dtype=torch.float32), os.path.join(ORBAX_TOY, "gpt_best"))
    prompts = np.load(os.path.join(ORBAX_TOY, "gpt_prompts.npy"))
    want_tokens = np.load(os.path.join(ORBAX_TOY, "gpt_tokens.npy")).tolist()
    eng = GenerateEngine(gpt, device=dev, eos_id=-1, prompt_len=prompts.shape[1],
                         max_new_tokens=meta["new_tokens"], batch_tiles=[1, 2],
                         cache_tiles=[g["seq_len"]])
    da.reset_launch_counts()
    eng.start()
    streams = [s.result(timeout=120) for s in [eng.submit(p.tolist()) for p in prompts]]
    eng.drain()
    jaxlike = ("jax", "jaxlib", "flax", "orbax", "tensorstore", "zstandard", "distribuuuu_tpu")
    res = {"phase": "orbax_weights",
           "jax_modules_loaded": sorted(m for m in sys.modules if m.split(".")[0] in jaxlike),
           "reads": reads, "rel_err_vs_jax_f32": errs, "rel_tol": ORBAX_REL_TOL,
           "gpt_streams_equal_jax": streams == want_tokens,
           "decode_attention_launches": da.launches}
    emit(res)
    if max(errs.values()) > ORBAX_REL_TOL or streams != want_tokens \
            or res["jax_modules_loaded"]:
        raise AssertionError(f"orbax weights on the card: {res} (streams {streams}, "
                             f"JAX {want_tokens})")
    return res


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


def _resnet50_serve_cfg(mode: str = "", queue: int = 4 * QUANT_REQUESTS):
    """config/resnet50.yaml as slice_phase serves it (bf16, buckets
    1/2/4/8, RNG_SEED 0), SERVE.QUANTIZE ``mode``; the same list the fleet's
    replicas get on their command line."""
    return ["DEVICE.COMPUTE_DTYPE", "bfloat16", "RNG_SEED", "0", "SERVE.MAX_BATCH", "8",
            "SERVE.BUCKET_SIZES", "[1, 2, 4, 8]", "SERVE.MAX_QUEUE", str(queue),
            "SERVE.MAX_WAIT_MS", "2.0", *(["SERVE.QUANTIZE", mode] if mode else [])]


def quantize_serve_phase(torch, ce, dev, fleet_payloads) -> dict:
    """config/resnet50.yaml at full width served full precision, bf16 and
    int8 (engines built in turns, kept; two bursts of QUANT_REQUESTS each,
    in turns): each mode's logits against full precision's
    (``rel_logits_delta`` <= quantize.TOLERANCE), top-1 agreement, JAX's
    byte meta, the engine's allocated and pool bytes, img/s and p50/p99,
    conv-epilogue launches; every bucket a captured graph; the int8
    logits against the port's f32 CPU forward of the same packed weights.
    Also returns the int8 engine's answers to ``fleet_payloads`` (through
    the replicas' val transform), the fleet's reference."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.serve import ServeMetrics, engine_from_cfg, protocol
    from distribuuuu_tpu_torch.serve import quantize as qlib

    images = np.random.default_rng(18).integers(0, 256, (QUANT_REQUESTS, 224, 224, 3), np.uint8)
    engines, rows = {}, {}
    for mode in ("", "bf16", "int8"):
        config.reset_cfg()
        config.merge_from_file("config/resnet50.yaml")
        cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "SERVE.DEVICE", 0,
                             *_resnet50_serve_cfg(mode)])
        torch.cuda.synchronize(dev)
        a0, r0 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        ce.conv1x1_bn_act.launches = 0
        t0 = time.perf_counter()
        eng = engines[mode] = engine_from_cfg().start()
        torch.cuda.synchronize(dev)
        rows[mode] = {
            "build_s": time.perf_counter() - t0, "warmup_conv_epilogue": ce.conv1x1_bn_act.launches,
            "allocated_bytes": torch.cuda.memory_allocated(dev) - a0,
            "reserved_bytes": torch.cuda.memory_reserved(dev) - r0,
            "pool_bytes": eng.memory["pool_bytes"], "packed_bytes": eng.memory["packed_bytes"],
            "meta": eng.quantize_meta, "walls": [], "p50_ms": [], "p99_ms": [],
            "batches": 0, "conv_epilogue_launches": 0,
            "graphs": sorted(b for b, g in eng._graphs.items() if g.graph is not None)}
    logits = {}
    for _ in range(2):  # bursts in turns
        for mode, eng in engines.items():
            eng.metrics = ServeMetrics()
            ce.conv1x1_bn_act.launches = 0
            t0 = time.perf_counter()
            futs = [eng.submit(img) for img in images]
            logits[mode] = np.stack([f.result(timeout=300) for f in futs])
            row, st = rows[mode], eng.metrics.snapshot()
            row["walls"].append(time.perf_counter() - t0)
            row["p50_ms"].append(st["p50_ms"])
            row["p99_ms"].append(st["p99_ms"])
            row["batches"] += st["batches"]
            row["conv_epilogue_launches"] += ce.conv1x1_bn_act.launches
    transform = protocol.make_transform()  # the replicas' val pipeline, this cfg
    eng = engines["int8"]
    fleet_ref = np.stack([f.result(timeout=300) for f in
                          [eng.submit(transform(p)) for p in fleet_payloads]])
    for e in engines.values():
        e.drain()
    ref = logits[""]
    scale = float(np.abs(ref).max())
    for mode, row in rows.items():
        row["img_per_s"] = [QUANT_REQUESTS / w for w in row.pop("walls")]
        if mode:
            row["rel_logits_delta"] = float(np.abs(logits[mode] - ref).max()) / scale
            row["tolerance"] = qlib.TOLERANCE[mode]
            row["top1_agree"] = float((logits[mode].argmax(1) == ref.argmax(1)).mean())
    # the int8 card logits against the port's f32 CPU forward of the packed weights
    seeded = trainer.build_model_from_cfg()
    packed, _ = qlib.quantize_state(seeded, "int8")
    cpu_model = build_model("resnet50", num_classes=cfg.MODEL.NUM_CLASSES, dtype=torch.float32)
    cpu_model.load_state_dict({**seeded.state_dict(), **qlib.dequantize_state(packed)})
    with torch.inference_mode():
        cpu = cpu_model.eval()(normalize_on_device(torch.from_numpy(
            images[:QUANT_CPU_CHECK]))).numpy()
    int8_cpu = float(np.abs(logits["int8"][:QUANT_CPU_CHECK] - cpu).max() / np.abs(cpu).max())
    res = {"phase": "quantize_serve", "arch": "resnet50", "requests": QUANT_REQUESTS,
           "modes": {m or "full": r for m, r in rows.items()},
           "int8_vs_cpu_f32_rel": int8_cpu, "rel_tol": SLICE_REL_TOL}
    emit(res)
    bad = [m for m, r in rows.items() if m and r["rel_logits_delta"] > r["tolerance"]]
    bad += [m or "full" for m, r in rows.items() if r["graphs"] != [1, 2, 4, 8]
            or r["conv_epilogue_launches"] != 33 * r["batches"]]
    if bad or int8_cpu > SLICE_REL_TOL or rows["int8"]["meta"]["quantized_leaves"] != 54:
        raise AssertionError(f"quantize_serve: {bad}, int8 vs CPU {int8_cpu}")
    return {"conv_epilogue": sum(r["conv_epilogue_launches"] + r["warmup_conv_epilogue"]
                                 for r in rows.values()),
            "fleet_ref": fleet_ref}


def _fleet_cmd(yaml: str, port: int, out: str, opts) -> list:
    return [sys.executable, "-m", "distribuuuu_tpu_torch.serve_net", "--cfg", yaml,
            "--fleet", "2", *opts, "SERVE.FLEET.AUTOSCALE", "False",
            "SERVE.FLEET.HEALTH_PERIOD_S", "0.5", "SERVE.FLEET.EMIT_INTERVAL_S", "1.0",
            "SERVE.PORT", str(port), "OUT_DIR", out]


def _start_fleet(yaml: str, out: str, opts):
    """``serve_net --fleet 2`` in a subprocess (its log in ``out``); returns
    (process, router port)."""
    from distribuuuu_tpu_torch.serve.fleet import free_port

    port = free_port()
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    log = open(os.path.join(out, "router.log"), "w")
    proc = subprocess.Popen(_fleet_cmd(yaml, port, out, opts), env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
    log.close()
    return proc, port


def _router_stats(port: int):
    import socket

    from distribuuuu_tpu_torch.serve import protocol

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
            protocol.send_frame(c, protocol.ctrl_request("stats"))
            return json.loads(protocol.recv_frame(c))
    except OSError:
        return None


def _wait_for(pred, timeout: float, what: str):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.2)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _stop_fleet(proc, out: str) -> dict:
    """SIGTERM the router (the fleet drains), wait, and read each
    replica's kernel launches from its log (the drain's line, else the
    warm-up's) and the router's records."""
    import re

    proc.terminate()
    rc = proc.wait(timeout=120)
    launches = {}
    for name in sorted(os.listdir(os.path.join(out, "fleet"))):
        if not name.endswith(".log"):
            continue
        text = open(os.path.join(out, "fleet", name)).read()
        found = re.findall(r"kernel launches (after warm-up|at drain): (\{.*\})", text)
        if found:
            launches[name[:-4]] = {"drained": found[-1][0] == "at drain", **json.loads(found[-1][1])}
    recs = _read_jsonl(os.path.join(out, "telemetry", "rank00000.jsonl"))
    return {"rc": rc, "launches": launches, "router_records": recs}


def _ask(port: int, payload: bytes, conn=None) -> dict:
    import socket

    from distribuuuu_tpu_torch.serve import protocol

    c = conn or socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        protocol.send_frame(c, payload)
        return json.loads(protocol.recv_frame(c))
    finally:
        if conn is None:
            c.close()


def _burst(port: int, payloads, clients: int = FLEET_CLIENTS, during=None):
    """``payloads`` over ``clients`` persistent connections at once;
    (answers in order, wall s, per-request ms). ``during`` runs once the
    burst is under way."""
    import socket
    import threading

    answers, lat = [None] * len(payloads), [0.0] * len(payloads)

    def client(k):
        with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
            for i in range(k, len(payloads), clients):
                t0 = time.perf_counter()
                answers[i] = _ask(port, payloads[i], c)
                lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        time.sleep(0.1)
        during()
    for t in threads:
        t.join(300)
    return answers, time.perf_counter() - t0, lat


def _npy_payload(img) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def fleet_serve_phase(fleet, payloads, ref, meanwhile=None) -> dict:
    """``serve_net --fleet 2 --cfg config/resnet50.yaml SERVE.QUANTIZE
    int8`` (started by the caller): FLEET_REQUESTS answers through the
    router against the in-process int8 engine's; the fleet's img/s over
    FLEET_CLIENTS connections against one replica's (the same load sent
    to its own port), the router's added p50 (FLEET_SEQ sequential
    requests each way); a replica SIGKILLed 0.1 s into a burst of four
    times the requests: no request lost, the pool back at its target
    (``meanwhile()`` runs while the replacement warms); the replicas'
    conv-epilogue launches from their logs; the router's fleet.* records
    valid."""
    import numpy as np

    from distribuuuu_tpu_torch.serve.fleet import probe_stats
    from distribuuuu_tpu_torch.telemetry import schema

    proc, port, out = fleet
    t0 = time.perf_counter()
    st = _wait_for(lambda: (lambda s: s if s and s["routable"] == 2 else None)(_router_stats(port)),
                   300, "the image fleet's two replicas")
    warm_s = time.perf_counter() - t0
    answers, wall, _ = _burst(port, payloads)
    got = np.array([a["logits"] for a in answers], np.float32)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    top1 = float((got.argmax(1) == ref.argmax(1)).mean())
    one = st["per_replica"][0]
    _, one_wall, _ = _burst(one["port"], payloads)
    _, fleet_wall, _ = _burst(port, payloads)
    seq_router = _burst(port, payloads[:FLEET_SEQ], clients=1)[2]
    seq_direct = _burst(one["port"], payloads[:FLEET_SEQ], clients=1)[2]
    victim = _router_stats(port)["per_replica"][0]
    pid = probe_stats(("127.0.0.1", victim["port"]))["pid"]
    killed, kwall, _ = _burst(port, payloads * 4, during=lambda: os.kill(pid, 9))
    lost = sum(1 for a in killed if a is None or "logits" not in a)
    t1 = time.perf_counter()
    side = meanwhile() if meanwhile is not None else None
    after = _wait_for(lambda: (lambda s: s if s and s["routable"] == 2 and victim["replica"] not in
                               [r["replica"] for r in s["per_replica"]] else None)(
        _router_stats(port)), 300, "the replacement replica")
    replace_s = time.perf_counter() - t1
    stop = _stop_fleet(proc, out)
    bad_recs = []
    for r in stop["router_records"]:
        try:
            schema.validate_record(r)
        except schema.SchemaError as e:
            bad_recs.append(str(e))
    kinds = sorted({r["kind"] for r in stop["router_records"] if r["kind"].startswith("fleet.")})
    res = {"phase": "fleet_serve", "replicas": 2, "quantize": "int8",
           "requests": len(payloads), "warm_s": warm_s,
           "rel_err_vs_in_process_int8": rel, "rel_tol": SLICE_REL_TOL, "top1_agreement": top1,
           "first_burst_img_per_s": len(payloads) / wall,
           "fleet_img_per_s": len(payloads) / fleet_wall,
           "one_replica_img_per_s": len(payloads) / one_wall,
           "fleet_over_one": one_wall / fleet_wall,
           "router_p50_ms": _pct(seq_router, 0.5), "direct_p50_ms": _pct(seq_direct, 0.5),
           "router_added_p50_ms": _pct(seq_router, 0.5) - _pct(seq_direct, 0.5),
           "killed_replica": victim["replica"], "burst_with_kill_answered": len(killed) - lost,
           "lost": lost, "kill_burst_wall_s": kwall, "replacement_s": replace_s,
           "replicas_after": [r["replica"] for r in after["per_replica"]],
           "rerouted": after["rerouted"], "replica_failures": after["replica_failures"],
           "router_rc": stop["rc"], "fleet_kinds": kinds, "invalid_records": bad_recs,
           "replica_launches": stop["launches"]}
    emit(res)
    if rel > SLICE_REL_TOL or lost or stop["rc"] != 0 or bad_recs \
            or not {"fleet.stats", "fleet.replica"} <= set(kinds) \
            or not all(v["drained"] for k, v in stop["launches"].items()
                       if k != f"replica{victim['replica']}"):
        raise AssertionError(f"fleet_serve: {res}")
    return {"conv_epilogue": sum(v["conv_epilogue"] for v in stop["launches"].values()),
            "meanwhile": side}


def _lm_fleet_opts(weights_path: str) -> list:
    return ["DEVICE.COMPUTE_DTYPE", "float32", "RNG_SEED", "0", "GENERATE.EOS_ID", "-1",
            "MODEL.WEIGHTS", weights_path, "SERVE.LONG_PROMPT_THRESHOLD",
            str(LM_FLEET_THRESHOLD), "SERVE.MAX_QUEUE", "64"]


def lm_fleet_weights(torch, path: str) -> str:
    """A gpt_nano state dict from seed 5, written as the user's ``.pth``."""
    from distribuuuu_tpu_torch.models import build_model

    model = build_model("gpt_nano", num_classes=320, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), path)
    return path


def lm_fleet_reference(torch, weights_path: str, prompts) -> list:
    """The greedy streams of one in-process engine under the LM fleet's
    config: what every stream through the fleet must equal."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.lm import service as lm_service

    config.reset_cfg()
    config.merge_from_file("config/gpt_nano.yaml")
    cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "SERVE.DEVICE", 0,
                         *_lm_fleet_opts(weights_path)])
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = lm_service.engine_from_cfg()
    eng.start()
    want = [s.result(timeout=300) for s in [eng.submit(p) for p in prompts]]
    eng.drain()
    return want


def fleet_lm_phase(fleet, prompts, want) -> dict:
    """``serve_net --fleet 2 --cfg config/gpt_nano.yaml`` at f32 with
    ``MODEL.WEIGHTS`` a ``.pth`` and SERVE.LONG_PROMPT_THRESHOLD
    LM_FLEET_THRESHOLD (started by the caller): LM_FLEET_REQUESTS streamed
    greedy requests through the router, short and long prompts at once,
    identical to one in-process engine's streams (``want``); the router's
    fleet.length_class rows for both classes; the replicas'
    decode-attention launches from their logs."""
    import threading

    from distribuuuu_tpu_torch.lm import service as lm_service
    from distribuuuu_tpu_torch.telemetry import schema

    proc, port, out = fleet
    t0 = time.perf_counter()
    _wait_for(lambda: (lambda s: s if s and s["routable"] == 2 else None)(_router_stats(port)),
              300, "the LM fleet's two replicas")
    warm_s = time.perf_counter() - t0
    got = [None] * len(prompts)

    def one(i):
        frames = list(lm_service.generate_request("127.0.0.1", port, tokens=prompts[i],
                                                  timeout=120))
        got[i] = [f["token"] for f in frames if "token" in f]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t1
    stats = _router_stats(port)
    stop = _stop_fleet(proc, out)
    rows = {r["length_class"]: r for r in stop["router_records"]
            if r["kind"] == "fleet.length_class"}
    for r in stop["router_records"]:
        schema.validate_record(r)
    res = {"phase": "fleet_lm", "replicas": 2, "dtype": "float32", "requests": len(prompts),
           "threshold": LM_FLEET_THRESHOLD, "warm_s_left": warm_s,
           "streams_equal_in_process": got == want, "tokens": sum(len(s) for s in got),
           "tokens_per_s": sum(len(s) for s in got) / wall, "wall_s": wall,
           "length_classes": stats.get("length_classes"),
           "length_class_records": sorted(rows), "router_rc": stop["rc"],
           "replica_launches": stop["launches"]}
    emit(res)
    if got != want or set(rows) != {"short", "long"} or stop["rc"] != 0 \
            or not all(v["drained"] for v in stop["launches"].values()):
        raise AssertionError(f"fleet_lm: {res}")
    return {"decode_attention": sum(v["decode_attn"] for v in stop["launches"].values())}


def slice18_phases(torch, ce, da, dev) -> dict:
    """orbax_weights, quantize_serve, then both fleets started at once:
    while they warm, the LM fleet's in-process reference; the image fleet's
    phase (fleet_serve), whose killed replica's replacement warms while
    the LM fleet's phase (fleet_lm) runs. Their launch counts for the
    kernels line."""
    import shutil

    import numpy as np

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_slice18_")
    fleets = []
    try:
        orbax_res = orbax_weights_phase(torch, da, dev)
        payloads = [_npy_payload(img) for img in np.random.default_rng(19).integers(
            0, 256, (FLEET_REQUESTS, 224, 224, 3), np.uint8)]
        quant = quantize_serve_phase(torch, ce, dev, payloads)
        img_out, lm_out = os.path.join(work, "fleet_img"), os.path.join(work, "fleet_lm")
        pth = lm_fleet_weights(torch, os.path.join(work, "gpt_nano_seed5.pth"))
        fleets.append(_start_fleet("config/resnet50.yaml", img_out,
                                   _resnet50_serve_cfg("int8", 256)))
        fleets.append(_start_fleet("config/gpt_nano.yaml", lm_out, _lm_fleet_opts(pth)))
        prompts = _lm_prompts(LM_FLEET_REQUESTS, seed=18)
        want = lm_fleet_reference(torch, pth, prompts)
        fleet_img = fleet_serve_phase(
            (*fleets[0], img_out), payloads, quant["fleet_ref"],
            meanwhile=lambda: fleet_lm_phase((*fleets[1], lm_out), prompts, want))
        fleet_lm = fleet_img["meanwhile"]
    finally:
        for proc, _ in fleets:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "slice18_seconds", "seconds": time.perf_counter() - t0})
    return {"conv_epilogue": quant["conv_epilogue"] + fleet_img["conv_epilogue"],
            "decode_attention": orbax_res["decode_attention_launches"]
            + fleet_lm["decode_attention"]}


# -- slice 19: the live plane: campaigns, the run monitor, the soak -----------
CAMPAIGN_DEGRADE = "config/campaigns/degrade.yaml"
CAMPAIGN_LM = "config/campaigns/lm_decode.yaml"
# the schedule hashes the JAX package's DSL gives the two shipped YAMLs (its
# committed SERVE_CAMPAIGN_r03.json; tests/test_torch_campaign.py holds the
# port's DSL to the JAX package's on every shipped YAML on the CPU)
JAX_SCHEDULE_HASH = {
    "degrade_under_pressure": "7f8bc2618a919260d5e3047428feb6ae8fe5225344a833b410d2c1e29ce8e895",
    "lm_decode": "ec7f68c1effa99320cab0d5cda1033d3cd8be0dc26f9a306c50195f3aa7b5a9c",
}
# the capacity each shipped YAML's rates were written for: the requests a
# second the premium model's one replica answered while the YAML's own
# burst saturated it, in the JAX package's committed run of it on a
# one-core CPU (SERVE_CAMPAIGN_r03.json): the model's answers in the burst
# phase, less the phase's off-burst arrivals, over the burst window.
# resnet50: (214 - 9 - 11 - 2 * 14 * 0.55) / (14 * 0.45) s; gpt_nano:
# (222 - 2 * 12 * 0.65) / (12 * 0.35) s. Scaling by card capacity over
# these keeps each burst's overload factor (2.1x and 4.1x) as shipped.
CAMPAIGN_REF_RPS = {"degrade_under_pressure": (214 - 9 - 11 - 2 * 14 * 0.55) / (14 * 0.45),
                    "lm_decode": (222 - 2 * 12 * 0.65) / (12 * 0.35)}
CAMPAIGN_CAP_CLIENTS = 4  # closed-loop clients of the capacity probe
CAMPAIGN_CAP_S = 1.0  # seconds of one capacity probe
CAMPAIGN_PROBES = 3  # capacity probes in a row; k from their median
# threads of the open-loop client: a thread is held for a request's whole
# latency. The degrade burst's answered requests wait in two 16-deep queues
# (hundreds of ms on a slow host); the LM's refused streams return in about a
# ms, and more threads than that cost the client more CPU than its requests
CAMPAIGN_WORKERS = {"degrade_under_pressure": 512, "lm_decode": 128}
CAMPAIGN_PAYLOADS = 16  # distinct uint8 224² images of the degrade campaign
MONITOR_RULES = "config/monitor_rules.yaml"
MONITOR_TICK_S = {"telemetry_train": 0.5, "recompile_storm": 0.1}
SOAK_PER_CLASS = 8  # images a class of the soak's corpus: 8 batches of 4 an epoch
SOAK_TICK_S = 1.0  # the soak monitor's interval


class LiveMonitor:
    """``python -m distribuuuu_tpu_torch.telemetry.live RUN --json-lines
    --prometheus-port -1 --rules config/monitor_rules.yaml`` in a
    subprocess, attached to a run directory before the run starts.
    ``finish()`` waits two ticks past the run's end, optionally scrapes
    /metrics once, reads the monitor's CPU seconds, interrupts it (its
    drain), and keeps its snapshots and alerts in ``result``."""

    def __init__(self, run_dir: str, interval: float):
        import threading

        os.makedirs(run_dir, exist_ok=True)
        self.run_dir, self.interval = run_dir, interval
        self.lines, self.result = [], None
        self._ready = threading.Event()
        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distribuuuu_tpu_torch.telemetry.live", run_dir,
             "--json-lines", "--prometheus-port", "-1", "--rules", MONITOR_RULES,
             "--interval", str(interval)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        if not self._ready.wait(60):
            self.proc.kill()
            raise AssertionError(f"monitor did not start: {self.lines}")

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if line.startswith("monitor: watching"):
                self._ready.set()

    def finish(self, scrape: bool = False) -> dict:
        import signal
        import urllib.request

        time.sleep(2 * self.interval + 0.2)
        page = None
        if scrape:
            url = next(ln.split(" on ", 1)[1] for ln in self.lines if "/metrics on " in ln)
            with urllib.request.urlopen(url, timeout=10) as r:
                page = r.read().decode()
        with open(f"/proc/{self.proc.pid}/stat") as f:
            ticks = f.read().rsplit(")", 1)[1].split()
        cpu_s = (int(ticks[11]) + int(ticks[12])) / os.sysconf("SC_CLK_TCK")
        self.proc.send_signal(signal.SIGINT)
        rc = self.proc.wait(30)
        self._reader.join(10)
        snaps = [json.loads(ln) for ln in self.lines if ln.startswith("{")]
        alerts = [r for r in _read_jsonl(os.path.join(self.run_dir, "MONITOR.jsonl"))
                  if r["kind"] == "alert"]
        self.result = {"rc": rc, "snapshots": snaps, "alerts": alerts, "metrics_page": page,
                       "cpu_s": cpu_s, "done_line": self.lines[-1] if self.lines else ""}
        if scrape:
            from distribuuuu_tpu_torch.telemetry import report

            self.result["report"] = report.build_report(self.run_dir)
        return self.result


def monitor_live_phase(runs: dict) -> None:
    """The two monitored runs: telemetry_train's must raise no alert, its
    last snapshot's totals (steps, graph captures) and the checkpoint saves
    of its snapshots must equal ``telemetry/report.build_report`` of the
    finished run, and the scraped /metrics must carry those totals; the
    recompile drill's storm run must raise exactly recompile-storm."""
    tel, storm = runs["telemetry_train"].result, runs["recompile_storm"].result
    rep, last = tel["report"], tel["snapshots"][-1]
    saves = sum(s["ckpt"]["saves"] for s in tel["snapshots"])
    totals = {"steps": last["totals"]["steps"], "compiles": last["totals"]["compiles"],
              "ckpt_saves": saves}
    want = {"steps": rep["step"]["count"], "compiles": rep["recompiles"]["count"],
            "ckpt_saves": rep["checkpoint"]["saves"]}
    page_ok = (f"dtpu_steps_total {totals['steps']}\n" in tel["metrics_page"]
               and f"dtpu_recompiles_total {totals['compiles']}\n" in tel["metrics_page"])
    storm_rules = sorted(a["rule"] for a in storm["alerts"])
    res = {"phase": "monitor_live", "rules": MONITOR_RULES,
           "telemetry_train": {"tick_s": MONITOR_TICK_S["telemetry_train"],
                               "ticks": len(tel["snapshots"]),
                               "alerts": [a["rule"] for a in tel["alerts"]],
                               "totals": totals, "report": want, "metrics_scraped": page_ok,
                               "monitor_cpu_s": tel["cpu_s"], "rc": tel["rc"]},
           "recompile_storm": {"tick_s": MONITOR_TICK_S["recompile_storm"],
                               "ticks": len(storm["snapshots"]), "alerts": storm_rules,
                               "alert_values": [a["value"] for a in storm["alerts"]],
                               "monitor_cpu_s": storm["cpu_s"], "rc": storm["rc"]}}
    emit(res)
    if tel["alerts"] or totals != want or not page_ok or storm_rules != ["recompile-storm"] \
            or tel["rc"] or storm["rc"]:
        raise AssertionError(f"monitor_live: {res}")


def card_spec(path: str, k: float):
    """The card's spec of a shipped campaign YAML: every ``rate_rps`` and
    ``peak_rps`` times ``k``, every model's ``p99_slo_ms`` and every
    p99-breach threshold (the ms thresholds) over ``k``; the seed, phase
    kinds, burst shapes, durations, rules, expectations and count
    thresholds as shipped."""
    import yaml

    from distribuuuu_tpu_torch.serve.campaign import dsl

    with open(path) as f:
        doc = yaml.safe_load(f)
    for p in doc["phases"]:
        for key in ("rate_rps", "peak_rps"):
            if key in p:
                p[key] = float(p[key]) * k
    for m in doc["models"]:
        if m.get("p99_slo_ms") is not None:
            m["p99_slo_ms"] = float(m["p99_slo_ms"]) / k
    for r in doc.get("rules") or []:
        if r["kind"] == "p99-breach":
            r["threshold"] = float(r["threshold"]) / k
    return dsl.parse_campaign(doc)


def _capacity_rps(router, model: str, payload_for) -> float:
    """Closed-loop capacity of a warmed fleet's ``model``: CAMPAIGN_CAP_CLIENTS
    clients through the router for CAMPAIGN_CAP_S, answered requests a
    second."""
    import threading

    from distribuuuu_tpu_torch.serve import protocol

    done, stop = [0] * CAMPAIGN_CAP_CLIENTS, time.perf_counter() + CAMPAIGN_CAP_S

    def client(i):
        while time.perf_counter() < stop:
            payload = payload_for(model)
            if payload.startswith(protocol.CTRL_MAGIC):
                resp = router.dispatch_generate(payload, model=model)
            else:
                resp = router.dispatch(protocol.model_envelope(model, payload))
            done[i] += not resp.startswith(b'{"error"')

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(CAMPAIGN_CAP_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(done) / (time.perf_counter() - t0)


def _replica_launches(fleet) -> dict:
    """The kernel launches each replica named in its log at its drain."""
    import re

    out = {}
    for model, logs in fleet.replica_logs().items():
        for path in logs:
            with open(path) as f:
                found = re.findall(r"kernel launches (after warm-up|at drain): (\{.*\})", f.read())
            if found:
                out[f"{model}/{os.path.basename(path)[:-4]}"] = {
                    "drained": found[-1][0] == "at drain", **json.loads(found[-1][1])}
    return out


class _GcPauses:
    """Every garbage collection of this process while armed (``gc.callbacks``):
    its generation, milliseconds and start on the ``perf_counter`` clock."""

    def __init__(self):
        self.events, self._t = [], None

    def __call__(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._t = now
        elif self._t is not None:
            self.events.append((info["generation"], (now - self._t) * 1e3, self._t))
            self._t = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self)

    def summary(self, since: float) -> dict:
        out = {}
        for gen in (0, 1, 2):
            ms = [e[1] for e in self.events if e[0] == gen]
            out[f"gen{gen}"] = {"count": len(ms), "max_ms": max(ms, default=0.0),
                                "total_ms": sum(ms)}
        out["over_10ms"] = [[e[0], e[1], e[2] - since] for e in self.events if e[1] > 10.0]
        return out


def _tail(lat: list, since: float = 0.0) -> dict:
    """p50/p99/max ms of ``(scheduled s, seconds)`` requests and the five
    slowest with their scheduled times."""
    import numpy as np

    if not lat:
        return {"n": 0}
    ms = np.array([x[1] for x in lat]) * 1e3
    slow = sorted(lat, key=lambda x: -x[1])[:5]
    return {"n": len(lat), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max()),
            "slowest": [[round(t, 3), round(d * 1e3, 3)] for t, d in slow]}


def campaign_phase(name: str, path: str, fleet, payloads):
    """One shipped campaign on its warmed fleet: CAMPAIGN_PROBES capacity
    probes in a row (k from their median, the spread printed), the card
    spec, the open-loop replay refereed phase by phase, each phase's
    client-side latency tail and this process's garbage collections over
    the replay; then the fleet drains in the background. Returns
    ``finish()``, which joins the drain, reads the replicas' launches,
    emits the phase and requires ``ok`` (alerts exact, control clean), a
    deterministic schedule, the shipped schedule JAX's, and no request
    failed."""
    import threading

    from distribuuuu_tpu_torch import serve_campaign
    from distribuuuu_tpu_torch.serve.campaign import dsl
    from distribuuuu_tpu_torch.serve.campaign.runner import CampaignRunner

    t0 = time.perf_counter()
    shipped = dsl.load_campaign(path)
    shipped_hash = dsl.schedule_hash(dsl.build_schedule(shipped))
    payload_for = serve_campaign.cycler(payloads)
    model = shipped.models[0]["name"]
    probes = [_capacity_rps(fleet.router, model, payload_for) for _ in range(CAMPAIGN_PROBES)]
    cap = statistics.median(probes)
    k = cap / CAMPAIGN_REF_RPS[shipped.name]
    spec = card_spec(path, k)
    for m in spec.models:  # the router's SLO targets become the card spec's
        fleet.router.register_model(m["name"], slo_class=m["slo_class"],
                                    p99_slo_ms=m["p99_slo_ms"], overflow_to=m["overflow_to"])
    h1, h2 = (dsl.schedule_hash(dsl.build_schedule(spec)) for _ in range(2))
    runner = CampaignRunner(spec, fleet.router, payload_for=payload_for, fleet=fleet,
                            max_workers=CAMPAIGN_WORKERS[shipped.name])
    import gc

    t_gc = time.perf_counter()
    gc.collect()  # the same collection on the frozen heap (fleet.gc_full_ms: before it froze)
    gc_frozen_ms = (time.perf_counter() - t_gc) * 1e3
    try:
        with _GcPauses() as gcp:
            t_replay = time.perf_counter()
            verdict = runner.run()
    finally:  # the fleet drains while the caller goes on
        drain = threading.Thread(target=fleet.shutdown)
        drain.start()
    seconds = time.perf_counter() - t0
    failed = sum(p["counts"]["failed"] + p["counts"]["unknown_model"]
                 for p in verdict["phases"])
    slo = {m["name"]: m["p99_slo_ms"] for m in spec.models}
    res = {"phase": f"campaign_{name}", "yaml": path, "campaign": shipped.name,
           "capacity_rps": cap, "capacity_probes_rps": probes,
           "probe_spread": max(probes) / max(min(probes), 1e-9),
           "ref_rps": CAMPAIGN_REF_RPS[shipped.name], "k": k,
           "shipped_schedule_hash": shipped_hash,
           "shipped_hash_is_jax": shipped_hash == JAX_SCHEDULE_HASH[shipped.name],
           "card_schedule_hash": verdict["schedule_hash"], "deterministic": h1 == h2
           == verdict["schedule_hash"], "requests_scheduled": verdict["requests_scheduled"],
           "phases": [{**{key: p[key] for key in ("name", "expected", "raised", "ok", "counts",
                                                  "degraded_delta", "p99_ms_end",
                                                  "send_lag_ms")},
                       "alert_values": [[a["rule"], a["value"]] for a in p["alerts"]]}
                      for p in verdict["phases"]],
           "models": {m: dict(r, p99_over_slo=(r["p99_ms"] / slo[m] if slo.get(m) else None))
                      for m, r in verdict["models"].items()},
           "alerts_exact": verdict["alerts_exact"], "control_clean": verdict["control_clean"],
           "client_latency": {p.name: _tail(lat) for p, lat in zip(spec.phases,
                                                                  runner.latencies)},
           "gc": gcp.summary(t_replay), "gc_full_ms_at_routable": fleet.gc_full_ms,
           "gc_full_ms_frozen": gc_frozen_ms,
           "failed": failed, "seconds": seconds}

    def finish() -> dict:
        drain.join()
        res["replica_launches"] = launches = _replica_launches(fleet)
        emit(res)
        if not (verdict["ok"] and res["deterministic"] and res["shipped_hash_is_jax"]
                and failed == 0 and launches and all(v["drained"] for v in launches.values())):
            raise AssertionError(f"campaign_{name}: {res}")
        return res

    return finish


def soak_smoke_phase(work: str, on_divergence=None) -> dict:
    """``python -m distribuuuu_tpu_torch.soak --smoke --serve --per-class
    SOAK_PER_CLASS`` on the card: the control and nonfinite intervals each
    raise exactly their expected alerts, the nonfinite interval's gate is
    evaluated and passes, the fleet's hot-reloads lose no request and
    change the served logits, the monitored control run is bitwise the
    unmonitored rerun, and the training runs launch opt_update.
    ``on_divergence()`` runs once the soak starts its unmonitored rerun,
    whose time nothing reads."""
    t0 = time.perf_counter()
    out = os.path.join(work, "SOAK.json")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-m", "distribuuuu_tpu_torch.soak", "--smoke",
                             "--serve", "--per-class", str(SOAK_PER_CLASS), "--interval-s",
                             str(SOAK_TICK_S), "--work-dir", work, "--out", out],
                            cwd=root, env=dict(os.environ, PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if on_divergence is not None and line.startswith("soak: divergence check"):
            on_divergence()
    rc = proc.wait(900)
    log = "".join(lines)
    if rc != 0 and not os.path.exists(out):
        raise AssertionError(f"soak_smoke rc {rc}: {log[-3000:]}")
    with open(out) as f:
        v = json.load(f)
    serve = v["serve"] or {}
    res = {"phase": "soak_smoke", "rc": rc, "ok": v["ok"],
           "per_class": SOAK_PER_CLASS, "batches": v["train_batches_per_interval"],
           "intervals": [{key: i.get(key) for key in ("name", "expected_alerts", "raised_alerts",
                                                      "alerts_exact", "duration_s", "rc")}
                         | {"gate": None if i["gate"] is None else
                            {"ok": i["gate"]["ok"], "expected": i["gate"]["expected"],
                             "rows": {r["metric"]: [r["baseline"], r["current"], r["tol_pct"],
                                                    r["ok"]] for r in i["gate"]["rows"]}}}
                         for i in v["intervals"]],
           "control_clean": v["control_clean"], "gates_evaluated": v["gates_evaluated"],
           "requests_ok": serve.get("requests_ok"), "requests_failed": serve.get("requests_failed"),
           "hot_reloads": [{key: h[key] for key in ("ok", "failed_during_reload",
                                                    "logits_changed")}
                           for h in serve.get("hot_reloads", [])],
           "bit_identical": v["divergence"].get("bit_identical"),
           "divergence": v["divergence"].get("detail"), "launches": v["kernel_launches"],
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not (rc == 0 and v["ok"] and [i["name"] for i in v["intervals"]]
            == ["control", "nonfinite"] and v["gates_evaluated"] and res["hot_reloads"]
            and all(h["ok"] and h["failed_during_reload"] == 0 and h["logits_changed"]
                    for h in res["hot_reloads"])
            and res["requests_failed"] == 0 and res["bit_identical"]
            and v["kernel_launches"].get("opt_update", 0) >= 3 * v["train_batches_per_interval"]):
        raise AssertionError(f"soak_smoke: {res} {log[-2000:]}")
    return res


def slice19_phases(torch, monitors: dict) -> dict:
    """monitor_live over the two runs ``monitors`` watched; soak_smoke,
    during whose unmonitored rerun both campaign fleets start (their
    warm-ups overlap each other and the rerun); the degrade campaign,
    whose fleet drains while the LM campaign runs. Launch counts for the
    kernels line."""
    import shutil

    import numpy as np

    from distribuuuu_tpu_torch import serve_campaign
    from distribuuuu_tpu_torch.serve.campaign import dsl
    from distribuuuu_tpu_torch.serve.campaign.fleet import MultiModelFleet

    t0 = time.perf_counter()
    monitor_live_phase(monitors)
    work = tempfile.mkdtemp(prefix="chip_smoke_slice19_")
    fleets, started = {}, []
    try:
        for name, path, base, yaml in (
                ("degrade", CAMPAIGN_DEGRADE, serve_campaign.base_cfg, "config/resnet50.yaml"),
                ("lm", CAMPAIGN_LM, serve_campaign.lm_base_cfg, "config/gpt_nano.yaml")):
            spec = dsl.load_campaign(path)
            cdir = os.path.join(work, name)
            fleets[name] = MultiModelFleet(base(cdir, yaml, ["DEVICE.PLATFORM", "auto"]),
                                           serve_campaign.fleet_specs(spec), out_dir=cdir)

        def start_fleets():
            if not started:
                started.append(time.perf_counter())
                for fleet in fleets.values():
                    fleet.start(wait=False)

        soak = soak_smoke_phase(os.path.join(work, "soak"), on_divergence=start_fleets)
        start_fleets()
        t1 = time.perf_counter()
        for fleet in fleets.values():
            fleet.wait_routable()
        emit({"phase": "campaign_fleets_warm", "seconds": time.perf_counter() - started[0],
              "waited_after_soak_s": time.perf_counter() - t1,
              "replicas": {n: f.router.n_routable() for n, f in fleets.items()}})
        images = np.random.default_rng(19).integers(0, 256, (CAMPAIGN_PAYLOADS, 224, 224, 3),
                                                    np.uint8)
        finish_degrade = campaign_phase("degrade", CAMPAIGN_DEGRADE, fleets["degrade"],
                                        [_npy_payload(img) for img in images])
        lm = campaign_phase("lm", CAMPAIGN_LM, fleets["lm"], serve_campaign.lm_payload_bank())()
        degrade = finish_degrade()
    finally:
        for fleet in fleets.values():
            if fleet.router.replicas():  # a campaign phase drains its own fleet
                fleet.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "slice19_seconds", "seconds": time.perf_counter() - t0})
    return {"conv_epilogue": sum(v["conv_epilogue"] for v in degrade["replica_launches"].values()),
            "decode_attention": sum(v["decode_attn"] for v in lm["replica_launches"].values()),
            "opt_update": soak["launches"].get("opt_update", 0)}


# -- slice 20: the MoE family, the model and expert axes ----------------------
MOE_VIT_STEPS = 3  # f32 steps card vs CPU
MOE_VIT_BATCH = 32
MOE_VIT_TIMED = 10  # bf16 graphed steps timed after MOE_VIT_STEPS warm ones
MOE_VIT_LOSS_RTOL = 1e-4  # f32 card vs CPU over MOE_VIT_STEPS steps
MOE_VIT_REQUESTS = 64
MOE_VIT_CPU_CHECK = 8  # served bf16 logits of these against the CPU f32 forward
MOE_LM_CORPUS_MB = 0.3
MOE_LM_PROMPTS = 8
TP_EP_RANKS = 4  # config/gpt_nano_moe.yaml's MODEL 2 x EXPERT 2, DATA -1 -> 1
TP_EP_BATCH = 4  # a process, and the one process's global batch (data axis 1)
TP_EP_STEPS = 3  # sequences in the pack: TP_EP_STEPS x TP_EP_BATCH
TP_EP_LOSS_RTOL = 1e-5
TP_EP_STATE_RTOL = 1e-3  # of each tensor's scale: f32 AdamW steps from sums in other orders
TP_EP_UPDATE_RTOL = 1e-3  # L2 of the difference of the two updates over the one-process one


def _moe_vit_cfg(dtype: str):
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg

    config.reset_cfg()
    config.merge_from_file("config/vit_tiny_moe.yaml")
    cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", dtype,
                         "RNG_SEED", 0, "SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8,
                         "SERVE.BUCKET_SIZES", [1, 2, 4, 8],
                         "SERVE.MAX_QUEUE", 2 * MOE_VIT_REQUESTS, "SERVE.MAX_WAIT_MS", 2.0])
    return cfg


def _moe_vit_steps(torch, device, dtype: str, steps: int, graphed=None):
    """Under config/vit_tiny_moe.yaml in ``dtype`` (RNG_SEED 0 weights):
    the model on ``device``, its optimizer at the warm-up rate and a
    ``trainer.TrainStep``, made here (they read the global config), and
    a function that runs ``steps`` steps on seeded uint8 batches and
    reads no config, so a side thread may run it: it returns the losses,
    the first MoE block's top-k indices of the first batch (before any
    step) and, with ``timed``, the device ms a step over ``timed`` more
    replays and the MoE layers' ms."""
    import numpy as np

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.ops import moe
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer, set_lr
    from distribuuuu_tpu_torch.utils.schedules import get_epoch_lr

    cfg = _moe_vit_cfg(dtype)
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(20)
    im = cfg.TRAIN.IM_SIZE
    batches = [{"image": torch.from_numpy(rng.integers(0, 256, (MOE_VIT_BATCH, im, im, 3),
                                                       np.uint8)),
                "label": torch.from_numpy(rng.integers(0, 1000, MOE_VIT_BATCH).astype(np.int32))}
               for _ in range(steps)]
    model = trainer.build_model_from_cfg().to(device).train()
    opt = construct_optimizer(model)
    set_lr(opt, get_epoch_lr(0))
    step = trainer.TrainStep(model, opt, 5, device=device, graphed=graphed)

    def run(timed: int = 0) -> dict:
        first = model.moe_layers()[0]
        seen = []
        hook = first.register_forward_hook(lambda m, a, o: seen.append(a[0].detach()))
        dev_batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
        with torch.no_grad():  # no autograd graph may outlive this into a capture
            model(trainer.prep_images(dev_batches[0]["image"]))
            x = seen[0].reshape(-1, seen[0].shape[-1]).to(first.dtype)
            idx = moe.top_k_gating(x, first.gate, first.top_k)[1]
        hook.remove()
        losses = [float(step([b], [False])[0, 0]) for b in dev_batches]
        out = {"losses": losses, "routing": idx.cpu(), "lr": opt.lr}
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for i in range(timed):
                step([dev_batches[i % steps]], [False])
            ev[1].record()
            torch.cuda.synchronize()
            out["step_ms"] = ev[0].elapsed_time(ev[1]) / timed
            out["moe_ms"] = _moe_layers_ms(torch, model, dev_batches[0])
        return out

    return run


def _moe_layers_ms(torch, model, batch, reps: int = 20) -> float:
    """The MoE layers' forward and backward (routing, every expert over
    every token, the balancing aux), each on the activation it takes in a
    train forward of ``batch``, as one CUDA graph (``graphs.StepGraph``,
    as the step runs), its replays timed with CUDA events: the device
    time the step spends in them."""
    from distribuuuu_tpu_torch import graphs, trainer

    layers = model.moe_layers()
    ins = []
    hooks = [m.register_forward_hook(lambda m, a, o: ins.append(a[0].detach().clone()))
             for m in layers]
    with torch.no_grad():
        model(trainer.prep_images(batch["image"]))
    for h in hooks:
        h.remove()
    xs = [x.requires_grad_(True) for x in ins]

    def body():
        out = []
        for m, x in zip(layers, xs):
            y = m(x)
            out.extend(torch.autograd.grad(y.float().sum() + m.aux, [x, *m.parameters()]))
            m.aux = None
        return out

    g = graphs.StepGraph(body, device=batch["image"].device)
    g()
    g()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        g()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def moe_vit_phase(torch, ou, dev) -> dict:
    """config/vit_tiny_moe.yaml on the card (module docstring, 15)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as side:
        cpu_run = side.submit(_moe_vit_steps(torch, torch.device("cpu"), "float32",
                                             MOE_VIT_STEPS))
        run = _moe_vit_steps(torch, dev, "float32", MOE_VIT_STEPS)
        ou.update.launches = 0
        card = run()
        f32_launches = ou.update.launches
        run = _moe_vit_steps(torch, dev, "bfloat16", MOE_VIT_STEPS)
        ou.update.launches = 0
        bf16 = run(timed=MOE_VIT_TIMED)
        bf16_launches = ou.update.launches
        # one served burst through the graphed buckets (bf16)
        cfg = _moe_vit_cfg("bfloat16")
        im = cfg.TRAIN.IM_SIZE
        images = np.random.default_rng(21).integers(0, 256, (MOE_VIT_REQUESTS, im, im, 3),
                                                    np.uint8)
        engine, t_build, walls, batches, logits = _serve_bursts(engine_from_cfg, images)
        stats = engine.stats()
        sd = {k: t.cpu() for k, t in engine.model.state_dict().items()}
        del engine
        cpu = cpu_run.result()
    ref = build_model("vit_tiny_moe", num_classes=1000, dtype=torch.float32, img_size=im)
    ref.load_state_dict(sd)
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device

    with torch.inference_mode():
        want = ref.eval()(normalize_on_device(torch.from_numpy(images[:MOE_VIT_CPU_CHECK])))
    want = want.numpy()
    rel = float(np.abs(logits[:MOE_VIT_CPU_CHECK] - want).max() / np.abs(want).max())
    routed_apart = int((card["routing"] != cpu["routing"]).any(-1).sum())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    res = {"phase": "moe_vit", "arch": "vit_tiny_moe", "batch": MOE_VIT_BATCH,
           "lr": card["lr"], "f32_losses_card": card["losses"], "f32_losses_cpu": cpu["losses"],
           "f32_loss_rel_err": loss_rel, "loss_rtol": MOE_VIT_LOSS_RTOL,
           "first_moe_tokens": int(card["routing"].shape[0]),
           "first_moe_tokens_routed_apart": routed_apart,
           "bf16_losses": bf16["losses"], "bf16_step_ms": bf16["step_ms"],
           "bf16_train_img_per_s": MOE_VIT_BATCH / bf16["step_ms"] * 1e3,
           "moe_layers_ms": bf16["moe_ms"], "moe_share_of_step": bf16["moe_ms"] / bf16["step_ms"],
           "opt_update_launches": {"f32": f32_launches, "bf16": bf16_launches},
           "serve_img_per_s": MOE_VIT_REQUESTS / walls[-1], "serve_p50_ms": stats["p50_ms"],
           "serve_p99_ms": stats["p99_ms"], "serve_batches": batches,
           "engine_build_s": t_build, "serve_rel_err_vs_cpu_f32": rel,
           "serve_rel_tol": SLICE_REL_TOL, "seconds": time.perf_counter() - t0}
    emit(res)
    import math

    if routed_apart or loss_rel > MOE_VIT_LOSS_RTOL:
        raise AssertionError(f"moe_vit card vs CPU f32: {routed_apart} tokens routed apart, "
                             f"loss rel err {loss_rel} (tol {MOE_VIT_LOSS_RTOL})")
    if (f32_launches != MOE_VIT_STEPS or bf16_launches != MOE_VIT_STEPS + MOE_VIT_TIMED
            or not all(math.isfinite(x) for x in bf16["losses"])):
        raise AssertionError(f"moe_vit: opt_update launches {f32_launches}, {bf16_launches} "
                             f"or bf16 losses {bf16['losses']}")
    if logits.shape != (MOE_VIT_REQUESTS, 1000) or rel > SLICE_REL_TOL:
        raise AssertionError(f"moe_vit served logits: shape {logits.shape}, rel err {rel}")
    return {"opt_update": f32_launches + bf16_launches}


def moe_gpt_phase(torch, ou, da, dev, work: str) -> dict:
    """config/gpt_nano_moe.yaml on one card (module docstring, 15)."""
    import contextlib
    import io
    import math

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.shards import pack_tokens
    from distribuuuu_tpu_torch.lm import service as lm_service

    t0 = time.perf_counter()
    src, pack = os.path.join(work, "corpus.txt"), os.path.join(work, "tokens")
    lm_corpus(src, seed=20, mb=MOE_LM_CORPUS_MB)
    with contextlib.redirect_stdout(io.StringIO()):
        if pack_tokens.main(["--src", src, "--out", pack, "--pack-len", "256",
                             "--val-frac", "0.05"]):
            raise AssertionError("moe_gpt: pack_tokens failed")
    one_card = ["MESH.MODEL", 1, "MESH.EXPERT", 1]

    def lm_cfg(dtype: str, *opts):
        config.reset_cfg()
        config.merge_from_file("config/gpt_nano_moe.yaml")
        cfg.merge_from_list(["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", dtype,
                             "RNG_SEED", 0, "SERVE.DEVICE", 0, "GENERATE.EOS_ID", -1,
                             "SERVE.MAX_QUEUE", 2 * LM_REQUESTS, *one_card, *opts])

    lm_cfg("bfloat16", "OPTIM.MAX_EPOCH", 1, "TRAIN.DATASET", pack, "TEST.DATASET", pack,
           "TRAIN.PRINT_FREQ", 100, "OUT_DIR", os.path.join(work, "train"))
    ou.update.launches = 0
    recs = []
    trainer.train_model(recs)
    torch.cuda.synchronize()
    rec, train_launches = recs[0], ou.update.launches
    losses, steps = rec["losses"], rec["steps"]
    w = min(LM_TRAIN_WINDOW, steps // 3)
    # greedy f32 streams on the card against the port's CPU engine
    prompts = _lm_prompts(MOE_LM_PROMPTS, seed=20)
    streams = []
    da.reset_launch_counts()
    for platform in ("auto", "cpu"):
        lm_cfg("float32", "DEVICE.PLATFORM", platform)
        torch.backends.cuda.matmul.allow_tf32 = False
        eng = lm_service.engine_from_cfg().start()
        streams.append([s.result(timeout=300) for s in [eng.submit(p) for p in prompts]])
        cpu_model = eng.model
        eng.drain()
    f32_launches = da.launches
    gaps, same = [], 0
    for p, a, b in zip(prompts, *streams):
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            same += 1
            continue
        with torch.inference_mode():
            row = cpu_model(torch.tensor([p + b[:k]]))[0, -1]
        gaps.append({"step": k, "rel_logit_gap": float((row[b[k]] - row[a[k]]).abs()
                                                       / row.abs().max())})
    # a bf16 burst through the graphed tiles
    lm_cfg("bfloat16")
    eng = lm_service.engine_from_cfg().start()
    burst = _lm_prompts(LM_REQUESTS)
    eng.submit(burst[0]).result(timeout=300)
    st0 = eng.stats()
    da.reset_launch_counts()
    t1 = time.perf_counter()
    outs = [s.result(timeout=300) for s in [eng.submit(p) for p in burst]]
    wall = time.perf_counter() - t1
    burst_launches = da.launches
    decode_steps = eng.stats()["decode_steps"] - st0["decode_steps"]
    eng.drain()
    tokens = sum(len(o) for o in outs)
    res = {"phase": "moe_gpt", "arch": "gpt_nano_moe", "mesh": "MODEL 1 EXPERT 1",
           "steps": steps, "batch": cfg.TRAIN.BATCH_SIZE, "train_tokens_per_s":
           rec["tokens_per_s"], "step_ms": rec["step_ms"], "first_loss": losses[0],
           f"loss_first{w}_mean": statistics.mean(losses[:w]),
           f"loss_last{w}_mean": statistics.mean(losses[-w:]),
           "opt_update_launches": train_launches, "f32_prompts": len(prompts),
           "f32_streams_equal": same, "f32_divergences": gaps, "f32_gap_tol": LM_F32_GAP_TOL,
           "f32_decode_attention_launches": f32_launches, "bf16_requests": len(burst),
           "bf16_tokens": tokens, "bf16_tokens_per_s": tokens / wall,
           "bf16_decode_steps": decode_steps, "bf16_decode_attention_launches": burst_launches,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if train_launches != steps or not all(math.isfinite(x) for x in losses) \
            or not statistics.mean(losses[-w:]) < statistics.mean(losses[:w]):
        raise AssertionError(f"moe_gpt train: launches {train_launches} for {steps} steps, "
                             f"losses {losses}")
    if [g for g in gaps if not g["rel_logit_gap"] <= LM_F32_GAP_TOL] or not f32_launches:
        raise AssertionError(f"moe_gpt f32 card vs CPU streams: {gaps}, decode_attention "
                             f"launches {f32_launches}")
    if tokens != LM_REQUESTS * LM_NEW_TOKENS or burst_launches != LM_DEPTH * decode_steps:
        raise AssertionError(f"moe_gpt burst: {tokens} tokens, {burst_launches} launches for "
                             f"{decode_steps} decode steps")
    return {"opt_update": train_launches,
            "decode_attention": f32_launches + burst_launches}


def _tp_ep_opts(pack: str, out: str, epochs: int) -> list:
    return ["DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "float32", "RNG_SEED", 0,
            "LM.SEQ_LEN", 256, "TRAIN.BATCH_SIZE", TP_EP_BATCH, "TEST.BATCH_SIZE", TP_EP_BATCH,
            "TRAIN.DATASET", pack, "TEST.DATASET", pack, "TEST.SPLIT", "train",
            "TRAIN.WORKERS", 1, "TRAIN.PRINT_FREQ", 1, "OPTIM.MAX_EPOCH", epochs,
            "TELEMETRY.ENABLED", False, "OUT_DIR", out]


def _tp_ep_train(torch, opts: list) -> list:
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg

    config.reset_cfg()
    config.merge_from_file("config/gpt_nano_moe.yaml")
    cfg.merge_from_list(opts)
    recs = []
    trainer.train_model(recs)
    return recs


def tp_ep_worker(work: str) -> int:
    """One rank of ``tp_ep_one_card_phase`` (``--tp-ep-worker``): gloo on
    cuda:0, config/gpt_nano_moe.yaml's own stanza, one epoch."""
    import torch

    from distribuuuu_tpu_torch.parallel import dist

    torch.cuda.set_device(0)
    dist.setup_distributed("gloo", timeout_s=600)
    recs = _tp_ep_train(torch, _tp_ep_opts(os.path.join(work, "tokens"),
                                           os.path.join(work, "sharded"), 1))
    with open(os.path.join(work, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump({"losses": recs[0]["losses"], "step_ms": recs[0].get("step_ms")}, f)
    dist.shutdown_distributed()
    return 0


def _tp_ep_pack(work: str) -> str:
    """A pack of exactly TP_EP_STEPS x TP_EP_BATCH sequences of 256."""
    import numpy as np

    from distribuuuu_tpu_torch.data.shards import tokens as ttok

    rng = np.random.default_rng(22)
    seqs = rng.integers(0, 256, (TP_EP_STEPS * TP_EP_BATCH, 257)).astype(np.uint16)
    out = os.path.join(work, "tokens")
    ttok.write_token_shards(os.path.join(out, "train"), [(q, 0) for q in seqs], 256)
    return out


def _state_rel(torch, got: dict, want: dict, lr: float, steps: int):
    """(worst relative difference of a tensor, its key), the attention's
    key bias apart: its gradient is 0 in exact arithmetic, so AdamW steps
    it by rounding noise; returns also its worst absolute difference
    against the bound 2·lr·steps."""
    worst, key, kb = 0.0, None, 0.0
    for k, w in want.items():
        if not (torch.is_tensor(w) and w.is_floating_point()):
            continue
        g, w = got[k].double(), w.double()
        if k.endswith("attn.qkv.bias"):
            d = w.shape[0] // 3
            kb = max(kb, float((g[d:2 * d] - w[d:2 * d]).abs().max()))
            g, w = torch.cat([g[:d], g[2 * d:]]), torch.cat([w[:d], w[2 * d:]])
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if err > worst:
            worst, key = err, k
    return worst, key, kb, 2 * lr * steps


def tp_ep_one_card_phase(torch, ou) -> dict:
    """config/gpt_nano_moe.yaml's stanza on 4 gloo ranks sharing cuda:0
    (module docstring, 15)."""
    import shutil
    import socket

    from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_ep_")
    procs = []
    try:
        pack = _tp_ep_pack(work)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        here = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(TP_EP_RANKS), "PYTHONPATH": here}
        for r in range(TP_EP_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-ep-worker", work],
                cwd=here, env={**env, "RANK": str(r), "LOCAL_RANK": "0"}))
        one = os.path.join(work, "one")
        ou.update.launches = 0
        ref1, ref2 = _tp_ep_train(torch, [*_tp_ep_opts(pack, one, 2), "MESH.MODEL", 1,
                                          "MESH.EXPERT", 1])
        for p in procs:
            if p.wait(timeout=600):
                raise AssertionError(f"tp_ep worker exited {p.returncode}")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(TP_EP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        sharded_dir = os.path.join(work, "sharded")
        got = ckpt.load_checkpoint(os.path.join(sharded_dir, "checkpoints", "ckpt_ep_000.pth"))
        want = ckpt.load_checkpoint(os.path.join(one, "checkpoints", "ckpt_ep_000.pth"))
        resumed = os.path.join(work, "resumed")
        shutil.copytree(sharded_dir, resumed)
        res2 = _tp_ep_train(torch, [*_tp_ep_opts(pack, resumed, 2), "MESH.MODEL", 1,
                                    "MESH.EXPERT", 1])
        launches = ou.update.launches
        got2 = ckpt.load_checkpoint(os.path.join(resumed, "checkpoints", "ckpt_ep_001.pth"))
        want2 = ckpt.load_checkpoint(os.path.join(one, "checkpoints", "ckpt_ep_001.pth"))
        from distribuuuu_tpu_torch import trainer

        init = trainer.build_model_from_cfg().state_dict()  # RNG_SEED 0, as every run
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        mesh_lib.reset()
        shutil.rmtree(work, ignore_errors=True)
    from distribuuuu_tpu_torch.config import cfg

    lr = float(cfg.OPTIM.BASE_LR)
    sharded = ranks[0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sharded, ref1["losses"]))
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(res2[0]["losses"], ref2["losses"]))
    save = _state_rel(torch, got["model"], want["model"], lr, TP_EP_STEPS)
    opt_m = _state_rel(torch, got["opt"]["m"], want["opt"]["m"], lr, TP_EP_STEPS)
    save2 = _state_rel(torch, got2["model"], want2["model"], lr, 2 * TP_EP_STEPS)
    keys = [k for k, v in want["model"].items() if v.is_floating_point()]
    upd = [(got["model"][k].double() - init[k].double(), want["model"][k].double()
            - init[k].double()) for k in keys]
    upd_rel = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in upd)
                               / sum((b ** 2).sum() for _, b in upd)))
    res = {"phase": "tp_ep_one_card", "arch": "gpt_nano_moe", "stanza": "dp1·tp2·ep2",
           "ranks": TP_EP_RANKS, "dist_backend": "gloo", "dtype": "float32",
           "batch_per_rank": TP_EP_BATCH, "steps": TP_EP_STEPS,
           "losses_ranks": [r["losses"] for r in ranks], "losses_one_process": ref1["losses"],
           "loss_rel_err": loss_rel, "loss_rtol": TP_EP_LOSS_RTOL,
           "step_ms_sharded": ranks[0]["step_ms"], "step_ms_one_process": ref1.get("step_ms"),
           "save_worst_rel": save[:2], "save_opt_m_worst_rel": opt_m[:2],
           "save_key_bias_abs": save[2], "key_bias_bound": save[3],
           "state_rtol": TP_EP_STATE_RTOL, "update_l2_rel_err": upd_rel,
           "update_rtol": TP_EP_UPDATE_RTOL, "resumed_epoch": res2[0]["epoch"] + 1,
           "resumed_loss_rel_err": resume_rel, "resumed_save_worst_rel": save2[:2],
           "opt_update_launches_one_process": launches, "wall_s": wall,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if (any(r["losses"] != sharded for r in ranks) or loss_rel > TP_EP_LOSS_RTOL
            or resume_rel > TP_EP_LOSS_RTOL or res["resumed_epoch"] != 2
            or upd_rel > TP_EP_UPDATE_RTOL):
        raise AssertionError(f"tp_ep_one_card losses: {res}")
    for worst, key, kb, bound in (save, opt_m, save2):
        if worst > TP_EP_STATE_RTOL or kb > bound:
            raise AssertionError(f"tp_ep_one_card save: {key} {worst}, key bias {kb} > {bound}")
    if launches != 3 * TP_EP_STEPS:
        raise AssertionError(f"tp_ep_one_card: opt_update launches {launches} != "
                             f"{3 * TP_EP_STEPS} one-process steps")
    return {"opt_update": launches}


def slice20_phases(torch, ou, da, dev) -> dict:
    """moe_vit, moe_gpt, tp_ep_one_card; launch counts for the kernels line."""
    import shutil

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_slice20_")
    try:
        vit = moe_vit_phase(torch, ou, dev)
        gpt = moe_gpt_phase(torch, ou, da, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tp_ep = tp_ep_one_card_phase(torch, ou)
    emit({"phase": "slice20_seconds", "seconds": time.perf_counter() - t0})
    return {"opt_update": vit["opt_update"] + gpt["opt_update"] + tp_ep["opt_update"],
            "decode_attention": gpt["decode_attention"]}


# -- slice 21: ZeRO stages 1 and 3 on the data axis -------------------------------

ZERO_RANKS = 2
ZERO_BATCH = 8       # ResNet-50 images a rank at 224²
ZERO_STEPS = 3
ZERO_LM_BATCH = 4    # GPT-nano sequences of 256 a rank
ZERO_SERVE_REL_TOL = 1e-3  # f32 served logits against the eval forward, of the scale
ZERO_LM_ARMS = (("s0", ["MESH.ZERO", 0]),
                ("s3", ["MESH.ZERO", 3, "ZERO.GATHER_AHEAD", -1, "ZERO.OVERLAP", False]),
                ("s3_per_use", ["MESH.ZERO", 3, "ZERO.GATHER_AHEAD", 0,
                                "ZERO.OVERLAP", False]))


def _zero_run(torch, dev, work: str, yaml: str, opts: list, batches: list, rank: int,
              keep_state: bool = False) -> dict:
    """``ZERO_STEPS`` eager train steps of ``yaml`` under ``opts`` on this
    rank's ``batches`` (the trainer's model, optimizer and step): losses,
    step ms, opt_update launches, data-axis all-gathers, resting bytes
    against the layout's prediction, peak memory, and the full state."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    from distribuuuu_tpu_torch.parallel import dist, zero
    from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
    from distribuuuu_tpu_torch.parallel.partition import specs
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    config.reset_cfg()
    config.merge_from_file(yaml)
    cfg.merge_from_list([*opts, "MESH.DATA", ZERO_RANKS, "DEVICE.COMPUTE_DTYPE", "float32",
                         "CUDNN.DETERMINISTIC", True, "CUDNN.BENCHMARK", False,
                         "CHECKPOINT.ASYNC", True, "OUT_DIR", work])
    trainer.apply_backend_flags()
    trainer.check_train_cfg()
    mesh = mesh_lib.setup(trainer.topology_from_cfg())
    model = trainer.build_model_from_cfg().to(dev).train()
    opt = construct_optimizer(model)
    rt = opt.zero
    if rt is not None:
        rt.rest(model)
    step = trainer.TrainStep(model, opt, trainer.effective_topk(), "raise", 1, device=dev,
                             graphed=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ou.update.launches, g0 = 0, dist.zero_gathers.count
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        out = step([{k: v.to(dev) for k, v in b.items()}], [False])
        losses.append(float(out[0, 0]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches, gathers = ou.update.launches, dist.zero_gathers.count - g0
    zdims = rt.zdims if rt is not None else [None] * len(opt.params)
    moments = [bufs for bufs in (opt.m, opt.v) if bufs]
    resting = zero.resting_bytes(opt)
    predicted = zero.predict_resting_bytes([tuple(p.shape) for p in opt.params], zdims,
                                           ZERO_RANKS, int(cfg.MESH.ZERO), 4,
                                           [bufs[0].element_size() for bufs in moments])
    res = {"losses": losses, "step_ms": ms, "launches": launches, "gathers": gathers,
           "bound": None if rt is None else zero.gather_bound(rt.plan, cfg.ZERO.GATHER_AHEAD),
           "sharded": 0 if rt is None else len(rt.sharded), "leaves": len(opt.params),
           "resting_bytes": resting, "predicted_bytes": predicted,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    with zero.gathered(model):
        full = zero.kept(specs.full_train_state(model, opt), model)
    res["state"] = {"model": {k: v.detach().cpu().clone() for k, v in full["model"].items()},
                    "opt": {k: {n: t.detach().cpu().clone() for n, t in full["opt"][k].items()}
                            for k in ("m", "v") if full["opt"][k] is not None}}
    res["_live"] = (model, opt, mesh) if keep_state else None
    return res


def _state_bitwise(torch, a: dict, b: dict) -> bool:
    if a["model"].keys() != b["model"].keys() or a["opt"].keys() != b["opt"].keys():
        return False
    return all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]) and all(
        torch.equal(a["opt"][m][n], b["opt"][m][n]) for m in a["opt"] for n in a["opt"][m])


def _zero_shard_kernel(torch, ou, dev, rt, opt) -> dict:
    """The fused update over this rank's update leaves (the split leaves'
    shards, the others whole) as the step runs it, once through the
    kernel and once through its plain version on the same inputs, and
    timed beside the fused torch.optim step over the same leaves."""
    def clone(ts):
        return None if ts is None else [t.detach().clone() for t in ts]

    p = [q if s is None else s for q, s in zip(opt.params, rt.pshard)]
    p, g, m, v = clone(p), clone(opt.grads), clone(opt.m), clone(opt.v)
    kp, km, kv = clone(p), clone(m), clone(v)
    h = opt.hyper
    scal = ou.staged_scalars(h, 0.1, 5, kp, km)
    table = ou.leaf_table(kp, g, km, kv)
    ou.update(kp, g, km, kv, h, scal, table=table)
    ou.update_plain(p, g, m, v, h, scal)
    torch.cuda.synchronize()
    worst, n_diff = 0, 0
    for got, want in zip([*kp, *(km or []), *(kv or [])], [*p, *(m or []), *(v or [])]):
        u, n = _ulps(torch, got, want)
        worst, n_diff = max(worst, u), n_diff + n
    nbytes = ou.pass_bytes(p, m, v)
    n_elem = sum(t.numel() for t in p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_elem * OPT_FLOPS_PER_ELEM[h.body()] / PEAK_FLOPS["float32"] * 1e3
    lp = [t.clone() for t in kp]
    for t, gt in zip(lp, g):
        t.grad = gt
    lib = (torch.optim.AdamW(lp, lr=0.1, eps=1e-8, weight_decay=h.wd, fused=True)
           if h.kind == "adamw" else
           torch.optim.SGD(lp, lr=0.1, momentum=h.mom, nesterov=h.nesterov,
                           weight_decay=h.wd, fused=True))
    return {"leaves": len(p), "shard_leaves": len(rt.sharded), "elements": n_elem,
            "max_ulp": worst, "elements_differing": n_diff,
            "max_abs_err": max(float((a.float() - b.float()).abs().max()) for a, b in
                               zip([*kp, *(km or []), *(kv or [])],
                                   [*p, *(m or []), *(v or [])])),
            "ms": time_ms(torch, lambda: ou.update(kp, g, km, kv, h, scal, table=table),
                          reps=20, hold_cycles=OPT_HOLD_CYCLES),
            "plain_ms": time_ms(torch, lambda: ou.update_plain(p, g, m, v, h, scal), reps=5,
                                warmup=1),
            "library_ms": time_ms(torch, lib.step, reps=20, hold_cycles=OPT_HOLD_CYCLES),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes}


def zero_worker(work: str) -> int:
    """One rank of ``zero_one_card_phase`` (``--zero-worker``): gloo on
    cuda:0, ResNet-50 (f32, the YAML's SGD Nesterov) at ZeRO 0, 1 and 3,
    the stage-3 run's update on its shards against the plain version and
    its sharded background save; GPT-nano (AdamW) at stage 0 and at stage 3
    with GATHER_AHEAD -1 and 0."""
    import torch

    from distribuuuu_tpu_torch.asyncplane import committer
    from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    from distribuuuu_tpu_torch.parallel import dist
    from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt

    # one host thread a rank: the ranks run beside shards_exact_resume's four
    # train_net processes, and their host work is gloo's copies and sums
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.setup_distributed("gloo", timeout_s=600)
    r = dist.get_rank()
    gen = torch.Generator().manual_seed(2100 + r)
    images = [{"image": torch.randint(0, 256, (ZERO_BATCH, 224, 224, 3), generator=gen,
                                      dtype=torch.uint8),
               "label": torch.randint(0, 1000, (ZERO_BATCH,), generator=gen)}
              for _ in range(ZERO_STEPS)]
    tokens = []
    for _ in range(ZERO_STEPS):
        t = torch.randint(0, 256, (ZERO_LM_BATCH, 257), generator=gen, dtype=torch.int32)
        tokens.append({"image": t[:, :-1].contiguous(), "label": t[:, 1:].long()})
    out, states = {"rank": r}, {}
    for stage in (0, 1, 3):
        run = _zero_run(torch, dev, os.path.join(work, f"r50_s{stage}"), "config/resnet50.yaml",
                        ["MESH.ZERO", stage, "TRAIN.BATCH_SIZE", ZERO_BATCH], images, r,
                        keep_state=stage == 3)
        states[stage] = run.pop("state")
        live = run.pop("_live")
        if stage == 3:
            model, opt, _ = live
            dist.barrier()  # rank 1 waits on the CPU while rank 0 times the kernel
            if r == 0:
                run["shard_kernel"] = _zero_shard_kernel(torch, ou, dev, opt.zero, opt)
            dist.barrier()
            t0 = time.perf_counter()
            ckpt.save_sharded_checkpoint(model, opt, ZERO_STEPS, 0, 0.0, False)
            run["save_snapshot_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            committer.join_commits()
            run["save_commit_s"] = time.perf_counter() - t1
            run["save_barrier_s"] = committer._state["barrier_s"]
            run["save_shard"] = committer._state["shard"]
            if r == 0:
                torch.save(states[3], os.path.join(work, "r50_s3_state.pt"))
            del model, opt, live
        out[f"resnet50_s{stage}"] = run
        mesh_lib.reset()
        torch.cuda.empty_cache()
    for stage in (1, 3):
        out[f"resnet50_s{stage}"]["bitwise_s0"] = _state_bitwise(torch, states[stage], states[0])
    lm = {}
    for name, opts in ZERO_LM_ARMS:
        run = _zero_run(torch, dev, os.path.join(work, f"lm_{name}"), "config/gpt_nano.yaml",
                        [*opts, "TRAIN.BATCH_SIZE", ZERO_LM_BATCH], tokens, r)
        lm[name] = run.pop("state")
        run.pop("_live")
        if name != "s0":
            run["bitwise_s0"] = _state_bitwise(torch, lm[name], lm["s0"])
        out[f"gpt_nano_{name}"] = run
        mesh_lib.reset()
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown_distributed()
    return 0


def zero_start() -> tuple:
    """Start the two ``--zero-worker`` ranks of ``zero_one_card_phase``;
    ``(procs, work dir, start time)`` for :func:`zero_finish`."""
    import socket

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(ZERO_RANKS), "PYTHONPATH": here}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--zero-worker", work],
                              cwd=here, env={**env, "RANK": str(r), "LOCAL_RANK": "0"})
             for r in range(ZERO_RANKS)]
    return procs, work, t0


def zero_one_card_phase(torch, dev, started=None, beside: str | None = None) -> dict:
    """ZeRO on two gloo ranks sharing cuda:0 (``--zero-worker``, started
    here or by :func:`zero_start`; ``beside`` names what ran alongside):
    stages 1 and 3 bitwise stage 0 (losses and final state, each rank),
    every GATHER_AHEAD arm too, opt_update launched once a step on each
    rank, the per-shard update held against its plain version, each
    rank's resting bytes equal to the layout's prediction and below stage
    0's; the stage-3
    run's sharded background save resumed by one process bitwise and
    served through MODEL.WEIGHTS, f32 logits against that state's eval
    forward."""
    import shutil

    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch import serve, trainer
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.utils.logger import get_logger
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    procs, work, t0 = started if started is not None else zero_start()
    try:
        for p in procs:
            if p.wait(timeout=600):
                raise AssertionError(f"zero worker exited {p.returncode}")
        ranks = []
        for r in range(ZERO_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        # one process resumes the sharded save: the state is the save's
        config.reset_cfg()
        config.merge_from_file("config/resnet50.yaml")
        out3 = os.path.join(work, "r50_s3")
        cfg.merge_from_list(["MESH.ZERO", 3, "DEVICE.COMPUTE_DTYPE", "float32",
                             "OUT_DIR", out3, "CUDNN.BENCHMARK", False])
        trainer.apply_backend_flags()
        model = trainer.build_model_from_cfg().to(dev)
        opt = construct_optimizer(model)
        st = {"step": 0}
        epoch = trainer._resume(model, opt, st, get_logger())[0]
        want = torch.load(os.path.join(work, "r50_s3_state.pt"), weights_only=True)
        got_opt = opt.state_dict()
        resumed_bitwise = (epoch == 1 and st["step"] == ZERO_STEPS and all(
            torch.equal(v.cpu(), want["model"][k]) for k, v in model.state_dict().items())
            and all(torch.equal(got_opt["m"][n].cpu(), t) for n, t in want["opt"]["m"].items()))
        # served through MODEL.WEIGHTS (the sharded directory), f32
        ckpt_dir = os.path.join(out3, "checkpoints", "ckpt_ep_000")
        config.reset_cfg()
        config.merge_from_file("config/resnet50.yaml")
        cfg.merge_from_list(["MODEL.WEIGHTS", ckpt_dir, "DEVICE.COMPUTE_DTYPE", "float32",
                             "SERVE.BUCKET_SIZES", "[4]", "SERVE.MAX_BATCH", 4,
                             "CUDNN.BENCHMARK", False])
        images = np.random.default_rng(21).integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)
        t_serve = time.perf_counter()
        engine = serve.engine_from_cfg().start()
        served = np.stack([f.result(timeout=300) for f in [engine.submit(i) for i in images]])
        engine.drain()
        t_serve = time.perf_counter() - t_serve
        with torch.inference_mode():
            ref = model.eval()(trainer.prep_images(torch.from_numpy(images).to(dev)))
        ref = ref.float().cpu().numpy()
        serve_rel = float(np.abs(served - ref).max() / np.abs(ref).max())
        del model, opt, engine
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
        config.reset_cfg()
    runs = [k for k in ranks[0] if k != "rank"]
    launches = sum(r[k]["launches"] for r in ranks for k in runs)
    s3 = [r["resnet50_s3"] for r in ranks]
    kern = ranks[0]["resnet50_s3"]["shard_kernel"]
    res = {"phase": "zero_one_card", "ranks": ZERO_RANKS, "dist_backend": "gloo",
           "dtype": "float32", "steps": ZERO_STEPS, "resnet50_batch_per_rank": ZERO_BATCH,
           "gpt_nano_batch_per_rank": ZERO_LM_BATCH,
           "runs": {k: [{f: r[k][f] for f in ("losses", "step_ms", "launches", "gathers",
                                               "bound", "sharded", "leaves", "resting_bytes",
                                               "predicted_bytes", "peak_bytes")
                          if f in r[k]} | {"bitwise_s0": r[k].get("bitwise_s0")}
                         for r in ranks] for k in runs},
           "resting_over_stage0": {k: ranks[0][k]["resting_bytes"]
                                   / ranks[0][k[:k.index("_s") + 1] + "s0"]["resting_bytes"]
                                   for k in runs if not k.endswith("s0")},
           "shard_kernel": kern,
           "save": [{"snapshot_s": x["save_snapshot_s"], "commit_s": x["save_commit_s"],
                     "barrier_s": x["save_barrier_s"], **(x["save_shard"] or {})} for x in s3],
           "resumed_one_process_bitwise": resumed_bitwise, "served_rel_err": serve_rel,
           "served_rel_tol": ZERO_SERVE_REL_TOL, "serve_s": t_serve,
           "opt_update_launches": launches, "beside": beside,
           "seconds": time.perf_counter() - t0}
    emit(res)
    bad = []
    for r in ranks:
        for k in runs:
            x = r[k]
            if x["launches"] != ZERO_STEPS:
                bad.append(f"{k}: {x['launches']} opt_update launches")
            if x["resting_bytes"] != x["predicted_bytes"]:
                bad.append(f"{k}: resting {x['resting_bytes']} != {x['predicted_bytes']}")
            if k.endswith("s0"):
                continue
            s0 = r[k[:k.index("_s") + 1] + "s0"]
            if x["resting_bytes"] >= s0["resting_bytes"]:
                bad.append(f"{k}: resting {x['resting_bytes']} not below stage 0's "
                           f"{s0['resting_bytes']}")
            if not x.get("bitwise_s0") or x["losses"] != r[k[:k.index("_s") + 1] + "s0"][
                    "losses"]:
                bad.append(f"{k}: not bitwise stage 0")
            if not 0 < x["gathers"] <= ZERO_STEPS * x["bound"]:
                bad.append(f"{k}: {x['gathers']} all-gathers, bound {x['bound']} a step")
    if kern["max_ulp"] > OPT_MAX_ULP or (kern["max_ulp"] and
                                         kern["elements_differing"] > OPT_MAX_ULP_ELEMS):
        bad.append(f"per-shard update kernel vs plain: {kern['max_ulp']} ulp")
    if not resumed_bitwise:
        bad.append("the one-process resume is not the save's state")
    if serve_rel > ZERO_SERVE_REL_TOL:
        bad.append(f"served logits {serve_rel} of the scale from the eval forward")
    if bad:
        raise AssertionError(f"zero_one_card: {bad} {res}")
    return {"opt_update": launches, "shard_kernel": kern}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time and trace the graphs against their eager bodies (a "
                         "ResNet-50 and a regnety_160 forward at batch 8, a GPT-nano decode "
                         "step at batch 4, a ResNet-50 and a ViT-S/16 train step at batch "
                         "32; served img/s and tokens/s both ways) and one regnety_160 "
                         "train step at batch 64")
    ap.add_argument("--two-ranks-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--tp-ep-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--zero-worker", metavar="DIR", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--counted-train-net"]:  # train_net's own arguments follow
        return counted_train_net(argv[1], argv[2:])
    args = ap.parse_args(argv)
    if args.two_ranks_worker:
        return two_ranks_worker(args.two_ranks_worker)
    if args.tp_ep_worker:
        return tp_ep_worker(args.tp_ep_worker)
    if args.zero_worker:
        return zero_worker(args.zero_worker)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    try:
        from distribuuuu_tpu_torch.ops.cuda import _build
        from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
        from distribuuuu_tpu_torch.ops.cuda import decode_attn as da
        from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa
        from distribuuuu_tpu_torch.ops.cuda import group_conv as gc
        from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    def tf32_off():
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    tf32_off()
    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    _build.build("conv_epilogue", "opt_update", "decode_attn", "group_conv")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": dict(_build.build_seconds)})
    for n in ("conv_epilogue", "group_conv", "decode_attn"):
        emit({"phase": f"build_{n}", "seconds": _build.build_seconds[n],
              "ptxas": ptxas_report(_build.build_logs.get(n, ""))})
    # flash_attention.cu, the slowest source, builds beside the phases up to
    # ResNet-50's serving and training, which do not load it
    flash_pool = ThreadPoolExecutor(1)
    flash_build = flash_pool.submit(_build.build, "flash_attention")

    rows, worst = kernel_phase(torch, ce, dev)
    emit(forward_total(rows, arch="resnet50", batch=8))
    for eval_batch in (200, 48):  # the trainer's eval: 10 batches of 200, one of 48
        eval_rows, eval_worst = kernel_phase(torch, ce, dev, eval_batch, ragged=False)
        worst = max(worst, eval_worst)
        emit(forward_total(eval_rows, arch="resnet50", batch=eval_batch))
    # K and N of 32..3712, 232 and 696 among them; regnety_160's eval at 200
    for arch, batch in (("regnety_160", 8), ("regnety_320", 8), ("regnety_160", 200)):
        reg_rows, reg_worst = kernel_phase(torch, ce, dev, batch, ragged=False,
                                           sites=regnet_sites(arch, batch, 224))
        worst = max(worst, reg_worst)
        emit(forward_total(reg_rows, arch=arch, batch=batch))
    # the image zoo's sites: K and N down to 16, bf16 silu, M up to 2.5M rows
    _, zoo_worst, _ = zoo_kernel_phase(torch, ce, dev)
    worst = max(worst, zoo_worst)
    group_rows = group_kernel_phase(torch, gc, dev)
    shapes = resnet50_leaves(torch)
    if len(shapes) != 161:
        raise AssertionError(f"ResNet-50 has {len(shapes)} parameter leaves, not 161")
    opt_rows = opt_kernel_phase(torch, ou, dev, shapes)
    decode_rows = decode_kernel_phase(torch, da, dev)

    launches, model = slice_phase(torch, ce, N_REQUESTS)
    del model

    import shutil

    def train_run(arch, phase):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_train_{arch}_")
        try:
            return phase(out_dir)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)

    runs = {"resnet50": train_run("resnet50", lambda d: resnet_train_phase(torch, ce, ou, d))}
    t1 = time.perf_counter()
    flash_build.result()
    flash_pool.shutdown()
    emit({"phase": "build_flash_attention", "seconds": _build.build_seconds["flash_attention"],
          "waited_s": time.perf_counter() - t1,
          "ptxas": ptxas_report(_build.build_logs.get("flash_attention", ""))})
    flash_rows = flash_kernel_phase(torch, fa, dev)
    vit_serve_fwd = vit_slice_phase(torch, fa, dev, N_REQUESTS)
    runs["vit_small"] = train_run("vit_small", lambda d: vit_train_phase(torch, fa, ou, d))
    tf32_off()
    # f32 steps card vs CPU: the card halves here, the CPU halves beside
    # graph_equal and recompile_drill below, which read no time
    cpu_halves = [step_vs_cpu_phase(torch, dev, "resnet50", bn_group=4, defer=True),
                  step_vs_cpu_phase(torch, dev, "vit_small", attn_impl="flash", defer=True)]
    vit_auto_phase(torch, fa, dev)

    # RegNet: every stride-1 grouped 3x3 at <= 14² through the kernel
    monitors = {}  # live monitors attached to runs, read by slice19_phases
    os.environ["DISTRIBUUUU_GROUP_CONV"] = "pallas"
    reg_dir = tempfile.mkdtemp(prefix="chip_smoke_regnet_")
    try:
        weights = regnet_weights(torch, os.path.join(reg_dir, "regnety_160.pth"))
        reg_serve_gc, reg_serve_ce, model = regnet_slice_phase(torch, ce, gc, dev, N_REQUESTS,
                                                               weights)
        del model
        runs["regnety_160"] = regnet_train_phase(torch, ce, gc, ou,
                                                 os.path.join(reg_dir, "train"), weights)
        tf32_off()
        cpu_halves.append(step_vs_cpu_phase(torch, dev, "regnety_160", bn_group=4,
                                            tweak=lambda m: regnet_last_bn(torch, m),
                                            reach=regnet_kernel_weights, defer=True))
        # the zoo's (under DISTRIBUUUU_GROUP_CONV=pallas, as their serving)
        for arch in ("efficientnet_b0", "botnet50", "densenet121"):
            cpu_halves.append(step_vs_cpu_phase(
                torch, dev, arch, bn_group=4, tweak=lambda m: seeded_bn(torch, m),
                reach=botnet_values if arch == "botnet50" else None, defer=True))
        # one graph per step: eager against graph, the recompile storm, the
        # folded step (and, profiling, the graphs' numbers beside eager)
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as side:
            halves = side.submit(lambda: [finish() for finish in cpu_halves])
            graph_equal_phase(torch, dev, weights)
            recompile_drill_phase(torch, os.path.join(reg_dir, "recompile"),
                                  watch=lambda d: monitors.setdefault(
                                      "recompile_storm",
                                      LiveMonitor(d, MONITOR_TICK_S["recompile_storm"])))
            t1 = time.perf_counter()
            halves.result()
        emit({"phase": "step_vs_cpu_cpu_halves", "archs": len(cpu_halves),
              "waited_s": time.perf_counter() - t1, "seconds": time.perf_counter() - t0})
        fold_train_phase(torch, dev)
        if args.profile:
            graph_profile_phases(torch, dev, weights)
    finally:
        shutil.rmtree(reg_dir, ignore_errors=True)
    tf32_off()
    if args.profile:
        train_profile_phase(torch, dev, "regnety_160", batch=64, classify=_regnet_kind,
                            bn_group=64)

    # the image zoo, still under DISTRIBUUUU_GROUP_CONV=pallas: EfficientNet's
    # depthwise convs must not reach the grouped-conv kernel
    zoo = zoo_phases(torch, ce, gc, ou, dev, ZOO_REQUESTS)

    lm_res, lm_launches, lm_engine, lm_prompts = lm_serve_phase(torch, da)
    lm_big, lm_big_launches, _, _ = lm_serve_phase(torch, da, LM_BIG_TILES)
    if lm_big["batch_tiles"] != LM_BIG_TILES:
        raise AssertionError(f"batch tiles {lm_big['batch_tiles']} != {LM_BIG_TILES}")
    tf32_off()
    lm_check_phase(torch, da, dev, lm_engine, lm_prompts)
    del lm_engine
    # the LM plane: gpt_nano trained on token shards, chunked prefill, the
    # length classes, speculative decoding
    tf32_off()
    lm_plane = lm_plane_phases(torch, ou, fa, da, dev)
    tf32_off()
    # telemetry on the card: a ResNet-50 run's records, on against off, the
    # LM's records and request traces
    tel = telemetry_phases(torch, ce, ou, da, dev,
                           watch=lambda d: monitors.setdefault(
                               "telemetry_train",
                               LiveMonitor(d, MONITOR_TICK_S["telemetry_train"])))
    tf32_off()
    # a JAX-trained checkpoint read with no JAX, quantized buckets, and
    # two fleets of replica processes sharing this card
    s18 = slice18_phases(torch, ce, da, dev)
    tf32_off()
    # the live plane: the monitor over the two watched runs, the shipped
    # degrade and LM campaigns at the card's rates, the soak referee
    s19 = slice19_phases(torch, monitors)
    tf32_off()
    # the MoE family on one card, and the model and expert axes as gloo
    # ranks sharing it
    s20 = slice20_phases(torch, ou, da, dev)
    tf32_off()

    # real images and process groups: SyncBN in a group of one, the
    # ImageFolder path in that group, then two ranks sharing the card
    from distribuuuu_tpu_torch.parallel import dist

    tf32_off()
    real_dir = tempfile.mkdtemp(prefix="chip_smoke_realdata_")
    try:
        try:
            t0 = time.perf_counter()
            root = make_image_tree(os.path.join(real_dir, "tree"))
            emit({"phase": "realdata_tree", "seconds": time.perf_counter() - t0,
                  "classes": REAL_CLASSES, "train": REAL_CLASSES * REAL_TRAIN,
                  "val": REAL_CLASSES * REAL_VAL})
            syncbn_world1_phase(torch, dev)
            real = realdata_phase(torch, ce, ou, root, os.path.join(real_dir, "out"),
                                  runs["resnet50"][0]["train_img_per_s"])
            shards = shards_train_phase(torch, ce, ou, root, os.path.join(real_dir, "shards"),
                                        real)
        finally:
            leave_world1(dist)
        tf32_off()
        # the resilience drills' train_net subprocesses (on a small tree of
        # their own) run beside the two phases that check bits and logs,
        # not times
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as side:
            drills = side.submit(loop_drills_phase, real_dir)
            # ZeRO's two gloo ranks sharing the card run beside these two,
            # which check bits and logs, not times
            zero_ranks = zero_start()
            resume = shards_exact_resume_phase(torch, shards["pack_root"],
                                               os.path.join(real_dir, "shards_resume"))
            tf32_off()
            s21 = zero_one_card_phase(torch, dev, zero_ranks,
                                      beside="shards_exact_resume, train_loop_drills")
            tf32_off()
            two_ranks_one_card_phase(torch, dev)
            # the rest of the train loop, in one process with no process
            # group, on the same ImageFolder
            tf32_off()
            loop = train_loop_phases(torch, ce, ou, dev, root, real_dir, drills)
    finally:
        shutil.rmtree(real_dir, ignore_errors=True)

    # per-forward totals over the 33 sites (sites_per_forward weights)
    def total(key):
        return sum(r[key] * r["sites_per_forward"] for r in rows)

    t_bytes = sum(r["bytes"] * r["sites_per_forward"] for r in rows) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(2 * r["M"] * r["K"] * r["N"] * r["sites_per_forward"] for r in rows
                if r["sites_per_forward"]) / PEAK_FLOPS["bfloat16"] * 1e3
    main_body = opt_rows["sgd_nesterov_f32"]  # config/resnet50.yaml's optimizer
    kernels = [{
        "name": "conv1x1_bn_act",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": "distribuuuu_tpu/ops/pallas/conv_epilogue.py:121",
        "launches": launches + reg_serve_ce + real["launches"]["conv_epilogue"]
        + tel["conv_epilogue"] + s18["conv_epilogue"] + s19["conv_epilogue"]
        + shards["launches"]["conv_epilogue"] + resume["launches"]["conv_epilogue"]
        + loop["conv_epilogue"] + zoo["conv_epilogue"]
        + sum(r["launches"]["conv_epilogue"] for a in ("resnet50", "regnety_160")
              for r in runs[a]),
        "max_abs_err": worst,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total("library_ms"),
    }, {
        "name": "opt_update",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/csrc/opt_update.cu",
        "replaces": "distribuuuu_tpu/ops/pallas/opt_update.py:75",
        "launches": real["launches"]["opt_update"] + shards["launches"]["opt_update"]
        + resume["launches"]["opt_update"] + loop["opt_update"] + zoo["opt_update"]
        + lm_plane["opt_update"] + tel["opt_update"] + s19["opt_update"] + s20["opt_update"]
        + s21["opt_update"]
        + sum(r["launches"]["opt_update"] for rs in runs.values() for r in rs),
        "max_abs_err": max(r["max_abs_err"] for r in opt_rows.values()),
        "ms": main_body["ms"],
        "plain_ms": main_body["plain_ms"],
        "bound_ms": main_body["bound_ms"],
        "bound_by": main_body["bound_by"],
        "library_ms": main_body["library_ms"],
    }]
    # the flash kernels at the ViT-S training shape, launches from the
    # ViT-S serving and training runs and the GPT-nano flash training run
    for kern, (name, replaces) in FLASH_KERNELS.items():
        train = flash_rows[FLASH_SHAPES[0][0]][kern]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "distribuuuu_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": (vit_serve_fwd if kern == "forward" else 0)
            + sum(r["launches"][f"flash_{kern}"] for r in runs["vit_small"])
            + lm_plane[f"flash_{kern}"],
            "max_abs_err": max(rs[kern]["max_abs_err"] for rs in flash_rows.values()),
            **{k: train[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    # decode attention at the GPT-nano decode tile, launches from the LM
    # serving bursts and the LM plane's serving phases (warm-ups apart)
    tile = decode_rows[DECODE_SHAPES[0][0]]
    kernels.append({
        "name": "decode_attention",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/csrc/decode_attn.cu",
        "replaces": "distribuuuu_tpu/ops/pallas/decode_attn.py:121",
        "launches": lm_launches + lm_big_launches + lm_plane["decode_attention"]
        + tel["decode_attention"] + s18["decode_attention"] + s19["decode_attention"]
        + s20["decode_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in decode_rows.values()),
        **{k: tile[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    # the grouped conv at regnety_160's stage 3 at the training batch 64,
    # launches (forward and dx) from the regnety_160 serving and training runs
    grow = group_rows["regnety_160_s3_b64"]
    kernels.append({
        "name": "group_conv3x3",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/csrc/group_conv.cu",
        "replaces": "distribuuuu_tpu/ops/group_conv.py:170",
        "launches": reg_serve_gc + sum(r["launches"]["group_conv"] + r["launches"]["group_conv_dx"]
                                       for r in runs["regnety_160"]),
        "max_abs_err": max(r["max_abs_err"] for r in group_rows.values()),
        **{k: grow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
