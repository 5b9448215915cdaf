"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which either succeeds or makes the script exit non-zero:

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 is switched off for matmuls and cuDNN;
2. build — every kernel source under ``paddle_tpu_torch/ops/pallas/csrc``
   compiled with ``nvcc`` for ``sm_90a`` (one process per source, all at
   once) into the ignored build directory, with each kernel's registers
   and spills; the SASS of the tensor-core kernels (K1, K2, K3, K4, K5,
   K7 and K8 in bf16, K1-K4 also in f16, K6's split kernel,
   ``cuobjdump --dump-sass``) must
   hold wgmma (``HGMMA``) and, where an operand comes by TMA, TMA loads
   (``UTMALDG``);
3. kernel vs plain — the ragged-paged-attention (RPA) kernel against its
   plain PyTorch version at Llama-3-8B head geometry on a ragged mix of
   decode rows, a 512-token prefill chunk over 1024 cached tokens and a
   padding tail: the float32 FMA kernel, and the bfloat16 split wgmma
   design at q tiles of 8, 16 and 32 tokens, also on a decode-only mix
   (phase 4's decode steps), and its float16 instance on both mixes at
   float16's own limit (``RPA_TOL``), timed beside bf16, with
   kernel/plain times (CUDA events, median of 20) and the least time the
   card could take;
4. serving — a Llama-3-8B-shaped model (all 32 layers, bf16, seeded
   random weights) behind ``ServingEngine`` + HTTP ``Server``, answering
   8 concurrent ``/generate`` requests; every request must return all
   its tokens, every logit must be finite, and the RPA launch count must
   equal ``num_hidden_layers x engine steps``; a profiled window sums the
   device time of every RPA kernel; then one real engine step with a
   prefill chunk, decode rows and two sequences sharing prefix pages has
   its layer-0 RPA output held against the plain version;
5. engine parity — full width, 2 layers, float32: the kernel engine and
   an ``attn_impl="gather"`` engine give identical greedy streams;
6. flash kernels vs plain — (a) the training shape (B=4, S=2048, Hq=16,
   Hkv=4, hd=128, causal) in bfloat16 and float32: the forward (K1), dq
   (K2) and dk/dv (K3) kernels against ``flash_attention_reference`` and
   autograd through it, with kernel/plain/library times, TFLOP/s, the
   design each ran (bf16 on wgmma fed by TMA, f32 FMA loops) and
   the least time the card could take; (b) a sweep over offset-causal, GQA
   groups 1/4/8, segment ids with fully masked rows, row and full bias,
   dropout, a length that is not a multiple of the tile, head_dim 64,
   DiT-XL/2's attention (non-causal, S 256, 16 heads of 72, zero-padded
   to the hd-128 kernels as ``flash_attention_bhsd`` pads it), head_dims
   32 and 80 (zero-padded to 64 and 128) and ERNIE-base's (non-causal, S 512, 12 heads of 64, dropout 0.1), each
   kernel against its plain version in both dtypes;
7. training — the Llama-recipe model of ``bench.py``'s training
   benchmark (vocab 128256 tied, hidden 2048, FFN 7168, 8 layers, 16/4
   heads, bf16, seeded random weights) through ``TrainStep`` with AdamW
   (f32 masters) and a global-norm clip on a 4 x 2048 batch, fused (the
   default: 2 warm-up and 10 timed steps) and then with ``fused=False``
   (2 + 5 steps, the per-parameter loop) from the same seed: the first
   loss must be within 1.0 of ln(vocab), the last lower, each flash
   kernel launched once per layer per step, ``fused_adam_update`` and
   ``fused_sqnorm`` once per bucket per fused step and never in the
   loop, and the first three losses of the two runs equal within rtol
   1e-3; step time, tokens/s, MFU, peak and resident memory of each,
   and a profiled step's device time by kind of kernel and by
   ``TrainStep`` range (forward+backward, clip, update);
7b. fused update — the Llama bucket's real sizes (0.70 B bf16 parameters
   with f32 masters, AdamW, a clip scale from ``fused_sqnorm``): two
   steps through ``fused_adam_update`` and through the plain bucket
   update must agree bit for bit, ``fused_sqnorm`` within 1e-6 of the
   plain f32 sum with the same bits on a second run; the kernels', the
   plain versions', the per-parameter loop's and ``torch._fused_adamw_``'s
   times on the same buffers, and the bounds;
8. grouped matmul vs plain — (a) one ``MoELayer`` at DeepSeekMoE-16B's
   expert widths (E=64, top-6, M=2048, H=1408, seeded bf16 weights)
   routes 4 x 2048 hidden states; its 49152 assignments, sorted by
   expert, go through ``gmm`` (bm 512), ``gmm_aligned`` (bm 128, groups
   padded with zero rows) and ``tgmm``, forward and backward through
   autograd, in bf16 and f32 (the launches of this run are the kernels'
   counts); each of K5-K8 against its plain version, with its design,
   kernel, plain, bound and ``torch._grouped_mm`` times, TFLOP/s and the
   loader of each operand of the bf16 wgmma kernel (TMA or registers); a
   row for K7's rhsᵀ form (its backward's d_lhs), by TMA and through
   registers; K5 on K7's groups and K7's group building, timed apart,
   and the device time of the shared wgmma kernel in K5 and K7 calls;
   and ``torch.bmm`` on the layer's own capacity layout for comparison.
   K6's bound counts 2*n*M*H once at the TF32 rate (f32 operands on the
   tensor cores), its split design's six bf16 products logged beside it
   as that design's floor; (b) a sweep over a hot expert beside empty and one-row
   experts, non-zero rows past the groups, widths 1000 x 333 and one
   expert, both dtypes, with K6's time on the hot expert; (c) K8 in
   bf16 on one 45056-row expert beside two with no block;
9. MoE training — ``MoeConfig.deepseek_moe_16b`` at full width cut to 4
   layers (1.71 B parameters, bf16, seeded weights) through
   ``TrainStep`` with AdamW (f32 masters) and a global-norm clip on 4 x
   2048 ids, fused (2 + 10 steps) and with ``fused=False`` (2 + 5), with
   phase 7's checks and numbers; capacity and drops per MoE layer and the
   expert products' share of device time;
10. fit, checkpoint, resume — phase 7's model through ``hapi.Model.fit``
   over ``ShardedStream`` -> ``DataPipeline(batch_size=4, seq_len=2048,
   pack=True, drop_last=True, device_prefetch=2)`` on 8 seeded documents
   of 32-6144 tokens (several epochs, so the loss can fall), under ``FitResilience(save_every_steps=4, keep_last_k=1)``
   in a fresh directory of the checkout: run A takes 7 steps (one async
   save, at step 4, in flight over steps 5-7); run B, a new model,
   optimizer and pipeline, restores step 4 and takes 3. B's batches
   (sha256 of input_ids) must be A's steps 5-7, its losses A's at rtol
   1e-5 and its f32 master weights after step 7 A's at rtol 1e-4; the
   first loss within 1.0 of ln(vocab) and the last lower; K1-K3 once per
   layer per step and ``fused_adam_update``/``fused_sqnorm`` once per
   step. It logs the fit step against phase 7's loop, the steps with a
   save in flight, the snapshot's stall, bytes, seconds to the commit
   and to restore, the real-token share, tokens/s and MFU, and a
   profiled fit step; then K1-K3 in bf16 on one packed batch's segment
   ids against the plain version at ``FLASH_TOL``, with their times
   beside phase 6's causal ones. The directory is deleted;
11. ERNIE — ``ErnieForPretraining(ErnieConfig())`` (vocab 40000, hidden
   768, 12 layers, 12 heads, FFN 3072, dropout 0.1; bf16, seeded weights
   by PaddleNLP's N(0, 0.02) recipe on the port's initializers) on 16 x
   512 seeded ids with 15% MLM labels and SOP labels, through
   ``TrainStep`` (AdamW, f32 masters, clip 1.0), fused (2 + 10 steps,
   the main path) and ``fused=False`` (2 + 3): the first loss within 1.0
   of ln(40000) + ln(2), the last lower, K1-K3 12 a step, the fused
   kernels once a bucket a step and never in the loop; step time,
   tokens/s, MFU, memory and a profiled step by kind with K1-K3's share.
   Then ``ErnieForSequenceClassification`` at that width through
   ``hapi.Model.prepare(AdamW, CrossEntropyLoss(), Accuracy())``: ``fit``
   3 steps, ``evaluate`` 64 samples in 4 batches (finite losses,
   accuracy in [0, 1]);
12. DiT — ``DiT(DiTConfig())`` (DiT-XL/2: input 32, patch 2, 256 tokens,
   hidden 1152, 28 blocks, 16 heads of 72, learn_sigma, 1000 classes;
   bf16, seeded) on a batch of 64 against one seeded target (MSE in
   f32), ``TrainStep`` fused, 2 + 10 steps: the first loss equal to
   mean(target^2) within 1e-2 (adaLN-Zero starts the output at exactly
   0), the last lower, K1-K3 28 a step, all on the zero-padded hd-128
   kernels; the same numbers as phase 11. Last, K1-K3 in bf16 at
   ERNIE's and DiT's attention shapes (B 16 and 64): each against its
   plain version at ``FLASH_TOL`` (padded columns exactly 0); kernel,
   plain, bound and library (sdpa) times and, at head_dim 72, the
   zero-padding copies' time;
13. vision training, on no Pallas kernel (conv and batch norm on cuDNN
   and PyTorch's kernels, the LSTM on PyTorch's fused recurrence, CTC
   on PyTorch's): (a) ``PPOCRRecModel(PPOCRRecConfig())`` (PP-OCRv4
   recognition uncut: widths 32/64/128/256, a 2-layer bidirectional
   LSTM of 120, 6625 classes, height 48; bf16, seeded) on 64 seeded 3 x
   48 x 320 images with 16 labels each (T = 80 frames), CTC,
   ``TrainStep`` fused, 2 + 10 steps (``bench.py``'s _suite_ppocr
   geometry): the first loss finite and the last lower, every
   ``BatchNorm2D``'s running mean and variance moved and finite, the
   LSTM on PyTorch's fused recurrence once a layer a forward
   (``rnn.cudnn_calls``), the fused update kernels once a bucket a
   step; (b) ``vision.models.resnet50(num_classes=1000)`` in bf16 on 64
   seeded 3 x 224 x 224 images and labels, cross entropy, fused, 2 + 5
   steps: the first loss within 1.0 of ln(1000), the last lower, the
   running statistics moved. Each reports step time, images/s, MFU
   (``vision_train_flops_per_step``: convolution, linear and LSTM
   shapes), peak and resident memory, and a profiled step by kind
   (convolution, batch norm, pooling, LSTM, CTC, GEMMs, elementwise,
   the optimizer);
14. the Paddle API from a user's script (``import paddle_tpu_torch as
   paddle``, no ``set_device`` call): (a) every op of the op library
   (``paddle.ops``) once on seeded card inputs and once on the same
   inputs on the CPU: each result on the card and equal to the CPU's
   (rtol 1e-5; reductions, linear algebra and special functions 1e-4;
   decompositions by what they reconstruct), random ops by device,
   shape, dtype and repeatability under one ``paddle.seed``; (b) phase
   7's model from ``paddle.to_tensor`` ids: the eager loop of
   ``examples/generate_llama.py`` (``loss.backward()``, ``opt.step()``,
   ``opt.clear_grad()``, 2 + 3 steps), whose first three losses must
   equal a ``fused=False`` ``TrainStep``'s at rtol 1e-3, then
   ``paddle.jit.TrainStep`` as in ``examples/train_llama.py`` (fused,
   clip 1.0, 2 + 10 steps, losses by ``float(loss.numpy())``): the loss
   falls, K1-K3 8 a step, and its step time beside phase 7's; (c)
   ``model.generate`` at that width in bf16: 4 seeded 512-token
   prompts, 64 greedy tokens, K1 launched 8 x (1 + 63) times on its
   offset-causal form (one query row a decode step), prefill and
   per-token times, tokens/s and K1's share of a profiled decode step;
   then in f32 at 2 layers every generated token must equal the argmax
   of the cacheless forward; K1 against its plain version at the decode
   shapes (kv_len 513, 600, 1000, 2047) with the kernel's, plain and
   ``sdpa`` times and the bound; (d) ``examples/{train_llama,
   generate_llama,train_packed,serve_llama}.py`` copied with only the
   package renamed, each in a fresh process on the card (all four at
   once): each exits 0 and ``train_llama``'s loss falls; the other
   examples are logged as not run, with the subsystem each needs.
   Since PR 13 ``examples/generate_compiled.py`` runs with them and must
   print that its compiled tokens equal the eager ones;
15. CUDA-graph capture, amp and recompute at phase 7's width: (a)
   ``generate_compiled`` in bf16 on 14(c)'s prompts (4 x 512, 64 greedy
   tokens): one capture a signature (the second call replays), prefill
   and decode ms a token and the decode's busy share beside 14(c)'s
   eager ``generate`` from the same call, a sampled run's tokens in the
   vocabulary; at 2 layers in f32 the tokens equal the eager
   ``generate``'s, chunked prefill equals one-shot and each row of a
   left-padded ragged batch equals its solo run; (b)
   ``paddle.jit.to_static`` of the eval forward (4 x 512): the capturing
   call and a replay equal the eager logits at bf16 tolerance, K1 8
   launches a replay (the eager forwards it is compared with and timed
   beside do not count), a parameter update seen without a new capture;
   (c) f32 weights under ``auto_cast(dtype="float16")`` O1 with a
   ``GradScaler`` (AdamW, 2 + 10 steps): losses finite and falling,
   found-inf steps counted, K1-K3 8 a step and every launch in float16;
   one O2 step of a ``decorate``d bf16 model; K1-K3 in float16 against
   their plain versions at phase 6's training shape at float16's own
   limits (``FLASH_TOL_F16``), timed beside the bf16 kernels; (d) four
   fused ``TrainStep``s with ``cfg.recompute`` and four without from the
   same weights: losses and the first step's gradient norm equal (rtol
   1e-3), step ms and peak memory of each, K1 twice a layer a step;
16. quantized, multi-tenant serving at phase 4's width and prompts (32
   new tokens, through the HTTP ``Server``): (a) the model in float16 on
   K4's f16 instance: all tokens, finite logits, K4 f16 launches = layers
   x steps, one engine step's layer-0 RPA output against the plain
   version; (b) bf16 with ``tuning.apply_lora(n_slots=4)``, two seeded
   tenants loaded, ``quantize="int8_wo"``, requests to slot 0 and both
   tenants: all tokens, finite logits, RPA launches = layers x steps, no
   leaked block, and the window's ``max_memory_allocated`` at least 6 GB
   below phase 4's; (c) ``kv_dtype="int8"`` at a gather geometry
   (prefill_chunk 16, max_blocks_per_seq 72): a 1088-token request then
   its 1024-token prefix alone (a copy-on-write prefix hit), the pools'
   bytes against a bf16 cache's (about half); (d) full width, 2 layers,
   f32: the ``int8_wo`` engine's streams on RPA equal gather's and eager
   ``generate`` over the dequantized weights; a LoRA slot's equal eager
   ``generate`` with the adapter merged, slot 0's a no-LoRA engine's; an
   ``fp8_wo`` engine serves with finite logits;
17. MoE serving and decoding, the autotuner and ``paddle.incubate``: (a)
   ``MoeConfig.deepseek_moe_16b()`` at full width cut to 2 of its 28
   layers, one dense and one MoE (to keep the script within its limit;
   16/16 heads of 128, 64
   routed experts top-6 beside 2 shared, bf16, seeded weights) behind
   the HTTP ``Server`` with phase 4's prompts and geometry: all tokens,
   finite logits, K4 launches = 2 x steps, the window's numbers and
   busy share, each MoE layer's capacity and dropped assignments in the
   window's busiest step, the layer-0 K4 output of a real step against
   the plain version, ``aux_loss()`` None and no leaked block; K4 at
   this model's heads on phase 3's mix against its plain version, timed;
   (b) eager ``generate`` (4 x 512, 64 greedy tokens): K1 2 x 64
   launches, ms a token, ``aux_loss()`` the last decode step's (finite,
   as the reference's); ``generate_compiled`` on the same prompts: one
   capture a signature, the replay equal to the capturing call, ms a
   token and busy share; (c) at 2 layers in f32: the kernel engine's
   greedy streams equal the gather engine's, ``generate_compiled``
   equals eager ``generate``, one request's tokens equal in a 1-slot and
   a 4-slot engine; (d) the engine q tile swept by hand on this model as
   phase 4's, then ``FLAGS_use_autotune``: ``rpa_tile_q``'s picks for
   this engine's and phase 4's signatures beside both sweeps, two engines
   served from the cache, ``_auto_chunks``' pick at phase 7's fused
   cross entropy; (e) ``incubate.nn.FusedMultiTransformer`` as 12
   post-LN ``FusedTransformerEncoderLayer``s at ERNIE-base widths (d 768,
   12 heads, FFN 3072, dropout 0.1, bf16) on 16 x 512 tokens, MSE to a
   seeded target through ``TrainStep`` (AdamW, 2 + 5 steps): the loss
   falls and K1-K3 launch 12 times a step; then small f32 modules on
   the card against the same modules on the CPU: ``FusedMultiTransformer``
   with a mask, ``FusedEcMoe`` with caller logits,
   ``memory_efficient_attention``, LookAhead and an EMA over 4 steps, a
   Jacobian and a Hessian, and ``prune_model`` + ``decorate`` keeping
   2:4 through a step;
18. export and deployment: (a) Llama-3-8B's widths at 2 decoder layers
   (untied, float16, seeded, eval) through ``paddle.jit.save`` with
   ``InputSpec([None, 1024], "int32")`` into a temporary directory of
   the checkout, then ``inference.Predictor`` on the card at batch 2
   and 4 (the shared dynamic batch): the logits within K1's float16
   limits of the eager forward, K1 two launches a run (through the
   registered op ``paddle_tpu::flash_fwd``), with the export, save and
   load seconds, the file sizes and the predictor's ms a run; K1 at that
   shape against its plain version, timed; (b) ``examples/{
   export_and_serve,int8_deploy,static_regression}.py`` to their end on
   the card; (c) a copy on a ``paddle.device.cuda.Stream`` ordered by an
   ``Event``; (d) a trainable float mask through
   ``F.scaled_dot_product_attention`` in f32 against the CPU, output and
   the gradients of q, k, v and the mask; (e) the host µs a call of K1
   at a tiny shape through the op and through its body called directly;
19. serving in production at Llama-3-8B widths (32 layers, bf16, seeded)
   with phase 4's prompts and geometry: each prompt's solo greedy stream
   (16 tokens), and the mean engine step with the request ledger armed
   and disarmed (A B B A); (a) one engine behind ``Server(
   max_queue_depth=4)``: a burst of 24 requests (phase 4's prompts three
   times, odd ones streamed, each with a ``traceparent``) gets 503s with
   ``Retry-After``, every accepted stream equals its solo stream and
   echoes its trace id; ``POST /debug/profile?seconds=2`` during the
   burst writes a ``torch.profiler`` trace naming ``rpa_wgmma_kernel``
   (a window whose trace holds none is opened once more over one live
   request through the server, and that one must name it; each
   window's counts are logged) and a second POST gets 409; ``/statusz?format=json`` carries burn
   rates and the top in-flight requests; ``deadline_s=0.05`` with 512
   tokens gets 504 and the request's blocks go back; ``/metrics`` parses
   and its request, rejection and token counters equal the client's and
   the ledger's counts; the memory ledger and ``memory_report()`` hold
   the parameters and pools within 1%; (b) ``build_fleet`` of a
   ``prefill`` and a ``decode`` replica sharing the model behind
   ``RouterServer``: every stream equals its solo stream, the decode
   replica's ledger shows the handed-off blocks as cached tokens, K4
   launches on both replicas (their sum the global count), ``trace merge
   --requests`` stitches router + both replicas per request, with the
   handoff's ms and bytes; (c) the replica serving a stream is killed
   after 3 tokens and the survivor, holding the prefix, finishes it
   token for token, recomputing only the tail;
20. training in production at phase 7's width (the bench's Llama recipe,
   bf16, AdamW f32 masters, clip 1.0) over phase 10's packed corpus at
   4 x 2048: (a) ``Model.fit`` for 8 steps with ``StepTelemetry`` (the
   bench's flop count), ``VisualDL``, ``FitResilience(save_every_steps=4,
   step_timeout=600, nan_guard=True)``, the flight recorder, numerics
   armed every 4 steps, a device-profiler window over steps 3-4
   (``profile.set_fit_window``) and the chaos harness poisoning step 6
   (a packed batch holds no float: its loss is corrupted): the losses
   finite but step 6's and falling, the guard tripping once and
   rolling back to step 4, its provenance replay finite, the goodput
   ledger's ``rollback_discarded`` charged and its bins summing to its
   wall within 1%, ``train_mfu_ratio`` = flops / step / the card's peak
   within 1%, ``train_step_seconds``' median within 10% of the same
   steps by CUDA events, one VisualDL ``train/loss`` record a step, every
   numerics sample finite and the last checkpoint's ``"numerics"`` entry
   equal to ``calibration_summary()``, the window's trace naming K1-K3's
   wgmma kernels and ``fused_adam_kernel``, the flight recorder's events
   holding step, ckpt and data kinds, K1-K3 8 a step (+ 8 for the
   replay) and the fused kernels once a step; a NaN weight's replay
   naming its layer's ``mlp`` tap; the mean step with StepTimer and the
   flight recorder armed against disarmed (A B B A) and a sampled
   numerics step against an unsampled one; (b) ``attribute_train_step``
   on the fit's model and batch, fused and ``fused=False``: the phase
   tables, the phases summing to the fit's step within 10%, the fused
   optimizer phase shorter than the looped one, the flop count equal to
   the bench's (the fused cross entropy's B*(S-1) rows); (c)
   ``paddle.profiler.Profiler(targets=[CPU, GPU], scheduler=
   make_scheduler(closed=1, ready=1, record=2))`` over 5 calls of a
   ``TrainStep`` whose loss is ``paddle.mean`` of the model's: five
   steps in ``step_info``, two ``TrainStep`` host spans and the op
   library's ``mean`` spans in the export, and K1-K3's kernels in the
   device trace beside it;
   ``ProfilerTarget.TPU`` raises; (d) ``tests/torch_chaos_worker.py``
   processes on the card (a tiny Llama, f32): a step held past
   ``step_timeout`` with ``watchdog_action="kill"`` exits 79 with a dump
   holding the flight recorder's events, and a fit SIGKILLed after step
   3 by the chaos harness, resumed, gives the uninterrupted run's losses
   at rtol 1e-5; (e) ``/fleetz``'s document carries ``local_goodput``.
   Its files go to a ``phase20_*`` directory of the checkout, deleted
   after.
21. data, tensor and sharded parallelism over ``torch.distributed``:
   (a) one rank over NCCL at full width: phase 7's model, batch and
   optimizer (AdamW f32 masters, clip 1.0) through
   ``init_parallel_env()`` (world size 1), ``fleet.init`` ->
   ``distributed_model`` -> ``distributed_optimizer`` ->
   ``TrainStep(mesh=init_mesh({"dp": 1}), bucketed=True)``, 2 + 5
   steps, against the unmeshed fused ``TrainStep`` of the same seed and
   batch (2 + 5 steps, rtol 1e-3): both step times by CUDA events, the
   all-reduces a step (the comm registry's count, which must equal the
   bucket plan's bucket count), the bytes through them and the host
   seconds around them (exposed / overlapped), the NCCL kernels' device
   ms in a profiled step, K1-K3 8 launches a step; (b) two processes
   started by the port's ``spawn`` share the card over gloo (NCCL
   refuses two ranks on one device; gloo takes CUDA tensors for
   all-reduce and broadcast, the collectives of dp and mp): the bench's
   widths cut to 2 layers in f32, 3 steps at dp 2 and 3 at mp 2, each
   rank's losses equal to one process's on the same global batch at
   rtol 1e-4, with the step times (two processes on one card: no
   measure of scaling). ZeRO's reduce-scatter and all-gather are held
   in the CPU tests only until a second card. Its files go to a
   ``phase21_*`` directory of the checkout, deleted after.
22. pipeline and sequence parallelism over ``torch.distributed``: first,
   in this process, ring-flash's block calls (``flash_block_fwd`` /
   ``flash_block_bwd``: K1 on the diagonal block, causal, and on a past
   block, the two merged through their lse, K2 and K3 on each with the
   merged output and the global lse) at the ring's block shape (32
   heads, 16384 queries, hd 128, bf16), and K1-K3 on the whole sequence
   (32 heads, 32768 tokens), against the plain versions run a few heads
   at a time, each tensor held by its norm-relative error and
   elementwise against its RMS (``SP_REL``, ``SP_ATOL_RMS``), with
   controls that these limits must reject (a block's own lse for the
   global one, the past block skipped, dk and dv halved); then two
   processes started by the port's ``spawn``
   share the card over gloo (which stages point-to-point, all-gather and
   all-to-all through the host): (a) ``ring_attention`` (the kernel
   path) and ``ulysses_attention`` at sp 2 on a causal sequence of
   1 x 32768 tokens, 32 heads (Llama-3-8B's query heads; the ring takes
   no GQA), hd 128, bf16, forward and backward, each rank's output and
   q/k/v gradient shards against K1-K3 on the whole sequence at the
   same limits, K1-K3 launched once each on rank 0 and twice on
   rank 1 (the causal ring skips the future block), once each by
   Ulysses; (b) pp 2 in f32 at ERNIE-base widths (an embedding, 12
   ``nn.TransformerEncoderLayer``s of d 768, 12 heads, ff 3072, dropout
   0, a head over a vocabulary of 18000), 16 x 512 in 4 micro-batches, 3
   steps of ``PipelineParallel`` at v 1 and v 2 and of
   ``SpmdPipelineParallel`` over the encoder layer (v 6, ``remat=False``),
   losses against one process's at rtol 1e-4, K1-K3 launched steps x
   micro-batches x 6 local layers on each rank. The times are no measure
   of scaling. Its files go to a ``phase22_*`` directory of the
   checkout, deleted after.
23. the multi-process job lifecycle under the port's launcher: (a) the
   bench's widths cut to 2 layers in f32 (phase 21(b)'s model) on 4 x
   2048 seeded global batches, trained by two trainers that ``python -m
   paddle_tpu_torch.distributed.launch --nproc_per_node 2 --max_restarts
   1`` starts (``chip_smoke.py --job-trainer``: gloo on the card, dp 2
   through ``fleet.distributed_model``, ``Model.fit`` under
   ``FitResilience`` with an asynchronous save every step): the chaos
   harness SIGKILLs rank 1 after step 2 and the launcher relaunches,
   resuming from step 2; SIGUSR1 reaches rank 0 as step 4 begins, both
   ranks stop at step 5 with one commit and exit 79, and the launcher
   relaunches without spending its crash budget; the job finishes step 6
   and exits 0. Every step's loss equals one process's uninterrupted run
   in this process at rtol 1e-4, each relaunched rank's restored state
   digests to the committed step's crc32s, and K1-K3 are counted over
   both ranks and every attempt; it logs the attempts, the seconds by
   part (starts, restores, saves, steps) and the goodput bins; (b) the
   tiny Llama in f32, elastic 2 -> 1 under the launcher: rank 1 departs
   with 83 at the agreed step, rank 0 continues in place on the state
   exchanged over the job's store, its losses equal to one process's at
   rtol 1e-4, and rank 0's heartbeat aggregator shows rank 1
   ``departed``. Its files go to a ``phase23_*`` directory of the
   checkout, deleted after.
24. expert-parallel MoE training and tensor-parallel serving: in this
   process first the one-process oracles (below) and K4 at one mp-2
   rank's heads of Llama-3-8B (16 query and 4 KV heads, hd 128, bf16;
   phase 3's mix) against its plain version, timed; then (a) and (b) each
   in two processes started by the port's ``spawn``, all four at once,
   sharing the card over gloo: (a)
   ``MoeConfig.deepseek_moe_16b`` at full width cut to 2 layers (layer 0
   dense, layer 1 64 experts top-6 beside 2 shared; f32, seeded, AdamW,
   clip 1.0) on 2 x 2048 seeded global ids at ``init_mesh({"ep": 2})``,
   3 steps with ``input_spec=P("ep")`` (each rank's row routed, the
   ``[64, 480, 2048]`` capacity buffer exchanged by ``all_to_all``) and
   3 with ``P()`` (every token on every rank, the partial combine
   all-reduced): each rank's losses equal one process's at rtol 1e-4 and
   each step's drops exactly, K1-K3 launched 2 layers x 3 steps on each
   rank in each layout; the all-to-alls a step and their bytes, the step
   ms and each rank's peak memory are logged; (b) at
   ``init_mesh({"mp": 2})``: Llama-3-8B widths at 2 layers in f32,
   phase 4's prompts x 16 greedy tokens through ``ServingEngine(mesh=)``
   (rank 0 drives, rank 1 follows), plain and ``int8_wo``: the streams
   equal one process's exactly; then ``LlamaConfig.llama3_8b()`` in bf16
   at 16 of its 32 layers (4 of 8 KV heads a rank) at phase 4's
   geometry, 32 greedy tokens: gloo's bf16 all-reduce (within one ulp
   of the f32 sum rounded once) and all-gather (bit-equal) on CUDA
   tensors; the first step's logits (every prompt's first chunk) equal
   on both ranks and to the step's replay, and within
   ``TP_BF16_LOGITS_RTOL`` of one process's, norm-relative, while the
   same step with each row-parallel sum cut to one rank's half (the
   control of a wrong collective) must exceed it; K4 one launch a layer
   a step on each rank, every stream either equal to one process's or
   parting at a near-tie of it (top-2 gap at most
   ``NEAR_TIE``; each parting logged with its gap), the mean step, the
   broadcasts, all-reduces and all-gathers a step, each rank's memory
   (before the model, its weights, with the engine, the peak) and pool
   bytes beside one process's. The times are no measure of scaling. Its
   files go to a ``phase24_*`` directory of the checkout, deleted after.
25. the layer, vision and dtype leftovers: (a) ``LlamaConfig.llama3_8b``
   cut to 4 layers in f32: four rows of 1024, 640, 384 and 128 prompt
   tokens prefilled side by side in chunks of 256 through per-row
   ``PagedLayerCache``s (block 16, padded tails), then 32 greedy tokens a
   row; each stream equals the row's eager ``generate`` (K1) or parts
   only where generate's top-2 logit gap is at most ``PAGED_GAP``
   (logged); the prefill and decode step ms and the peak memory. Then
   ``MoeConfig.deepseek_moe_16b`` at 2 layers in f32, one per-row chunk
   of rows of 256, 200, 97 and 31 tokens: the routed layer on the chunk
   and its token mask equals the same layer on the valid tokens alone at
   the same capacity (equal drops and outputs: the padded tails claim no
   slot), and, at a capacity no assignment exceeds, each row's logits
   equal the row run alone; (b) ``vision.ops`` at Mask R-CNN R50-FPN's
   sizes: the P2 map [2, 256, 200, 336], 2 x 512 RoIs, ``roi_align`` at
   the 7x7 box and 14x14 mask poolers with ``sampling_ratio`` 2 and the
   adaptive default (8 here), forward and backward into the map,
   ``roi_pool`` 7x7, RPN ``nms`` (2000 boxes, IoU 0.7) and per-class
   ``nms`` (1000 boxes of 80 categories, 0.5), ``box_coder`` encoding 100
   boxes against the 201600 P2 anchors and decoding two images' deltas;
   each timed with its peak memory and checked against the same call on
   the CPU (the RoI ops on a subset of RoIs; indices equal); (c) every
   functional and layer the slice ported, forward and backward once at a
   Cityscapes head's, an ESPCN x3 upscaler's, a spatial transformer's and
   a 3x3 im2col's sizes and the losses over [4096, 1024], against the
   CPU in f32 (``CENSUS_SUM_TOL``: ``CENSUS_TOL``'s rtol, atol 1e-4 for
   the two devices' other orders of f32 sums); the random layers by their
   statistics; a weight-normed conv three SGD steps under
   ``clip_grad_norm_`` against the CPU's; the five new dtypes through
   ``to_tensor`` on the card.

It prints its measurements on earlier lines, then one JSON line with a
record per kernel (K1-K3's with their times at ERNIE's and DiT's shapes,
and K1's at the decode shapes, under ``at_model_shapes``, and their
float16 record under ``float16``; K1-K3's ``launches_by_path`` with phase
14's ``api_train`` and ``generate`` and phase 15's ``to_static``,
``amp_f16`` and ``recompute``; K4's float16 record (phase 3 and phase
16(a)) under ``float16``, its record at phase 17's MoE heads under
``at_moe_heads`` and the autotuner's picks under ``autotune``, and its
``launches_by_path`` with phase 16's ``serving_f16`` and
``serving_int8_lora`` and phase 17's ``moe_serving``; K1-K3's with phase
17's ``moe_generate`` and ``incubate`` and phase 18's ``export``, and
K1's phase 18 record under ``export``; K4's ``launches_by_path`` with
phase 19's ``serving_prod`` and ``fleet``, and phase 19's ledger step
costs under ``serving_ledger_step_ms``; K1-K3's and the fused kernels'
``launches_by_path`` with phase 20's ``train_prod`` and ``profiler``,
and K1's phase 20 figures under ``train_prod``; K1-K3's
``launches_by_path`` with phase 21's ``dist_one_rank`` and
``dist_two_ranks``, the fused kernels' with ``dist_one_rank``, and
phase 21's figures under K1's ``dist``; K1-K3's ``launches_by_path``
with phase 22's ``ring_flash``, ``ulysses``, ``pipeline`` and
``spmd_pipeline`` (both ranks), and phase 22's figures under K1's
``seq_pipe``; K1-K3's ``launches_by_path`` with phase 23's ``launch``
(both ranks, every attempt) and ``elastic``, and phase 23's figures under
K1's ``job``; K1-K3's ``launches_by_path`` with phase 24's ``ep_train``
(both ranks, both layouts) and K4's with its ``tp_serving`` (both ranks),
phase 24's training figures under K1's ``ep_train`` and its serving
figures, with K4 at one rank's heads, under K4's ``tp_serving``; K1-K3's
``launches_by_path`` with phase 25's ``paged_rows`` (the per-row runs,
0 by design) and ``paged_rows_generate`` (its eager ``generate`` runs),
and phase 25's figures under K1's ``leftovers``),
and ends with
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float16: 989e12,   # dense tensor-core fp16
              torch.float32: 67e12}    # float32 outside the tensor cores
TF32_FLOPS = 495e12  # dense tensor-core TF32: f32 operands on the tensor cores
SEED = 0
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def free_device_memory():
    """Release what a finished phase held: the server, engine and model
    sit in reference cycles (the HTTP server and its handler), which only
    the cycle collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA
    events, with the 50 MB L2 cache flushed before each run."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
def phase_environment():
    from paddle_tpu_torch.device import card_name
    card = card_name()
    log(card)  # name, power limit — exactly as nvidia-smi prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return card


# the tensor-core instances and what their SASS must hold: wgmma (HGMMA)
# and, where an operand comes by TMA, TMA loads (UTMALDG)
FLASH_TC_INSTANCES = {f"I{e}Li{d}EE": True for e in ("13__nv_bfloat16",
                                                      "6__half")
                      for d in (64, 128)}
SASS_CHECKS = (  # library, kernel, instance -> TMA expected
    # K1-K3 <element type (bf16 or f16), head dim>
    ("flash_attention", "flash_fwd_wgmma_kernel", FLASH_TC_INSTANCES),
    ("flash_attention", "flash_dq_wgmma_kernel", FLASH_TC_INSTANCES),
    ("flash_attention", "flash_dkv_wgmma_kernel", FLASH_TC_INSTANCES),
    # <TMA lhs, rhs load>: 0 registers, 1 TMA MN-major, 2 TMA K-major
    ("grouped_matmul", "gmm_wgmma_kernel",
     {"ILb1ELi1EE": True, "ILb1ELi2EE": True, "ILb1ELi0EE": True,
      "ILb0ELi1EE": True, "ILb0ELi2EE": True, "ILb0ELi0EE": False}),
    # <f32 tiles by TMA>, else by cp.async
    ("grouped_matmul", "tgmm_split_kernel", {"ILb1EE": True, "ILb0EE": False}),
    # K8 in bf16 <operands by TMA>, else through registers
    ("grouped_matmul", "tgmm_aligned_wgmma_kernel",
     {"ILb1EE": True, "ILb0EE": False}),
    # K4 <element type (bf16 or f16), head dim, warpgroups>
    ("ragged_paged_attention", "rpa_wgmma_kernel",
     {f"I{e}Li{d}ELi{w}EE": True for e in ("13__nv_bfloat16", "6__half")
      for d in (64, 128) for w in (1, 2)}))


def kernel_instance(mangled):
    """A mangled kernel name cut to its name and template arguments
    (``flash_dq_wgmma_kernelILi128E``), or its first 70 characters."""
    m = re.search(r"([a-z_]+_kernel)((?:I\w*?E)?)E*v", mangled)
    if m:
        return m.group(1) + m.group(2)
    m = re.search(r"\d([a-z_]+_kernel)E", mangled)  # not a template
    return m.group(1) if m else mangled[:70]


def ptxas_usage(log_text):
    """{mangled kernel: "N registers, S B spill stores, L B spill loads"}
    from nvcc's -Xptxas -v output."""
    usage, name, spills = {}, None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            usage[name] = f"{regs}; {spills}"
    return usage


def sass_counts(lib_path):
    """{mangled kernel: (HGMMA count, UTMALDG count)} of a built library,
    from ``cuobjdump --dump-sass``."""
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "UTMALDG" in line
    return counts


def phase_build():
    from paddle_tpu_torch.ops.pallas import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} of {len(_build.sources())} kernel sources "
        f"compiled in {time.perf_counter() - t0:.2f} s, one nvcc each, all "
        f"at once (nvcc {' '.join(_build.NVCC_FLAGS)}); per source: "
        + ", ".join(f"{n} {info['seconds']:.2f} s"
                    for n, info in built.items()))
    for name, info in built.items():
        for kernel, use in ptxas_usage(info["log"]).items():
            log(f"  {name}: {kernel_instance(kernel)}: {use}")
        # e.g. ptxas serialising wgmma, or ignoring setmaxnreg
        for line in info["log"].splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"  {name}: {line.strip()}")
    # the tensor-core kernels really run wgmma and TMA: read their SASS
    for lib, kernel, instances in SASS_CHECKS:
        counts = {k: c for k, c in sass_counts(_build._target(lib)).items()
                  if kernel in k}
        for inst, tma in instances.items():
            found = [c for k, c in counts.items() if inst in k]
            if len(found) != 1 or found[0][0] == 0 or \
                    (tma and found[0][1] == 0):
                raise AssertionError(
                    f"{kernel}{inst}: SASS lacks HGMMA or UTMALDG "
                    f"(HGMMA, UTMALDG counts {found})")
            log(f"sass: {kernel} {inst}: {found[0][0]} HGMMA, "
                f"{found[0][1]} UTMALDG")


# --------------------------------------------------------------------------
# phase 4's prompt lengths: the decode-only mix gives each a decode row
SERVING_LENS = [128, 384, 640, 896, 1280, 1664, 2048, 1536]
RPA_TILES = (8, 16, 32)  # the reference's tile candidates (_TILE_CANDIDATES)
RPA_KERNELS = ("rpa_kernel", "rpa_wgmma_kernel", "rpa_items_kernel",
               "rpa_combine_kernel")  # every kernel of one RPA call


def rpa_mix(dtype, seed=SEED, tile_q=None, decode_only=False, n_heads=32,
            n_kv=8):
    """An engine-shaped RPA input at Llama-3-8B head geometry (or
    ``n_heads``/``n_kv`` of head_dim 128: DeepSeekMoE-16B's 16/16 in
    phase 17), in the token budget of ServingEngine(max_batch=8,
    prefill_chunk=512): 6 decode rows with 100-3000 tokens of context,
    one 512-token prefill chunk on top of 1024 cached tokens, and a
    padding tail; or (``decode_only``) phase 4's decode steps, 8 decode
    rows over its prompts with 16 tokens generated."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        DEFAULT_TILE_Q, build_step_maps, rpa_max_steps)
    rng = np.random.RandomState(seed)
    hd, bs = 128, 16
    max_seqs, pool_blocks, mbps = 8, 2048, 512
    tile_q = DEFAULT_TILE_Q if tile_q is None else tile_q
    T = -(-(max_seqs + 512) // tile_q) * tile_q
    seqs = [(1, int(c)) for c in rng.randint(100, 3001, 6)] + [(512, 1024)]
    if decode_only:
        seqs = [(1, n + 16) for n in SERVING_LENS]
    bt = np.zeros((max_seqs + 1, mbps), np.int32)
    cu = np.zeros(max_seqs + 2, np.int32)
    ctx = np.zeros(max_seqs + 1, np.int32)
    kv_lens, nxt, off = [], 1, 0
    perm = rng.permutation(np.arange(1, pool_blocks + 1)).astype(np.int32)
    for s, (n, c) in enumerate(seqs):
        npg = -(-(n + c) // bs)
        bt[s, :npg] = perm[nxt - 1:nxt - 1 + npg]  # scattered pages
        nxt += npg
        ctx[s] = c
        cu[s + 1] = off + n
        kv_lens.append(n + c)
        off += n
    cu[len(seqs) + 1:] = off
    ssq, sbk = build_step_maps(
        cu[:len(seqs) + 1], kv_lens, total_tokens=T, tile_q=tile_q,
        block_size=bs, max_steps=rpa_max_steps(tile_q, mbps, max_seqs),
        max_seqs=max_seqs)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=dtype, generator=g)
    shape = (pool_blocks + 1, bs, n_kv, hd)
    args = dict(
        q=torch.randn(T, n_heads, hd, **kw),
        k_pool=torch.randn(shape, **kw), v_pool=torch.randn(shape, **kw))
    dev = {k: torch.from_numpy(v).cuda() for k, v in dict(
        block_tables=bt, cu_seqlens=cu, context_lens=ctx, step_seq=ssq,
        step_blk=sbk).items()}
    args.update(dev)
    # what this mix needs: live pages (K and V), q and out, the metadata
    # the kernel reads, and 4*hd flops per visible (query head, key)
    esz = torch.finfo(dtype).bits // 8
    pages = sum(-(-kv // bs) for kv in kv_lens)
    live_steps = int((ssq < max_seqs).sum())
    nbytes = (2 * pages * bs * n_kv * hd * esz + 2 * T * n_heads * hd * esz
              + 4 * (2 * live_steps + ssq.shape[0] + pages + cu.size
                     + ctx.size))
    pairs = sum(n * c + n * (n + 1) // 2 for n, c in seqs) * n_heads
    flops = 4 * hd * pairs
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
        flops / PEAK_FLOPS[dtype] else "operations"
    valid = torch.zeros(T, dtype=torch.bool, device="cuda")
    valid[:off] = True
    return args, valid, dict(bytes=nbytes, flops=flops, bound_ms=bound_ms,
                             bound_by=bound_by, T=T, pages=pages)


def _rpa_check(what, out, ref, valid, atol, rtol=0.0):
    """max |err| of the kernel on the valid rows (raises past ``atol +
    rtol * |plain|`` or on a non-finite value); padding rows must be
    exactly 0."""
    want = ref[valid].float()
    err = (out[valid].float() - want).abs()
    max_err = float(err.max())
    if not bool(torch.isfinite(out).all()) or \
            bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(
            f"RPA kernel disagrees with its plain version ({what}): max "
            f"|err| {max_err} (atol {atol}, rtol {rtol})")
    if not bool((out[~valid] == 0).all()):
        raise AssertionError(f"RPA padding rows are not exactly 0 ({what})")
    return max_err


# K4 kernel vs plain, max |err| limit (rtol 0) by dtype. float32 as the
# CPU tests; bfloat16: both sides round an f32 result to bf16 once (a bf16
# unit of the outputs); float16 keeps three more mantissa bits and rounds
# at the same places (P to v's dtype, the output once), so its limit sits
# between its own readings on phase 3's mixes and bf16's (1.2e-4 and
# 2.4e-4 against 9.8e-4 and 2.0e-3 on phase 3's mix and the decode-only
# mix; PERF.md): an f16 instance that packed P or its output at bf16
# precision fails it
RPA_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3, torch.float16: 5e-4}


def phase_kernel():
    """RPA kernel vs its plain version: f32 (FMA kernel) at the default q
    tile, bf16 (split wgmma design) at each q tile on phase 3's mix and on
    the decode-only mix, and f16 (the same design's f16 instance) at the
    default tile on both mixes, timed beside bf16 in the same call.
    Returns the bf16 record at the default tile and the f16 record (with
    its decode-only mix under ``decode_only``)."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        DEFAULT_TILE_Q, ragged_paged_attention,
        ragged_paged_attention_reference)
    cases = [(torch.float32, DEFAULT_TILE_Q, False)] + [
        (torch.bfloat16, tq, decode) for decode in (False, True)
        for tq in RPA_TILES] + [
        (torch.float16, DEFAULT_TILE_Q, decode) for decode in (False, True)]
    record, f16, bf16_ms = None, {}, {}
    for dtype, tile_q, decode in cases:
        atol = RPA_TOL[dtype]
        args, valid, need = rpa_mix(dtype, tile_q=tile_q, decode_only=decode)
        out = ragged_paged_attention(**args)
        torch.cuda.synchronize()
        ref = ragged_paged_attention_reference(**args)
        name = str(dtype).replace("torch.", "")
        mix = "decode-only mix" if decode else "phase 3 mix"
        max_err = _rpa_check(f"{name}, tile_q {tile_q}, {mix}", out, ref,
                             valid, atol)
        ms = cuda_ms(lambda: ragged_paged_attention(**args))
        main = tile_q == DEFAULT_TILE_Q and (
            not decode or dtype == torch.float16)
        plain_ms = cuda_ms(
            lambda: ragged_paged_attention_reference(**args)) if main \
            else None
        design = "FMA kernel" if dtype == torch.float32 \
            else "split wgmma design"
        if dtype == torch.bfloat16 and tile_q == DEFAULT_TILE_Q:
            bf16_ms[decode] = ms
        log(f"rpa {name} ({design}, tile_q {tile_q}, {mix}): T={need['T']}"
            f" live pages={need['pages']} max|err|={max_err:.3e} (atol "
            f"{atol}, rtol 0) padding rows exactly 0; kernel {ms:.4f} ms"
            + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
            + f", bound {need['bound_ms']:.4f} ms ({need['bound_by']}: "
            f"{need['bytes']} B, {need['flops']} flop)"
            + (f"; bf16 {bf16_ms[decode]:.4f} ms in this call, f16/bf16 "
               f"{ms / bf16_ms[decode]:.3f}" if dtype == torch.float16
               else ""))
        rec = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=need["bound_ms"], bound_by=need["bound_by"])
        if main and dtype == torch.bfloat16:
            record = rec
        if dtype == torch.float16:
            f16["decode_only" if decode else "main"] = dict(
                rec, bf16_ms=bf16_ms[decode], atol=atol)
    return record, dict(f16["main"], decode_only=f16["decode_only"])


# --------------------------------------------------------------------------
def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        raw = r.read().decode()
    if body.get("stream"):
        lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
        done = lines[-1]
        if not done.get("done") or "error" in done:
            raise AssertionError(f"stream failed: {done}")
        done["streamed"] = [x["token"] for x in lines if "token" in x]
        return done
    return json.loads(raw)


def device_rows(prof):
    """``(device us, name, count)`` of every kernel and copy the profiler
    saw on the card, largest first. Host-side events are left out: a
    host op also reports the device time of the kernels it launched (a
    kernel launched through ctypes has no ATen parent, so its time shows
    again on the enclosing autograd node), which would count it twice."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    return sorted(((dev_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and dev_us(e) > 0 and e.key not in STEP_RANGES),
                  reverse=True)


def profile_window(engine, plain_prompts, profiled_prompts, new_tokens):
    """Where the device time goes in a short serving window of the
    running engine. Two request sets of the same lengths (fresh tokens,
    so neither hits the prefix cache) run one after the other: the first
    without the profiler, for the window's wall time, the second under
    ``torch.profiler``, for the device time per kernel. The profiler's
    host overhead lengthens its own window, so the device-busy share is
    the profiled device time over the un-profiled wall; the share over
    the profiled wall is printed beside it as a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    def window(prompts):
        steps0, t0 = engine.steps, time.perf_counter()
        hs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
        for h in hs:
            h.result(600)
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0), engine.steps - steps0

    plain_us, plain_steps = window(plain_prompts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us, steps = window(profiled_prompts)

    rows = device_rows(prof)
    total = sum(us for us, _, _ in rows)
    if total == 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    rpa_us = sum(us for us, k, _ in rows
                 if any(name in k for name in RPA_KERNELS))
    log(f"profile: {len(profiled_prompts)} requests x {new_tokens} tokens;"
        f" device time {total / 1e3:.3f} ms in {steps} steps (profiled);"
        f" wall {plain_us / 1e3:.3f} ms in {plain_steps} steps without the"
        f" profiler, {wall_us / 1e3:.3f} ms with it; device busy "
        f"{100 * total / plain_us:.1f}% of the un-profiled wall "
        f"({100 * total / wall_us:.1f}% of the profiled wall, a lower "
        f"bound); RPA kernels {100 * rpa_us / total:.1f}% of device time "
        f"({rpa_us / 1e3:.3f} ms, {rpa_us / 1e3 / steps:.3f} ms a step)")
    for us, key, count in rows[:6]:
        log(f"  {100 * us / total:5.1f}%  {us / 1e3:10.3f} ms  "
            f"{count:6d}x  {key[:90]}")


def engine_step_check(engine, cfg, rng, dtype=torch.bfloat16):
    """One real engine step's layer-0 RPA output against the plain
    version on the same inputs. Request A0 (a 1024-token prefix P and 50
    more) is served while C decodes; then A1 and A2, both starting with P,
    hit the prefix cache, so a step holds a prefill chunk, C's decode row
    and two sequences sharing P's pages. The model's paged attention step
    is wrapped for this window only: the first layer-0 call with all
    three is checked (the pools then hold exactly what the kernel read),
    at the card tests' bf16 tolerance (atol 4e-3, rtol 8e-3: both sides
    round to bf16 once, and the model's outputs are not all below 1 as
    phase 3's random ones are); an f16 engine at f16's own limits (atol
    ``RPA_TOL[f16]``, rtol twice that)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import \
        ragged_paged_attention_reference
    orig = pa.ragged_paged_attention_step
    found = []

    atol, rtol = (4e-3, 8e-3) if dtype == torch.bfloat16 else \
        (RPA_TOL[dtype], 2 * RPA_TOL[dtype])

    def capturing(q, k, v, k_pool, v_pool, bt, cu, ctx, sid, pos, ssq, sbk,
                  *, scale=None, attn_impl="rpa", **kw):
        out = orig(q, k, v, k_pool, v_pool, bt, cu, ctx, sid, pos, ssq, sbk,
                   scale=scale, attn_impl=attn_impl, **kw)
        if found or k_pool is not engine.cache.k_pools[0]:
            return out
        n = (cu[1:] - cu[:-1]).cpu()[:bt.shape[0] - 1]
        live = torch.nonzero(n > 0).flatten()
        pages = [set(bt[s].cpu().tolist()) - {0} for s in live.tolist()]
        shared = any(pages[i] & pages[j] for i in range(len(pages))
                     for j in range(i + 1, len(pages)))
        if not (bool((n > 1).any()) and bool((n == 1).any()) and shared):
            return out
        ref = ragged_paged_attention_reference(
            q, k_pool, v_pool, bt, cu, ctx, ssq, sbk, sm_scale=scale)
        valid = sid < bt.shape[0] - 1
        got = out.reshape(ref.shape)
        found.append((_rpa_check("engine step, layer 0", got, ref, valid,
                                 atol, rtol), n[live].tolist(),
                      int(ssq.shape[0])))
        return out

    prefix = rng.randint(1, cfg.vocab_size, 1024).tolist()
    fresh = lambda m: rng.randint(1, cfg.vocab_size, m).tolist()  # noqa
    pa.ragged_paged_attention_step = capturing
    try:
        c = engine.submit(fresh(64), max_new_tokens=96)
        engine.submit(prefix + fresh(50), max_new_tokens=1).result(600)
        hs = [engine.submit(prefix + fresh(m), max_new_tokens=4)
              for m in (60, 90)]
        for h in hs + [c]:
            h.result(600)
    finally:
        pa.ragged_paged_attention_step = orig
    if not found:
        raise AssertionError("no engine step held a prefill chunk, a decode "
                             "row and shared pages")
    err, news, tiles = found[0]
    log(f"serving ({str(dtype).replace('torch.', '')}): one engine step's "
        f"layer-0 RPA output (new tokens per "
        f"sequence {news}, shared prefix pages, {tiles} q tiles) agrees "
        f"with the plain version: max|err| {err:.3e} (atol {atol}, rtol "
        f"{rtol}: a model's outputs reach past 1, where one bf16 unit is "
        f"7.8e-3 and one f16 unit 9.8e-4); padding rows exactly 0")
    return err


def serve_window(engine, cfg, prompts, new_tokens, adapter_ids=None,
                 during=None):
    """A serving window of phases 4 and 16: ``prompts`` as concurrent
    ``/generate`` requests through the HTTP ``Server`` (odd ones
    streamed), each to its LoRA slot in ``adapter_ids``;
    ``during(engine)`` runs before the server stops. Every request must return all its tokens, every logit
    must be finite, the RPA launches must equal layers x steps (0 on the
    gather path) and no KV block may leak. The peak is
    ``max_memory_allocated`` over the window, reset when it opens, as
    phase 4's window peak. Returns the window's numbers."""
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import Server
    adapter_ids = adapter_ids or [0] * len(prompts)
    bad_logits = []
    orig_project = engine._project

    def checked_project(h):
        logits = orig_project(h)
        if not bool(torch.isfinite(logits).all()):
            bad_logits.append(tuple(logits.shape))
        return logits

    engine._project = checked_project
    results = [None] * len(prompts)
    errors = []
    torch.cuda.reset_peak_memory_stats()
    with Server(engine) as srv:
        def fire(i):
            try:
                results[i] = _post(srv.url + "/generate", {
                    "prompt_ids": prompts[i], "max_new_tokens": new_tokens,
                    "temperature": 0.0, "stream": i % 2 == 1,
                    "adapter_id": adapter_ids[i]})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")
        steps0 = engine.steps
        rpa.ragged_paged_attention.launches = 0
        rpa.ragged_paged_attention.launches_f16 = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = rpa.ragged_paged_attention.launches
        launches_f16 = rpa.ragged_paged_attention.launches_f16
        steps = engine.steps - steps0
        peak = torch.cuda.max_memory_allocated()
        with urllib.request.urlopen(srv.url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        extra = during(engine) if during is not None else None
    engine._project = orig_project
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors}")
    for i, res in enumerate(results):
        toks = res["token_ids"]
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i} returned {toks}")
        if "streamed" in res and res["streamed"] != toks:
            raise AssertionError(f"request {i}: streamed tokens differ")
    if bad_logits:
        raise AssertionError(f"non-finite logits in steps {bad_logits}")
    want = cfg.num_hidden_layers * steps if engine.attn_impl == "rpa" else 0
    if launches != want or steps == 0 or health["rpa_launches"] != launches:
        raise AssertionError(
            f"rpa launches {launches} (healthz {health['rpa_launches']}) != "
            f"{want} ({cfg.num_hidden_layers} layers x {steps} steps on the "
            f"{engine.attn_impl} path)")
    engine.cache.allocator.assert_no_leaks()
    gaps = sorted((r["latency_ms"] - r["ttft_ms"]) / (new_tokens - 1)
                  for r in results)
    return dict(launches=launches, launches_f16=launches_f16, steps=steps,
                wall=wall, peak=peak, health=health, extra=extra,
                mean_step_ms=1e3 * wall / steps,
                gap_p50=statistics.median(gaps), gap_max=gaps[-1],
                ttft_p50=statistics.median(r["ttft_ms"] for r in results))


def _window_line(what, w, n, new_tokens):
    return (f"{what}: {n} requests x {new_tokens} tokens, all returned, "
            f"logits finite; {w['steps']} engine steps, {w['launches']} RPA "
            f"launches; mean step (wall / steps) {w['mean_step_ms']:.3f} ms;"
            f" gap between output tokens p50 {w['gap_p50']:.3f} ms, max "
            f"{w['gap_max']:.3f} ms; p50 TTFT {w['ttft_p50']:.3f} ms; "
            f"max_memory_allocated over the window {w['peak']} B")


def _phase4_prompts(cfg, rng):
    """Phase 4's prompt lengths, fresh tokens; the last two share a
    1024-token prefix."""
    prefix = rng.randint(1, cfg.vocab_size, 1024).tolist()
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in SERVING_LENS]
    prompts[6] = prefix + prompts[6][1024:]
    prompts[7] = prefix + prompts[7][1024:]
    return prompts


def phase_serving():
    """Llama-3-8B widths, 32 layers, bf16, behind the HTTP server."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serving: Llama-3-8B widths, {cfg.num_hidden_layers} layers, bf16,"
        f" {n_params} parameters built in "
        f"{time.perf_counter() - t0:.2f} s")
    engine = ServingEngine(model, max_batch=8, block_size=16,
                           prefill_chunk=512, max_blocks=2048)
    rng = np.random.RandomState(SEED)
    prompts = _phase4_prompts(cfg, rng)
    new_tokens = 32

    def during(eng):
        plain, profiled = ([rng.randint(1, cfg.vocab_size, n).tolist()
                            for n in (256, 512, 1024, 2048)]
                           for _ in range(2))
        profile_window(eng, plain, profiled, new_tokens)
        engine_step_check(eng, cfg, rng)

    w = serve_window(engine, cfg, prompts, new_tokens, during=during)
    launches, steps, wall = w["launches"], w["steps"], w["wall"]
    log(f"serving: {len(prompts)} requests, prompts {SERVING_LENS}, "
        f"{new_tokens} new tokens each, all returned; {steps} engine steps,"
        f" {launches} RPA launches (= {cfg.num_hidden_layers} x steps)")
    log(f"serving: window wall {wall:.3f} s; mean step (wall / steps) "
        f"{w['mean_step_ms']:.3f} ms; decode tokens/s (generated tokens /"
        f" wall) {len(prompts) * new_tokens / wall:.2f}; gap between output"
        f" tokens per request, p50 {w['gap_p50']:.3f} ms, max "
        f"{w['gap_max']:.3f} ms; p50 TTFT {w['ttft_p50']:.3f} ms; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B "
        f"({w['peak']} B over the 8-request window); "
        f"prefix cache {w['health']['prefix_cache']}")
    del engine
    free_device_memory()
    sweep = serving_tile_sweep(model, cfg)
    del model
    free_device_memory()
    return launches, w["peak"], sweep


def serving_tile_sweep(model, cfg, what="serving"):
    """The engine's q tile on phase 4's step: the same engine geometry at
    tile_q 8, 16 and 32, then again in reverse order (the engine
    module's DEFAULT_TILE_Q set for each engine's construction, then
    restored),
    each serving 8 fresh requests of phase 4's prompt lengths x 16 tokens
    in process after one warm-up request: mean step ms (wall / engine
    steps). Returns ``(tile_q, step_tokens, mean step ms, steps)`` of
    each engine."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import engine as engine_mod
    rng = np.random.RandomState(SEED + 7)
    default = engine_mod.DEFAULT_TILE_Q
    res = []
    for tile_q in RPA_TILES + RPA_TILES[::-1]:
        engine_mod.DEFAULT_TILE_Q = tile_q
        try:
            eng = ServingEngine(model, max_batch=8, block_size=16,
                                prefill_chunk=512, max_blocks=2048)
        finally:
            engine_mod.DEFAULT_TILE_Q = default
        eng.submit(rng.randint(1, cfg.vocab_size, 600).tolist(),
                   max_new_tokens=4)
        eng.run_until_idle()
        hs = [eng.submit(rng.randint(1, cfg.vocab_size, n).tolist(),
                         max_new_tokens=16) for n in SERVING_LENS]
        steps0, t0 = eng.steps, time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for h in hs:
            h.result(60)
        steps = eng.steps - steps0
        res.append((tile_q, eng.step_tokens, 1e3 * wall / steps, steps))
        del eng
        free_device_memory()
    log(f"{what} tile sweep (8 requests of phase 4's prompt lengths x 16 "
        "tokens, in process, in order then reversed): " + "; ".join(
            f"tile_q {t}: step_tokens {T}, mean step {ms:.3f} ms over {n} "
            f"steps" for t, T, ms, n in res))
    return res


def phase_parity():
    """Kernel engine vs gather engine, full width, 2 layers, float32."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, dtype="float32", seed=SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (100, 300, 600, 900)]
    streams = {}
    for impl in ("rpa", "gather"):
        eng = ServingEngine(model, max_batch=4, block_size=16,
                            prefill_chunk=64, max_blocks=256,
                            max_blocks_per_seq=64, attn_impl=impl)
        hs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run_until_idle()
        streams[impl] = [h.result(60)["token_ids"] for h in hs]
        eng.cache.allocator.assert_no_leaks()
        del eng
    if streams["rpa"] != streams["gather"]:
        raise AssertionError(f"greedy streams differ: {streams}")
    log(f"parity: kernel and gather engines agree on {len(prompts)} greedy "
        f"streams of 16 tokens at full width, 2 layers, float32")
    del model
    free_device_memory()


# --------------------------------------------------------------------------
FLASH_SRC = "paddle_tpu_torch/ops/pallas/csrc/flash_attention.cu"
FLASH_KERNELS_NAMES = ("flash_attention_fwd", "flash_attention_dq",
                       "flash_attention_dkv")
FLASH_KERNELS = (  # name, the TPU kernel it replaces
    ("flash_attention_fwd", "paddle_tpu/ops/pallas/flash_attention.py:242"),
    ("flash_attention_dq", "paddle_tpu/ops/pallas/flash_attention.py:410"),
    ("flash_attention_dkv", "paddle_tpu/ops/pallas/flash_attention.py:471"))
# limits of kernel vs plain: (atol, rtol) of o and lse, and of gradients.
# float32 as the CPU parity tests. bfloat16: the largest errors measured on
# the card at the training shape (PERF.md: 3.9e-3 for o, 1.6e-2 for dq,
# 6.3e-2 for dk/dv) are a bfloat16 unit or two of the values they sit on
# (dv reaches 10.3, where a unit is 6.25e-2): both sides round the result to
# bfloat16 once, and the kernels round p and ds to bfloat16 against a
# running max where the plain version uses the row's final max
FLASH_TOL = {torch.float32: ((2e-5, 2e-4), (2e-4, 2e-3)),
             torch.bfloat16: ((1e-2, 1e-2), (2e-2, 2e-2))}
# float16 keeps three more mantissa bits than bfloat16 and rounds at the
# same places. Its limits, (atol, rtol) of K1's o and lse, of K2's dq and
# of K3's dk and dv at the training shape, sit near 3x its own largest
# errors there (PERF.md: 4.9e-4, 2.0e-3 and 7.8e-3, one float16 unit of
# dv's 10.3) and below bfloat16's (3.9e-3, 1.6e-2, 6.3e-2): a float16
# instance that rounded p, ds or its outputs at bfloat16's precision
# fails them
FLASH_TOL_F16 = ((1.5e-3, 0.0), (6e-3, 0.0), (2.4e-2, 0.0))


def flash_kernel_tols(dtype):
    """The limits of K1, K2 and K3 against their plain versions."""
    if dtype == torch.float16:
        return FLASH_TOL_F16
    o_tol, g_tol = FLASH_TOL[dtype]
    return o_tol, g_tol, g_tol


def _reset_flash_counts():
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0


def _uncounted_flash(fn):
    """``fn()``, with K1-K3's counters put back as they were before it:
    an eager run made only to compare with or to time beside a path does
    not count on that path."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    held = fa.launches_fwd, fa.launches_dq, fa.launches_dkv
    out = fn()
    fa.launches_fwd, fa.launches_dq, fa.launches_dkv = held
    return out


def _flash_counts():
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    return dict(flash_attention_fwd=fa.launches_fwd,
                flash_attention_dq=fa.launches_dq,
                flash_attention_dkv=fa.launches_dkv)


def flash_need(q, k, g, products, out_bytes, in_extra):
    """Least work of one kernel call on these inputs: every input read
    once, every output written once; 2*hd flops per product per visible
    (q head, key) pair (causal: the pairs this offset leaves visible)."""
    bhq, sq, hd = q.shape
    sk = k.shape[1]
    if g.causal:
        i = torch.arange(sq, dtype=torch.float64)
        pairs = float(torch.clamp(i + (sk - sq) + 1, 0, sk).sum()) * bhq
    else:
        pairs = float(sq * sk * bhq)
    flops = 2 * hd * products * pairs
    nbytes = q.numel() * q.element_size() + 2 * k.numel() * \
        k.element_size() + in_extra + out_bytes
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _check(what, got, want, atol, rtol):
    """max |got - want|; raises unless finite and within atol + rtol *
    |want| everywhere."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > atol + rtol * want.abs()).any()):
        raise AssertionError(
            f"{what}: kernel disagrees with the plain version: max |err| "
            f"{float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    return float(err.max())


def flash_training_shape(dtype):
    """Phase 6(a) in one dtype: returns {kernel: record}."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    B, hq, hkv, S, hd = 4, 16, 4, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def mk(h):
        return torch.randn(B, h, S, hd, device="cuda", dtype=dtype,
                           generator=gen)
    q4, k4, v4, do4 = mk(hq), mk(hkv), mk(hkv), mk(hq)
    q, k, v, g, _ = fa._geometry(q4, k4, v4, True, None, None, None, None,
                                 0.0, None)
    do = do4.reshape(q.shape)
    k1_tol, k2_tol, k3_tol = flash_kernel_tols(dtype)

    o, lse = fa.flash_attention_fwd(q, k, v, g)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, g)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, g)
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    ro, rlse = fa.flash_attention_reference(*leaves, causal=True)
    rgrads = torch.autograd.grad(ro, leaves, do4)
    name = str(dtype).replace("torch.", "")
    errs = {
        "flash_attention_fwd": max(
            _check(f"K1 o {name}", o, ro.reshape(o.shape), *k1_tol),
            _check(f"K1 lse {name}", lse, rlse.reshape(lse.shape),
                   *k1_tol)),
        "flash_attention_dq": _check(f"K2 dq {name}", dq,
                                     rgrads[0].reshape(dq.shape), *k2_tol),
        "flash_attention_dkv": max(
            _check(f"K3 dk {name}", dk, rgrads[1].reshape(dk.shape),
                   *k3_tol),
            _check(f"K3 dv {name}", dv, rgrads[2].reshape(dv.shape),
                   *k3_tol))}
    log(f"flash {name}: largest |plain| o {float(ro.detach().abs().max()):.3f},"
        f" dq {float(rgrads[0].abs().max()):.3f}, dk "
        f"{float(rgrads[1].abs().max()):.3f}, dv "
        f"{float(rgrads[2].abs().max()):.3f}")
    del ro, rlse, rgrads, leaves

    esz, row = q.element_size(), 4 * q.shape[0] * q.shape[1]
    kernels = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, g),
            lambda: fa._forward_plain(q, k, v, g),
            flash_need(q, k, g, 2, q.numel() * esz + row, 0)),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, g),
            lambda: fa._dq_plain(q, k, v, do, lse, delta, g),
            flash_need(q, k, g, 3, q.numel() * esz,
                       q.numel() * esz + 2 * row)),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, g),
            lambda: fa._dkv_plain(q, k, v, do, lse, delta, g),
            flash_need(q, k, g, 4, 2 * k.numel() * esz,
                       q.numel() * esz + 2 * row))}
    # the yardstick: PyTorch's fused attention on the same inputs (the
    # port never calls it)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)

    def lib_fwd_bwd():
        out = sdpa(*leaves, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, leaves, do4)
    lib_f = cuda_ms(lib_fwd)
    lib_b = cuda_ms(lib_fwd_bwd) - lib_f
    records = {}
    with torch.no_grad():
        for kname, (kern, plain, need) in kernels.items():
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain)
            lib = lib_f if kname == "flash_attention_fwd" else lib_b
            design = ("FMA loops" if dtype == torch.float32
                      else "wgmma, tiles by TMA")
            log(f"flash {name} {kname} ({design}): max|err|={errs[kname]:.3e};"
                f" kernel {ms:.4f} ms "
                f"({need['flops'] / (ms / 1e3) / 1e12:.1f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms, bound "
                f"{need['bound_ms']:.4f} ms ({need['bound_by']}: "
                f"{need['bytes']} B, {need['flops']:.4e} flop), library "
                f"{lib:.4f} ms "
                + ("(sdpa forward)" if lib is lib_f else
                   "(sdpa backward: dq, dk and dv together)"))
            records[kname] = dict(max_abs_err=errs[kname], ms=ms,
                                  plain_ms=plain_ms,
                                  bound_ms=need["bound_ms"],
                                  bound_by=need["bound_by"],
                                  library_ms=lib)
    return records


def _sweep_case(name, dtype, gen):
    """Phase 6(b) inputs: (q, k, v, do, geometry, rows with no live key)."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    B, hq, hkv, sq, sk, hd = 2, 8, 2, 320, 320, 128
    kw = dict(causal=True)
    dev = dict(device="cuda")
    if name == "offset_causal":
        sk = 448
    elif name.startswith("gqa_"):
        hkv = hq // int(name.split("_")[1])
    elif name == "segments_dead_rows":
        kw["q_segment_ids"] = torch.tensor([[1] * 200 + [5] * 120] * B,
                                           **dev)
        kw["kv_segment_ids"] = torch.tensor([[1] * 100 + [2] * 220] * B,
                                            **dev)
    elif name == "row_bias":
        kw = dict(causal=False, bias=torch.randn(B, 1, 1, sk, generator=gen,
                                                 **dev))
    elif name == "full_bias":
        kw["bias"] = torch.randn(1, hq, sq, sk, generator=gen, **dev)
    elif name == "dropout":
        kw.update(dropout_p=0.1, dropout_seed=2024)
    elif name == "ragged":
        sq = sk = 333
    elif name == "head_dim_64":
        hd = 64
    elif name == "head_dim_72":  # DiT-XL/2's attention
        hq = hkv = 16
        sq = sk = 256
        hd = 72
        kw = dict(causal=False)
    elif name in ("head_dim_32", "head_dim_80"):  # padded to 64 and 128
        hd = int(name.rsplit("_", 1)[1])
    elif name == "ernie_shape":  # ERNIE-base's attention, with dropout
        hq = hkv = 12
        sq = sk = 512
        hd = 64
        kw = dict(causal=False, dropout_p=0.1, dropout_seed=2024)
    mk = lambda h, s: torch.randn(B, h, s, hd, generator=gen,  # noqa: E731
                                  dtype=dtype, **dev)
    q, k, v, g, _ = fa._geometry(
        mk(hq, sq), mk(hkv, sk), mk(hkv, sk), kw.pop("causal"), None,
        kw.pop("bias", None), kw.pop("q_segment_ids", None),
        kw.pop("kv_segment_ids", None), kw.pop("dropout_p", 0.0),
        kw.pop("dropout_seed", None))
    dead = None
    if g.q_seg is not None:
        dead = g.q_seg[0] == 5
    return q, k, v, torch.randn(q.shape, generator=gen, dtype=dtype,
                                **dev), g, dead


SWEEP = ("offset_causal", "gqa_1", "gqa_4", "gqa_8", "segments_dead_rows",
         "row_bias", "full_bias", "dropout", "ragged", "head_dim_64",
         "head_dim_72", "head_dim_32", "head_dim_80", "ernie_shape")


def flash_sweep():
    """Phase 6(b): every case, both dtypes, each kernel against its plain
    version on the same inputs (and the same lse and delta), through
    ``padded_launch``: a head_dim with no kernel instance (32, 72, 80)
    goes in zero-padded as ``flash_attention_bhsd`` pads it, and the
    kernels' outputs are sliced back (their padded columns must be
    exactly 0)."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            o_tol, g_tol = FLASH_TOL[dtype]
            for case in SWEEP:
                q, k, v, do, g, dead = _sweep_case(case, dtype, gen)
                (o, lse, delta, dq, dk, dv), tail = fa.padded_launch(
                    q, k, v, do, g)
                if tail != 0:
                    raise AssertionError(
                        f"{case}: padded columns not 0 (max |x| {tail})")
                ro, rlse = fa._forward_plain(q, k, v, g)
                rdq = fa._dq_plain(q, k, v, do, lse, delta, g)
                rdk, rdv = fa._dkv_plain(q, k, v, do, lse, delta, g)
                what = f"{case} {str(dtype).replace('torch.', '')}"
                errs = [_check(f"K1 o {what}", o, ro, *o_tol),
                        _check(f"K1 lse {what}", lse, rlse, *o_tol),
                        _check(f"K2 dq {what}", dq, rdq, *g_tol),
                        _check(f"K3 dk {what}", dk, rdk, *g_tol),
                        _check(f"K3 dv {what}", dv, rdv, *g_tol)]
                if dead is not None and not (
                        bool((o[:, dead] == 0).all())
                        and bool((lse[:, dead] == 0).all())
                        and bool((dq[:, dead] == 0).all())):
                    raise AssertionError(
                        f"{what}: rows with no live key are not exactly 0")
                key = (case, dtype)
                worst[key] = max(errs)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        log(f"flash sweep {name}: all kernels agree with the plain versions "
            f"(max |err| per case: " + ", ".join(
                f"{c} {worst[(c, dtype)]:.2e}" for c in SWEEP) + ")")
    log("flash sweep: rows with no live key give exactly 0 o, lse and dq")


def phase_flash():
    """Phase 6; returns the bf16 records of the training shape."""
    _reset_flash_counts()
    flash_training_shape(torch.float32)  # checked and logged
    recs = flash_training_shape(torch.bfloat16)
    flash_sweep()
    free_device_memory()
    return recs


# --------------------------------------------------------------------------
def train_flops_per_step(cfg, B, S):
    """``bench.py``'s training flop count (bench_full_model): 3 x the
    forward's 2-per-MAC flops, attention at its causal half."""
    d, ffn, V, L = (cfg.hidden_size, cfg.intermediate_size,
                    cfg.vocab_size, cfg.num_hidden_layers)
    d_kv = cfg.num_key_value_heads * (d // cfg.num_attention_heads)
    per_tok = L * (4 * d * d + 4 * d * d_kv + 6 * d * ffn) + 2 * d * V
    attn = L * 2 * B * S * S * d
    return 3 * (B * S * per_tok + attn)


# device kernels by kind, first match wins: (label, words in the name)
KERNEL_KINDS = (
    ("flash K1-K3", ("flash_",)),
    ("fused optimizer kernels", ("fused_adam", "fused_sqnorm")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass")),
    ("copies, casts, cat, fill", ("copy", "memcpy", "memset", "catarray",
                                  "fill")),
    ("multi-tensor (foreach)", ("multi_tensor_apply",)),
    ("gathers, scatters, sorts, embedding", (
        "index", "gather", "scatter", "sort", "radix", "scan", "cumsum",
        "embedding", "histogram")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)))
# the ranges TrainStep opens around its three parts
STEP_RANGES = ("TrainStep.forward_backward", "TrainStep.clip",
               "TrainStep.update")


def kernel_kind(key):
    low = key.lower()
    for label, words in KERNEL_KINDS:
        if any(w in low for w in words):
            if label == "elementwise":  # by the type the functor computes
                return "elementwise bf16" if "bfloat16" in low else \
                    "elementwise f32" if "float" in low else "elementwise"
            return label
    return "other"


# the port's own kernels, launched through ctypes, which the profiler
# links to no host op: each belongs to a TrainStep range by its name
OWN_KERNEL_RANGES = (("flash_", "TrainStep.forward_backward"),
                     ("fused_sqnorm", "TrainStep.clip"),
                     ("fused_adam", "TrainStep.update"))


def range_device_us(prof):
    """Device us of each ``TrainStep`` range: every kernel a host op
    launched while the range was open on the host (the backward's ops
    run on autograd's own thread while the step's thread waits inside
    its range), and the port's own kernels by their names."""
    from torch.autograd import DeviceType

    def own(name):
        return next((r for w, r in OWN_KERNEL_RANGES if w in name), None)
    spans = {n: [] for n in STEP_RANGES}
    for e in prof.events():
        if e.name in spans and e.device_type == DeviceType.CPU:
            spans[e.name].append((e.time_range.start, e.time_range.end))
    out = dict.fromkeys(STEP_RANGES, 0.0)
    if not any(spans.values()):
        return out
    seen = set()
    for e in prof.events():
        # CUPTI's own markers ("Command Buffer Full") share the correlation
        # id of the op they interrupt and carry its kernels again: each id
        # counts once
        if e.device_type != DeviceType.CPU or not e.kernels or e.id in seen:
            continue
        seen.add(e.id)
        t = e.time_range.start
        r = next((n for n, ivs in spans.items()
                  if any(a <= t <= b for a, b in ivs)), None)
        if r is not None:
            out[r] += sum(k.duration for k in e.kernels
                          if own(k.name) is None)
    for us, key, _ in device_rows(prof):
        if own(key) is not None:
            out[own(key)] += us
    return out


def dev_total_us(e):
    """A host op's device time with its children's (the attribute's name
    depends on the PyTorch version)."""
    return e.device_time_total if hasattr(e, "device_time_total") \
        else e.cuda_time_total


def step_breakdown(prof, what, step_ms, kind=kernel_kind):
    """Log one profiled training step's device time by kind of kernel
    (``kind`` of its name, with launches) and by ``TrainStep``'s ranges;
    returns ``{kind or range: device ms}``. A range's time is the device
    time of every kernel launched inside it."""
    rows = device_rows(prof)
    total = sum(us for us, _, _ in rows)
    if total == 0:
        log(f"{what} profile: the profiler saw no device time "
            f"(not measured)")
        return {}
    kinds = {}
    for us, key, count in rows:
        k = kinds.setdefault(kind(key), [0.0, 0])
        k[0] += us
        k[1] += count
    log(f"{what} profile: one step, device time {total / 1e3:.3f} ms = "
        f"{100 * total / 1e3 / step_ms:.1f}% of the un-profiled step wall;"
        f" by kind of kernel (device ms, share, launches):")
    for label, (us, count) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"  {label:38s} {us / 1e3:9.3f} ms {100 * us / total:5.1f}% "
            f"{count:6d}x")
    out = {label: us / 1e3 for label, (us, _) in kinds.items()}
    spans = range_device_us(prof)
    if any(spans.values()):
        log(f"{what} profile: by TrainStep range (device ms, share): "
            + ", ".join(f"{n.split('.')[1]} {us / 1e3:.3f} "
                        f"({100 * us / total:.1f}%)"
                        for n, us in spans.items())
            + f", outside them {(total - sum(spans.values())) / 1e3:.3f}")
        out.update({n: us / 1e3 for n, us in spans.items()})
    else:
        log(f"{what} profile: no TrainStep ranges in the trace")
    for us, key, count in rows[:15]:
        log(f"  {100 * us / total:5.1f}%  {us / 1e3:10.3f} ms  "
            f"{count:6d}x  {key[:100]}")
    return out


def profile_train_step(step, x, step_ms, what="train", kind=kernel_kind):
    """Device time of one more training step under ``torch.profiler``,
    by kind of kernel and by ``TrainStep`` range."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x)
        torch.cuda.synchronize()
    return step_breakdown(prof, what, step_ms, kind)


FUSED_SRC = "paddle_tpu_torch/ops/pallas/csrc/fused_update.cu"
# the fused optimizer kernels have no Pallas counterpart: they stand in for
# XLA's fusion of the reference's fused_clip_and_update
FUSED_REPLACES = "paddle_tpu/jit/fused_update.py:250"
FUSED_KERNELS = ("fused_adam_update", "fused_sqnorm")


def _reset_fused_counts():
    from paddle_tpu_torch.jit import fused_update as fu
    fu.launches_adam = fu.launches_sqnorm = 0


def _fused_counts():
    from paddle_tpu_torch.jit import fused_update as fu
    return dict(fused_adam_update=fu.launches_adam,
                fused_sqnorm=fu.launches_sqnorm)


def train_run(what, make_model, fused, warmup, timed, flops,
              profile=None):
    """One training run of a seeded causal LM on one seeded batch of 4 x
    2048 ids (:func:`model_train_run`, ``profile`` as given), whose first
    loss must be within 1.0 of ln(vocab) and whose last must be lower;
    returns the run's numbers and the model."""
    B, S = 4, 2048
    free_device_memory()
    before = torch.cuda.memory_allocated()  # left by earlier phases
    torch.cuda.reset_peak_memory_stats()
    model = make_model()
    cfg = model.cfg
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S))).cuda()
    run = model_train_run(what, model, lambda m, x: m(x, labels=x)[1], [x],
                          warmup, timed, flops, cfg.num_hidden_layers,
                          before, fused=fused, items=B * S,
                          profile=profile, desc=f"batch {B} x {S}")
    losses = run["losses"]
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(losses[0]) and abs(losses[0] - ln_v) <= 1.0):
        raise AssertionError(f"{what}: first loss {losses[0]} is not within "
                             f"1.0 of ln(vocab) = {ln_v:.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    return run, model


def compare_fused_and_loop(what, fused, loop):
    """The fused and the looped runs of one model from the same seed:
    their first three losses agree within rtol 1e-3."""
    a, b = fused["losses"][:3], loop["losses"][:3]
    if not np.allclose(a, b, rtol=1e-3, atol=0):
        raise AssertionError(f"{what}: fused losses {a} and looped {b} "
                             f"differ by more than rtol 1e-3")
    opt_ms = {k: r["shares"].get("TrainStep.clip", 0.0)
              + r["shares"].get("TrainStep.update", 0.0)
              for k, r in (("fused", fused), ("loop", loop))}
    log(f"{what}: fused step {fused['step_ms']:.3f} ms against "
        f"{loop['step_ms']:.3f} ms with fused=False "
        f"({loop['step_ms'] / fused['step_ms']:.3f}x); clip + update "
        f"device time {opt_ms['fused']:.3f} against {opt_ms['loop']:.3f} "
        f"ms; first three losses {[round(v, 5) for v in a]} and "
        f"{[round(v, 5) for v in b]} (rtol 1e-3); peak "
        f"{fused['peak']} against {loop['peak']} B, held between steps "
        f"{fused['resident']} against {loop['resident']} B")


def llama_bench_config():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=7168,
        num_hidden_layers=8, num_attention_heads=16, num_key_value_heads=4,
        max_position_embeddings=4096, tie_word_embeddings=True)


def phase_training():
    """The bench's training step at its full configuration, fused (the
    default: 2 + 10 steps, the main path whose launches are counted) and
    with ``fused=False`` (2 + 5 steps); returns the fused run's flash
    and fused-kernel launch counts."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cfg = llama_bench_config()
    flops = train_flops_per_step(cfg, 4, 2048)

    def make():
        return LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    fused, model = train_run("train", make, None, 2, 10, flops)
    del model
    loop, model = train_run("train", make, False, 2, 5, flops)
    del model
    free_device_memory()
    compare_fused_and_loop("train", fused, loop)
    return {**fused["flash"], **fused["fused"]}, fused["step_ms"]


# --------------------------------------------------------------------------
def phase_fused_update():
    """The fused update's kernels on the Llama bucket's real sizes (the
    bench model's 0.70 B bf16 parameters, f32 masters, AdamW): two steps
    through the kernels and through the plain bucket update, from the
    same state and gradients, must agree bit for bit; then the times of
    the kernels, the plain versions, the per-parameter loop (the clip and
    update of ``fused=False``) and ``torch._fused_adamw_`` on the same
    flat f32 buffers (another rule: timed, not compared)."""
    from paddle_tpu_torch.jit import fused_update as fu
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    free_device_memory()
    model = LlamaForCausalLM(llama_bench_config(), dtype="bfloat16",
                             seed=SEED)
    clip = ClipGradByGlobalNorm(1.0)
    copies = []
    for params in (dict(model.named_parameters()),
                   {n: torch.nn.Parameter(p.detach().clone())
                    for n, p in model.named_parameters()}):
        opt = AdamW(learning_rate=1e-4, parameters=list(params.values()),
                    multi_precision=True, grad_clip=clip)
        layout = fu.build_layout(opt, params, list(params))
        (b,), flats = layout.buckets, fu.build_flat_states(opt, layout,
                                                           params)
        copies.append((opt, b, [params[n] for n in b.names], flats[0]))
    del model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [(torch.randn(p.shape, device="cuda", generator=gen) * 1e-3)
             .to(torch.bfloat16) for p in copies[0][2]]
    n = sum(g.numel() for g in grads)
    lr = 1e-4

    def scale_of(sq):
        return clip.scale(torch.sqrt(sq))
    (opt_k, b_k, ps_k, f_k), (opt_p, b_p, ps_p, f_p) = copies
    _reset_fused_counts()  # these launches are checks, not the main path
    sq_k = fu.fused_sqnorm(grads, b_k)
    sq_p = fu.sqnorm_plain(grads)
    for _ in range(2):
        fu.fused_adam_update(opt_k, b_k, ps_k, grads, f_k, lr,
                             scale_of(sq_k))
        fu.bucket_update_plain(opt_p, b_p, ps_p, grads, f_p, lr,
                               scale_of(sq_k))
    torch.cuda.synchronize()
    sq_err = abs(float(sq_k) - float(sq_p)) / float(sq_p)
    if sq_err > 1e-6 or not torch.equal(sq_k, fu.fused_sqnorm(grads, b_k)):
        raise AssertionError(f"fused_sqnorm: {float(sq_k)} against plain "
                             f"{float(sq_p)} (relative {sq_err:.3e}), or not "
                             f"the same bits on a second run")
    diffs = {k: float((f_k[k].float() - f_p[k].float()).abs().max())
             for k in f_k}
    diffs["param"] = max(float((a.detach().float() - c.detach().float())
                               .abs().max()) for a, c in zip(ps_k, ps_p))
    same = all(torch.equal(f_k[k], f_p[k]) for k in f_k) and all(
        torch.equal(a.detach(), c.detach()) for a, c in zip(ps_k, ps_p))
    if not same:
        raise AssertionError(f"fused_adam_update differs from the plain "
                             f"bucket update: max |err| {diffs}")
    log(f"fused update: {n} parameters in one bucket of {len(ps_k)} "
        f"tensors (bf16, f32 masters, AdamW decay 0.01, clip scale "
        f"{float(scale_of(sq_k)):.6f}); fused_adam_update equals the plain "
        f"bucket update bit for bit over 2 steps (parameters, m, v, "
        f"masters, beta powers); fused_sqnorm {float(sq_k):.9e} against "
        f"plain {float(sq_p):.9e} (relative {sq_err:.2e}, limit 1e-6), the "
        f"same bits on a second run")

    scale = scale_of(sq_k)
    pairs = list(zip(ps_p, grads))
    group = opt_p._param_groups[0]
    flat_f32 = {k: f_p[k] for k in ("master_weight", "moment1", "moment2")}
    g32 = torch.cat([g.reshape(-1) for g in grads]).float()
    steps32 = torch.ones((), device="cuda")

    def loop():  # fused=False's clip and update
        clipped, _ = clip._clip_with_norm(pairs)
        opt_p._apply(group, clipped, lr)

    def library():
        torch._fused_adamw_(
            [flat_f32["master_weight"]], [g32], [flat_f32["moment1"]],
            [flat_f32["moment2"]], [], [steps32], lr=lr, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False)
    times = dict(
        adam=cuda_ms(lambda: fu.fused_adam_update(opt_k, b_k, ps_k, grads,
                                                  f_k, lr, scale)),
        adam_plain=cuda_ms(lambda: fu.bucket_update_plain(
            opt_p, b_p, ps_p, grads, f_p, lr, scale), reps=10),
        sqnorm=cuda_ms(lambda: fu.fused_sqnorm(grads, b_k)),
        sqnorm_plain=cuda_ms(lambda: fu.sqnorm_plain(grads), reps=10),
        loop=cuda_ms(loop, reps=10),
        library=cuda_ms(library, reps=10))
    torch.cuda.synchronize()
    adam_bytes, sq_bytes = 28 * n, 2 * n
    bound = {"adam": 1e3 * adam_bytes / HBM_BYTES_PER_S,
             "sqnorm": 1e3 * sq_bytes / HBM_BYTES_PER_S}
    log(f"fused update: fused_adam_update {times['adam']:.4f} ms "
        f"({adam_bytes / times['adam'] / 1e9:.3f} TB/s, "
        f"{100 * bound['adam'] / times['adam']:.1f}% of the bound's rate), "
        f"plain bucket update {times['adam_plain']:.4f} ms, "
        f"torch._fused_adamw_ on the flat f32 buffers (another rule, f32 "
        f"gradients, no bf16 parameters) {times['library']:.4f} ms; bound "
        f"{adam_bytes} B (28 B a parameter: the bf16 gradient read, m, v "
        f"and the master read and written, the bf16 parameter written) / "
        f"3.35 TB/s = {bound['adam']:.4f} ms")
    log(f"fused update: fused_sqnorm {times['sqnorm']:.4f} ms, plain "
        f"{times['sqnorm_plain']:.4f} ms; bound {sq_bytes} B / 3.35 TB/s = "
        f"{bound['sqnorm']:.4f} ms. Clip + update: the kernels "
        f"{times['adam'] + times['sqnorm']:.4f} ms against the "
        f"per-parameter loop's {times['loop']:.4f} ms")
    del copies, opt_k, opt_p, ps_k, ps_p, f_k, f_p, pairs, flat_f32, g32
    free_device_memory()
    return {
        "fused_adam_update": dict(
            max_abs_err=max(diffs.values()), ms=times["adam"],
            plain_ms=times["adam_plain"], bound_ms=bound["adam"],
            bound_by="bytes", library_ms=times["library"]),
        "fused_sqnorm": dict(
            max_abs_err=abs(float(sq_k) - float(sq_p)), ms=times["sqnorm"],
            plain_ms=times["sqnorm_plain"], bound_ms=bound["sqnorm"],
            bound_by="bytes", library_ms=None)}


# --------------------------------------------------------------------------
GMM_SRC = "paddle_tpu_torch/ops/pallas/csrc/grouped_matmul.cu"
GMM_KERNELS = (  # name, launch-count attribute, the TPU kernel it replaces
    ("gmm", "launches_gmm", "paddle_tpu/ops/pallas/grouped_matmul.py:131"),
    ("tgmm", "launches_tgmm", "paddle_tpu/ops/pallas/grouped_matmul.py:196"),
    ("gmm_aligned", "launches_gmm_aligned",
     "paddle_tpu/ops/pallas/grouped_matmul.py:269"),
    ("tgmm_aligned", "launches_tgmm_aligned",
     "paddle_tpu/ops/pallas/grouped_matmul.py:304"))
GMM_NAMES = tuple(name for name, _, _ in GMM_KERNELS)
# kernel vs plain: max |err| over the largest |plain| value, by the dtype
# of the result. f32 results sum in another order (a hot expert sums 44k
# rows); bf16 results are rounded once on each side, so they may sit one
# bf16 unit (2**-7 of the value) apart
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# DeepSeekMoE-16B's routed experts: d_model, expert width, experts, top-k
MOE_M, MOE_H, MOE_E, MOE_K = 2048, 1408, 64, 6


def _gmm_counts():
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    return {name: getattr(gm, attr) for name, attr, _ in GMM_KERNELS}


def _reset_gmm_counts():
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    for _, attr, _ in GMM_KERNELS:
        setattr(gm, attr, 0)


def _rel_check(what, got, want, tol, live=None):
    """max |got - want| (over ``live`` rows of the leading dim, if given);
    raises unless got is finite and the error is within ``tol`` of the
    largest |want|."""
    got, want = got.detach().float(), want.detach().float()
    if live is not None:
        got, want = got[live], want[live]
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or err > tol * max(scale, 1e-6):
        raise AssertionError(
            f"{what}: kernel disagrees with the plain version: max |err| "
            f"{err:.3e}, largest |plain| {scale:.3e} (limit {tol} of it)")
    return err


def aligned_layout(rows, sizes, bm):
    """The bm-aligned layout of group-sorted ``rows``: each group padded
    with zero rows to a multiple of ``bm``. Returns (rows, padded sizes);
    sizing reads the counts on the host (this script only)."""
    padded = (sizes + bm - 1) // bm * bm
    n_data = int(sizes.sum())
    e_of = torch.repeat_interleave(torch.arange(sizes.shape[0],
                                                device=rows.device),
                                   sizes.long(), output_size=n_data)
    start = torch.cumsum(sizes, 0) - sizes
    start_al = torch.cumsum(padded, 0) - padded
    dest = start_al[e_of] + torch.arange(n_data, device=rows.device) \
        - start[e_of]
    out = rows.new_zeros(int(padded.sum()), rows.shape[1])
    out[dest] = rows[:n_data]
    return out, padded.to(torch.int32)


def moe_routed_traffic():
    """Phase 8(a)'s traffic: the port's ``MoELayer`` at DeepSeekMoE-16B's
    expert widths (seeded bf16 weights) routes 4 x 2048 seeded hidden
    states of unit RMS (what the post-attention RMSNorm hands it). The
    T*K assignments, sorted by expert, become the rows; nothing is
    dropped. Returns (rows, group sizes, w1, the layer's capacity)."""
    from paddle_tpu_torch.distributed.fleet import MoELayer
    from paddle_tpu_torch.distributed.fleet.moe import route
    T = 4 * 2048
    layer = MoELayer(MOE_M, MOE_H, MOE_E, gate="gshard", top_k=MOE_K,
                     activation="silu", dtype="bfloat16", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(T, MOE_M, device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    with torch.no_grad():
        r = route(x, layer.gate.weight, MOE_K, layer.capacity_factor)
    e_flat = r.idx_k.reshape(-1)  # assignment t*K + k
    order = torch.sort(e_flat, stable=True).indices
    sizes = torch.bincount(e_flat, minlength=MOE_E).to(torch.int32)
    return x[order // MOE_K], sizes, layer.w1.detach(), r.capacity


# K6's design: each f32 value split into three bf16 values, six of the nine
# products on the bf16 tensor cores. Its floor, logged beside the bound; the
# bound itself counts the function's 2*n*M*H once.
TGMM_SPLIT_PRODUCTS = 6


def gmm_need(n_live, m, h, nbytes, peak):
    """Least time of one grouped product: 2*n*M*H operations for the n
    rows that carry data at ``peak`` flop/s, against every input read
    once and the output written once."""
    flops = 2 * n_live * m * h
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                peak=peak)


def library_ms(fn, want, tol, live=None):
    """(ms, note) of one PyTorch call computing the same function, or
    (None, why not). Only this script calls it; the port never does."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no torch._grouped_mm"
    try:
        got = fn()
        torch.cuda.synchronize()
        _rel_check("torch._grouped_mm", got, want, tol, live)
    except (RuntimeError, AssertionError, TypeError) as e:
        return None, f"torch._grouped_mm does not compute it here: " \
            f"{str(e).splitlines()[0][:160]}"
    return cuda_ms(fn), "torch._grouped_mm"


def gmm_main_path(rows_bf, sizes, w1_bf):
    """The entry points once each, forward and backward through autograd,
    in bf16 and f32: what phase 8 counts launches on. Returns the
    tensors for the checks."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    al_bf, al_sizes = aligned_layout(rows_bf, sizes, 128)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        # fresh leaves: in bf16, .to() would hand back the same tensor
        lhs = rows_bf.detach().to(dtype).requires_grad_()
        rhs = w1_bf.detach().to(dtype).requires_grad_()
        dy = torch.randn(rows_bf.shape[0], MOE_H, device="cuda", dtype=dtype,
                         generator=gen)
        out = gm.gmm(lhs, rhs, sizes, bm=512)
        out.backward(dy)
        lhs_al = al_bf.detach().to(dtype).requires_grad_()
        rhs_al = w1_bf.detach().to(dtype).requires_grad_()
        dy_al = torch.randn(al_bf.shape[0], MOE_H, device="cuda",
                            dtype=dtype, generator=gen)
        out_al = gm.gmm_aligned(lhs_al, rhs_al, al_sizes, bm=128)
        out_al.backward(dy_al)
        t = gm.tgmm(lhs.detach(), dy, sizes, MOE_E, bm=512)
        runs[dtype] = dict(lhs=lhs, rhs=rhs, dy=dy, out=out, lhs_al=lhs_al,
                           rhs_al=rhs_al, dy_al=dy_al, out_al=out_al, t=t,
                           al_sizes=al_sizes)
    torch.cuda.synchronize()
    return runs


def gmm_check_main(run, sizes):
    """Every result of one dtype's main-path run against the plain
    versions on the same inputs; returns {kernel: max |err|}."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    dtype = run["lhs"].dtype
    tol = GMM_TOL[dtype]
    name = str(dtype).replace("torch.", "")
    lhs, rhs, dy = run["lhs"].detach(), run["rhs"].detach(), run["dy"]
    offs = gm._offsets_ext(sizes, lhs.shape[0])
    g32 = dy.float()
    errs = {"gmm": max(
        _rel_check(f"K5 gmm {name}", run["out"], gm._gmm_plain(lhs, rhs, offs),
                   tol),
        _rel_check(f"K5 d_lhs {name}", run["lhs"].grad,
                   gm._gmm_plain(g32, rhs.transpose(1, 2), offs).to(dtype),
                   tol))}
    errs["tgmm"] = max(
        _rel_check(f"K6 d_rhs {name}", run["rhs"].grad,
                   gm._tgmm_plain(lhs.float(), g32, offs, MOE_E).to(dtype),
                   tol),
        _rel_check(f"K6 tgmm {name}", run["t"],
                   gm._tgmm_plain(lhs.float(), g32, offs, MOE_E),
                   GMM_TOL[torch.float32]))
    lhs_al, dy_al = run["lhs_al"].detach(), run["dy_al"]
    be = gm._block_experts(run["al_sizes"], lhs_al.shape[0] // 128, MOE_E,
                           128)
    errs["gmm_aligned"] = max(
        _rel_check(f"K7 gmm_aligned {name}", run["out_al"],
                   gm._gmm_aligned_plain(lhs_al, rhs, be, 128), tol),
        _rel_check(f"K7 d_lhs {name}", run["lhs_al"].grad,
                   gm._gmm_aligned_plain(dy_al, rhs.transpose(1, 2), be,
                                         128).to(dtype), tol))
    d_rhs = gm._tgmm_aligned_plain(lhs_al, dy_al, be, MOE_E, 128)
    live = (run["al_sizes"] > 0)[:, None, None]
    errs["tgmm_aligned"] = _rel_check(
        f"K8 d_rhs {name}", run["rhs_al"].grad,
        torch.where(live, d_rhs, torch.zeros_like(d_rhs)).to(dtype), tol)
    n = int(sizes.sum())
    if n < lhs.shape[0] and not bool((run["out"][n:] == 0).all()):
        raise AssertionError("K5: rows past the groups are not exactly 0")
    empty = run["al_sizes"] == 0
    if not bool((run["rhs_al"].grad[empty] == 0).all()):
        raise AssertionError("K8: an expert with no rows got a non-zero "
                             "d_rhs")
    return errs


def kernel_device_ms(fn, name, reps=5):
    """Mean device time per call of ``fn`` of the kernels whose name
    holds ``name``, from ``torch.profiler``, the L2 cache flushed before
    each call as in :func:`cuda_ms`; None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(t for t, key, _ in device_rows(prof) if name in key)
    return us / reps / 1e3 if us else None


def gmm_timings(run_bf, run_f32, sizes):
    """Phase 8(a)'s times: K5, K7 and K8 on the bf16 traffic, K6 (f32
    only, as in the reference) on the f32 traffic, and K7's rhsᵀ form
    (its backward's d_lhs) by TMA and through registers; each against its
    plain version, its bound and, where it computes the same function,
    ``torch._grouped_mm``. Returns the records of the four kernels."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    bf = torch.bfloat16
    lhs, rhs, dy = (run_bf[k].detach() for k in ("lhs", "rhs", "dy"))
    lhs_al, dy_al = run_bf["lhs_al"].detach(), run_bf["dy_al"]
    al_sizes = run_bf["al_sizes"]
    lhs32, dy32 = run_f32["lhs"].detach(), run_f32["dy"]
    R, R_al, n = lhs.shape[0], lhs_al.shape[0], int(sizes.sum())
    E, M, H = rhs.shape
    offs = gm._offsets_ext(sizes, R)
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    ends_al = torch.cumsum(al_sizes, 0, dtype=torch.int32)
    be = gm._block_experts(al_sizes, R_al // 128, E, 128)
    live = al_sizes > 0
    w_bytes = rhs.numel() * 2
    rhs_t = rhs.transpose(1, 2)
    # the same rhsᵀ one element into its storage: TMA cannot describe it
    store = torch.empty(rhs.numel() + 8, dtype=bf, device=rhs.device)
    rhs_t_regs = store[1:1 + rhs.numel()].view(E, M, H).copy_(rhs) \
        .transpose(1, 2)
    aligned_need = gmm_need(n, M, H, 2 * R_al * M + w_bytes + 2 * R_al * H
                            + 4 * (R_al // 128), PEAK_FLOPS[bf])

    def wgmma(a, b, what=""):
        return f"wgmma{what}, lhs/rhs by " + "/".join(gm._gmm_loaders(a, b))
    cases = {  # name: (dtype, kernel, plain, library, need, live, design)
        "gmm": (bf, lambda: gm._gmm_fwd(lhs, rhs, offs),
                lambda: gm._gmm_plain(lhs, rhs, offs),
                lambda: torch._grouped_mm(lhs, rhs, offs=ends),
                gmm_need(n, M, H, 2 * R * M + w_bytes + 2 * R * H
                         + 4 * (E + 2), PEAK_FLOPS[bf]), None,
                wgmma(lhs, rhs)),
        "tgmm": (torch.float32,
                 lambda: gm._tgmm_fwd(lhs32, dy32, offs, E),
                 lambda: gm._tgmm_plain(lhs32, dy32, offs, E),
                 lambda: torch._grouped_mm(lhs32.t(), dy32, offs=ends),
                 gmm_need(n, M, H, 4 * R * M + 4 * R * H + 4 * E * M * H
                          + 4 * (E + 2), TF32_FLOPS),
                 None, f"wgmma, f32 split into three bf16 values, "
                 f"{TGMM_SPLIT_PRODUCTS} products, f32 tiles by "
                 + gm._tgmm_loader(lhs32, dy32)),
        "gmm_aligned": (bf, lambda: gm._gmm_aligned_fwd(lhs_al, rhs, be, 128),
                        lambda: gm._gmm_aligned_plain(lhs_al, rhs, be, 128),
                        lambda: torch._grouped_mm(lhs_al, rhs, offs=ends_al),
                        aligned_need, None,
                        wgmma(lhs_al, rhs, " over the block runs")),
        "gmm_aligned rhsT": (
            bf, lambda: gm._gmm_aligned_fwd(dy_al, rhs_t, be, 128),
            lambda: gm._gmm_aligned_plain(dy_al, rhs_t, be, 128),
            lambda: torch._grouped_mm(dy_al, rhs_t, offs=ends_al),
            gmm_need(n, H, M, 2 * R_al * H + w_bytes + 2 * R_al * M
                     + 4 * (R_al // 128), PEAK_FLOPS[bf]), None,
            wgmma(dy_al, rhs_t, " over the block runs")),
        "gmm_aligned rhsT registers": (
            bf, lambda: gm._gmm_aligned_fwd(dy_al, rhs_t_regs, be, 128),
            lambda: gm._gmm_aligned_plain(dy_al, rhs_t_regs, be, 128),
            lambda: torch._grouped_mm(dy_al, rhs_t_regs, offs=ends_al),
            gmm_need(n, H, M, 2 * R_al * H + w_bytes + 2 * R_al * M
                     + 4 * (R_al // 128), PEAK_FLOPS[bf]), None,
            wgmma(dy_al, rhs_t_regs, " over the block runs")),
        "tgmm_aligned": (bf,
                         lambda: gm._tgmm_aligned_fwd(lhs_al, dy_al, be, E,
                                                      128),
                         lambda: gm._tgmm_aligned_plain(lhs_al, dy_al, be, E,
                                                        128),
                         lambda: torch._grouped_mm(
                             lhs_al.t(), dy_al, offs=ends_al,
                             out_dtype=torch.float32),
                         gmm_need(n, M, H, 2 * R_al * M + 2 * R_al * H
                                  + 4 * E * M * H + 4 * (R_al // 128),
                                  PEAK_FLOPS[bf]),
                         live, "wgmma over the block runs, lhs/g by "
                         + gm._tgmm_aligned_loader(lhs_al, dy_al))}
    records = {}
    with torch.no_grad():
        for kname, (dtype, kern, plain, lib, need, rows_live,
                    design) in cases.items():
            want = plain()
            out_dtype = torch.float32 if kname.startswith("t") else dtype
            # the record's error: the kernel's own output on these inputs
            err = _rel_check(f"{kname} timed inputs", kern(), want,
                             GMM_TOL[out_dtype], rows_live)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain)
            lib_ms, lib_note = library_ms(lib, want, GMM_TOL[out_dtype],
                                          rows_live)
            rows = R_al if "aligned" in kname else R
            extra = ""
            if kname == "tgmm":  # the design's floor and the FMA rate's bound
                fma = gmm_need(n, M, H, need["bytes"],
                               PEAK_FLOPS[torch.float32])
                floor = gmm_need(n, M, H, need["bytes"],
                                 PEAK_FLOPS[bf] / TGMM_SPLIT_PRODUCTS)
                extra = (f"; the split design's floor ({TGMM_SPLIT_PRODUCTS}"
                         f" bf16 products at 989 TFLOP/s) "
                         f"{floor['bound_ms']:.4f} ms; the f32 FMA rate's "
                         f"bound {fma['bound_ms']:.4f} ms")
            scale = float((want[rows_live] if rows_live is not None
                           else want).abs().max())
            log(f"gmm {kname} ({str(dtype).replace('torch.', '')}, R={rows},"
                f" {n} rows of data; {design}): max|err| {err:.3e} = "
                f"{err / scale:.2e} of the largest |plain| (limit "
                f"{GMM_TOL[out_dtype]}); "
                f"kernel {ms:.4f} ms "
                f"({need['flops'] / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
                f"{100 * need['bound_ms'] / ms:.1f}% of the bound's rate), "
                f"plain {plain_ms:.4f} ms, library "
                + (f"{lib_ms:.4f} ms ({lib_note})" if lib_ms is not None
                   else f"none ({lib_note})")
                + f"; bound max(2*n*M*H = {need['flops']:.4e} flop / "
                f"{need['peak'] / 1e12:.0f} TFLOP/s, {need['bytes']} B / 3.35 TB/s) = "
                f"{need['bound_ms']:.4f} ms ({need['bound_by']}){extra}")
            if kname in GMM_NAMES:
                records[kname] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms,
                                      bound_ms=need["bound_ms"],
                                      bound_by=need["bound_by"],
                                      library_ms=lib_ms)
        # K7 against K5 on the same mainloop: K5 on K7's groups, built
        # beforehand, and K7's group building alone
        al_offs = gm._aligned_offsets(be, E, 128)
        k5_on_al = cuda_ms(lambda: gm._gmm_fwd(lhs_al, rhs, al_offs))
        build_ms = cuda_ms(lambda: gm._gmm_tiles(
            gm._aligned_offsets(be, E, 128), R_al))
        row_tiles = [int((gm._gmm_tiles(o, r)[:, 2] >= 0).sum())
                     for o, r in ((offs, R), (al_offs, R_al))]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        items = [t * -(-H // 128) for t in row_tiles]
        log(f"gmm K7 against K5: row tiles K5 {row_tiles[0]}, K7 "
            f"{row_tiles[1]}; items (x {-(-H // 128)} column tiles) "
            f"{items[0]} = {items[0] / sms:.2f} waves, {items[1]} = "
            f"{items[1] / sms:.2f} waves on {sms} SMs; K5 on K7's groups "
            f"(offsets built beforehand) {k5_on_al:.4f} ms; K7's group "
            f"building (offsets and tile list) {build_ms:.4f} ms")
        calls = (
            ("K5", lambda: gm._gmm_fwd(lhs, rhs, offs)),
            ("K5 on K7's groups", lambda: gm._gmm_fwd(lhs_al, rhs, al_offs)),
            ("K5 on K7's groups built in the call", lambda: gm._gmm_fwd(
                lhs_al, rhs, gm._aligned_offsets(be, E, 128))),
            ("K7", lambda: gm._gmm_aligned_fwd(lhs_al, rhs, be, 128)))
        for order, seq in (("in order", calls), ("reversed", calls[::-1])):
            log(f"gmm K7 against K5, device time of gmm_wgmma_kernel per "
                f"call (torch.profiler, mean of 5, L2 flushed; {order}): "
                + ", ".join(f"{k} " + ("not measured" if v is None
                                       else f"{v:.4f} ms")
                            for k, v in ((k, kernel_device_ms(
                                f, "gmm_wgmma_kernel")) for k, f in seq)))
    return records


def capacity_bmm_ms(w1_bf, capacity):
    """What the MoE layer itself runs for the same w1 product: one
    ``torch.bmm`` over the capacity layout ``[E, C, M]`` (a comparison,
    not the same function: it pays for empty capacity slots)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(MOE_E, capacity, MOE_M, device="cuda",
                    dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        ms = cuda_ms(lambda: torch.bmm(x, w1_bf))
    flops = 2 * MOE_E * capacity * MOE_M * MOE_H
    log(f"gmm comparison: torch.bmm on the MoE layer's capacity layout "
        f"[E={MOE_E}, C={capacity}, M={MOE_M}] x [E, M, H={MOE_H}] bf16: "
        f"{ms:.4f} ms for {flops:.4e} flop, "
        f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s")


def gmm_sweep_case(name, gen):
    """Phase 8(b) inputs: (lhs rows [R, M] f32, sizes, rhs [E, M, H] f32,
    g [R, H] f32); rows past the groups are zero unless the case says."""
    E, M, H, R = 16, 512, 256, 4096
    if name == "hot_empty_single":
        sizes = [0] * E
        sizes[3] = 3686  # 90% of the rows
        for e in (0, 1, 7, 11):
            sizes[e] = 1
        sizes[15] = R - 3686 - 4 - 200
        sizes[9] = 200
    elif name == "tail_rows_not_zero":
        E, M, H = 8, 256, 256
        sizes = [300, 0, 500, 1000, 0, 700, 400, 100]  # 3000 of 4096 rows
    elif name == "widths_1000_333":
        E, M, H, R = 8, 1000, 333, 2048
        sizes = [256, 300, 0, 200, 512, 80, 300, 400]
    else:  # "one_expert"
        E, M, H, R = 1, 512, 384, 2048
        sizes = [1900]
    mk = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa
    lhs, rhs, g = mk(R, M), mk(E, M, H), mk(R, H)
    n = sum(sizes)
    if name != "tail_rows_not_zero":
        lhs[n:] = 0
    return lhs, torch.tensor(sizes, dtype=torch.int32, device="cuda"), rhs, g


GMM_SWEEP = ("hot_empty_single", "tail_rows_not_zero", "widths_1000_333",
             "one_expert")


def gmm_sweep():
    """Phase 8(b): every case in both dtypes, each kernel against its
    plain version on the same inputs, with gmm's backward form (f32 g
    against the strided rhsᵀ view) and the exact zeros checked; K6's time
    on the hot expert."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, loaders, hot_ms = {}, {}, None
    bm = 64
    with torch.no_grad():
        for case in GMM_SWEEP:
            lhs32, sizes, rhs32, g32 = gmm_sweep_case(case, gen)
            E, R, n = rhs32.shape[0], lhs32.shape[0], int(sizes.sum())
            offs = gm._offsets_ext(sizes, R)
            al32, al_sizes = aligned_layout(lhs32[:n], sizes, bm)
            g_al32 = torch.randn(al32.shape[0], g32.shape[1], device="cuda",
                                 generator=gen)
            be = gm._block_experts(al_sizes, al32.shape[0] // bm, E, bm)
            for dtype in (torch.bfloat16, torch.float32):
                lhs, rhs, al, g_al = (t.to(dtype) for t in
                                      (lhs32, rhs32, al32, g_al32))
                what = f"{case} {str(dtype).replace('torch.', '')}"
                tol, tol32 = GMM_TOL[dtype], GMM_TOL[torch.float32]
                out = gm._gmm_fwd(lhs, rhs, offs)
                d_lhs = gm._gmm_fwd(g32, rhs.transpose(1, 2), offs)
                t = gm._tgmm_fwd(lhs.float(), g32, offs, E)
                out_al = gm._gmm_aligned_fwd(al, rhs, be, bm)
                d_al = gm._gmm_aligned_fwd(g_al, rhs.transpose(1, 2), be, bm)
                t_al = gm._tgmm_aligned_fwd(al, g_al, be, E, bm)
                torch.cuda.synchronize()
                live = al_sizes > 0
                errs = [
                    _rel_check(f"K5 {what}", out,
                               gm._gmm_plain(lhs, rhs, offs), tol),
                    _rel_check(f"K5 rhsT {what}", d_lhs, gm._gmm_plain(
                        g32, rhs.transpose(1, 2), offs), tol32),
                    _rel_check(f"K6 {what}", t, gm._tgmm_plain(
                        lhs.float(), g32, offs, E), tol32),
                    _rel_check(f"K7 {what}", out_al, gm._gmm_aligned_plain(
                        al, rhs, be, bm), tol),
                    _rel_check(f"K7 rhsT {what}", d_al, gm._gmm_aligned_plain(
                        g_al, rhs.transpose(1, 2), be, bm), tol),
                    _rel_check(f"K8 {what}", t_al, gm._tgmm_aligned_plain(
                        al, g_al, be, E, bm), tol32, live)]
                if not (bool((out[n:] == 0).all())
                        and bool((d_lhs[n:] == 0).all())):
                    raise AssertionError(f"K5 {what}: rows past the groups "
                                         f"are not exactly 0")
                if not bool((t[sizes == 0] == 0).all()):
                    raise AssertionError(f"K6 {what}: an empty expert is "
                                         f"not exactly 0")
                worst[(case, dtype)] = max(errs)
                if dtype == torch.bfloat16:
                    loaders[case] = "/".join(gm._gmm_loaders(lhs, rhs))
            if case == "hot_empty_single":
                hot_ms = cuda_ms(lambda: gm._tgmm_fwd(lhs32, g32, offs, E))
    for dtype in (torch.float32, torch.bfloat16):
        log(f"gmm sweep {str(dtype).replace('torch.', '')}: K5-K8 agree with "
            f"the plain versions (max |err| per case: " + ", ".join(
                f"{c} {worst[(c, dtype)]:.2e}" for c in GMM_SWEEP) + ")")
    log("gmm sweep: rows past the groups (K5, also when they hold data) and "
        "empty experts (K6) are exactly 0; K5 bf16 loaders (lhs/rhs): "
        + ", ".join(f"{c} {v}" for c, v in loaders.items())
        + f"; K6 on hot_empty_single (3686 of 4096 rows on one expert, "
        f"M=512, H=256): {hot_ms:.4f} ms")


def k8_long_expert():
    """Phase 8(c): K8 in bf16 at phase 8's widths on one expert of 45056
    rows (its accumulators restart every 1024 rows) beside two experts
    with no block, against the plain version at the f32 limit; through
    ``gmm_aligned``'s backward the empty experts' d_rhs is exactly 0."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows, bm = 45056, 128
    lhs = torch.randn(rows, MOE_M, device="cuda", dtype=torch.bfloat16,
                      generator=gen)
    g = torch.randn(rows, MOE_H, device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    sizes = torch.tensor([0, rows, 0], dtype=torch.int32, device="cuda")
    be = gm._block_experts(sizes, rows // bm, 3, bm)
    with torch.no_grad():
        got = gm._tgmm_aligned_fwd(lhs, g, be, 3, bm)
        want = gm._tgmm_aligned_plain(lhs, g, be, 3, bm)
        torch.cuda.synchronize()
        err = _rel_check("K8 on a 45056-row expert", got[1], want[1],
                         GMM_TOL[torch.float32])
        ms = cuda_ms(lambda: gm._tgmm_aligned_fwd(lhs, g, be, 3, bm))
    rhs = torch.randn(3, MOE_M, MOE_H, device="cuda", dtype=torch.bfloat16,
                      generator=gen).requires_grad_()
    d_rhs, = torch.autograd.grad(gm.gmm_aligned(lhs, rhs, sizes, bm=bm),
                                 rhs, g)
    if not (bool((d_rhs[0] == 0).all()) and bool((d_rhs[2] == 0).all())):
        raise AssertionError("K8: an expert with no rows got a non-zero "
                             "d_rhs")
    scale = float(want[1].abs().max())
    log(f"gmm K8 long expert (bf16, {rows} rows on one of 3 experts, "
        f"M={MOE_M}, H={MOE_H}, wgmma, lhs/g by "
        f"{gm._tgmm_aligned_loader(lhs, g)}): max|err| {err:.3e} = "
        f"{err / scale:.2e} of the largest |plain| (limit "
        f"{GMM_TOL[torch.float32]}); kernel {ms:.4f} ms; empty experts' "
        f"d_rhs exactly 0")


def phase_gmm():
    """Phase 8; returns {kernel: record} with the launches of the main
    path (the entry points on the routed traffic, forward and backward,
    both dtypes)."""
    rows, sizes, w1, capacity = moe_routed_traffic()
    counts = sizes.tolist()
    log(f"gmm traffic: {rows.shape[0]} assignments (T=8192 x top-{MOE_K}) "
        f"of E={MOE_E} experts, M={MOE_M}, H={MOE_H}; rows per expert min "
        f"{min(counts)}, median {int(statistics.median(counts))}, max "
        f"{max(counts)}")
    _reset_gmm_counts()
    runs = gmm_main_path(rows, sizes, w1)
    launches = _gmm_counts()
    log(f"gmm main path launches (gmm, gmm_aligned fwd+bwd and tgmm, bf16 "
        f"and f32): {launches}")
    errs = {dtype: gmm_check_main(run, sizes) for dtype, run in runs.items()}
    for dtype, e in errs.items():
        log(f"gmm {str(dtype).replace('torch.', '')}: kernels agree with the "
            f"plain versions on the routed traffic (max |err|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
            + "); pad rows and empty experts exactly 0")
    records = gmm_timings(runs[torch.bfloat16], runs[torch.float32], sizes)
    for kname, rec in records.items():
        rec["launches"] = launches[kname]
    del runs
    capacity_bmm_ms(w1, capacity)
    gmm_sweep()
    k8_long_expert()
    free_device_memory()
    return records


# --------------------------------------------------------------------------
def moe_train_flops_per_step(cfg, B, S):
    """The MoE step's flop count, 2 per MAC, 3 x the forward: attention
    projections (4*d*d per token, MHA) and scores at their causal half
    (2*B*S*S*d per layer), the dense FFN of the first layers (3*d*ffn per
    token), and per MoE layer the gate (d*E), the routed experts at the K
    assignments each token really has (K * 2*d*H MACs = K*4*d*H flop,
    not the E*C capacity slots the bmm pays for) and the shared experts
    (3*d*H*n_shared), plus the head (d*V)."""
    d, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    H, K, E = cfg.moe_intermediate_size, cfg.num_experts_per_tok, \
        cfg.num_experts
    dense = min(cfg.first_k_dense_replace, L)
    macs = L * 4 * d * d + dense * 3 * d * cfg.intermediate_size \
        + (L - dense) * (d * E + K * 2 * d * H
                         + 3 * d * H * cfg.num_shared_experts) + d * V
    attn = L * 2 * B * S * S * d
    return 3 * (2 * B * S * macs + attn)


def profile_moe_step(step, x, step_ms, what="moe"):
    """:func:`profile_train_step` for the MoE step, with the share of the
    expert products beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x)
        torch.cuda.synchronize()
    shares = step_breakdown(prof, what, step_ms)
    total = sum(us for us, _, _ in device_rows(prof))
    # the expert products are the only aten::bmm calls of the step (its
    # host op carries the device time of the kernels it launched)
    bmm = sum(dev_total_us(e) for e in prof.key_averages()
              if e.key == "aten::bmm"
              and getattr(e, "device_type", None) == DeviceType.CPU)
    if total:
        log(f"{what} profile: the expert bmm (cuBLAS) {bmm / 1e3:.3f} ms, "
            f"{100 * bmm / total:.1f}% of device time")
    return shares


def phase_moe_training():
    """Phase 9: DeepSeekMoE-16B at full width, 4 layers, fused (2 + 10
    steps) and with ``fused=False`` (2 + 5 steps); returns the fused
    run's flash and fused-kernel launch counts."""
    from paddle_tpu_torch.distributed.fleet import MoELayer
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM

    cfg = MoeConfig.deepseek_moe_16b(num_hidden_layers=4)
    B = 4
    flops = moe_train_flops_per_step(cfg, B, 2048)

    def make():
        return MoeForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    _reset_gmm_counts()
    fused, model = train_run("moe train", make, None, 2, 10, flops,
                             profile_moe_step)
    gmm_counts = _gmm_counts()
    moe_layers = [(i, layer.mlp) for i, layer in enumerate(model.layers)
                  if isinstance(layer.mlp, MoELayer)]
    log(f"moe train: DeepSeekMoE-16B widths, {cfg.num_hidden_layers} layers "
        f"(layer 0 dense, FFN {cfg.intermediate_size}; {len(moe_layers)} MoE "
        f"layers of {cfg.num_experts} experts x {cfg.moe_intermediate_size}, "
        f"top-{cfg.num_experts_per_tok}, {cfg.num_shared_experts} shared); "
        f"K5-K8 {gmm_counts} (the layer computes its experts with torch.bmm "
        f"on the capacity layout, as the reference computes einsums)")
    log("moe train: capacity and dropped assignments of the last step: "
        + ", ".join(f"layer {i} C={m.last_capacity} dropped "
                    f"{int(m.last_dropped)} of {B * 2048 * m.gate.top_k}"
                    for i, m in moe_layers))
    del model, moe_layers
    loop, model = train_run("moe train", make, False, 2, 5, flops,
                            profile_moe_step)
    del model
    free_device_memory()
    compare_fused_and_loop("moe train", fused, loop)
    return {**fused["flash"], **fused["fused"]}


# --------------------------------------------------------------------------
# run A saves at step 4 and runs to 7; run B resumes from 4 and takes 3
FIT_SAVE_EVERY, FIT_A_STEPS, FIT_B_STEPS = 4, 7, 3
# ~25k tokens: about three packed batches an epoch, so steps 4-7 see
# documents again (drop_last=True: the packer's carry rides into the
# next epoch)
FIT_DOCUMENTS = 8
# room for what a save writes besides the tensors' bytes: aux.pkl (the
# skeleton with the data state) and index.json, kilobytes each
FIT_SKELETON_ROOM = 1 << 20


class SyntheticCorpus:
    """Seeded token documents of 32-6144 tokens (the packer splits those
    longer than a row), ids uniform in [1, vocab). Uniform random ids
    leave nothing to learn but their repetition: phase 10 trains over a
    few documents for several epochs, so its loss falls as the model
    memorises what it has seen."""

    def __init__(self, n, vocab, seed):
        rng = np.random.RandomState(seed)
        self.lengths = rng.randint(32, 6145, n)
        self.seeds = rng.randint(0, 2 ** 31 - 1, n)
        self.vocab = vocab

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        return np.random.RandomState(self.seeds[i]).randint(
            1, self.vocab, self.lengths[i]).astype(np.int32)


def _step_recorder(fr, registry, profile_at=None):
    """A callback that records each step's wall, data wait and whether a
    save was in flight (placed before ``fr``), with a profiler window
    over fit step ``profile_at``."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.hapi import Callback

    class Recorder(Callback):
        def __init__(self):
            self.rows = []
            self.prof = None

        def on_train_batch_begin(self, step, logs=None):
            if step == profile_at:
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
            self._t0 = time.perf_counter()
            self._data = logs["data_time"]

        def on_train_batch_end(self, step, logs=None):
            # train_batch read the loss back: the step is done on the card
            wall = time.perf_counter() - self._t0
            if self.prof is not None and step == profile_at:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
            in_flight = registry.get("ckpt_in_flight")
            self.rows.append(dict(
                step=fr._step0 + step, loss=logs["loss"], ms=1e3 * wall,
                data_ms=1e3 * self._data,
                in_flight=in_flight is not None and in_flight.value() > 0))

    return Recorder()


class _Kept:
    """The pipeline's batches as delivered, each one's ids and segment
    ids kept for hashing after the run (no copy back inside the loop)."""

    def __init__(self, pipe):
        self.pipe, self.batches = pipe, []

    def __iter__(self):
        for b in self.pipe:
            self.batches.append((b["input_ids"], b["attention_mask"]))
            yield b


def fit_run(what, corpus, ckpt_dir, steps, restore, profile_at=None):
    """One ``Model.fit`` of the bench's Llama over the packed pipeline
    under ``FitResilience`` (saves every 4 global steps, keep 1)."""
    from paddle_tpu_torch.data import DataPipeline
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import FitResilience

    net = LlamaForCausalLM(llama_bench_config(), dtype="bfloat16",
                           seed=SEED)
    opt = AdamW(learning_rate=1e-4, parameters=net.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    model = Model(net).prepare(opt, loss=None)
    pipe = DataPipeline(corpus, batch_size=4, seq_len=2048, pack=True,
                        base_seed=SEED, drop_last=True, device_prefetch=2)
    registry = MetricsRegistry()
    fr = FitResilience(checkpoint_dir=ckpt_dir,
                       save_every_steps=FIT_SAVE_EVERY, keep_last_k=1,
                       pipeline=pipe, registry=registry)
    need = _save_need(net)
    if not restore:
        free = shutil.disk_usage(ckpt_dir).free
        log(f"{what}: a save holds {need} B of tensors (each parameter's "
            f"bf16 weight, f32 master and two f32 moments) and up to "
            f"{FIT_SKELETON_ROOM} B of skeleton; {free} B free under the "
            f"checkpoint directory")
        if free < need + FIT_SKELETON_ROOM:
            raise AssertionError(f"{what}: {free} B free on disk, a save "
                                 f"needs {need} + {FIT_SKELETON_ROOM} B")
    restored, t0 = None, time.perf_counter()
    if restore:
        restored = fr.restore(model)
        torch.cuda.synchronize()
        log(f"{what}: restored step {restored} in "
            f"{time.perf_counter() - t0:.3f} s (restore() wall: read, "
            f"crc-check, to the card, into the model, optimizer and "
            f"pipeline)")
    rec = _step_recorder(fr, registry, profile_at)
    kept = _Kept(pipe)
    t0 = time.perf_counter()
    model.fit(kept, epochs=steps, num_iters=steps, verbose=0,
              callbacks=[rec, fr])
    wall = time.perf_counter() - t0
    return dict(net=net, opt=opt, rows=rec.rows, prof=rec.prof,
                kept=kept.batches, registry=registry, wall=wall, fr=fr,
                restored=restored, step0=fr._step0, need=need)


def _hashes(kept):
    import hashlib
    return [hashlib.sha256(ids.cpu().numpy().tobytes()).hexdigest()[:16]
            for ids, _ in kept]


def _save_need(net):
    """Bytes of the tensors a save writes, from the parameter count: each
    parameter's own weight, its f32 master and AdamW's two f32 moments
    (the beta powers and the skeleton are left to the room above)."""
    return sum(p.numel() * (p.element_size() + 3 * 4)
               for p in net.parameters())


def _masters(opt):
    return {k: t.detach().cpu() for k, t in opt.state_dict().items()
            if k.endswith("master_weight")}


def packed_flash_check(seg, flash_recs):
    """K1-K3 in bf16 at the training shape on one packed batch's segment
    ids against autograd through the plain version at ``FLASH_TOL``, and
    their times beside phase 6's causal times."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    B, hq, hkv, S, hd = 4, 16, 4, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def mk(h):
        return torch.randn(B, h, S, hd, device="cuda", dtype=torch.bfloat16,
                           generator=gen)
    q4, k4, v4, do4 = mk(hq), mk(hkv), mk(hkv), mk(hq)
    q, k, v, g, _ = fa._geometry(q4, k4, v4, True, None, None, seg, seg,
                                 0.0, None)
    do = do4.reshape(q.shape)
    o_tol, g_tol = FLASH_TOL[torch.bfloat16]
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, g)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, g)
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    ro, rlse = fa.flash_attention_reference(
        *leaves, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    rg = torch.autograd.grad(ro, leaves, do4)
    errs = {
        "flash_attention_fwd": max(
            _check("packed K1 o", o, ro.reshape(o.shape), *o_tol),
            _check("packed K1 lse", lse, rlse.reshape(lse.shape), *o_tol)),
        "flash_attention_dq": _check("packed K2 dq", dq,
                                     rg[0].reshape(dq.shape), *g_tol),
        "flash_attention_dkv": max(
            _check("packed K3 dk", dk, rg[1].reshape(dk.shape), *g_tol),
            _check("packed K3 dv", dv, rg[2].reshape(dv.shape), *g_tol))}
    del ro, rlse, rg, leaves
    with torch.no_grad():
        ms = {"flash_attention_fwd": cuda_ms(
                  lambda: fa.flash_attention_fwd(q, k, v, g)),
              "flash_attention_dq": cuda_ms(
                  lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, g)),
              "flash_attention_dkv": cuda_ms(
                  lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 g))}
    docs = [int(r.max()) for r in seg]
    pad = int((seg == 0).sum())
    log(f"fit packed batch: documents per row {docs}, {pad} padding tokens; "
        f"K1-K3 bf16 on its segment ids against the plain version: "
        + ", ".join(f"{k} max|err| {errs[k]:.3e} ({ms[k]:.4f} ms, phase 6 "
                    f"causal {flash_recs[k]['ms']:.4f} ms)" for k in errs)
        + f" (limits {FLASH_TOL[torch.bfloat16]})")
    free_device_memory()


def phase_fit(flash_recs, train_step_ms):
    """Phase 10: ``Model.fit`` over the packed pipeline with step
    checkpoints and an exact resume. Returns the flash and fused-kernel
    launch counts of the two runs."""
    import tempfile
    cfg = llama_bench_config()
    corpus = SyntheticCorpus(FIT_DOCUMENTS, cfg.vocab_size, SEED)
    ckpt_dir = tempfile.mkdtemp(prefix="phase10_ckpt_", dir=REPO_ROOT)
    try:
        return _phase_fit(cfg, corpus, ckpt_dir, flash_recs, train_step_ms)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _phase_fit(cfg, corpus, ckpt_dir, flash_recs, train_step_ms):
    free_device_memory()
    _reset_flash_counts()
    _reset_fused_counts()
    a = fit_run("fit A", corpus, ckpt_dir, FIT_A_STEPS, restore=False)
    # FitResilience.on_train_end waited for the save: it committed or failed
    reg, need = a["registry"], a["need"]
    snap = reg.get("ckpt_blocking_seconds").stats(mode="async")
    saved = reg.get("ckpt_save_seconds").stats(mode="async")
    written = reg.get("ckpt_bytes_total").value(direction="write")
    failed = reg.get("ckpt_failures_total").value(kind="save")
    if snap is None or snap["count"] != 1:
        raise AssertionError(f"fit A: expected one async save, got {snap}")
    if failed or not need <= written <= need + FIT_SKELETON_ROOM:
        raise AssertionError(f"fit A: the save of step {FIT_SAVE_EVERY} "
                             f"failed ({failed:.0f} failures; {written:.0f} "
                             f"B written of {need} + up to "
                             f"{FIT_SKELETON_ROOM} B)")
    a_hash, a_losses = _hashes(a["kept"]), [r["loss"] for r in a["rows"]]
    a_masters = _masters(a["opt"])
    a_params = {n: p.detach().cpu() for n, p in a["net"].named_parameters()}
    seg0 = a["kept"][0][1]
    real = [int((seg != 0).sum()) for _, seg in a["kept"]]
    rows = a["rows"]
    del a
    free_device_memory()

    b = fit_run("fit B", corpus, ckpt_dir, FIT_B_STEPS, restore=True,
                profile_at=FIT_B_STEPS)
    counts, fused_counts = _flash_counts(), _fused_counts()
    restore_s = b["registry"].get("ckpt_restore_seconds").stats()
    b_hash, b_losses = _hashes(b["kept"]), [r["loss"] for r in b["rows"]]
    steps = FIT_A_STEPS + FIT_B_STEPS
    if b["restored"] != FIT_SAVE_EVERY or b["step0"] != FIT_SAVE_EVERY:
        raise AssertionError(f"fit B restored step {b['restored']}, not "
                             f"{FIT_SAVE_EVERY}")
    if b_hash != a_hash[FIT_SAVE_EVERY:]:
        raise AssertionError(f"fit B saw other batches: {b_hash} against "
                             f"{a_hash[FIT_SAVE_EVERY:]}")
    want = a_losses[FIT_SAVE_EVERY:]
    loss_diff = max(abs(x - y) for x, y in zip(b_losses, want))
    if not np.allclose(b_losses, want, rtol=1e-5, atol=0):
        raise AssertionError(f"fit B losses {b_losses} differ from A's "
                             f"{want} beyond rtol 1e-5")
    b_masters = _masters(b["opt"])
    master_diff = 0.0
    for key, ta in a_masters.items():
        tb = b_masters[key]
        _check(f"fit B {key}", tb, ta, 0.0, 1e-4)
        master_diff = max(master_diff, float((tb - ta).abs().max()))
    param_diff = max(float((p.detach().cpu().float()
                            - a_params[n].float()).abs().max())
                     for n, p in b["net"].named_parameters())
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(a_losses[0]) and abs(a_losses[0] - ln_v) <= 1.0):
        raise AssertionError(f"fit: first loss {a_losses[0]} is not within "
                             f"1.0 of ln(vocab) = {ln_v:.3f}")
    if not b_losses[-1] < a_losses[0]:
        raise AssertionError(f"fit: loss did not fall: {a_losses} then "
                             f"{b_losses}")
    for kname, n in counts.items():
        if n != steps * cfg.num_hidden_layers:
            raise AssertionError(f"fit: {kname} launched {n} times in "
                                 f"{steps} steps")
    for kname, n in fused_counts.items():
        if n != steps:
            raise AssertionError(f"fit: {kname} launched {n} times in "
                                 f"{steps} steps")
    log(f"fit: A {FIT_A_STEPS} steps (async save at step {FIT_SAVE_EVERY}),"
        f" B restored from it and took {FIT_B_STEPS}; losses A "
        f"{[round(v, 4) for v in a_losses]}, B "
        f"{[round(v, 4) for v in b_losses]}; B's steps "
        f"{FIT_SAVE_EVERY + 1}-{FIT_A_STEPS} saw A's batches (sha256 of "
        f"input_ids {b_hash}); largest difference from A: loss "
        f"{loss_diff:.3e} (rtol 1e-5), f32 master weights after step "
        f"{FIT_A_STEPS} {master_diff:.3e} (rtol 1e-4), bf16 parameters "
        f"{param_diff:.3e}")
    log(f"fit: launches in {steps} steps K1 {counts['flash_attention_fwd']},"
        f" K2 {counts['flash_attention_dq']}, K3 "
        f"{counts['flash_attention_dkv']} (= {cfg.num_hidden_layers} a "
        f"step); fused_adam_update {fused_counts['fused_adam_update']}, "
        f"fused_sqnorm {fused_counts['fused_sqnorm']} (1 a step)")

    # timings of run A: the steps with no save in flight, after the first
    quiet = [r for r in rows[1:] if not r["in_flight"]]
    busy = [r for r in rows if r["in_flight"]]
    fit_ms = statistics.median(r["ms"] for r in quiet)
    flops = train_flops_per_step(cfg, 4, 2048)
    real_share = sum(real) / (len(real) * 4 * 2048)
    log(f"fit A step rows (step, ms, data wait ms, save in flight): "
        + ", ".join(f"({r['step']}, {r['ms']:.3f}, {r['data_ms']:.3f}, "
                    f"{r['in_flight']})" for r in rows))
    log(f"fit: step {fit_ms:.3f} ms (median of A's steps "
        f"{[r['step'] for r in quiet]}, those after the first with no save "
        f"in flight: {[round(r['ms'], 3) for r in quiet]} ms, each step's "
        f"wall including its loss read back) against phase 7's TrainStep "
        f"loop {train_step_ms:.3f} ms in this run "
        f"({fit_ms - train_step_ms:+.3f} ms); steps "
        f"{[r['step'] for r in busy]} with a save in flight "
        f"{[round(r['ms'], 3) for r in busy]} ms")
    log(f"fit: save of step {FIT_SAVE_EVERY}: the loop paid "
        f"{1e3 * snap['sum']:.3f} ms for the snapshot (device-to-host "
        f"copies queued into pinned memory, skeleton pickled); {written} B "
        f"written; {saved['sum']:.3f} s from the snapshot to the commit; "
        f"restore {restore_s['sum']:.3f} s (read and crc-check, "
        f"ckpt_restore_seconds)")
    log(f"fit: real-token share {real_share:.4f} ({sum(real)} of "
        f"{len(real) * 4 * 2048} tokens in A's {len(real)} batches); "
        f"{real_share * 4 * 2048 / (fit_ms / 1e3):.1f} real tokens/s, "
        f"{4 * 2048 / (fit_ms / 1e3):.1f} tokens/s with padding; MFU "
        f"{100 * flops / (fit_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]:.2f}% "
        f"on bench.py's {flops:.4e} flop a step")
    b_rows = b["rows"]
    log(f"fit B step rows (step, ms, data wait ms): "
        + ", ".join(f"({r['step']}, {r['ms']:.3f}, {r['data_ms']:.3f})"
                    for r in b_rows)
        + f" (step {FIT_A_STEPS} under the profiler)")
    if b["prof"] is not None:
        step_breakdown(b["prof"], f"fit step {FIT_A_STEPS}", fit_ms)
    del b
    free_device_memory()
    packed_flash_check(seg0, flash_recs)
    return {**counts, **fused_counts}


# --------------------------------------------------------------------------
def ernie_train_flops_per_step(cfg, B, S):
    """ERNIE pretraining's flops per step: 6 per matmul parameter per
    token (2 forward, 4 backward) over 12 layers of 4H^2 (q, k, v, out)
    + 2HF (the FFN), the tied H x V decoder and the H^2 MLM transform at
    every position, the pooler's H^2 and the SOP head's 2H once per
    sequence; plus 12 * L * S * H per token of non-causal attention
    (QK^T and PV, 2 * S * H each forward, times 3)."""
    H, F, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    per_token = L * (4 * H * H + 2 * H * F) + H * V + H * H
    per_seq = H * H + 2 * H
    return 6 * (B * S * per_token + B * per_seq) + B * S * 12 * L * S * H


def dit_train_flops_per_step(cfg, B):
    """DiT's flops per step: 6 per matmul parameter per token over the
    blocks' 4H^2 (attention) + 2HM (the MLP, M = 4H), the final linear
    and the patch embedding; the adaLN projections (6H^2 a block, 2H^2
    at the end) and the timestep MLP once per image; plus 12 * L * N * H
    per token of non-causal attention over the N patches."""
    H, L, p = cfg.hidden_size, cfg.depth, cfg.patch_size
    M = int(H * cfg.mlp_ratio)
    N = (cfg.input_size // p) ** 2
    out_c = cfg.in_channels * (2 if cfg.learn_sigma else 1)
    per_token = L * (4 * H * H + 2 * H * M) + H * p * p * out_c + \
        p * p * cfg.in_channels * H
    per_image = L * 6 * H * H + 2 * H * H + 256 * H + H * H
    return 6 * (B * N * per_token + B * per_image) + B * N * 12 * L * N * H


def ernie_init(model):
    """PaddleNLP's ERNIE recipe on the port's initializers: every 2-D
    weight (embeddings and projections) ~ N(0, 0.02), drawn from the
    seeded generator. The reference model's layer defaults (N(0, 1)
    embeddings tied to the decoder) would start the MLM loss near
    sqrt(H) * sqrt(2 ln V), far above ln V."""
    from paddle_tpu_torch.nn import initializer as I
    init = I.Normal(0.0, 0.02)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.copy_(init(list(p.shape), p.dtype, p.device))


def model_train_run(what, model, loss_fn, batch, warmup, timed, flops,
                    layers, before, fused=None, unit="tokens", items=0,
                    profile=None, desc=""):
    """One run of ``model`` on one seeded ``batch`` through ``TrainStep``
    (AdamW lr 1e-4, f32 masters, global-norm clip 1.0), ``fused`` as
    given (None: the default, fused): ``warmup`` + ``timed`` steps, then
    one profiled step (``profile``, by default
    :func:`profile_train_step`). Checks that K1-K3 each launched
    ``layers`` times a step and the fused kernels once a bucket a step
    (none on the loop); returns the run's numbers. ``items`` of ``unit``
    make one step; ``before`` is the memory allocated before the model
    was built."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, loss_fn, opt, fused=fused)
    _reset_flash_counts()
    _reset_fused_counts()
    padded0 = fa.launches_padded
    losses = [float(step(*batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    timed_losses = [step(*batch) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, fused_counts = _flash_counts(), _fused_counts()
    padded = fa.launches_padded - padded0
    peak = torch.cuda.max_memory_allocated()
    losses += [float(t) for t in timed_losses]
    steps = warmup + timed
    for kname, n in counts.items():
        if n != steps * layers:
            raise AssertionError(f"{what}: {kname} launched {n} times in "
                                 f"{steps} steps, not {layers} per step")
    layout = step._layout
    buckets = len(layout.buckets) if layout is not None else 0
    if (layout is not None) != step._fused or \
            (layout is not None and layout.residue):
        raise AssertionError(f"{what}: layout {layout} for fused={fused}")
    for kname, n in fused_counts.items():  # one per bucket per step
        if n != steps * buckets:
            raise AssertionError(f"{what}: {kname} launched {n} times in "
                                 f"{steps} steps over {buckets} buckets")
    step_ms = 1e3 * wall / timed
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    mode = "fused" if step._fused else "fused=False (per-parameter loop)"
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{what} [{mode}]: {n_params} parameters in {buckets} buckets, "
        f"{desc + ', ' if desc else ''}bf16, AdamW f32 masters, clip 1.0; "
        f"loss step 1 {losses[0]:.4f}, step {steps} {losses[-1]:.4f}; "
        f"losses {[round(v, 4) for v in losses]}")
    log(f"{what} [{mode}]: launches per step K1 "
        f"{counts['flash_attention_fwd'] // steps}, K2 "
        f"{counts['flash_attention_dq'] // steps}, K3 "
        f"{counts['flash_attention_dkv'] // steps} (= {layers} layers), "
        f"{padded} of them at a zero-padded head_dim in {steps} steps; "
        f"fused_adam_update {fused_counts['fused_adam_update']} and "
        f"fused_sqnorm {fused_counts['fused_sqnorm']} in {steps} steps")
    log(f"{what} [{mode}]: step {step_ms:.3f} ms (synchronised wall / "
        f"{timed} steps); {items / (step_ms / 1e3):.1f} {unit}/s; "
        f"{flops:.4e} flop per step, floor "
        f"{1e3 * flops / PEAK_FLOPS[torch.bfloat16]:.2f} ms at 989 "
        f"TFLOP/s; MFU {100 * mfu:.2f}%; max_memory_allocated "
        f"{peak - before} B above the {before} B allocated before the "
        f"run, of which {resident - before} B stay allocated between steps")
    shares = (profile or profile_train_step)(
        lambda _: step(*batch), None, step_ms, f"{what} [{mode}]")
    return dict(losses=losses, step_ms=step_ms, mfu=mfu, padded=padded,
                peak=peak - before, resident=resident - before,
                flash=counts, fused=fused_counts, shares=shares)


def _kernel_share(what, shares):
    total = sum(v for k, v in shares.items() if not k.startswith("Train"))
    if total:
        log(f"{what}: K1-K3 take {shares.get('flash K1-K3', 0.0):.3f} ms, "
            f"{100 * shares.get('flash K1-K3', 0.0) / total:.1f}% of the "
            f"profiled step's device time")


class _Counted:
    """An iterable of batches that counts what it hands out."""

    def __init__(self, batches):
        self.batches, self.served = batches, 0

    def __iter__(self):
        for b in self.batches:
            self.served += 1
            yield b


def ernie_finetune(cfg, rng):
    """Phase 11's fine-tuning: ``ErnieForSequenceClassification`` at
    ERNIE-base width through ``hapi.Model.prepare(AdamW,
    CrossEntropyLoss(), Accuracy())``, ``fit`` for 3 steps of 16 x 512,
    then ``evaluate`` on 64 seeded samples in 4 batches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    B, S = 16, 512

    def batches(n):
        return [(rng.randint(0, cfg.vocab_size, (B, S)),
                 rng.randint(0, 2, B)) for _ in range(n)]
    ptt.seed(SEED + 1)
    net = ErnieForSequenceClassification(cfg, num_classes=2,
                                         dtype="bfloat16")
    ernie_init(net)
    acc = Accuracy()
    model = Model(net).prepare(
        AdamW(learning_rate=1e-4, parameters=net.parameters(),
              multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0)),
        CrossEntropyLoss(), acc)
    rec = Losses()
    t0 = time.perf_counter()
    model.fit(batches(3), epochs=1, verbose=0, callbacks=[rec])
    fit_s = time.perf_counter() - t0
    evald = _Counted(batches(4))
    logs = model.evaluate(evald, verbose=0)
    if len(rec.losses) != 3 or not all(map(math.isfinite, rec.losses)):
        raise AssertionError(f"ernie fine-tune: fit losses {rec.losses}")
    if not (math.isfinite(logs["loss"]) and 0.0 <= logs["acc"] <= 1.0):
        raise AssertionError(f"ernie fine-tune: evaluate gave {logs}")
    if evald.served != 4 or int(acc.count[0]) != 4 * B:
        raise AssertionError(f"ernie fine-tune: evaluated {evald.served} "
                             f"batches, {int(acc.count[0])} samples")
    log(f"ernie fine-tune: hapi.Model(ErnieForSequenceClassification "
        f"bf16).prepare(AdamW, CrossEntropyLoss(), Accuracy()); fit 3 "
        f"steps of {B} x {S} in {fit_s:.3f} s (first step builds the "
        f"fused plan), losses {[round(v, 4) for v in rec.losses]}; "
        f"evaluate on {4 * B} samples in {evald.served} batches: loss "
        f"{logs['loss']:.4f}, acc {logs['acc']:.4f}")
    del model, net


def phase_ernie():
    """Phase 11: ERNIE-base pretraining at the reference's configuration
    (vocab 40000, hidden 768, 12 layers, 12 heads, FFN 3072, dropout 0.1)
    in bf16 on 16 x 512 tokens (bench.py's _suite_ernie), fused (2 + 10
    steps, the main path) and with fused=False (2 + 3 steps); then the
    classifier through hapi. Returns the fused run's launch counts."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    cfg = ErnieConfig()
    B, S = 16, 512
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (B, S))
    types = np.broadcast_to((np.arange(S) >= S // 2).astype(np.int64),
                            (B, S)).copy()
    masked = rng.rand(B, S) < 0.15
    mlm = np.where(masked, rng.randint(0, cfg.vocab_size, (B, S)), -100)
    sop = rng.randint(0, 2, B)
    batch = [torch.from_numpy(a).cuda() for a in (ids, types, mlm, sop)]
    flops = ernie_train_flops_per_step(cfg, B, S)
    want = math.log(cfg.vocab_size) + math.log(2)

    def loss_fn(m, ids, types, mlm, sop):
        return m(ids, types, masked_lm_labels=mlm, sop_labels=sop)[2]
    runs = {}
    for fused, warm, timed in ((None, 2, 10), (False, 2, 3)):
        free_device_memory()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ptt.seed(SEED)
        model = ErnieForPretraining(cfg, dtype="bfloat16")
        ernie_init(model)
        r = model_train_run("ernie", model, loss_fn, batch, warm, timed,
                            flops, cfg.num_hidden_layers, before,
                            fused=fused, items=B * S)
        del model
        runs[fused] = r
    losses = runs[None]["losses"]
    if not (math.isfinite(losses[0]) and abs(losses[0] - want) <= 1.0):
        raise AssertionError(f"ernie: first loss {losses[0]} is not within "
                             f"1.0 of ln(V) + ln(2) = {want:.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ernie: loss did not fall: {losses}")
    # the loop's 5 steps are too few to fall through dropout's noise: from
    # the same seed (weights and masks) they repeat the fused run's losses
    compare_fused_and_loop("ernie", runs[None], runs[False])
    _kernel_share("ernie [fused]", runs[None]["shares"])
    log(f"ernie: {int(masked.sum())} of {B * S} positions masked (15% "
        f"seeded), first loss {losses[0]:.4f} against ln(V) + ln(2) = "
        f"{want:.4f}, last {losses[-1]:.4f}")
    free_device_memory()
    ernie_finetune(cfg, rng)
    free_device_memory()
    return {**runs[None]["flash"], **runs[None]["fused"]}


def phase_dit():
    """Phase 12: DiT-XL/2 at full width and depth (input 32, patch 2, 256
    tokens, hidden 1152, 28 blocks, 16 heads of 72, learn_sigma, 1000
    classes) in bf16 on a batch of 64 (bench.py's _suite_dit), MSE
    against one seeded target, fused, 2 + 10 steps. Returns the run's
    launch counts."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.dit import DiT, DiTConfig
    from paddle_tpu_torch.nn import MSELoss
    cfg = DiTConfig.dit_xl_2()
    B = 64
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(B, cfg.in_channels, cfg.input_size,
                                   cfg.input_size).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 1000, B))
    y = torch.from_numpy(rng.randint(0, cfg.num_classes, B))
    target = torch.from_numpy(rng.randn(
        B, 2 * cfg.in_channels, cfg.input_size,
        cfg.input_size).astype(np.float32)).cuda()
    batch = [x.cuda().to(torch.bfloat16), t.cuda(), y.cuda(), target]
    mse = MSELoss()

    def loss_fn(m, x, t, y, target):
        return mse(m(x, t, y).float(), target)
    free_device_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptt.seed(SEED)
    model = DiT(cfg, dtype="bfloat16")
    r = model_train_run("dit", model, loss_fn, batch, 2, 10,
                        dit_train_flops_per_step(cfg, B), cfg.depth, before,
                        unit="images", items=B)
    del model
    want = float((target ** 2).mean())
    losses = r["losses"]
    if not abs(losses[0] - want) <= 1e-2:
        raise AssertionError(f"dit: first loss {losses[0]} is not "
                             f"mean(target^2) = {want:.5f} within 1e-2 "
                             f"(adaLN-Zero starts the output at 0)")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"dit: loss did not fall: {losses}")
    if r["padded"] != 3 * cfg.depth * 12:
        raise AssertionError(f"dit: {r['padded']} padded launches, not "
                             f"3 x {cfg.depth} x 12")
    _kernel_share("dit [fused]", r["shares"])
    log(f"dit: first loss {losses[0]:.5f} against mean(target^2) "
        f"{want:.5f}; head_dim {cfg.hidden_size // cfg.num_heads} runs on "
        f"the hd-128 kernels, zero-padded")
    free_device_memory()
    return {**r["flash"], **r["fused"]}


def flash_model_shape(what, B, H, S, d, dropout):
    """K1-K3 in bf16 at one model's attention shape (non-causal): each
    kernel against its plain version on the same inputs at ``FLASH_TOL``
    (through ``padded_launch``, as the autograd path pads and slices),
    then kernel, plain and library (sdpa) times, the bound of the
    caller's head_dim and, where it has no instance, the zero-padding
    copies the autograd wrapper adds (q, k, v in the forward, do in the
    backward). Returns {kernel: record}."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    mk = lambda: torch.randn(B, H, S, d, device="cuda",  # noqa: E731
                             dtype=torch.bfloat16, generator=gen)
    q4, k4, v4, do4 = mk(), mk(), mk(), mk()
    q, k, v, g, _ = fa._geometry(q4, k4, v4, False, None, None, None, None,
                                 dropout, 2024 if dropout else None)
    do = do4.reshape(q.shape)
    o_tol, g_tol = FLASH_TOL[torch.bfloat16]
    with torch.no_grad():
        (o, lse, delta, dq, dk, dv), tail = fa.padded_launch(q, k, v, do, g)
        if tail != 0:
            raise AssertionError(f"flash {what}: padded columns not 0 "
                                 f"(max |x| {tail})")
        ro, rlse = fa._forward_plain(q, k, v, g)
        errs = {"flash_attention_fwd": max(
            _check(f"K1 o {what}", o, ro, *o_tol),
            _check(f"K1 lse {what}", lse, rlse, *o_tol))}
        del o, ro, rlse
        errs["flash_attention_dq"] = _check(
            f"K2 dq {what}", dq, fa._dq_plain(q, k, v, do, lse, delta, g),
            *g_tol)
        rdk, rdv = fa._dkv_plain(q, k, v, do, lse, delta, g)
        errs["flash_attention_dkv"] = max(
            _check(f"K3 dk {what}", dk, rdk, *g_tol),
            _check(f"K3 dv {what}", dv, rdv, *g_tol))
        del dq, dk, dv, rdk, rdv
    qp, kp, vp = fa.pad_head_dim(q, k, v, g)
    width = qp.shape[-1]
    dop = torch.nn.functional.pad(do, (0, width - d))
    esz, row = q.element_size(), 4 * q.shape[0] * q.shape[1]
    pad_ms = cuda_ms(lambda: (fa.pad_head_dim(q, k, v, fa.FlashGeometry(
        hq=H, hkv=H, causal=False, sm_scale=1.0)),
        torch.nn.functional.pad(do, (0, width - d)))) if width != d else 0.0
    kernels = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(qp, kp, vp, g),
            lambda: fa._forward_plain(q, k, v, g),
            flash_need(q, k, g, 2, q.numel() * esz + row, 0)),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(qp, kp, vp, dop, lse, delta, g),
            lambda: fa._dq_plain(q, k, v, do, lse, delta, g),
            flash_need(q, k, g, 3, q.numel() * esz,
                       q.numel() * esz + 2 * row)),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(qp, kp, vp, dop, lse, delta, g),
            lambda: fa._dkv_plain(q, k, v, do, lse, delta, g),
            flash_need(q, k, g, 4, 2 * k.numel() * esz,
                       q.numel() * esz + 2 * row))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, dropout_p=dropout)

    def lib_fwd_bwd():
        out = sdpa(*leaves, dropout_p=dropout)
        torch.autograd.grad(out, leaves, do4)
    lib_f = cuda_ms(lib_fwd)
    lib_b = cuda_ms(lib_fwd_bwd) - lib_f
    recs = {}
    with torch.no_grad():
        for kname, (kern, plain, need) in kernels.items():
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            lib = lib_f if kname == "flash_attention_fwd" else lib_b
            recs[kname] = dict(max_abs_err=errs[kname], ms=ms,
                               plain_ms=plain_ms, bound_ms=need["bound_ms"],
                               bound_by=need["bound_by"], library_ms=lib)
            log(f"flash {what} (B={B}, H={H}, S={S}, head_dim {d}"
                + (f" on the hd-{width} kernel" if width != d else "")
                + (f", dropout {dropout}" if dropout else "")
                + f", bf16) {kname}: max|err|={errs[kname]:.3e}; kernel "
                f"{ms:.4f} ms "
                f"({need['flops'] / (ms / 1e3) / 1e12:.1f} TFLOP/s of the "
                f"head_dim-{d} work), plain {plain_ms:.4f} ms, bound "
                f"{need['bound_ms']:.4f} ms ({need['bound_by']}), library "
                f"{lib:.4f} ms")
    if width != d:
        log(f"flash {what}: the zero-padding copies of one layer (q, k, v "
            f"and do to {width}) take {pad_ms:.4f} ms")
        for r in recs.values():
            r["pad_ms"] = pad_ms
    del lse, delta, qp, kp, vp, dop, leaves
    free_device_memory()
    return recs


# --------------------------------------------------------------------------
# phase 13: vision training (PP-OCRv4 recognition, ResNet-50)
# device kernels of a vision step by kind, first match wins; the rest as
# in the other phases
VISION_KINDS = (
    ("fused optimizer kernels", ("fused_adam", "fused_sqnorm")),
    ("CTC", ("ctc_loss",)),
    ("LSTM (PyTorch's fused recurrence)", ("rnn", "lstm", "persist")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("pooling", ("pool",)),
    ("convolution (cuDNN)", ("conv", "xmma", "fprop", "dgrad", "wgrad",
                             "implicit", "cudnn", "winograd", "nhwc")),
)


def vision_kernel_kind(key):
    low = key.lower()
    for label, words in VISION_KINDS:
        if any(w in low for w in words):
            return label
    return kernel_kind(key)


def vision_train_flops_per_step(model, x):
    """3 x the forward's 2-per-multiply-add flops (forward, and the
    backward's two products), counted from the shapes of one eval
    forward of ``x``: each convolution's output elements times its
    ``in/groups * kh * kw`` (hooks on every ``Conv2D``), each ``Linear``'s
    output elements times its input width, and each LSTM layer's ``T * B
    * 4H * (in + H)`` per direction (input projection and recurrence)."""
    from paddle_tpu_torch import nn
    macs = [0]

    def conv(m, args, out):
        w = m.weight
        macs[0] += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]

    def linear(m, args, out):
        macs[0] += out.numel() * m.weight.shape[0]

    def lstm(m, args, out):
        B, T = args[0].shape[0], args[0].shape[1]
        macs[0] += sum(T * B * c.weight_ih.shape[0] *
                       (c.weight_ih.shape[1] + c.weight_hh.shape[1])
                       for c in m._cells)
    hooks = [mod.register_forward_hook(
        conv if isinstance(mod, nn.Conv2D) else
        linear if isinstance(mod, nn.Linear) else lstm)
        for mod in model.modules()
        if isinstance(mod, (nn.Conv2D, nn.Linear, nn.LSTM))]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    return 3 * 2 * macs[0]


def _bn_buffers(model):
    from paddle_tpu_torch import nn
    return {n: (m._mean.detach().clone(), m._variance.detach().clone())
            for n, m in model.named_modules()
            if isinstance(m, nn.BatchNorm2D)}


def _check_bn_moved(what, model, before):
    """Every ``BatchNorm2D``'s running mean and variance left its initial
    zeros and ones and is finite."""
    after = _bn_buffers(model)
    for n, (m0, v0) in before.items():
        m1, v1 = after[n]
        if torch.equal(m0, m1) or torch.equal(v0, v1):
            raise AssertionError(f"{what}: {n}'s running stats did not move")
        if not (torch.isfinite(m1).all() and torch.isfinite(v1).all()):
            raise AssertionError(f"{what}: {n}'s running stats are not "
                                 f"finite")
    dtypes = sorted({str(m.dtype) for m, _ in after.values()})
    log(f"{what}: all {len(before)} BatchNorm2D layers' _mean/_variance "
        f"moved and are finite ({', '.join(dtypes)})")


def vision_run(what, model, loss_fn, batch, warmup, timed, B, before):
    """``model_train_run`` for a vision model (no flash layers, images a
    step, the vision kernel kinds in the profile); returns the run, with
    the calls of PyTorch's fused recurrence in its steps (the profiled
    one too) under ``recurrence_calls``."""
    from paddle_tpu_torch.nn.layer import rnn
    flops = vision_train_flops_per_step(model, batch[0])
    bn0 = _bn_buffers(model)
    calls0 = rnn.cudnn_calls
    r = model_train_run(
        what, model, loss_fn, batch, warmup, timed, flops, 0, before,
        unit="images", items=B, desc=f"batch {B} x {tuple(batch[0].shape[1:])}",
        profile=lambda fn, x, ms, w: profile_train_step(
            fn, x, ms, w, vision_kernel_kind))
    r["recurrence_calls"] = rnn.cudnn_calls - calls0
    _check_bn_moved(what, model, bn0)
    losses = r["losses"]
    if not (math.isfinite(losses[0]) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    return r


def phase_ppocr():
    """Phase 13a: PP-OCRv4 recognition, ``PPOCRRecConfig()`` uncut (widths
    32/64/128/256, LSTM hidden 120, 6625 classes, height 48), bf16, on
    64 seeded 3 x 48 x 320 images with 16 labels each (T = 80 frames),
    CTC, ``TrainStep`` fused, 2 + 10 steps (bench.py's _suite_ppocr
    geometry). The two LSTM layers take PyTorch's fused recurrence once a
    forward each. Returns the run's launch counts."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.ppocr import PPOCRRecConfig, PPOCRRecModel
    cfg = PPOCRRecConfig()
    B, W, L = 64, 320, 16
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.randn(B, cfg.in_channels, cfg.img_height,
                                        W).astype(np.float32))
    labels = torch.from_numpy(rng.randint(1, cfg.num_classes, (B, L)))
    batch = [images.cuda().to(torch.bfloat16), labels.cuda(),
             torch.full((B,), L, dtype=torch.int64, device="cuda")]

    def loss_fn(m, x, y, n):  # the reference's logits are float32
        return m.loss(m(x).float(), y, n)
    free_device_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptt.seed(SEED)
    model = PPOCRRecModel(cfg, dtype="bfloat16")
    r = vision_run("ppocr", model, loss_fn, batch, 2, 10, B, before)
    calls = r["recurrence_calls"]
    steps = 2 + 10 + 1  # and the profiled one
    if calls != 2 * steps:
        raise AssertionError(f"ppocr: {calls} fused-recurrence calls in "
                             f"{steps} steps, not 2 a step (one a layer)")
    T = W // 4
    log(f"ppocr: T = {T} frames, LSTM 2 layers x 2 directions of "
        f"{cfg.hidden_size}, {calls} fused-recurrence calls in {steps} "
        f"steps (2 a step, both directions in each)")
    del model
    free_device_memory()
    return {**r["flash"], **r["fused"]}


def phase_resnet():
    """Phase 13b: ``vision.models.resnet50(num_classes=1000)`` in bf16 on
    64 seeded 3 x 224 x 224 images and labels, ``CrossEntropyLoss``,
    ``TrainStep`` fused, 2 + 5 steps; the first loss within 1.0 of
    ln(1000). Returns the run's launch counts."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.vision.models import resnet50
    B = 64
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.randn(B, 3, 224, 224).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 1000, B))
    batch = [images.cuda().to(torch.bfloat16), labels.cuda()]
    ce = CrossEntropyLoss()

    def loss_fn(m, x, y):
        return ce(m(x).float(), y)
    free_device_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptt.seed(SEED)
    model = resnet50(num_classes=1000, dtype="bfloat16")
    r = vision_run("resnet50", model, loss_fn, batch, 2, 5, B, before)
    first, ln_c = r["losses"][0], math.log(1000)
    if not abs(first - ln_c) <= 1.0:
        raise AssertionError(f"resnet50: first loss {first} is not within "
                             f"1.0 of ln(1000) = {ln_c:.4f}")
    log(f"resnet50: first loss {first:.4f} against ln(1000) = {ln_c:.4f}")
    del model
    free_device_memory()
    return {**r["flash"], **r["fused"]}


# --------------------------------------------------------------------------
# phase 14: the Paddle API from a user's script
API_NOT_OPS = {"OPS", "RAW", "TensorArray", "get_op", "op",
               "monkey_patch_tensor"}
API_RANDOM = {"rand", "randn", "randint", "randint_like", "uniform",
              "normal", "standard_normal", "randperm", "bernoulli",
              "multinomial", "poisson", "exponential_", "binomial"}
# compared at rtol 1e-4 (reductions, linear algebra, special functions);
# every other floating result at rtol 1e-5, integers and booleans exactly
API_LOOSE = {
    "sum", "mean", "prod", "std", "var", "median", "quantile", "nanquantile",
    "logsumexp", "nanmean", "nansum", "cumsum", "cumprod", "logcumsumexp",
    "norm", "dist", "cdist", "pdist", "matmul", "bmm", "dot", "mv", "inner",
    "outer", "addmm", "einsum", "mm", "tensordot", "kron", "multi_dot",
    "cholesky", "cholesky_solve", "qr", "svd", "eig", "eigh", "eigvals",
    "eigvalsh", "det", "slogdet", "inverse", "pinv", "solve",
    "triangular_solve", "lstsq", "matrix_power", "matrix_exp", "lu",
    "corrcoef", "cov", "householder_product", "renorm", "trapezoid",
    "cumulative_trapezoid", "trace", "polygamma", "igamma", "igammac",
    "lgamma", "digamma", "erfinv", "i0", "i1", "logit", "stanh"}
# equal only up to a sign per singular or eigen vector: compare what the
# decomposition reconstructs
API_RECONSTRUCT = {"svd", "qr", "eig", "eigh", "eigvals"}


def api_specs():
    """``{op: (args, kwargs)}``: seeded numpy inputs (turned into tensors
    on the device under test), the shapes of the CPU op table cut small;
    an op not listed takes one [3, 4] float32 input."""
    rng = np.random.RandomState(SEED)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    X, Y = f(3, 4), f(3, 4) + 0.1
    U = rng.rand(3, 4).astype(np.float32) * 0.8 + 0.2
    V = (rng.rand(3, 4).astype(np.float32) - 0.5) * 1.8  # in (-0.9, 0.9)
    ints = lambda hi, *s: rng.randint(0, hi, s).astype(np.int64)  # noqa
    B1, B2 = rng.rand(3, 4) > 0.5, rng.rand(3, 4) > 0.5
    spd = f(3, 3)
    spd = spd @ spd.T + 3 * np.eye(3, dtype=np.float32)
    nan = np.array([[1.0, np.nan, -np.inf], [np.inf, 2.0, 3.0]], np.float32)
    cplx = (f(3, 4) + 1j * f(3, 4)).astype(np.complex64)
    specs = {n: ((X, Y), {}) for n in (
        "add", "subtract", "multiply", "maximum", "minimum", "fmax", "fmin",
        "atan2", "hypot", "logaddexp", "heaviside", "equal", "not_equal",
        "less_than", "less_equal", "greater_than", "greater_equal",
        "isclose", "inner", "complex")}
    specs.update({n: ((X, U), {}) for n in (
        "divide", "floor_divide", "remainder", "mod", "floor_mod")})
    specs.update({n: ((U,), {}) for n in (
        "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
        "lgamma", "digamma", "logit")})
    specs.update({n: ((V,), {}) for n in ("asin", "acos", "atanh",
                                           "erfinv")})
    specs.update({n: ((ints(50, 3, 4) + 1, ints(7, 3, 4) + 1), {}) for n in (
        "gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor")})
    specs.update({n: ((B1, B2), {}) for n in (
        "logical_and", "logical_or", "logical_xor")})
    specs.update({n: ((nan,), {}) for n in (
        "isnan", "isinf", "isfinite", "nan_to_num", "nanmean", "nansum")})
    specs.update({n: ((X, 1), {}) for n in (
        "cumsum", "cummax", "cummin", "logcumsumexp", "sum", "mean", "max",
        "min", "amax", "amin", "std", "var", "median", "logsumexp",
        "argmax", "argmin", "sort", "unbind", "diagonal", "unstack")})
    specs.update({
        "pow": ((U, Y), {}), "acosh": ((U + 1.0,), {}),
        "left_shift": ((ints(9, 3, 4), ints(4, 3, 4)), {}),
        "right_shift": ((ints(99, 3, 4), ints(4, 3, 4)), {}),
        "bitwise_not": ((ints(9, 3, 4),), {}), "logical_not": ((B1,), {}),
        "scale": ((X, 2.0, 0.5), {}), "lerp": ((X, Y, 0.3), {}),
        "clip": ((X, -0.5, 0.5), {}), "clip_": ((X.copy(), -0.5, 0.5), {}),
        "multiplex": (([X, Y], ints(2, 3, 1)), {}),
        "cumprod": ((U, 1), {}), "allclose": ((X, X + 1e-7), {}),
        "equal_all": ((X, X), {}), "prod": ((U, 1), {}),
        "all": ((B1, 1), {}), "any": ((B1, 0), {}),
        "quantile": ((X, 0.3), {"axis": 1}),
        "nanquantile": ((nan, 0.4), {"axis": 1}),
        "topk": ((X, 2), {}), "kthvalue": ((X, 2), {}),
        "mode": ((np.array([[1., 2., 2., 3.], [4., 4., 1., 1.]],
                           np.float32),), {}),
        "count_nonzero": ((ints(3, 3, 4), 1), {}),
        "cast": ((X, "float16"), {}), "assign": ((X,), {}),
        "reshape": ((X, [0, 2, 2]), {}), "transpose": ((X, [1, 0]), {}),
        "moveaxis": ((X[None], 0, 2), {}), "swapaxes": ((X, 0, 1), {}),
        "concat": (([X, Y], 1), {}), "stack": (([X, Y], 0), {}),
        "split": ((X, [1, -1, 1], 1), {}), "chunk": ((X, 2, 1), {}),
        "squeeze": ((X[None], 0), {}), "unsqueeze": ((X, [0, 2]), {}),
        "flatten": ((X[None],), {}), "tile": ((X, [2, 1]), {}),
        "expand": ((X[:1], [3, -1]), {}),
        "broadcast_to": ((X[:1], [3, 4]), {}),
        "expand_as": ((X[:1], Y), {}),
        "broadcast_tensors": (([X, X[:1]],), {}),
        "flip": ((X, [0, 1]), {}), "roll": ((X, 2, 1), {}),
        "rot90": ((X,), {}), "gather": ((X, np.array([2, 0]), 0), {}),
        "gather_nd": ((X, np.array([[0, 1], [2, 3]])), {}),
        "take_along_axis": ((X, np.array([[1], [0], [3]]), 1), {}),
        "put_along_axis": ((X, np.array([[1], [0], [3]]), 5.0, 1), {}),
        "scatter": ((X, np.array([2, 0]), Y[:2]), {}),
        "scatter_nd_add": ((X, np.array([[0], [2]]), Y[:2]), {}),
        "scatter_nd": ((np.array([[0], [2]]), Y[:2], [4, 4]), {}),
        "index_select": ((X, np.array([3, 1]), 1), {}),
        "index_sample": ((X, np.array([[0, 3], [1, 1], [2, 0]])), {}),
        "index_add": ((X, np.array([0, 2]), 0, Y[:2]), {}),
        "index_fill": ((X, np.array([0, 2]), 1, 3.0), {}),
        "masked_select": ((X, B1), {}), "masked_fill": ((X, B1, 2.0), {}),
        "where": ((B1, X, Y), {}), "nonzero": ((B1,), {}),
        "tril": ((X, -1), {}), "triu": ((X, 1), {}),
        "pad": ((X, [1, 2]), {"mode": "reflect"}),
        "repeat_interleave": ((X, 2, 0), {}),
        "argsort": ((X, 0), {"descending": True}),
        "unique": ((ints(4, 3, 4),), {}),
        "unique_consecutive": ((np.array([1, 1, 3, 3, 2, 1]),), {}),
        "diff": ((X, 1, 1), {}), "one_hot": ((ints(4, 5), 4), {}),
        "slice": ((X, [0, 1], [1, 0], [3, 3]), {}),
        "strided_slice": ((X, [1], [3], [0], [-2]), {}),
        "crop": ((X, [2, 2], [1, 1]), {}),
        "bucketize": ((X, np.array([-1.0, 0.0, 1.0], np.float32)), {}),
        "searchsorted": ((np.array([-1.0, 0.0, 1.0], np.float32), X), {}),
        "digitize": ((X, np.array([-1.0, 0.0, 1.0], np.float32)), {}),
        "as_real": ((cplx,), {}), "as_complex": ((f(3, 4, 2),), {}),
        "shard_index": ((ints(20, 4, 1), 20, 2, 0), {}),
        "matmul": ((X, Y.T.copy()), {}),
        "bmm": ((f(2, 3, 4), f(2, 4, 2)), {}), "dot": ((X, Y), {}),
        "mv": ((X, f(4)), {}), "outer": ((f(3), f(4)), {}),
        "addmm": ((f(3, 2), X, f(4, 2)), {"beta": 0.5, "alpha": 2.0}),
        "einsum": (("ij,kj->ik", X, Y), {}), "mm": ((X, Y.T.copy()), {}),
        "norm": ((X,), {"p": 3}), "dist": ((X, Y), {"p": 3.0}),
        "cross": ((f(2, 3), f(2, 3)), {}), "cdist": ((X, Y), {}),
        "histogram": ((X,), {"bins": 5}),
        "bincount": ((ints(5, 8),), {}),
        "cholesky": ((spd,), {}),
        "cholesky_solve": ((f(3, 2), np.linalg.cholesky(spd)), {}),
        "qr": ((X.T.copy(),), {}), "svd": ((X,), {}),
        "eig": ((spd + f(3, 3),), {}), "eigvals": ((spd + f(3, 3),), {}),
        "eigh": ((spd,), {}), "eigvalsh": ((spd,), {}),
        "matrix_rank": ((X,), {}), "det": ((spd,), {}),
        "slogdet": ((spd,), {}), "inverse": ((spd,), {}),
        "pinv": ((X,), {}), "solve": ((spd, f(3, 2)), {}),
        "triangular_solve": ((np.triu(spd), f(3, 2)), {}),
        "lstsq": ((f(5, 3), f(5, 2)), {}),
        "matrix_power": ((spd / 4, 3), {}),
        "multi_dot": (([X, Y.T.copy(), f(3, 2)],), {}), "lu": ((spd,), {}),
        "corrcoef": ((X,), {}), "cov": ((X,), {}),
        "kron": ((f(2, 2), f(2, 3)), {}), "trapezoid": ((X,), {"dx": 0.5}),
        "cumulative_trapezoid": ((X,), {"dx": 0.5}),
        "polygamma": ((U + 0.5, 1), {}), "igamma": ((U + 0.5, U), {}),
        "igammac": ((U + 0.5, U), {}), "renorm": ((X, 2.0, 0, 1.0), {}),
        "label_smooth": ((np.eye(4, dtype=np.float32)[:3],),
                         {"epsilon": 0.2}),
        "increment": ((X.copy(), 2.0), {}), "polar": ((U, X), {}),
        "matrix_exp": ((X[:3, :3] / 2,), {}), "vander": ((f(3),), {}),
        "householder_product": ((X.T.copy(), U[0, :3].copy()), {}),
        "pdist": ((f(4, 3),), {}), "tensordot": ((X, Y.T.copy()),
                                                 {"axes": 1}),
        "trace": ((X,), {"offset": 1}), "vsplit": ((f(4, 2), 2), {}),
        "hsplit": ((f(2, 4), [1, 3]), {}), "dsplit": ((f(2, 2, 4), 2), {}),
        "tensor_split": ((X, 3, 1), {}),
        # creation: the default device (or the input's)
        "zeros": (([2, 3],), {}), "ones": (([4],), {}),
        "full": (([2, 2], 7.0), {}), "empty": (([2, 3],), {}),
        "arange": ((10,), {}), "linspace": ((0, 1, 5), {}),
        "logspace": ((0, 2, 3), {}), "eye": ((3, 4), {}),
        "tril_indices": ((4, 4, 0), {}), "triu_indices": ((4, 4, 1), {}),
        "full_like": ((X, 2.0), {}), "diag": ((f(3),), {}),
        "diagflat": ((f(3),), {}), "meshgrid": ((f(3), f(4)), {}),
        # random: device, shape, dtype and seed-repeatability only
        "rand": (([3, 4],), {}), "randn": (([3, 4],), {}),
        "standard_normal": (([3, 4],), {}),
        "randint": ((0, 10, [3, 4]), {}),
        "randint_like": ((ints(3, 3, 4), 0, 10), {}),
        "uniform": (([3, 4],), {}), "normal": ((0.0, 1.0, [3, 4]), {}),
        "randperm": ((10,), {}), "bernoulli": ((U * 0.9,), {}),
        "multinomial": ((U, 2), {}), "poisson": ((U * 3,), {}),
        "exponential_": ((X.copy(),), {}),
        "binomial": ((np.array([5, 50, 500], np.int64),
                      np.array([0.1, 0.5, 0.9], np.float32)), {}),
        # TensorArray (a list of tensors on the host, its length a tensor)
        "create_array": (("float32", [X]), {}),
        "array_write": ((X, 0), {}), "array_length": (([X, Y],), {}),
        "array_read": (([X, Y], 1), {}),
        "numel": ((X,), {}), "rank": ((X,), {}),
    })
    return specs


def _api_call(paddle, name, spec, place):
    """Run op ``name`` on ``spec``'s inputs placed on ``place``."""
    def conv(a):
        if isinstance(a, np.ndarray):
            return paddle.to_tensor(a.copy(), place=place)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [paddle.to_tensor(v.copy(), place=place) for v in a]
        return a
    args, kw = spec
    args = [conv(a) for a in args]
    if name in ("array_length", "array_read"):  # over a TensorArray
        args[0] = paddle.ops.create_array("float32", args[0])
    return getattr(paddle.ops, name)(*args, **kw)


def _api_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _api_tensors(o)]
    return []


def _api_values(name, outs):
    o = [t.numpy() for t in outs]
    if name == "svd":
        return [(o[0] * o[1]) @ o[2], o[1]]
    if name == "qr":
        return [o[0] @ o[1], np.abs(o[1])]
    if name == "eigh":
        return [(o[1] * o[0]) @ o[1].T, o[0]]
    if name in ("eig", "eigvals"):
        return [np.sort_complex(o[0])]
    if name == "lstsq":  # the card's QR solver gives no rank or values
        return o[:1]
    return o


def api_op_library():
    """14(a): every op of the op library once on the card and once on the
    CPU, on the same seeded inputs; each result must lie on the card and
    equal the CPU's. Random ops: device, shape, dtype and repeatability
    under one seed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device
    specs = api_specs()
    unary = ((np.random.RandomState(7).randn(3, 4).astype(np.float32),), {})
    names = [n for n in paddle.ops.__all__ if n not in API_NOT_OPS]
    failures, t0 = [], time.perf_counter()
    for name in names:
        spec = specs.get(name, unary)
        try:
            paddle.seed(123)
            got = _api_tensors(_api_call(paddle, name, spec, "gpu"))
            if not got or any(t.device.type != "cuda" for t in got):
                raise AssertionError(
                    f"result on {[str(t.device) for t in got]}, not cuda")
            if name in API_RANDOM:
                paddle.seed(123)
                again = _api_tensors(_api_call(paddle, name, spec, "gpu"))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError("not repeated under one seed")
                continue
            device.set_device("cpu")  # the CPU twin, creation ops too
            try:
                want = _api_tensors(_api_call(paddle, name, spec, "cpu"))
            finally:
                device._chosen[0] = None  # as if set_device never ran
            rtol, atol = (1e-4, 1e-5) if name in API_LOOSE else (1e-5, 1e-6)
            if name in API_RECONSTRUCT:
                rtol, atol = 1e-4, 1e-5
            a, b = _api_values(name, got), _api_values(name, want)
            if len(a) != len(b):
                raise AssertionError(f"{len(a)} results, not {len(b)}")
            for x, y in zip(a, b):
                if x.shape != y.shape or x.dtype != y.dtype:
                    raise AssertionError(f"{x.shape} {x.dtype} against "
                                         f"{y.shape} {y.dtype}")
                if x.dtype.kind in "iub":
                    if not np.array_equal(x, y):
                        raise AssertionError("differs from the CPU's")
                else:
                    np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                               equal_nan=True)
        except Exception as e:  # noqa: BLE001 — logged, then the phase fails
            failures.append(name)
            log(f"api ops: {name} FAILED: {type(e).__name__}: "
                f"{str(e).splitlines()[0][:200] if str(e) else ''}")
    log(f"api ops: {len(names)} ops of the op library on the card against "
        f"the CPU ({len(API_RANDOM)} random ones by device, shape, dtype "
        f"and seed), rtol 1e-5 (reductions, linear algebra and special "
        f"functions 1e-4); {len(failures)} failed {failures}; "
        f"{time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"op library on the card: {failures}")
    return len(names)


def api_eager_losses(cfg, ids, steps, opt_kw):
    """The loop of ``examples/generate_llama.py`` at full width: ``_, loss
    = model(ids, labels=ids)``, ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``; returns the losses, the step ms and the flash
    launches."""
    import paddle_tpu_torch as paddle
    paddle.seed(SEED)
    model = paddle.models.LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    opt = paddle.optimizer.AdamW(parameters=model.parameters(), **opt_kw)
    _reset_flash_counts()
    losses, t0 = [], None
    for i in range(steps):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _, loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (steps - 2)
    counts = _flash_counts()
    del model, opt, loss
    free_device_memory()
    return losses, step_ms, counts


def api_train(train_step_ms):
    """14(b): a user's training script at full width, with no
    ``set_device`` call: ids from ``paddle.to_tensor(numpy)``, the eager
    loop (2 + 3 steps), a ``fused=False`` ``TrainStep`` (3 steps) from
    the same seed, then ``paddle.jit.TrainStep`` as in
    ``examples/train_llama.py`` (2 + 10 steps, losses read with
    ``float(loss.numpy())``)."""
    import paddle_tpu_torch as paddle
    cfg = llama_bench_config()
    B, S = 4, 2048
    ids = paddle.to_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)))
    if ids.place != "gpu:0" or type(ids) is not paddle.Tensor:
        raise AssertionError(f"to_tensor gave {type(ids)} on {ids.place}")
    L = cfg.num_hidden_layers
    opt_kw = dict(learning_rate=1e-4, multi_precision=True)
    eager, eager_ms, eager_counts = api_eager_losses(cfg, ids, 5, opt_kw)
    for kname, n in eager_counts.items():
        if n != 5 * L:
            raise AssertionError(f"api eager: {kname} launched {n} times "
                                 f"in 5 steps, not {L} a step")
    log(f"api eager loop (model(ids, labels=ids), loss.backward(), "
        f"opt.step(), opt.clear_grad()): losses "
        f"{[round(v, 5) for v in eager]}; step {eager_ms:.3f} ms; K1-K3 "
        f"{L} a step")

    def run_step(fused, warmup, timed, clip):
        paddle.seed(SEED)
        model = paddle.models.LlamaForCausalLM(cfg, dtype="bfloat16",
                                               seed=SEED)
        kw = dict(opt_kw)
        if clip:
            kw["grad_clip"] = paddle.nn.ClipGradByGlobalNorm(1.0)
        opt = paddle.optimizer.AdamW(parameters=model.parameters(), **kw)

        def loss_fn(m, x, y):
            _, loss = m(x, labels=y)
            return loss
        step = paddle.jit.TrainStep(model, loss_fn, opt, fused=fused)
        _reset_flash_counts()
        _reset_fused_counts()
        losses = [float(step(ids, ids).numpy()) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step(ids, ids) for _ in range(timed)]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / max(timed, 1)
        if out and type(out[-1]) is not paddle.Tensor:
            raise AssertionError(f"TrainStep returned {type(out[-1])}")
        losses += [float(t.numpy()) for t in out]
        counts = {**_flash_counts(), **_fused_counts()}
        del model, opt, step, out
        free_device_memory()
        return losses, ms, counts
    loop, _, _ = run_step(False, 3, 0, False)
    if not np.allclose(eager[:3], loop[:3], rtol=1e-3, atol=0):
        raise AssertionError(f"api: eager losses {eager[:3]} and "
                             f"TrainStep(fused=False) {loop[:3]} differ by "
                             f"more than rtol 1e-3")
    log(f"api: eager first three losses {[round(v, 5) for v in eager[:3]]} "
        f"= TrainStep(fused=False) {[round(v, 5) for v in loop[:3]]} "
        f"(rtol 1e-3)")
    losses, step_ms, counts = run_step(None, 2, 10, True)
    ln_v = math.log(cfg.vocab_size)
    if not (abs(losses[0] - ln_v) <= 1.0 and losses[-1] < losses[0]):
        raise AssertionError(f"api TrainStep: losses {losses} (ln V "
                             f"{ln_v:.3f})")
    for kname in ("flash_attention_fwd", "flash_attention_dq",
                  "flash_attention_dkv"):
        if counts[kname] != 12 * L:
            raise AssertionError(f"api TrainStep: {kname} launched "
                                 f"{counts[kname]} times in 12 steps")
    log(f"api TrainStep (paddle.jit.TrainStep over paddle.to_tensor ids, "
        f"fused, clip 1.0): losses {[round(v, 4) for v in losses]}; K1-K3 "
        f"{L} a step; step {step_ms:.3f} ms against phase 7's fused step "
        f"{train_step_ms:.3f} ms from the same call "
        f"({step_ms / train_step_ms:.3f}x)")
    return counts, step_ms


def api_generate():
    """14(c): ``generate`` at full width: 4 seeded 512-token prompts, 64
    greedy tokens in bf16 (prefill and decode times, K1's launches and
    its share of a decode step's device time); then the f32 replay at 2
    layers: every token equals the argmax of the cacheless forward over
    the sequence so far."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    cfg = llama_bench_config()
    B, P, N = 4, 512, 64
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, P))
    model = paddle.models.LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    model.eval()
    ids = paddle.to_tensor(prompt)
    model.generate(ids, max_new_tokens=2, temperature=0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate(ids, max_new_tokens=1, temperature=0)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    _reset_flash_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=N, temperature=0)
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    k1 = fa.launches_fwd
    want = cfg.num_hidden_layers * N
    if k1 != want or type(out) is not paddle.Tensor or \
            out.shape != [B, P + N] or fa.launches_dq or fa.launches_dkv:
        raise AssertionError(f"generate: K1 {k1} launches (want {want}), "
                             f"{type(out)} of {out.shape}")
    tok = out.numpy()[:, P:]
    if not ((tok >= 0) & (tok < cfg.vocab_size)).all():
        raise AssertionError("generate: tokens out of the vocabulary")
    decode_ms = (total_ms - prefill_ms) / (N - 1)
    log(f"generate (bf16, {cfg.num_hidden_layers} layers, batch {B} x "
        f"{P}-token prompts, {N} greedy tokens): prefill {prefill_ms:.3f} "
        f"ms; {decode_ms:.3f} ms a decode token; {total_ms:.3f} ms in all, "
        f"{B * N / (total_ms / 1e3):.1f} tokens/s; K1 launched {k1} times "
        f"= {cfg.num_hidden_layers} x (1 + {N - 1})")
    # one decode step under the profiler: K1's share of its device time
    with torch.no_grad():
        L = cfg.num_hidden_layers
        x = torch.as_tensor(prompt, device="cuda")
        h, caches = model.model(x, caches=[(None, None)] * L)
        step_tok = model._logits(h[:, -1:]).argmax(-1)

        def decode(_):
            hh, _c = model.model(step_tok, caches=caches)
            model._logits(hh)
        decode(None)
        shares = profile_train_step(decode, None, decode_ms,
                                    "generate decode step")
    k1_share = shares.get("flash K1-K3", 0.0)
    total_dev = sum(v for k, v in shares.items()
                    if not k.startswith("Train"))
    share = 100 * k1_share / total_dev if total_dev else float("nan")
    log(f"generate decode step: K1 {k1_share:.3f} ms of {total_dev:.3f} "
        f"ms device time ({share:.1f}%); busy "
        f"{100 * total_dev / decode_ms:.1f}% of the {decode_ms:.3f} ms "
        f"decode token")
    del model, caches, h, out
    free_device_memory()
    # the replay oracle, f32 at 2 layers
    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = paddle.models.LlamaForCausalLM(small, dtype="float32",
                                           seed=SEED)
    model.eval()
    out = model.generate(paddle.to_tensor(prompt[:, :64]),
                         max_new_tokens=16, temperature=0)
    seq = out.numpy()
    with torch.no_grad():
        full = torch.as_tensor(seq, device="cuda")
        for t in range(64, seq.shape[1]):
            nxt = model(full[:, :t])[:, -1].argmax(-1).cpu().numpy()
            if not np.array_equal(nxt, seq[:, t]):
                raise AssertionError(f"generate f32: token {t} "
                                     f"{seq[:, t]} is not the cacheless "
                                     f"argmax {nxt}")
    log("generate f32 (2 layers, batch 4 x 64, 16 greedy tokens): every "
        "token equals the argmax of the cacheless forward over the "
        "sequence so far")
    del model
    free_device_memory()
    return dict(flash_attention_fwd=k1, flash_attention_dq=0,
                flash_attention_dkv=0, fused_adam_update=0, fused_sqnorm=0,
                prefill_ms=prefill_ms, decode_ms=decode_ms, k1_share=share,
                decode_dev_ms=total_dev)


API_EXAMPLES = ("train_llama.py", "generate_llama.py", "train_packed.py",
                "serve_llama.py", "generate_compiled.py")
# lines an example must print to have done its work on the card
EXAMPLE_LINES = {
    "generate_compiled.py": ("token-for-token: True",),
    "export_and_serve.py": ("served logits: (2, 16, 256)",),
    "int8_deploy.py": ("simulation vs int8 match: True",
                       "served == int8: True")}
# phase 18(b): the deployment examples
DEPLOY_EXAMPLES = ("export_and_serve.py", "int8_deploy.py",
                   "static_regression.py")
# the reference's other examples, and the subsystem each needs
API_EXAMPLES_NOT_RUN = {
    "pipeline_spmd.py": "the mesh and fleet pipeline (paddle.distributed, "
                        "ROADMAP §1 item 5)",
    "train_llama_spmd.py": "the mesh and sharding API "
                           "(paddle.distributed, ROADMAP §1 item 5)"}


def api_examples(names=API_EXAMPLES):
    """14(d) and 18(b): the reference's examples, copied with
    ``paddle_tpu`` renamed ``paddle_tpu_torch`` and nothing else changed,
    each in a fresh process on the card by default (all at once)."""
    import subprocess
    import tempfile
    src = os.path.join(REPO_ROOT, "examples")
    tmp = tempfile.mkdtemp(prefix="api_examples_", dir=REPO_ROOT)
    procs = {}
    try:
        for name in ("_common.py",) + tuple(names):
            with open(os.path.join(src, name)) as fh:
                text = re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch",
                              fh.read())
            with open(os.path.join(tmp, name), "w") as fh:
                fh.write(text)
        env = dict(os.environ, PYTHONPATH=REPO_ROOT)
        for name in names:
            code = (f"import runpy, sys; sys.path.insert(0, {tmp!r}); "
                    f"runpy.run_path({os.path.join(tmp, name)!r}, "
                    f"run_name='__main__')")
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", code], cwd=tmp, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        bad = []
        for name, p in procs.items():
            try:
                out, err = p.communicate(timeout=400)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            tail = out.strip().splitlines()[-3:]
            log(f"example {name}: exit {p.returncode}; " + " | ".join(tail))
            if p.returncode != 0:
                log(err[-2000:])
                bad.append(name)
            if name in ("train_llama.py", "static_regression.py") and \
                    p.returncode == 0:
                ls = [float(v) for v in re.findall(r"loss ([0-9.]+)", out)]
                if not ls[-1] < ls[0]:
                    bad.append(name + " (loss did not fall)")
            for want in EXAMPLE_LINES.get(name, ()):
                if p.returncode == 0 and want not in out:
                    bad.append(f"{name} (no {want!r})")
        if names is API_EXAMPLES:
            for name, need in API_EXAMPLES_NOT_RUN.items():
                log(f"example {name}: not run (needs {need})")
        if bad:
            raise AssertionError(f"examples failed on the port: {bad}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def flash_decode_shapes():
    """K1 at ``generate``'s decode shapes: one query row per head over
    513, 600, 1000 and 2047 cached keys (GQA 16/4, hd 128, bf16, batch
    4), against its plain version at ``FLASH_TOL``, with the kernel's,
    the plain version's and ``sdpa``'s times and the bound (bytes: q, the
    K/V cache and o read or written once)."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    B, hq, hkv, hd = 4, 16, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for sk in (513, 600, 1000, 2047):
        q4, k4, v4 = [torch.randn(B, h, s, hd, device="cuda",
                                  dtype=torch.bfloat16, generator=gen)
                      for h, s in ((hq, 1), (hkv, sk), (hkv, sk))]
        q, k, v, g, _ = fa._geometry(q4, k4, v4, True, None, None, None,
                                     None, 0.0, None)
        o, lse = fa.flash_attention_fwd(q, k, v, g)
        ro, rlse = fa._forward_plain(q, k, v, g)
        tol = FLASH_TOL[torch.bfloat16][0]
        err = max(_check(f"K1 decode o {sk}", o, ro, *tol),
                  _check(f"K1 decode lse {sk}", lse, rlse, *tol))
        esz = q.element_size()
        need = flash_need(q, k, g, 2, q.numel() * esz + 4 * q.shape[0], 0)
        with torch.no_grad():
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, g))
            plain_ms = cuda_ms(lambda: fa._forward_plain(q, k, v, g))
            # one query row that sees every key: sdpa's non-causal form
            lib = cuda_ms(lambda: sdpa(q4, k4, v4, enable_gqa=True))
        log(f"flash decode K1 (q_len 1, kv_len {sk}, GQA 16/4, hd 128, "
            f"bf16, batch 4): max|err|={err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {need['bound_ms']:.4f} ms "
            f"({need['bound_by']}: {need['bytes']} B), library "
            f"{lib:.4f} ms (sdpa)")
        out[f"decode_kv{sk}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=need["bound_ms"], bound_by=need["bound_by"],
            library_ms=lib)
    return out


def phase_api(train_step_ms):
    """Phase 14, the Paddle API from a user's script: returns each path's
    kernel counts (``api_train``, ``generate``) and K1's records at the
    decode shapes."""
    api_op_library()
    counts, _ = api_train(train_step_ms)
    gen = api_generate()
    decode = flash_decode_shapes()
    api_examples()
    return counts, gen, decode


# --------------------------------------------------------------------------
# phase 15: CUDA-graph capture (generate_compiled, to_static), amp in
# float16 with K1-K3's f16 instances, and recompute
def _profiled_device_ms(fn):
    """Device ms of one call of ``fn`` under ``torch.profiler`` (every
    kernel and copy it saw), or None where it saw none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(us for us, _, _ in device_rows(prof))
    return total / 1e3 if total else None


def _timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def _left_padded(prompts, S):
    ids = np.zeros((len(prompts), S), np.int64)
    mask = np.zeros((len(prompts), S), np.int64)
    for b, p in enumerate(prompts):
        ids[b, S - len(p):] = p
        mask[b, S - len(p):] = 1
    return ids, mask


def compiled_generate_run(gen):
    """15(a): ``generate_compiled`` at 14(c)'s width and prompts (bf16, 4 x
    512, 64 greedy tokens): one capture a signature (a second call
    replays), prefill and decode ms a token and the decode's busy share
    beside 14(c)'s eager ``generate`` (``gen``) from this call; a sampled
    run's tokens in the vocabulary. Then at 2 layers in f32: tokens equal
    the eager ``generate``'s, chunked prefill equals one-shot, and each
    row of a left-padded ragged batch equals its prompt's solo run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import cuda_graph
    cfg = llama_bench_config()
    B, P, N = 4, 512, 64
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, P))
    model = paddle.models.LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    model.eval()
    ids = paddle.to_tensor(prompt)
    c0 = cuda_graph.captures
    first_ms, first = _timed_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=N))
    c1 = cuda_graph.captures
    model.generate_compiled(ids, max_new_tokens=1)  # its own signature
    prefill_ms, _ = _timed_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=1))
    total_ms, out = _timed_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=N))
    captures = c1 - c0
    if captures != 1 or cuda_graph.captures != c1:
        raise AssertionError(f"generate_compiled: {captures} captures for "
                             f"one signature, {cuda_graph.captures - c1} "
                             f"on the calls after")
    tok = out.numpy()
    if type(out) is not paddle.Tensor or tok.shape != (B, P + N) or \
            not np.array_equal(tok, first.numpy()) or \
            not ((tok >= 0) & (tok < cfg.vocab_size)).all():
        raise AssertionError(f"generate_compiled: {type(out)} of "
                             f"{tok.shape}, replay equal to the capturing "
                             f"call: {np.array_equal(tok, first.numpy())}")
    decode_ms = (total_ms - prefill_ms) / (N - 1)
    dev_all = _profiled_device_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=N))
    dev_pre = _profiled_device_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=1))
    if dev_all is None or dev_pre is None:
        dev_ms = busy = None
        busy_txt = "busy share not measured (the profiler saw no device time)"
    else:
        dev_ms = (dev_all - dev_pre) / (N - 1)
        busy = dev_ms / decode_ms
        busy_txt = (f"{dev_ms:.3f} ms of device work a decode token, busy "
                    f"{100 * busy:.1f}%")
    eager_busy = gen["decode_dev_ms"] / gen["decode_ms"]
    log(f"generate_compiled (bf16, {cfg.num_hidden_layers} layers, batch "
        f"{B} x {P}-token prompts, {N} greedy tokens; the decode step one "
        f"CUDA graph replayed {N - 1} times): first call {first_ms:.3f} ms "
        f"(the capture; {captures} capture for the signature, 0 on the "
        f"calls after); prefill {prefill_ms:.3f} ms; {decode_ms:.3f} ms a "
        f"decode token; {total_ms:.3f} ms in all, "
        f"{B * N / (total_ms / 1e3):.1f} tokens/s; {busy_txt}")
    log(f"generate_compiled against 14(c)'s eager generate in this call: "
        f"decode {decode_ms:.3f} against {gen['decode_ms']:.3f} ms a token "
        f"({gen['decode_ms'] / decode_ms:.2f}x); busy "
        + (f"{100 * busy:.1f}%" if busy is not None else "not measured")
        + f" against {100 * eager_busy:.1f}%; prefill {prefill_ms:.3f} "
        f"against {gen['prefill_ms']:.3f} ms")
    paddle.seed(SEED)
    sampled = model.generate_compiled(ids[:, :128], max_new_tokens=16,
                                      temperature=1.0, top_k=50).numpy()
    new = sampled[:, 128:]
    if not ((new >= 0) & (new < cfg.vocab_size)).all():
        raise AssertionError("generate_compiled sampled: tokens out of the "
                             "vocabulary")
    log(f"generate_compiled sampled (temperature 1, top_k 50, 16 tokens, "
        f"the card's generator registered with the graph): in-vocabulary "
        f"tokens, row 0 {new[0].tolist()}")
    del model, out, first
    free_device_memory()
    # the f32 oracles at 2 layers
    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = paddle.models.LlamaForCausalLM(small, dtype="float32", seed=SEED)
    model.eval()
    ids = paddle.to_tensor(prompt[:, :64])
    eager = model.generate(ids, max_new_tokens=16, temperature=0).numpy()
    comp = model.generate_compiled(ids, max_new_tokens=16).numpy()
    chunked = model.generate_compiled(ids, max_new_tokens=16,
                                      prefill_chunk=16).numpy()
    if not np.array_equal(comp, eager) or not np.array_equal(chunked, comp):
        raise AssertionError("generate_compiled f32: tokens differ from the "
                             "eager generate's or chunked from one-shot")
    lens = (64, 40, 17, 5)
    prompts = [prompt[b, :n] for b, n in enumerate(lens)]
    pad, mask = _left_padded(prompts, 64)
    rag = model.generate_compiled(paddle.to_tensor(pad), max_new_tokens=16,
                                  attention_mask=paddle.to_tensor(mask))
    rag = rag.numpy()
    for b, p in enumerate(prompts):
        solo = model.generate_compiled(paddle.to_tensor(p[None]),
                                       max_new_tokens=16).numpy()
        if not np.array_equal(rag[b, 64:], solo[0, len(p):]):
            raise AssertionError(f"generate_compiled ragged: row {b} "
                                 f"(prompt {len(p)}) is not its solo run")
    log(f"generate_compiled f32 (2 layers, batch 4 x 64, 16 greedy tokens):"
        f" tokens equal the eager generate's; prefill in chunks of 16 "
        f"equals one-shot; a left-padded batch of prompts {list(lens)} "
        f"gives each row its solo run")
    del model
    free_device_memory()
    return dict(decode_ms=decode_ms, prefill_ms=prefill_ms, busy=busy,
                captures=captures)


def to_static_run():
    """15(b): ``paddle.jit.to_static`` of the bench model's eval forward
    (bf16, 4 x 512 ids): the capturing call and a replay against the
    eager logits at bf16 tolerance; K1 8 launches a replay; a parameter
    update between calls seen without a new capture; replay and eager
    forward ms. Returns the path's kernel counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    cfg = llama_bench_config()
    L = cfg.num_hidden_layers
    model = paddle.models.LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    model.eval()
    x = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (4, 512))).cuda()
    with torch.no_grad():
        eager = model(x)
    sm = paddle.jit.to_static(model)
    _reset_flash_counts()
    c0 = cuda_graph.captures
    first = sm(x)
    k1 = fa.launches_fwd
    replay = sm(x)
    per_replay = fa.launches_fwd - k1
    tol = FLASH_TOL[torch.bfloat16][0]
    err = max(_check("to_static capturing call", first, eager, *tol),
              _check("to_static replay", replay, eager, *tol))
    if per_replay != L or cuda_graph.captures != c0 + 1:
        raise AssertionError(f"to_static: K1 {per_replay} launches a "
                             f"replay (want {L}), "
                             f"{cuda_graph.captures - c0} captures")
    # the eager forwards (timed, and the oracle after the update) are
    # not to_static's: its count holds the capturing call's warm-up run,
    # and 8 a replay
    with torch.no_grad():
        eager_ms = _uncounted_flash(lambda: cuda_ms(lambda: model(x),
                                                    reps=10))
    replay_ms = cuda_ms(lambda: sm(x), reps=10)
    with torch.no_grad():
        model.model.norm.weight.mul_(1.5)
        updated = _uncounted_flash(lambda: model(x))
    err_u = _check("to_static after a parameter update", sm(x), updated,
                   *tol)
    if cuda_graph.captures != c0 + 1 or len(sm.code_cache) != 1:
        raise AssertionError("to_static: a parameter update captured again")
    calls = 1 + 1 + 13 + 1  # capturing call, replay, 3 + 10 timed, update
    if fa.launches_fwd != calls * L:
        raise AssertionError(f"to_static: K1 {fa.launches_fwd} launches "
                             f"over {calls} calls (want {calls * L})")
    log(f"to_static (bench model eval forward, bf16, 4 x 512 ids): the "
        f"capturing call and replays equal the eager logits (max|err| "
        f"{err:.3e}, after a parameter update {err_u:.3e}; atol/rtol "
        f"{tol}); K1 {per_replay} launches a replay, {fa.launches_fwd} "
        f"over the path's {calls} calls; one capture, one "
        f"cache entry; replay {replay_ms:.3f} ms against the eager "
        f"forward's {eager_ms:.3f} ms ({eager_ms / replay_ms:.2f}x)")
    counts = {**_flash_counts(), "fused_adam_update": 0, "fused_sqnorm": 0}
    del model, sm, eager, first, replay, updated
    free_device_memory()
    return counts


def amp_run():
    """15(c): the bench model with f32 weights under
    ``auto_cast(dtype="float16")`` O1 and a ``GradScaler`` (AdamW, 2 + 10
    steps of 4 x 2048 ids): finite losses that fall, the found-inf steps
    counted, K1-K3 8 a step and every launch in float16; then one O2 step
    of a ``decorate``d bf16 model. Returns the O1 run's kernel counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    cfg = llama_bench_config()
    L = cfg.num_hidden_layers
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 2048))).cuda()
    seen = {}
    orig = {n: getattr(fa, n) for n in ("flash_attention_fwd",
                                        "flash_attention_dq",
                                        "flash_attention_dkv")}

    def recording(name):
        def call(q, *a, **kw):
            seen.setdefault(name, set()).add(q.dtype)
            return orig[name](q, *a, **kw)
        return call
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    model = paddle.models.LlamaForCausalLM(cfg, dtype="float32", seed=SEED)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    losses, skipped, scales = [], 0, []
    _reset_flash_counts()
    try:
        for n in orig:
            setattr(fa, n, recording(n))
        for i in range(12):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with paddle.amp.auto_cast(dtype="float16"):
                _, loss = model(x, labels=x)
            scaler.scale(loss).backward()
            scaler.step(opt)
            skipped += scaler._found_inf
            scaler.update()
            opt.clear_grad()
            scales.append(scaler.get_loss_scaling())
            losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / 10
    finally:
        for n, f in orig.items():
            setattr(fa, n, f)
    counts = {**_flash_counts(), "fused_adam_update": 0, "fused_sqnorm": 0}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"amp f16: losses {losses}")
    if any(seen.get(n) != {torch.float16} for n in orig) or \
            any(counts[n] != 12 * L for n in orig):
        raise AssertionError(f"amp f16: K1-K3 dtypes {seen}, launches "
                             f"{counts} (want float16, {12 * L} each)")
    log(f"amp O1 float16 (bench model, f32 weights, auto_cast white ops in "
        f"f16, GradScaler from 1024, AdamW, 4 x 2048 ids): losses "
        f"{[round(v, 4) for v in losses]}; {skipped} of 12 steps skipped "
        f"on a non-finite gradient (scale after each step {scales}); K1-K3 "
        f"{L} a step, every launch in float16; step {step_ms:.3f} ms "
        f"(eager loop: scale, backward, unscale, step); peak {peak} B")
    del model, opt, loss
    free_device_memory()
    model = paddle.models.LlamaForCausalLM(cfg, dtype="float32", seed=SEED)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        _, loss = model(x, labels=x)
    loss.backward()
    opt.step()
    w = model.model.layers[0].self_attn.q_proj.weight
    first = float(loss.detach())
    if w.dtype != torch.bfloat16 or not opt._multi_precision or \
            abs(first - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"amp O2: weight {w.dtype}, masters "
                             f"{opt._multi_precision}, loss {first}")
    log(f"amp O2 bfloat16 (decorate: weights cast to bf16, AdamW with f32 "
        f"masters): one step, loss {first:.4f} (ln V "
        f"{math.log(cfg.vocab_size):.4f})")
    del model, opt, loss, w
    free_device_memory()
    return counts


def recompute_run():
    """15(d): one fused ``TrainStep`` of the bench model (bf16, 4 x 2048)
    with and without ``cfg.recompute`` from the same weights and batch:
    the four losses and the first step's gradient norm equal at bf16
    tolerance; step ms (1 + 3 steps) and
    peak memory of each. Returns the recompute run's kernel counts."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    base = llama_bench_config()
    L = base.num_hidden_layers
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, base.vocab_size, (4, 2048))).cuda()
    runs = {}
    for rc in (False, True):
        free_device_memory()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = LlamaForCausalLM(dataclasses.replace(base, recompute=rc),
                                 dtype="bfloat16", seed=SEED)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, lambda m, v: m(v, labels=v)[1], opt)
        _reset_flash_counts()
        _reset_fused_counts()
        losses = [float(step(x))]
        gnorm = float(step.last_grad_norm)
        ms, out = _timed_ms(lambda: [step(x) for _ in range(3)])
        losses += [float(v) for v in out]
        runs[rc] = dict(losses=losses, gnorm=gnorm, step_ms=ms / 3,
                        peak=torch.cuda.max_memory_allocated() - before,
                        counts={**_flash_counts(), **_fused_counts()})
        del model, opt, step, out
    free_device_memory()
    a, b = runs[False], runs[True]
    want = {"flash_attention_fwd": 2 * 4 * L, "flash_attention_dq": 4 * L,
            "flash_attention_dkv": 4 * L}
    # the first loss is the forward's, which recompute leaves alone; the
    # first step's gradient norm and the losses after steps 1-3 (same
    # weights, same batch) are where a wrong re-run backward would show
    if not np.allclose(b["losses"], a["losses"], rtol=1e-3, atol=0) \
            or not np.isclose(b["gnorm"], a["gnorm"], rtol=1e-3, atol=0) \
            or any(b["counts"][k] != n for k, n in want.items()):
        raise AssertionError(f"recompute: losses {b['losses']} against "
                             f"{a['losses']}, first gradient norm "
                             f"{b['gnorm']} against {a['gnorm']}; launches "
                             f"{b['counts']} (want {want})")
    log(f"recompute (bench model, bf16, fused TrainStep, 4 x 2048): losses "
        f"{b['losses']} against {a['losses']} without, first step's "
        f"gradient norm {b['gnorm']:.6g} against {a['gnorm']:.6g} (rtol "
        f"1e-3); step "
        f"{b['step_ms']:.3f} against {a['step_ms']:.3f} ms "
        f"({b['step_ms'] / a['step_ms']:.3f}x); peak {b['peak']} against "
        f"{a['peak']} B ({b['peak'] / a['peak']:.3f}x); K1 {2 * L} a step "
        f"(each layer's forward runs again in the backward), K2 and K3 {L}")
    return b["counts"]


def phase_capture_amp_recompute(gen, flash_bf16):
    """Phase 15; returns each path's kernel counts and K1-K3's float16
    records at the training shape (timed beside phase 6's bf16 ones)."""
    compiled_generate_run(gen)
    static = to_static_run()
    amp = amp_run()
    f16 = flash_training_shape(torch.float16)
    log(f"flash float16 limits at the training shape, (atol, rtol) of "
        f"K1/K2/K3: {FLASH_TOL_F16}")
    for kname, rec in f16.items():
        log(f"flash float16 {kname} against bfloat16 in this call: "
            f"{rec['ms']:.4f} against {flash_bf16[kname]['ms']:.4f} ms "
            f"({rec['ms'] / flash_bf16[kname]['ms']:.3f}x), bound "
            f"{rec['bound_ms']:.4f} ms")
    free_device_memory()
    rc = recompute_run()
    return {"to_static": static, "amp_f16": amp, "recompute": rc}, f16


# --------------------------------------------------------------------------
def _tenant(stacks, seed, std=0.02):
    """A seeded LoRA tenant: N(0, std) rows for every A and B stack (B
    non-zero, so the tenant's delta is)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(v.shape[1:], generator=g, device="cuda",
                           dtype=torch.float32).mul_(std).to(v.dtype)
            for k, v in stacks.items()}


def int8_lora_costs(engine, model, cfg):
    """What phase 16(b)'s two plain-PyTorch stages cost a step, at its step
    shape (``step_tokens`` rows; the head at ``max_batch`` rows), device
    ms by CUDA events: one layer's seven quantized projections
    (dequantize + ``torch.matmul``, the engine's own forward) against
    ``torch.matmul`` over the same weights dequantized beforehand, and
    the LoRA hooks' per-token gather-and-einsum over slot ids 0-2, each
    scaled by the layer count, plus the head. Bound of a weight-only
    product: the int8 weights read once at the card's memory rate."""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.tuning import lora
    T, L = engine.step_tokens, cfg.num_hidden_layers
    layer = model.model.layers[0]
    projs = [getattr(layer.self_attn, n) for n in
             ("q_proj", "k_proj", "v_proj", "o_proj")] + \
        [getattr(layer.mlp, n) for n in ("gate_proj", "up_proj",
                                         "down_proj")]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.randn(T, p._wq.q.shape[0], generator=g, device="cuda",
                      dtype=torch.bfloat16) for p in projs]
    ws = [p._wq.dequantize() for p in projs]
    outs = [torch.zeros(T, p._wq.q.shape[1], device="cuda",
                        dtype=torch.bfloat16) for p in projs]
    ids = (torch.arange(T, device="cuda") % 3).to(torch.int32)
    hook = lora._make_hook(tuning.LoRAConfig().scaling)
    deq_ms = cuda_ms(lambda: [p.forward(x) for p, x in zip(projs, xs)])
    mm_ms = cuda_ms(lambda: [torch.matmul(x, w) for x, w in zip(xs, ws)])
    with lora.adapter_ids(ids):
        lora_ms = cuda_ms(lambda: [hook(p, (x,), o) for p, x, o in
                                   zip(projs, xs, outs)])
    head = model.lm_head
    x8 = torch.randn(engine.max_batch, cfg.hidden_size, generator=g,
                     device="cuda", dtype=torch.bfloat16)
    head_deq_ms = cuda_ms(lambda: head.forward(x8))
    w_head = head._wq.dequantize()
    head_mm_ms = cuda_ms(lambda: torch.matmul(x8, w_head))
    del ws, w_head
    qbytes = sum(leaf.nbytes for leaf in engine._qleaves.values())
    step = dict(deq=L * deq_ms + head_deq_ms, mm=L * mm_ms + head_mm_ms,
                lora=L * lora_ms,
                bound=1e3 * qbytes / HBM_BYTES_PER_S)
    log(f"quantized serving (b) costs a step ({T} rows, {L} layers): "
        f"dequantize + torch.matmul {step['deq']:.3f} ms against "
        f"torch.matmul over pre-dequantized bf16 weights {step['mm']:.3f} "
        f"ms (one layer {deq_ms:.4f} / {mm_ms:.4f} ms, head "
        f"{head_deq_ms:.4f} / {head_mm_ms:.4f} ms); a weight-only int8 "
        f"product's bound (the int8 weights read once) {step['bound']:.3f}"
        f" ms; the LoRA hooks' gather-and-einsum {step['lora']:.3f} ms "
        f"(one layer's seven {lora_ms:.4f} ms)")
    return step


def int8_kv_gather_cost(engine, cfg):
    """What phase 16(c)'s int8 gather read costs a step, device ms by CUDA
    events, one layer scaled by the layer count: its step geometry (a
    16-token prefill chunk at context 1024 and a decode row at 1087, of
    a sequence whose 68 pages the pools hold) through
    ``ragged_gather_attention`` with the scale pools, against K4's bf16
    kernel on the same pages dequantized to bf16, and the bound of
    reading the int8 pages and scales once."""
    from paddle_tpu_torch.ops.paged_attention import ragged_gather_attention
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        build_step_maps, ragged_paged_attention)
    c = engine.cache
    T, S, L = engine.step_tokens, engine.max_batch, cfg.num_hidden_layers
    n_heads, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.hidden_size // n_heads
    bt = np.zeros((S + 1, c.max_blocks_per_seq), np.int32)
    bt[0, :68] = bt[1, :68] = np.arange(1, 69)
    cu = np.zeros(S + 2, np.int32)
    cu[1:] = [16] + [17] * S
    ctx = np.zeros(S + 1, np.int32)
    ctx[:2] = (1024, 1087)
    sid = np.full(T, S, np.int32)
    sid[:16], sid[16] = 0, 1
    pos = np.zeros(T, np.int32)
    pos[:16], pos[16] = 1024 + np.arange(16), 1087
    ssq, sbk = build_step_maps(cu[:3], [1040, 1088], total_tokens=T,
                               tile_q=engine._tile_q, block_size=16,
                               max_steps=engine._max_steps, max_seqs=S)
    dev = {k: torch.from_numpy(v).cuda() for k, v in dict(
        bt=bt, cu=cu, ctx=ctx, sid=sid, pos=pos, ssq=ssq, sbk=sbk).items()}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(T, n_heads, hd, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp, ks, vs = c.k_pools[0], c.v_pools[0], c.k_scales[0], c.v_scales[0]
    gather_ms = cuda_ms(lambda: ragged_gather_attention(
        q, kp, vp, dev["bt"], dev["sid"], dev["pos"], scale=hd ** -0.5,
        k_scale=ks, v_scale=vs))
    kb = (kp.float() * ks[..., None]).bfloat16()
    vb = (vp.float() * vs[..., None]).bfloat16()
    rpa_ms = cuda_ms(lambda: ragged_paged_attention(
        q, kb, vb, dev["bt"], dev["cu"], dev["ctx"], dev["ssq"],
        dev["sbk"]))
    del kb, vb
    # both sequences read the same 68 pages: each page once per layer
    nbytes = 2 * 68 * 16 * n_kv * (hd + 4)
    step = dict(gather=L * gather_ms, rpa=L * rpa_ms,
                bound=1e3 * L * nbytes / HBM_BYTES_PER_S)
    log(f"quantized serving (c) cost a step ({T} rows, {L} layers): the "
        f"int8 gather read {step['gather']:.3f} ms (one layer "
        f"{gather_ms:.4f} ms) against K4's bf16 kernel on the same pages "
        f"{step['rpa']:.3f} ms; bound of reading the int8 pages and scales "
        f"once {step['bound']:.4f} ms")
    return step


def phase_quantized_serving(phase4_peak):
    """Phase 16: quantized, multi-tenant serving at Llama-3-8B widths (32
    layers, seeded random weights) behind ``ServingEngine`` and the HTTP
    ``Server``, phase 4's prompt lengths x 32 tokens. (a) float16 on K4's
    f16 instance; (b) bf16 with 4 LoRA slots (two loaded) under
    ``quantize="int8_wo"``, its window peak against phase 4's; (c) int8
    KV at the gather geometry, with a copy-on-write prefix hit; (d) the
    exactness oracles at 2 layers in f32. Returns K4's launches by path
    and the f16 engine step's max |err|."""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache

    cfg = LlamaConfig.llama3_8b()
    rng = np.random.RandomState(SEED + 16)
    new_tokens = 32
    geometry = dict(max_batch=8, block_size=16, prefill_chunk=512,
                    max_blocks=2048)

    # (a) float16 on the RPA path
    model = LlamaForCausalLM(cfg, dtype="float16", seed=SEED)
    engine = ServingEngine(model, **geometry)
    wa = serve_window(engine, cfg, _phase4_prompts(cfg, rng), new_tokens,
                      during=lambda e: engine_step_check(
                          e, cfg, rng, torch.float16))
    if wa["launches_f16"] != wa["launches"]:
        raise AssertionError(f"f16 engine: {wa['launches_f16']} of "
                             f"{wa['launches']} RPA launches in float16")
    log(_window_line("quantized serving (a) float16", wa, 8, new_tokens)
        + f"; K4 float16 launches {wa['launches_f16']} (= "
        f"{cfg.num_hidden_layers} x steps)")
    del engine, model
    free_device_memory()

    # (b) int8 weights under 4 LoRA slots, two tenants loaded
    model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    tuning.apply_lora(model, tuning.LoRAConfig(), n_slots=4)
    t0 = time.perf_counter()
    engine = ServingEngine(model, quantize="int8_wo", **geometry)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qbytes = sum(leaf.nbytes for leaf in engine._qleaves.values())
    held = torch.cuda.memory_allocated()
    stacks = {k: v for k, v in model.named_parameters() if "lora_" in k}
    for slot in (1, 2):
        engine.load_adapter(slot, _tenant(stacks, SEED + slot),
                            name=f"tenant-{slot}")
    ids = [0, 1, 2, 0, 1, 2, 1, 2]
    wb = serve_window(engine, cfg, _phase4_prompts(cfg, rng), new_tokens,
                      adapter_ids=ids)
    st = engine.stats()
    if st["weight_dtype"] != "int8" or st["adapters"]["loaded"] != 2:
        raise AssertionError(f"int8 + LoRA engine stats {st}")
    saved = phase4_peak - wb["peak"]
    log(_window_line("quantized serving (b) int8_wo + 4 LoRA slots", wb, 8,
                     new_tokens)
        + f"; adapter ids {ids}; {len(engine._qleaves)} quantized leaves, "
        f"{qbytes} B of int8 values + scales (quantized at construction "
        f"in {build_s:.2f} s); {held} B held after construction; window "
        f"peak {wb['peak']} B against phase 4's bf16 {phase4_peak} B: "
        f"{saved} B less")
    if saved < 6e9:
        raise AssertionError(f"the int8 + LoRA engine's window peak is only "
                             f"{saved} B below phase 4's (want >= 6 GB)")
    int8_lora_costs(engine, model, cfg)
    del engine, model, stacks
    free_device_memory()

    # (c) int8 KV at the gather geometry, a copy-on-write prefix hit
    model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    kv_geom = dict(max_batch=8, block_size=16, prefill_chunk=16,
                   max_blocks=2048, max_blocks_per_seq=72)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine = ServingEngine(model, kv_dtype="int8", **kv_geom)
    if engine.attn_impl != "gather" or not any(
            issubclass(w.category, RuntimeWarning) for w in caught):
        raise AssertionError("int8 KV did not pin the gather path loudly")
    copies = []
    copy_block = engine.cache.copy_block

    def counted(src, dst):
        copies.append((src, dst))
        copy_block(src, dst)
    engine.cache.copy_block = counted
    prefix = rng.randint(1, cfg.vocab_size, 1024).tolist()
    w1 = serve_window(engine, cfg,
                      [prefix + rng.randint(1, cfg.vocab_size, 64).tolist()],
                      new_tokens)
    w2 = serve_window(engine, cfg, [list(prefix)], new_tokens)
    pc = engine.stats()["prefix_cache"]
    if not copies or pc["hits"] < 1:
        raise AssertionError(f"no copy-on-write prefix hit: copies {copies},"
                             f" prefix cache {pc}")
    kv_bytes = engine.cache.pool_bytes()
    scale_bytes = sum(t.numel() * t.element_size() for t in
                      engine.cache.k_scales + engine.cache.v_scales)
    int8_kv_gather_cost(engine, cfg)
    del engine
    free_device_memory()
    ref = PagedKVCache(cfg.num_hidden_layers, kv_geom["max_blocks"], 16,
                       cfg.num_key_value_heads, cfg.hidden_size //
                       cfg.num_attention_heads, 72, dtype=torch.bfloat16)
    bf16_bytes = ref.pool_bytes()
    del ref
    log(f"quantized serving (c) int8 KV, gather read (prefill_chunk 16, "
        f"max_blocks_per_seq 72): a 1088-token request then its 1024-token"
        f" prefix alone (a fully cached prompt: {len(copies)} copy-on-write "
        f"block copy, prefix cache {pc}), 32 tokens each, all returned, "
        f"logits finite; {w1['steps']} + {w2['steps']} steps, mean step "
        f"{w1['mean_step_ms']:.3f} / {w2['mean_step_ms']:.3f} ms; pools "
        f"{kv_bytes} B ({scale_bytes} B of them scales) against {bf16_bytes}"
        f" B for a bf16 cache of the same geometry: "
        f"{kv_bytes / bf16_bytes:.4f}x")
    if not kv_bytes / bf16_bytes < 0.55:
        raise AssertionError("the int8 KV pools are not about half the bf16 "
                             "cache's")
    del model
    free_device_memory()

    quantized_serving_exactness()
    return {"serving_f16": wa["launches"],
            "serving_int8_lora": wb["launches"]}, wa["extra"]


def quantized_serving_exactness():
    """Phase 16(d), full width, 2 layers, float32 (phase 5's pattern; one
    model per engine, each built from the same seed): the ``int8_wo``
    engine on RPA and on gather give identical greedy streams, equal to
    the eager ``generate`` of the model with its projection weights
    replaced by their dequantized values; a LoRA tenant slot's streams
    equal the eager ``generate`` of the model with that adapter merged (W
    + A B scaling), and slot 0's a no-LoRA engine's; an ``fp8_wo`` engine
    serves a request with finite logits."""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization.weight_only import (QuantizedLeaf,
                                                           quantize_state)
    from paddle_tpu_torch.serving import ServingEngine

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2)
    rng = np.random.RandomState(SEED + 161)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (100, 300, 600, 900)]
    kw = dict(max_batch=4, block_size=16, prefill_chunk=64, max_blocks=256,
              max_blocks_per_seq=64)
    n_new = 16

    def fresh():
        free_device_memory()
        return LlamaForCausalLM(cfg, dtype="float32", seed=SEED + 1)

    def served(model, **ekw):
        return ServingEngine(model, **kw, **ekw)

    def streams(eng, jobs):
        hs = [eng.submit(p, max_new_tokens=n_new, adapter_id=a)
              for p, a in jobs]
        eng.run_until_idle()
        out = [h.result(60)["token_ids"] for h in hs]
        eng.cache.allocator.assert_no_leaks()
        return out

    def eager(model):
        return [model.generate(torch.tensor([p], device="cuda"),
                               max_new_tokens=n_new, temperature=0.0)[
                                   0, len(p):].tolist() for p in prompts]

    base_jobs = [(p, 0) for p in prompts]
    s_rpa = streams(served(fresh(), quantize="int8_wo"), base_jobs)
    s_gather = streams(served(fresh(), quantize="int8_wo",
                              attn_impl="gather"), base_jobs)
    if s_rpa != s_gather:
        raise AssertionError(f"int8_wo rpa and gather streams differ: "
                             f"{s_rpa} / {s_gather}")
    model = fresh()
    with torch.no_grad():
        params = dict(model.named_parameters())
        for k, leaf in quantize_state(params, "int8_wo").items():
            if isinstance(leaf, QuantizedLeaf):
                params[k].copy_(leaf.dequantize())
        del params
    s_deq = eager(model)
    if s_rpa != s_deq:
        raise AssertionError(f"int8_wo engine {s_rpa} != eager generate over "
                             f"the dequantized weights {s_deq}")
    del model

    model = fresh()
    lcfg = tuning.LoRAConfig()
    tuning.apply_lora(model, lcfg, n_slots=2)
    stacks = {k: v for k, v in model.named_parameters() if "lora_" in k}
    tenant = _tenant(stacks, SEED + 7)
    eng = served(model)
    eng.load_adapter(1, tenant, name="tenant")
    s_lora = streams(eng, base_jobs + [(p, 1) for p in prompts])
    del eng, model, stacks
    s_plain = streams(served(fresh()), base_jobs)
    model = fresh()
    with torch.no_grad():
        for name, sub in model.named_sublayers():
            if name.rsplit(".", 1)[-1] in lcfg.target_modules:
                sub.weight.add_(tenant[f"{name}.lora_A"]
                                @ tenant[f"{name}.lora_B"] * lcfg.scaling)
    s_merged = eager(model)
    del model
    if s_lora[:len(prompts)] != s_plain:
        raise AssertionError(f"slot 0 {s_lora[:len(prompts)]} != the no-LoRA "
                             f"engine {s_plain}")
    if s_lora[len(prompts):] != s_merged:
        raise AssertionError(f"slot 1 {s_lora[len(prompts):]} != eager "
                             f"generate with the adapter merged {s_merged}")
    if s_merged == s_plain:
        raise AssertionError("the tenant's adapter changed no stream")

    model = fresh()
    eng = served(model, quantize="fp8_wo")
    finite = []
    orig = eng._project

    def checked(h):
        logits = orig(h)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits
    eng._project = checked
    out = streams(eng, base_jobs[:1])[0]
    if len(out) != n_new or not all(finite):
        raise AssertionError(f"fp8_wo engine: {out}, finite {finite}")
    del eng, model
    free_device_memory()
    log(f"quantized serving (d), full width, 2 layers, float32: the int8_wo "
        f"engine on RPA and on gather agree on {len(prompts)} greedy streams"
        f" of {n_new} tokens, equal to eager generate over the dequantized "
        f"weights; LoRA slot 1's streams equal eager generate with the "
        f"adapter merged (W + A B x {lcfg.scaling}), slot 0's a no-LoRA "
        f"engine's, and differ from them; an fp8_wo engine served "
        f"{n_new} tokens with finite logits ({len(finite)} steps)")


# --------------------------------------------------------------------------
# phase 17: MoE serving and decoding, the autotuner, paddle.incubate
def _moe_recorder(model, engine):
    """Wrap every routed layer's forward for a serving window: each call
    records the engine step it ran in, the layer, its capacity, and (as
    device tensors, read after the window) its dropped assignments and
    live tokens. Returns the records and the function that unwraps."""
    from paddle_tpu_torch.distributed.fleet import MoELayer
    records, wrapped = [], []
    for i, layer in enumerate(model.layers):
        mlp = layer.mlp
        if not isinstance(mlp, MoELayer):
            continue

        def forward(x, token_mask=None, _i=i, _mlp=mlp,
                    _orig=mlp.forward):
            out = _orig(x, token_mask=token_mask)
            live = token_mask.sum() if token_mask is not None else None
            records.append((engine.steps, _i, _mlp.last_capacity,
                            _mlp.last_dropped, live))
            return out
        mlp.forward = forward
        wrapped.append(mlp)

    def unwrap():
        for mlp in wrapped:
            del mlp.forward
    return records, unwrap


def moe_serving(model, cfg):
    """17(a): DeepSeekMoE-16B behind the HTTP server with phase 4's
    prompts and geometry, then K4 at this model's heads on phase 3's mix.
    Returns the window's K4 launches and the kernel record."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)
    from paddle_tpu_torch.serving import ServingEngine
    engine = ServingEngine(model, max_batch=8, block_size=16,
                           prefill_chunk=512, max_blocks=2048)
    rng = np.random.RandomState(SEED + 17)
    prompts = _phase4_prompts(cfg, rng)
    new_tokens = 32
    records, unwrap = _moe_recorder(model, engine)
    steps0 = engine.steps

    def during(eng):
        plain, profiled = ([rng.randint(1, cfg.vocab_size, n).tolist()
                            for n in (256, 512, 1024, 2048)]
                           for _ in range(2))
        profile_window(eng, plain, profiled, new_tokens)
        return engine_step_check(eng, cfg, rng)

    try:
        w = serve_window(engine, cfg, prompts, new_tokens, during=during)
    finally:
        unwrap()
    if model.aux_loss() is not None:
        raise AssertionError("moe serving: aux_loss() is not None after "
                             "the engine's steps")
    if engine.stats()["kv_blocks_in_use"]:
        raise AssertionError("moe serving: KV blocks left in use")
    log(_window_line("moe serving (DeepSeekMoE-16B, bf16)", w, len(prompts),
                     new_tokens) + f"; decode tokens/s (generated tokens / "
        f"wall) {len(prompts) * new_tokens / w['wall']:.2f}; "
        f"{cfg.num_hidden_layers} x {w['steps']} steps = "
        f"{cfg.num_hidden_layers * w['steps']} K4 launches; prefix cache "
        f"{w['health']['prefix_cache']}; aux_loss() None, no KV block "
        f"leaked")
    window = [r for r in records if steps0 <= r[0] < steps0 + w["steps"]]
    live = {}
    for step, _, _, _, n in window:
        live.setdefault(step, int(n))
    busiest = max(live, key=live.get)
    per_layer = [(i, c, int(d)) for st, i, c, d, _ in window
                 if st == busiest]
    log(f"moe serving: the window's busiest step ({live[busiest]} live of "
        f"{engine.step_tokens} step tokens): capacity and dropped "
        f"assignments by MoE layer " + ", ".join(
            f"{i}: C {c} dropped {d}" for i, c, d in per_layer)
        + f"; {sum(d for _, _, d in per_layer)} of "
        f"{live[busiest] * cfg.num_experts_per_tok * len(per_layer)} "
        f"assignments dropped in that step")
    del engine
    free_device_memory()
    args, valid, need = rpa_mix(torch.bfloat16, n_heads=16, n_kv=16)
    out = ragged_paged_attention(**args)
    ref = ragged_paged_attention_reference(**args)
    err = _rpa_check("bfloat16, DeepSeekMoE-16B heads", out, ref, valid,
                     RPA_TOL[torch.bfloat16])
    ms = cuda_ms(lambda: ragged_paged_attention(**args))
    plain_ms = cuda_ms(lambda: ragged_paged_attention_reference(**args))
    log(f"rpa bfloat16 at DeepSeekMoE-16B's heads (16 query and 16 KV "
        f"heads, group 1, hd 128; phase 3's mix, tile_q 8): T={need['T']} "
        f"live pages={need['pages']} max|err|={err:.3e} (atol "
        f"{RPA_TOL[torch.bfloat16]}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {need['bound_ms']:.4f} ms "
        f"({need['bound_by']}: {need['bytes']} B, {need['flops']} flop)")
    return w["launches"], dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=need["bound_ms"],
                               bound_by=need["bound_by"],
                               engine_step_max_abs_err=w["extra"],
                               launches=w["launches"])


def moe_decoding(model, cfg):
    """17(b): eager ``generate`` (4 x 512, 64 greedy tokens) on K1, then
    ``generate_compiled`` on the same prompts: one capture a signature,
    the replay equal to the capturing call, ms a token and busy share.
    Returns the eager run's launch counts."""
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    B, P, N = 4, 512, 64
    L = cfg.num_hidden_layers
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, P))
    ids = torch.as_tensor(prompt, device="cuda")
    _uncounted_flash(lambda: model.generate(ids, max_new_tokens=2,
                                            temperature=0))
    prefill_ms, _ = _uncounted_flash(lambda: _timed_ms(
        lambda: model.generate(ids, max_new_tokens=1, temperature=0)))
    _reset_flash_counts()
    _reset_fused_counts()
    total_ms, out = _timed_ms(
        lambda: model.generate(ids, max_new_tokens=N, temperature=0))
    counts = {**_flash_counts(), **_fused_counts()}
    if counts["flash_attention_fwd"] != L * N or fa.launches_dq or \
            fa.launches_dkv or tuple(out.shape) != (B, P + N):
        raise AssertionError(f"moe generate: K1 {counts} (want {L} x {N}),"
                             f" {tuple(out.shape)}")
    aux = model.aux_loss()  # the last decode step's, as the reference's
    if aux is None or not bool(torch.isfinite(aux)):
        raise AssertionError(f"moe generate: aux_loss() {aux} after the "
                             f"eager generate, want the last step's")
    decode_ms = (total_ms - prefill_ms) / (N - 1)
    log(f"moe generate (DeepSeekMoE-16B, bf16, batch {B} x {P}-token "
        f"prompts, {N} greedy tokens): prefill {prefill_ms:.3f} ms; "
        f"{decode_ms:.3f} ms a decode token; {total_ms:.3f} ms in all, "
        f"{B * N / (total_ms / 1e3):.1f} tokens/s; K1 launched "
        f"{counts['flash_attention_fwd']} times = {L} x (1 + {N - 1}); "
        f"aux_loss() {float(aux):.4f} (the last decode step's)")
    c0 = cuda_graph.captures
    first_ms, first = _timed_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=N))
    c1 = cuda_graph.captures
    model.generate_compiled(ids, max_new_tokens=1)
    cprefill_ms, _ = _timed_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=1))
    ctotal_ms, comp = _timed_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=N))
    if c1 - c0 != 1 or cuda_graph.captures != c1 or \
            not torch.equal(comp, first) or model.aux_loss() is not None:
        raise AssertionError(
            f"moe generate_compiled: {c1 - c0} captures for the signature,"
            f" {cuda_graph.captures - c1} after; replay equal to the "
            f"capturing call: "
            f"{torch.equal(comp, first)}")
    cdecode_ms = (ctotal_ms - cprefill_ms) / (N - 1)
    dev_all = _profiled_device_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=N))
    dev_pre = _profiled_device_ms(
        lambda: model.generate_compiled(ids, max_new_tokens=1))
    busy_txt = "busy share not measured (the profiler saw no device time)"
    if dev_all is not None and dev_pre is not None:
        dev_ms = (dev_all - dev_pre) / (N - 1)
        busy_txt = (f"{dev_ms:.3f} ms of device work a decode token, busy "
                    f"{100 * dev_ms / cdecode_ms:.1f}%")
    same = int((comp[:, P:] == out[:, P:]).all(1).sum())
    log(f"moe generate_compiled (same prompts; the decode step one CUDA "
        f"graph replayed {N - 1} times): first call {first_ms:.3f} ms (1 "
        f"capture for the signature), prefill {cprefill_ms:.3f} ms, "
        f"{cdecode_ms:.3f} ms a decode token ({decode_ms / cdecode_ms:.2f}x"
        f" faster than eager), {B * N / (ctotal_ms / 1e3):.1f} tokens/s; "
        f"{busy_txt}; the replay equals the capturing call; {same} of {B} "
        f"rows equal the eager generate's in bf16")
    return counts


def moe_exactness():
    """17(c): DeepSeekMoE-16B's widths at 2 layers in f32: the ``rpa``
    engine's greedy streams equal the gather engine's, ``generate_compiled``
    equals eager ``generate``, and one request gets the same tokens in a
    1-slot and a 4-slot engine."""
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    cfg = MoeConfig.deepseek_moe_16b(num_hidden_layers=2)
    model = MoeForCausalLM(cfg, dtype="float32", seed=SEED + 1).eval()
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (100, 300, 600, 900)]
    kw = dict(block_size=16, prefill_chunk=64, max_blocks=256,
              max_blocks_per_seq=64)

    def streams(jobs, **extra):
        eng = ServingEngine(model, **dict(kw, **extra))
        hs = [eng.submit(p, max_new_tokens=16) for p in jobs]
        eng.run_until_idle()
        eng.cache.allocator.assert_no_leaks()
        return [h.result(60)["token_ids"] for h in hs]
    got = {impl: streams(prompts, max_batch=4, attn_impl=impl)
           for impl in ("rpa", "gather")}
    if got["rpa"] != got["gather"]:
        raise AssertionError(f"moe f32: kernel and gather streams differ: "
                             f"{got}")
    slots = [streams([prompts[1]], max_batch=mb)[0] for mb in (1, 4)]
    if slots[0] != slots[1]:
        raise AssertionError(f"moe f32: 1-slot and 4-slot engines differ: "
                             f"{slots}")
    ids = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (4, 64)), device="cuda")
    eager = _uncounted_flash(lambda: model.generate(ids, max_new_tokens=16,
                                                    temperature=0))
    comp = model.generate_compiled(ids, max_new_tokens=16)
    if not torch.equal(eager, comp) or model.aux_loss() is not None:
        raise AssertionError("moe f32: generate_compiled differs from the "
                             "eager generate")
    log("moe f32 (DeepSeekMoE-16B widths, 2 layers): kernel and gather "
        "engines agree on 4 greedy streams of 16 tokens; one request gets "
        "the same 16 tokens in a 1-slot and a 4-slot engine; "
        "generate_compiled equals the eager generate (4 x 64, 16 tokens)")
    del model
    free_device_memory()


def moe_autotune(model, cfg, llama_sweep):
    """17(d): the engine q tile's sweep on this model (the autotuner off,
    the tile set by hand as phase 4's), then with ``FLAGS_use_autotune``
    on: ``rpa_tile_q``'s pick for this engine's signature and phase 4's,
    beside the sweeps; a second engine of the same signature a cache hit;
    ``_auto_chunks``' pick at phase 7's fused cross entropy."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.ops import fused_ce
    from paddle_tpu_torch.ops.pallas import autotune as at
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import \
        rpa_tile_q
    from paddle_tpu_torch.serving import ServingEngine
    moe_sweep = serving_tile_sweep(model, cfg, "moe serving")
    cache = at.AutoTuneCache.instance()
    cache.clear()
    set_flags({"FLAGS_use_autotune": True})
    try:
        t0 = time.perf_counter()
        picks = {}
        for what, heads, kv in (("moe", 16, 16), ("llama", 32, 8)):
            picks[what] = rpa_tile_q(520, heads, kv, 128, 16, 512, 2048,
                                     dtype="bfloat16")
        sweep_s = time.perf_counter() - t0
        stats0 = cache.stats()
        engines = [ServingEngine(model, max_batch=8, block_size=16,
                                 prefill_chunk=512, max_blocks=2048)
                   for _ in range(2)]
        tiles = [e._tile_q for e in engines]
        del engines
        free_device_memory()
        stats = cache.stats()
        bench = llama_bench_config()
        T, V, d = 4 * 2047, bench.vocab_size, bench.hidden_size
        t0 = time.perf_counter()
        chunks = fused_ce._auto_chunks(T, V, d, torch.bfloat16, "cuda")
        chunks_s = time.perf_counter() - t0
    finally:
        set_flags({"FLAGS_use_autotune": False})
    if tiles != [picks["moe"]] * 2 or stats["hits"] - stats0["hits"] != 2:
        raise AssertionError(f"autotune: engine tiles {tiles} against the "
                             f"pick {picks['moe']}, cache {stats}")

    def mean_by_tile(res):
        return {t: statistics.mean(ms for tt, _, ms, _ in res if tt == t)
                for t in RPA_TILES}
    for what, sweep in (("moe", moe_sweep), ("llama", llama_sweep)):
        by = mean_by_tile(sweep)
        best = min(by, key=by.get)
        log(f"autotune ({what} engine signature): rpa_tile_q picks "
            f"tile_q {picks[what]} (the kernel alone on the reference's "
            f"synthetic mix); the engine-step sweep's mean step by tile "
            + ", ".join(f"{t}: {ms:.3f} ms" for t, ms in by.items())
            + f" -> fastest engine step at tile_q {best}")
    log(f"autotune: both sweeps {sweep_s:.2f} s; two engines of the MoE "
        f"signature took tile_q {tiles} from the cache (hits "
        f"{stats['hits']}, misses {stats['misses']}, {stats['size']} "
        f"entries); _auto_chunks at phase 7's fused cross entropy (T {T}, "
        f"V {V}, d {d}, bf16) picks {chunks} chunks of 4, 8, 16, 32 in "
        f"{chunks_s:.2f} s")
    return dict(picks=picks, chunks=chunks)


def incubate_train_flops_per_step(L, B, S, d, ffn):
    """6 x matmul parameters a token, plus attention's 12 * B * S^2 * d a
    layer (forward and backward)."""
    params = L * (4 * d * d + 2 * d * ffn)
    return 6 * params * B * S + 12 * L * B * S * S * d


def incubate_checks():
    """17(e), the CPU counterparts: small f32 modules on the card against
    the same modules on the CPU with the same weights and inputs."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate import autograd as iag
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.incubate import optimizer as iopt
    attn_tol, grad_tol = FLASH_TOL[torch.float32]
    g = np.random.RandomState(SEED + 17)

    def twin(make):
        cpu = make("cpu")
        card = make("cuda")
        card.set_state_dict(cpu.state_dict())
        return cpu, card

    def both(fn, *arrays):
        return [fn(*[torch.as_tensor(a, device=dev) for a in arrays])
                for dev in ("cpu", "cuda")]

    def check(what, got, want, tol):
        return _check(what, got.detach().cpu(), want.detach(), *tol)

    errs = {}
    mt = twin(lambda dev: inn.FusedMultiTransformer(
        64, 4, 128, num_layers=2, device=dev))
    x = g.randn(2, 64, 64).astype(np.float32)
    mask = np.where(g.rand(2, 1, 64, 64) < 0.2, -1e9, 0.0).astype(np.float32)
    mask[..., 0] = 0.0
    with torch.no_grad():
        want, got = [m(torch.as_tensor(x, device=d),
                       attn_mask=torch.as_tensor(mask, device=d))
                     for m, d in zip(mt, ("cpu", "cuda"))]
    errs["FusedMultiTransformer"] = check("FusedMultiTransformer", got,
                                          want, attn_tol)
    moe = twin(lambda dev: inn.FusedEcMoe(64, 128, 8, device=dev))
    gate = g.randn(2, 64, 8).astype(np.float32)
    with torch.no_grad():
        want, got = [m(torch.as_tensor(x, device=d),
                       torch.as_tensor(gate, device=d))
                     for m, d in zip(moe, ("cpu", "cuda"))]
    errs["FusedEcMoe"] = check("FusedEcMoe (caller logits)", got, want,
                               (1e-5, 1e-4))
    q, k, v = (g.randn(2, 64, 4, 64).astype(np.float32) for _ in range(3))
    want, got = both(lambda a, b, c: inn.memory_efficient_attention(
        a, b, c, scale=0.05, training=False), q, k, v)
    errs["memory_efficient_attention"] = check(
        "memory_efficient_attention", got, want, attn_tol)
    # LookAhead over SGD and an EMA of the same weights, 4 steps
    stacks = twin(lambda dev: inn.FusedMultiTransformer(
        64, 4, 128, num_layers=2, device=dev))
    y = g.randn(2, 64, 64).astype(np.float32)
    shadows = []
    for m, dev in zip(stacks, ("cpu", "cuda")):
        la = iopt.LookAhead(ptt.optimizer.SGD(
            learning_rate=0.05, parameters=m.parameters()), alpha=0.5, k=2)
        ema = iopt.ExponentialMovingAverage(m.parameters(), decay=0.7)
        xx, yy = (torch.as_tensor(a, device=dev) for a in (x, y))
        for _ in range(4):
            loss = ((m(xx) - yy) ** 2).mean()
            loss.backward()
            la.step()
            la.clear_grad()
            ema.update()
        with ema.apply():
            shadows.append({n: p.detach().clone()
                            for n, p in m.named_parameters()})
    errs["LookAhead"] = max(check(f"LookAhead {n}", p, dict(
        stacks[0].named_parameters())[n], grad_tol)
        for n, p in stacks[1].named_parameters())
    errs["ExponentialMovingAverage"] = max(
        check(f"EMA {n}", shadows[1][n], shadows[0][n], grad_tol)
        for n in shadows[0])
    # one Jacobian and one Hessian
    W = g.randn(5, 3).astype(np.float32)
    xs = g.randn(3).astype(np.float32)
    for name, make in (
            ("Jacobian", lambda w, t: iag.Jacobian(
                lambda u: torch.tanh(w @ u), t)),
            ("Hessian", lambda w, t: iag.Hessian(
                lambda u: (torch.tanh(w @ u) ** 2).sum(), t))):
        want, got = both(lambda w, t: make(w, t)._compute(), W, xs)
        errs[name] = check(name, got, want, (1e-6, 1e-5))
    # ASP: prune to 2:4, one decorated SGD step, the pattern kept
    pruned = twin(lambda dev: inn.FusedMultiTransformer(
        64, 4, 128, num_layers=2, device=dev))
    for m, dev in zip(pruned, ("cpu", "cuda")):
        asp.prune_model(m, n=2, m=4)
        opt = asp.decorate(ptt.optimizer.SGD(
            learning_rate=0.05, parameters=m.parameters()))
        loss = m(torch.as_tensor(x, device=dev)).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    masks = asp.ASPHelper.masks_for(pruned[1])
    cpu_params = dict(pruned[0].named_parameters())
    for n, p in pruned[1].named_parameters():
        errs["asp"] = max(errs.get("asp", 0.0),
                          check(f"asp {n}", p, cpu_params[n], grad_tol))
        if n in masks and not asp.check_mask_1d(p, 2, 4):
            raise AssertionError(f"asp: {n} left 2:4 after the step")
    if not masks:
        raise AssertionError("asp: nothing pruned")
    log("incubate on the card against the same modules on the CPU (f32, "
        "same weights and inputs): max |err| " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items())
        + f"; {len(masks)} weights kept 2:4 through a decorated SGD step")


# phase 17's MoE depth: DeepSeekMoE-16B's 28 layers cut to 2 (a dense
# layer and an MoE layer) to keep phases 1-24 within the script's limit
# (14, then 8, before phase 24 came)
MOE_SERVING_LAYERS = 2


def phase_moe_and_incubate(llama_sweep):
    """Phase 17: MoE serving and decoding at DeepSeekMoE-16B's full width,
    the f32 equalities at 2 layers, the autotuner, and
    ``paddle.incubate``. Returns the launch counts of its paths and K4's
    record at the MoE geometry."""
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM
    cfg = MoeConfig.deepseek_moe_16b(num_hidden_layers=MOE_SERVING_LAYERS)
    free_device_memory()
    t0 = time.perf_counter()
    model = MoeForCausalLM(cfg, dtype="bfloat16", seed=SEED).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe: DeepSeekMoE-16B, {cfg.num_hidden_layers} of its 28 layers, "
        f"bf16, "
        f"{n_params} parameters ({2 * n_params} B) built in "
        f"{time.perf_counter() - t0:.2f} s")
    parts = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out
    rpa_launches, rpa_rec = timed("serving", moe_serving, model, cfg)
    generate_counts = timed("decoding", moe_decoding, model, cfg)
    autotune = timed("autotune", moe_autotune, model, cfg, llama_sweep)
    del model
    free_device_memory()
    timed("f32 equalities", moe_exactness)
    # (e) the fused encoder stack at ERNIE-base widths
    L, B, S, d, H, ffn = 12, 16, 512, 768, 12, 3072
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stack = inn.FusedMultiTransformer(d, H, ffn, dropout_rate=0.1,
                                      normalize_before=False, num_layers=L,
                                      dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(B, S, d, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    y = torch.randn(B, S, d, device="cuda", generator=gen,
                    dtype=torch.bfloat16)

    def loss_fn(m, x, y):
        return ((m(x).float() - y.float()) ** 2).mean()
    t = time.perf_counter()
    r = model_train_run(
        "incubate FusedMultiTransformer", stack, loss_fn, [x, y], 2, 5,
        incubate_train_flops_per_step(L, B, S, d, ffn), L, before,
        items=B * S, desc=f"{L} post-LN FusedTransformerEncoderLayers at "
        f"ERNIE-base widths (d {d}, {H} heads, FFN {ffn}, dropout 0.1), "
        f"{B} x {S} tokens, MSE to a seeded target")
    if not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"incubate: loss did not fall: {r['losses']}")
    del stack
    free_device_memory()
    parts["incubate training"] = time.perf_counter() - t
    timed("incubate checks", incubate_checks)
    free_device_memory()
    log("phase 17 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(moe_serving=rpa_launches, rpa_moe=rpa_rec,
                moe_generate=generate_counts,
                incubate={**r["flash"], **r["fused"]}, autotune=autotune)

# --------------------------------------------------------------------------
def export_llama():
    """18(a): Llama-3-8B's widths at 2 decoder layers (untied, float16,
    seeded, eval) through ``jit.save`` with ``InputSpec([None, 1024],
    "int32")``, then ``inference.Predictor`` on the card at batch 2 and
    batch 4 (the shared dynamic batch dim): logits within K1's float16
    limits of the eager forward, K1 two launches a run. Returns the
    path's launch counts and K1's export record."""
    import tempfile
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.jit import serialization
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    from paddle_tpu_torch.static import InputSpec
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2)
    L, S = cfg.num_hidden_layers, 1024
    model = LlamaForCausalLM(cfg, dtype="float16", seed=SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    spec = [InputSpec([None, S], "int32", "ids")]
    tmp = tempfile.mkdtemp(prefix="phase18_export_", dir=REPO_ROOT)
    path = os.path.join(tmp, "llama")
    try:
        # torch.export alone, on the same example inputs jit.save makes
        args, dyn = serialization._example_inputs(spec, "cuda")
        t = time.perf_counter()
        with torch.no_grad():
            torch.export.export(model, args, dynamic_shapes=dyn)
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        jit.save(model, path, input_spec=spec)
        save_s = time.perf_counter() - t
        sizes = {ext: os.path.getsize(path + ext)
                 for ext in (".pdmodel", ".pdiparams")}
        t = time.perf_counter()
        pred = Predictor(Config(path))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        gen = torch.Generator().manual_seed(SEED)
        _reset_flash_counts()
        runs, errs, tol = 0, {}, FLASH_TOL_F16[0]
        for b in (2, 4):
            ids = torch.randint(0, cfg.vocab_size, (b, S), generator=gen,
                                dtype=torch.int32)
            (logits,) = pred.run([ids.numpy()])
            runs += 1
            with torch.no_grad():
                eager = _uncounted_flash(lambda: model(ids.cuda()))
            errs[b] = _check(f"export: predictor logits at batch {b}",
                             torch.from_numpy(logits).cuda(), eager, *tol)
        if fa.launches_fwd != L * runs:
            raise AssertionError(f"export: K1 {fa.launches_fwd} launches "
                                 f"in {runs} runs, want {L} a run")
        ids_np = ids.numpy()
        reps = 5
        t = time.perf_counter()
        for _ in range(reps):
            pred.run([ids_np])
        run_ms = 1e3 * (time.perf_counter() - t) / reps
        ids_dev = ids.cuda()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: pred._module(ids_dev), reps=reps,
                             warmup=1)
        runs += reps + reps + 1
        counts = dict(_flash_counts(), fused_adam_update=0, fused_sqnorm=0)
        if counts["flash_attention_fwd"] != L * runs or \
                counts["flash_attention_dq"] or counts["flash_attention_dkv"]:
            raise AssertionError(f"export: launches {counts}, want K1 "
                                 f"{L} x {runs} runs and no K2/K3")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, pred
    free_device_memory()
    log(f"export (a): Llama-3-8B widths at {L} layers, untied, float16, "
        f"{n_params} parameters; torch.export {export_s:.2f} s, jit.save "
        f"{save_s:.2f} s (.pdmodel {sizes['.pdmodel']} B, .pdiparams "
        f"{sizes['.pdiparams']} B), Predictor load {load_s:.2f} s; logits "
        f"against the eager forward max|err| batch 2 {errs[2]:.3e}, batch "
        f"4 {errs[4]:.3e} (limit {tol}); K1 {L} launches a run, "
        f"{counts['flash_attention_fwd']} in {runs} runs; predictor "
        f"{run_ms:.3f} ms a run at batch 4 x {S} (ids in, float16 logits "
        f"out as numpy), the program's forward {fwd_ms:.3f} ms on the card "
        f"(CUDA events, logits left there)")
    return counts, dict(export_s=export_s, save_s=save_s, load_s=load_s,
                        pdmodel_bytes=sizes[".pdmodel"],
                        pdiparams_bytes=sizes[".pdiparams"],
                        predictor_ms=run_ms, forward_ms=fwd_ms,
                        max_abs_err=max(errs.values()))


def flash_export_shape():
    """K1 at 18(a)'s shape (batch 4 x 1024, 32/8 heads, hd 128, causal,
    float16) against its plain version at float16's limit, with the
    kernel's, plain and ``sdpa`` times and the bound."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    B, hq, hkv, S, hd = 4, 32, 8, 1024, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q4, k4, v4 = [torch.randn(B, h, S, hd, device="cuda",
                              dtype=torch.float16, generator=gen)
                  for h in (hq, hkv, hkv)]
    q, k, v, g, _ = fa._geometry(q4, k4, v4, True, None, None, None, None,
                                 0.0, None)
    o, lse = _uncounted_flash(lambda: fa.flash_attention_fwd(q, k, v, g))
    ro, rlse = fa._forward_plain(q, k, v, g)
    tol = FLASH_TOL_F16[0]
    err = max(_check("K1 export shape o", o, ro, *tol),
              _check("K1 export shape lse", lse, rlse, *tol))
    need = flash_need(q, k, g, 2, q.numel() * 2 + 4 * q.shape[0], 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        ms = _uncounted_flash(
            lambda: cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, g)))
        plain_ms = cuda_ms(lambda: fa._forward_plain(q, k, v, g))
        lib = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True,
                                   enable_gqa=True))
    log(f"flash export K1 (4 x {S}, GQA {hq}/{hkv}, hd {hd}, causal, f16): "
        f"max|err|={err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {need['bound_ms']:.4f} ms ({need['bound_by']}), library "
        f"{lib:.4f} ms (sdpa)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=need["bound_ms"], bound_by=need["bound_by"],
                library_ms=lib)


def stream_and_event():
    """18(c): a copy made on a ``paddle.device.cuda.Stream`` and ordered
    before the current stream by an ``Event`` reads back its values."""
    from paddle_tpu_torch.device import cuda as pcuda
    src = torch.arange(1 << 22, device="cuda", dtype=torch.float32)
    dst = torch.empty_like(src)
    side = pcuda.Stream(priority=1)
    done = pcuda.Event(enable_timing=True)
    start = pcuda.Event(enable_timing=True)
    side.wait_stream(pcuda.current_stream())
    with pcuda.stream_guard(side):
        start.record()
        dst.copy_(src * 3.0)
        side.record_event(done)
    pcuda.current_stream().wait_event(done)
    back = (dst - 1.0).cpu()  # on the current stream, after the event
    done.synchronize()
    if not done.query() or not torch.equal(back,
                                            src.cpu() * 3.0 - 1.0):
        raise AssertionError("stream/event: the copy on the side stream "
                             "did not read back")
    log(f"stream (c): a {src.numel() * 4} B copy on a side Stream (priority "
        f"1) ordered by an Event read back equal; {start.elapsed_time(done):.3f}"
        f" ms between its events")


def trainable_mask_on_the_card():
    """18(d): ``F.scaled_dot_product_attention`` with a float mask that
    requires grad (the composite route: no flash launch) in f32 on the
    card, its output and the gradients of q, k, v and the mask against
    the CPU's; a constant mask on the same inputs launches K1."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    gen = torch.Generator().manual_seed(SEED)
    shapes = [(2, 128, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64),
              (1, 8, 128, 128)]
    cpu = [torch.randn(*sh, generator=gen) for sh in shapes]
    outs = {}
    before = fa.launches_fwd
    for dev in ("cpu", "cuda"):
        q, k, v, m = [x.detach().clone().to(dev).requires_grad_()
                      for x in cpu]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           is_causal=True)
        torch.sin(o).sum().backward()
        outs[dev] = [o, q.grad, k.grad, v.grad, m.grad]
    if fa.launches_fwd != before:
        raise AssertionError("trainable mask: the composite launched K1")
    (o_tol, g_tol), err = FLASH_TOL[torch.float32], 0.0
    for name, a, b in zip(("o", "dq", "dk", "dv", "dmask"), outs["cuda"],
                          outs["cpu"]):
        err = max(err, _check(f"trainable mask {name}", a.cpu(), b,
                              *(o_tol if name == "o" else g_tol)))
    with torch.no_grad():
        const = _uncounted_flash(lambda: F.scaled_dot_product_attention(
            *[x.cuda() for x in cpu[:3]], attn_mask=cpu[3].cuda(),
            is_causal=True))
        _check("constant mask on K1", const, outs["cuda"][0], *o_tol)
    log(f"trainable mask (d): f32 on the card against the CPU, output and "
        f"the gradients of q, k, v and the mask max|err| {err:.3e}; no K1 "
        f"launch on the composite; the constant mask through K1 agrees")


def flash_op_host_cost(calls=1000):
    """18(e): host microseconds a call of K1 at a tiny shape (1 head, 64
    rows, hd 64, bf16) through the registered op ``paddle_tpu::flash_fwd``
    and through the op's body called directly, 1000 calls each, in turns;
    the launches are not counted on any path."""
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = [torch.randn(1, 64, 64, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3)]
    args = (q, k, v, None, None, None, 1, 1, True, 0.125, 1, 1, 0.0, 0, -1)
    routes = {"op": lambda: torch.ops.paddle_tpu.flash_fwd(*args),
              "direct": lambda: fa._flash_fwd_op._init_fn(*args)}
    us = {name: [] for name in routes}

    def run():
        for _ in range(2):
            for name, fn in routes.items():
                fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(calls):
                    fn()
                us[name].append(1e6 * (time.perf_counter() - t) / calls)
                torch.cuda.synchronize()
    _uncounted_flash(run)
    best = {name: min(v) for name, v in us.items()}
    log(f"flash op (e): host us a call over {calls} calls of K1 (1 x 64 x "
        f"64, bf16): paddle_tpu::flash_fwd {best['op']:.2f} "
        f"({', '.join(f'{x:.2f}' for x in us['op'])}), direct "
        f"{best['direct']:.2f} ({', '.join(f'{x:.2f}' for x in us['direct'])}"
        f"): the op adds {best['op'] - best['direct']:.2f} us a call")
    return dict(op_host_us=best["op"], direct_host_us=best["direct"])


def phase_export_and_deploy():
    """Phase 18: export and deployment on the card. Returns the export
    path's launch counts and K1's export record."""
    parts = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out
    free_device_memory()
    counts, rec = timed("(a) export", export_llama)
    rec["kernel_at_shape"] = timed("(a) K1 at its shape", flash_export_shape)
    timed("(b) examples", api_examples, DEPLOY_EXAMPLES)
    timed("(c) stream", stream_and_event)
    timed("(d) trainable mask", trainable_mask_on_the_card)
    rec.update(timed("(e) op cost", flash_op_host_cost))
    free_device_memory()
    log("phase 18 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) +
        f"; phase 18 {sum(parts.values()):.1f} s")
    return counts, rec


# --------------------------------------------------------------------------
# phase 19: serving in production — the HTTP server's shedding, deadlines,
# trace echo, /metrics, /statusz, the profiler window, the request and
# memory ledgers, and the two-replica fleet with its KV handoff
PROD_NEW_TOKENS = 16
PROD_BURST = 24


def _http(method, url, body=None, headers=None, timeout=600):
    """``(status, headers, body bytes)`` of one request; an HTTP error
    status is returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _prom(text):
    """``{series: value}`` of a Prometheus text exposition; raises on a
    line that is not ``# ...`` or ``name{labels} value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r'([a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?) (\S+)',
                         line)
        if m is None:
            raise AssertionError(f"not Prometheus text: {line!r}")
        out[m.group(1)] = float(m.group(3))
    return out


def _solo_streams(model, prompts, new_tokens):
    """Each prompt alone through a fresh engine of phase 4's geometry:
    its greedy tokens, and at each the gap between the two largest
    logits (the near-tie margin of that choice)."""
    from paddle_tpu_torch.serving import ServingEngine
    out = []
    for p in prompts:
        eng = ServingEngine(model, max_batch=8, block_size=16,
                            prefill_chunk=512, max_blocks=2048,
                            request_ledger=False)
        gaps = []
        sample = eng._sample

        def recording(row, seq, sample=sample, gaps=gaps):
            top2 = np.partition(row, -2)[-2:]
            gaps.append(float(top2[1] - top2[0]))
            return sample(row, seq)
        eng._sample = recording
        h = eng.submit(p, max_new_tokens=new_tokens)
        eng.run_until_idle()
        out.append((h.result(60)["token_ids"], gaps))
        del eng, sample, recording
        free_device_memory()  # the recording closure holds a cycle
    return out


#: the largest top-2 logit gap at which a bf16 batched greedy stream may
#: part from its solo stream: a step of another batch composition splits
#: K4's work list and the prefill chunks elsewhere, and the logits are
#: bf16 values (a unit is 0.0625 between 8 and 16); the partings measured
#: sat at gaps of 0 to 0.1875 (PERF.md §6), the limit is 4 units.
#: The f32 oracle of phase 19 holds the same paths to exact equality
NEAR_TIE = 0.25


def _check_streams(what, streams, solo):
    """Each stream against its solo ``(tokens, gaps)``: equal, or parting
    first at a near-tie of the solo run (gap at most ``NEAR_TIE``).
    Returns ``(exact, [(request, position, gap), ...])``; raises on a
    stream that parts where the solo choice was clear."""
    exact, ties = 0, []
    for i, s in streams.items():
        toks, gaps = solo[i]
        if s == toks:
            exact += 1
            continue
        j = next((j for j, (a, b) in enumerate(zip(s, toks)) if a != b),
                 min(len(s), len(toks)))
        if j >= len(gaps) or gaps[j] > NEAR_TIE:
            raise AssertionError(
                f"{what}: request {i} parts from its solo stream at token "
                f"{j}, where the solo run's top-2 gap is "
                f"{gaps[j] if j < len(gaps) else None} (> {NEAR_TIE})")
        ties.append((i, j, round(gaps[j], 5)))
    return exact, ties


def _ledger_step_cost(model, prompts):
    """Mean engine step (wall / steps) over the same 8 requests with the
    request ledger armed and disarmed, in turns A B B A."""
    from paddle_tpu_torch.serving import ServingEngine
    res = {True: [], False: []}
    for armed in (True, False, False, True):
        eng = ServingEngine(model, max_batch=8, block_size=16,
                            prefill_chunk=512, max_blocks=2048,
                            request_ledger=armed)
        hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        res[armed].append(1e3 * (time.perf_counter() - t0) / eng.steps)
        for h in hs:
            h.result(60)
        del eng, hs
        free_device_memory()
    return res


def f32_exactness(prompts):
    """Phase 19's exactness oracle: Llama-3-8B widths cut to 2 layers in
    float32 (K4's FMA kernel, no bf16 rounding): a concurrent batch of
    phase 4's prompts through one engine, and through a prefill ->
    decode fleet sharing the model, each equal to its solo greedy
    stream token for token."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import FleetRouter, ServingEngine, \
        build_fleet
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, dtype="float32", seed=SEED + 19)
    kw = dict(max_batch=8, block_size=16, prefill_chunk=512,
              max_blocks=2048)
    solo = [toks for toks, _ in _solo_streams(model, prompts,
                                              PROD_NEW_TOKENS)]
    eng = ServingEngine(model, **kw)
    hs = [eng.submit(p, max_new_tokens=PROD_NEW_TOKENS) for p in prompts]
    eng.run_until_idle()
    batched = [h.result(60)["token_ids"] for h in hs]
    del eng, hs
    free_device_memory()
    reps = build_fleet(lambda: model, 2, roles=["prefill", "decode"], **kw)
    router = FleetRouter(reps)
    router.start()
    try:
        hs = [router.submit(p, max_new_tokens=PROD_NEW_TOKENS)
              for p in prompts]
        fleet = [h.result(300)["token_ids"] for h in hs]
    finally:
        router.shutdown(drain=True)
    if batched != solo or fleet != solo:
        raise AssertionError(f"f32: batched {batched} / fleet {fleet} != "
                             f"solo {solo}")
    log(f"serving prod (f32 oracle): Llama-3-8B widths at 2 layers, f32: "
        f"{len(prompts)} concurrent requests through one engine and "
        f"through a prefill -> decode fleet, every stream equal to its "
        f"solo greedy stream ({PROD_NEW_TOKENS} tokens)")
    del reps, router, model
    free_device_memory()


def _trace_counts(trace_dir):
    """``(events, device kernels, rpa_wgmma_kernel events)`` of a capture
    window's trace."""
    from paddle_tpu_torch.observability import profile as obs_profile
    with open(os.path.join(trace_dir, obs_profile.TRACE_FILE)) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(events), len(kernels), sum(
        1 for e in events if "rpa_wgmma_kernel" in str(e.get("name", "")))


def production_server(model, cfg, prompts, solo, work_dir):
    """Phase 19(a): one engine behind ``Server(max_queue_depth=4)``."""
    from paddle_tpu_torch.observability import memory as obs_memory
    from paddle_tpu_torch.observability import profile as obs_profile
    from paddle_tpu_torch.observability import requests as obs_requests
    from paddle_tpu_torch.observability import slo
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import Server, ServingEngine
    from paddle_tpu_torch.serving.engine import serving_metrics

    led = obs_requests.active()
    slo.configure({"ttft_p99": (10.0, 0.99), "success": (0.99, 0.99)},
                  windows_s=(60.0, 600.0))
    obs_profile.set_trace_dir(work_dir)
    engine = ServingEngine(model, max_batch=8, block_size=16,
                           prefill_chunk=512, max_blocks=2048)
    fam = serving_metrics()
    base = {k: fam["requests"].value(outcome=k)
            for k in ("accepted", "completed", "failed")}
    rej0 = {r: fam["rejections"].value(reason=r)
            for r in ("queue_full", "deadline")}
    tok0 = {k: fam["tokens"].value(kind=k) for k in ("prompt", "generated")}
    burst = [prompts[i % len(prompts)] for i in range(PROD_BURST)]
    results = [None] * len(burst)
    tid = [f"{0x19a00000 + i:032x}" for i in range(len(burst))]
    out = {}
    with Server(engine, max_queue_depth=4) as srv:
        t_fire = time.perf_counter() + 0.05

        def fire(i):
            # one arrival every 10 ms: each shed check sees the queue the
            # earlier arrivals built (arrivals at one instant would all
            # pass the check before any of them was queued)
            time.sleep(max(t_fire + 0.01 * i - time.perf_counter(), 0))
            results[i] = _http("POST", srv.url + "/generate", {
                "prompt_ids": burst[i], "max_new_tokens": PROD_NEW_TOKENS,
                "stream": i % 2 == 1},
                {"traceparent": f"00-{tid[i]}-00f067aa0ba902b7-01"})
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(burst))]
        torch.cuda.reset_peak_memory_stats()
        rpa.ragged_paged_attention.launches = 0
        steps0 = engine.steps
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # /statusz and /metrics while requests are in flight
        deadline = time.monotonic() + 120
        while not (engine.steps > steps0 and
                   engine.stats()["requests_in_flight"]) and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        t_s = time.perf_counter()
        _, _, statusz = _http("GET", srv.url + "/statusz?format=json")
        statusz_ms = 1e3 * (time.perf_counter() - t_s)
        scrape_ms = []
        for _ in range(5):
            t_s = time.perf_counter()
            _http("GET", srv.url + "/metrics")
            scrape_ms.append(1e3 * (time.perf_counter() - t_s))
        # the profiler window opens during the burst; a second one is 409
        t_s = time.perf_counter()
        code1, _, body1 = _http("POST", srv.url + "/debug/profile?seconds=2")
        profile_start_ms = 1e3 * (time.perf_counter() - t_s)
        code2, _, body2 = _http("POST", srv.url + "/debug/profile?seconds=2")
        # one request straight into the engine while the window is open,
        # so the window holds engine steps whatever the burst has left
        prof_tid = "e" * 32
        prof_h = engine.submit(prompts[2], max_new_tokens=PROD_NEW_TOKENS,
                               trace_id=prof_tid)
        prof_toks = prof_h.result(600)["token_ids"]
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = rpa.ragged_paged_attention.launches
        steps = engine.steps - steps0
        peak = torch.cuda.max_memory_allocated()
        # the window's trace must hold K4 (checked below); when it holds
        # none, the same window once more over one live request through
        # the server, and the check reads that one (both are logged)
        deadline = time.monotonic() + 120
        while obs_profile.capture_active() and time.monotonic() < deadline:
            time.sleep(0.05)
        windows = [_trace_counts(json.loads(body1)["trace_dir"])] \
            if code1 == 200 else []
        retry = None
        retry_tid = "f" * 32
        if windows and not windows[0][2]:
            code1, _, body1 = _http("POST",
                                    srv.url + "/debug/profile?seconds=2")
            retry = _http("POST", srv.url + "/generate", {
                "prompt_ids": prompts[3],
                "max_new_tokens": PROD_NEW_TOKENS},
                {"traceparent": f"00-{retry_tid}-00f067aa0ba902b7-01"})
            deadline = time.monotonic() + 120
            while obs_profile.capture_active() and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            if code1 == 200:
                windows.append(_trace_counts(json.loads(body1)["trace_dir"]))
            if retry[0] != 200:
                raise AssertionError(f"the second window's request: {retry}")
        # the deadline request: 512 tokens in 50 ms cannot be served
        dl_tid = "d" * 32
        code_dl, hdr_dl, body_dl = _http("POST", srv.url + "/generate", {
            "prompt_ids": prompts[0], "max_new_tokens": 512,
            "deadline_s": 0.05},
            {"traceparent": f"00-{dl_tid}-00f067aa0ba902b7-01"})
        deadline = time.monotonic() + 60
        while engine.stats()["requests_in_flight"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        code_bad, _, _ = _http("POST", srv.url + "/generate", {
            "prompt_ids": prompts[0], "deadline_s": 0})
        _, _, metrics_text = _http("GET", srv.url + "/metrics")
        _, _, health = _http("GET", srv.url + "/healthz")
        fleetz = _http("GET", srv.url + "/fleetz")[0]
    health = json.loads(health)
    statusz = json.loads(statusz)
    # -- the burst: at least one 503, the accepted streams exact
    codes = [r[0] for r in results]
    shed = [i for i, c in enumerate(codes) if c == 503]
    accepted = [i for i, c in enumerate(codes) if c == 200]
    if not shed or len(shed) + len(accepted) != len(burst):
        raise AssertionError(f"burst status codes {codes}")
    for i in shed:
        if not results[i][1].get("Retry-After"):
            raise AssertionError("a 503 without Retry-After")
    streams = {}
    for i in accepted + shed:
        code, hdr, body = results[i]
        if tid[i] not in hdr.get("traceparent", ""):
            raise AssertionError(f"request {i}: traceparent not echoed "
                                 f"({hdr.get('traceparent')})")
        if code != 200:
            continue
        if i % 2:
            lines = [json.loads(x) for x in body.decode().splitlines()
                     if x.strip()]
            done = lines[-1]
            toks = [x["token"] for x in lines if "token" in x]
            if done["token_ids"] != toks:
                raise AssertionError(f"request {i}: streamed tokens differ")
        else:
            done = json.loads(body)
        if done.get("trace_id") != tid[i]:
            raise AssertionError(f"request {i}: trace id {done}")
        streams[i] = done["token_ids"]
    extra = {"profiled": (prof_tid, prof_toks, solo[2])}
    if retry is not None:
        extra["second window"] = (retry_tid, json.loads(retry[2])[
            "token_ids"], solo[3])
    exact, ties = _check_streams(
        "(a)", {**streams, **{k: v[1] for k, v in extra.items()}},
        {**{i: solo[i % len(prompts)] for i in streams},
         **{k: v[2] for k, v in extra.items()}})
    want = cfg.num_hidden_layers * steps
    if launches != want or engine.rpa_launches < want:
        raise AssertionError(f"rpa launches {launches} (engine "
                             f"{engine.rpa_launches}) != {want}")
    # -- the deadline: 504, aborted, blocks back
    dl = json.loads(body_dl)
    if code_dl != 504 or dl.get("trace_id") != dl_tid or \
            dl_tid not in hdr_dl.get("traceparent", "") or code_bad != 400:
        raise AssertionError(f"deadline: {code_dl} {dl} {code_bad}")
    st = engine.stats()
    if st["requests_in_flight"] or st["kv_blocks_in_use"]:
        raise AssertionError(f"the aborted request kept its blocks: {st}")
    engine.cache.allocator.assert_no_leaks()
    # -- /metrics against the client's counts and the engine
    prom = _prom(metrics_text.decode())

    def delta(series, before):
        return prom.get(series, 0.0) - before
    recs = {d["trace_id"]: d for d in led.exemplars()}
    dl_rec = recs[dl_tid]
    served = [tid[i] for i in accepted] + [v[0] for v in extra.values()]
    gen = sum(len(s) for s in streams.values()) + dl_rec["decode_tokens"] \
        + sum(len(v[1]) for v in extra.values())
    prompt_tok = sum(recs[t]["prefilled_tokens"] for t in served + [dl_tid])
    checks = {
        "accepted": (delta('serving_requests_total{outcome="accepted"}',
                           base["accepted"]), len(served) + 1),
        "completed": (delta('serving_requests_total{outcome="completed"}',
                            base["completed"]), len(served)),
        "failed": (delta('serving_requests_total{outcome="failed"}',
                         base["failed"]), 1),
        "queue_full": (delta('serving_rejections_total{reason="queue_full"}',
                             rej0["queue_full"]), len(shed)),
        "deadline": (delta('serving_rejections_total{reason="deadline"}',
                           rej0["deadline"]), 1),
        "generated": (delta('serving_tokens_total{kind="generated"}',
                            tok0["generated"]), gen),
        "prompt": (delta('serving_tokens_total{kind="prompt"}',
                         tok0["prompt"]), prompt_tok),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad or health["steps"] != engine.steps or \
            health["rpa_launches_engine"] != engine.rpa_launches:
        raise AssertionError(f"/metrics against the counts: {bad}")
    # -- /statusz: burn rates and the top in-flight requests
    burn = statusz["slo"]["slos"]["ttft_p99"]["burn_rate"]
    top = statusz["requests"]["top_in_flight"]
    if set(burn) != {"fast", "slow"} or not top or any(
            "kv_block_seconds" not in r for r in top):
        raise AssertionError(f"/statusz: {statusz}")
    # -- the ledger's token accounting
    for t in served:
        r = recs[t]
        if r["preemptions"] == 0 and \
                r["prefilled_tokens"] + r["cached_tokens"] != r["prompt_len"]:
            raise AssertionError(f"ledger record {r}")
    cached = sum(recs[t]["cached_tokens"] for t in served)
    # -- the profiler window
    cap = json.loads(body1)
    if code1 != 200 or code2 != 409:
        raise AssertionError(f"profile: {code1} {body1} {code2} {body2}")
    trace_file = os.path.join(cap["trace_dir"], obs_profile.TRACE_FILE)
    n_events, n_kernels, rpa_events = _trace_counts(cap["trace_dir"])
    if not rpa_events:
        raise AssertionError(
            f"the profile window holds no rpa_wgmma_kernel: (trace events, "
            f"device kernels, K4 events) of each window {windows}")
    trace_bytes = os.path.getsize(trace_file)
    # -- memory: parameters and pools within 1%
    snap = obs_memory.snapshot()
    rep = engine.memory_report()
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    # the RoPE tables ride with the parameters (4 MiB at 8B widths)
    params += sum(b.numel() * b.element_size() for b in model.buffers())
    pools = engine.cache.pool_bytes()
    for what, got, want_b in (
            ("snapshot params", snap["owners"]["serving_params"], params),
            ("snapshot pools", snap["owners"]["kv_cache"], pools),
            ("report", rep.argument_bytes, params + pools)):
        if abs(got - want_b) > 0.01 * want_b:
            raise AssertionError(f"memory {what}: {got} vs {want_b}")
    log(f"serving prod (a): burst of {len(burst)} through Server("
        f"max_queue_depth=4): {len(accepted)} accepted, {len(shed)} shed "
        f"503 with Retry-After; accepted streams against their solo "
        f"greedy streams ({PROD_NEW_TOKENS} tokens; with the request "
        f"served in the profile window): {exact} equal, "
        f"{len(ties)} parting at a solo near-tie (request, token, top-2 "
        f"gap) {ties}; traceparent echoed on "
        f"all {len(burst)}; {steps} engine steps, {launches} RPA launches "
        f"(= {cfg.num_hidden_layers} x steps); wall {wall:.3f} s, mean "
        f"step {1e3 * wall / steps:.3f} ms; window peak {peak} B; "
        f"prefix-cache tokens {cached}")
    log(f"serving prod (a): deadline_s=0.05 with 512 tokens -> {code_dl}, "
        f"aborted after {dl_rec['decode_tokens']} tokens, its blocks back "
        f"(kv_blocks_in_use 0); deadline_s=0 -> {code_bad}; /fleetz "
        f"{fleetz}; /metrics parsed, {len(prom)} series, equal to the "
        f"client's and the engine's counts: " + ", ".join(
            f"{k} {v[0]:g}" for k, v in checks.items()))
    log(f"serving prod (a): /metrics scrape {statistics.median(scrape_ms):.3f}"
        f" ms median of 5 under load (max {max(scrape_ms):.3f}); /statusz "
        f"{statusz_ms:.3f} ms, burn rates {burn}, {len(top)} top in-flight "
        f"requests by KV block-seconds")
    log(f"serving prod (a): profile window 2 s -> {code1} (the POST took "
        f"{profile_start_ms:.1f} ms), second POST -> "
        f"{code2}; trace {trace_bytes} B with {rpa_events} rpa_wgmma_kernel "
        f"events, export_chrome_trace "
        f"{obs_profile.last_export_seconds:.3f} s"
        + (f"; a second window over one live request: (trace events, "
           f"device kernels, K4 events) of each {windows}"
           if retry is not None else ""))
    log(f"serving prod (a): memory snapshot serving_params "
        f"{snap['owners']['serving_params']} B (parameters and RoPE "
        f"tables {params} B), "
        f"kv_cache {snap['owners']['kv_cache']} B (pools {pools} B); "
        f"memory_report {rep.to_json()}")
    out.update(launches=launches, steps=steps, wall=wall, peak=peak,
               exact=exact, ties=ties,
               scrape_ms=statistics.median(scrape_ms),
               accepted=len(accepted), shed=len(shed))
    del engine
    free_device_memory()
    slo.reset()
    return out


def production_fleet(model, cfg, prompts, solo, work_dir):
    """Phase 19(b): one prefill and one decode replica, one model."""
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.observability import requests as obs_requests
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import FleetRouter, RouterServer, \
        build_fleet

    free, total = torch.cuda.mem_get_info()
    pool_bytes = 2 * cfg.num_hidden_layers * 2049 * 16 * \
        cfg.num_key_value_heads * 128 * 2
    if free < 2 * pool_bytes + (2 << 30):
        raise AssertionError(f"{free} B free: two pool sets of "
                             f"{pool_bytes} B do not fit")
    led = obs_requests.active()
    reps = build_fleet(lambda: model, 2, roles=["prefill", "decode"],
                       max_batch=8, block_size=16, prefill_chunk=512,
                       max_blocks=2048)
    router = FleetRouter(reps)
    handoff = {"export_ms": [], "import_ms": [], "import_call_ms": [],
               "bytes": []}

    def timed(obj, name, key):
        """Time ``obj.name`` (synchronized), into ``handoff[key]``."""
        fn = getattr(obj, name)

        def wrapped(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            handoff[key].append(1e3 * (time.perf_counter() - t))
            if name == "export_blocks":
                handoff["bytes"].append(sum(x.numel() * x.element_size()
                                            for x in out))
            return out
        setattr(obj, name, wrapped)
    # the copies themselves, and the decode replica's whole import call
    # (which waits for the step in flight to take the engine's lock)
    timed(reps[0].engine.cache, "export_blocks", "export_ms")
    timed(reps[1].engine.cache, "import_blocks", "import_ms")
    timed(reps[1].engine, "import_kv_blocks", "import_call_ms")
    trace_dir = os.path.join(work_dir, "spans")
    trace.enable(trace_dir)
    tid = [f"{0x19b00000 + i:032x}" for i in range(len(prompts))]
    results = [None] * len(prompts)
    try:
        with RouterServer(router, max_queue_depth=8) as srv:
            def fire(i):
                results[i] = _http("POST", srv.url + "/generate", {
                    "prompt_ids": prompts[i],
                    "max_new_tokens": PROD_NEW_TOKENS,
                    "stream": i % 2 == 1},
                    {"traceparent": f"00-{tid[i]}-00f067aa0ba902b7-01"})
            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(len(prompts))]
            torch.cuda.reset_peak_memory_stats()
            rpa.ragged_paged_attention.launches = 0
            own0 = [r.engine.rpa_launches for r in reps]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            wall = time.perf_counter() - t0
            launches = rpa.ragged_paged_attention.launches
            own = [r.engine.rpa_launches - o for r, o in zip(reps, own0)]
            peak = torch.cuda.max_memory_allocated()
            fleetz = json.loads(_http("GET", srv.url + "/fleetz")[2])
    finally:
        trace.disable()
    streams = {}
    for i, (code, hdr, body) in enumerate(results):
        if code != 200:
            raise AssertionError(f"fleet request {i}: {code} {body[:200]}")
        if i % 2:
            lines = [json.loads(x) for x in body.decode().splitlines()
                     if x.strip()]
            streams[i] = lines[-1]["token_ids"]
        else:
            streams[i] = json.loads(body)["token_ids"]
    exact, ties = _check_streams("(b)", streams, solo)
    if min(own) <= 0 or sum(own) != launches:
        raise AssertionError(f"K4 launches per replica {own}, global "
                             f"{launches}")
    recs = {}
    for d in led.exemplars():
        recs.setdefault(d["trace_id"], []).append(d)
    for i, p in enumerate(prompts):
        pre, dec = recs[tid[i]][0], recs[tid[i]][-1]
        full = len(p) // 16 * 16
        if pre["prefilled_tokens"] != len(p) or \
                dec["cached_tokens"] != min(full, len(p) - 1) or \
                dec["prefilled_tokens"] >= 16:
            raise AssertionError(f"fleet request {i}: prefill {pre}, "
                                 f"decode {dec}")
    summary = __import__(
        "paddle_tpu_torch.observability.trace", fromlist=["merge"]).merge(
        trace_dir, requests=True)
    chains = summary["requests"]["requests"]
    with open(os.path.join(trace_dir, "merged_trace.json")) as f:
        by_tid = {}
        for e in json.load(f)["traceEvents"]:
            t = (e.get("args") or {}).get("trace")
            if t is not None:
                by_tid.setdefault(t, []).append(e["name"])
    for t in tid:
        names = by_tid.get(t, [])
        if chains[t]["spans"] < 8 or names.count("router_route") != 2 or \
                names.count("router_handoff") != 1 or \
                names.count("request_done") != 2:
            raise AssertionError(f"trace chain of {t}: {names}")
    n = len(prompts)
    log(f"serving prod (b): fleet of 1 prefill + 1 decode replica sharing "
        f"one model, behind RouterServer: {n} requests of {SERVING_LENS} "
        f"tokens x {PROD_NEW_TOKENS}: against one engine's solo streams "
        f"{exact} equal, {len(ties)} parting at a solo near-tie {ties}; "
        f"routing {fleetz['routing']}; K4 launches prefill {own[0]}, decode "
        f"{own[1]} (sum {sum(own)} = global {launches}); wall {wall:.3f} s; "
        f"window peak {peak} B")
    log(f"serving prod (b): KV handoff per request: export "
        f"{statistics.median(handoff['export_ms']):.3f} ms median (max "
        f"{max(handoff['export_ms']):.3f}), import "
        f"{statistics.median(handoff['import_ms']):.3f} ms median (max "
        f"{max(handoff['import_ms']):.3f}; the whole import call, waiting "
        f"for the decode replica's step, "
        f"{statistics.median(handoff['import_call_ms']):.3f} ms median), "
        f"{statistics.median(handoff['bytes'])} B median ({min(handoff['bytes'])}"
        f"-{max(handoff['bytes'])} B); decode replica cached tokens "
        f"{[recs[t][-1]['cached_tokens'] for t in tid]}, prefilled "
        f"{[recs[t][-1]['prefilled_tokens'] for t in tid]}; trace merge "
        f"--requests: {len(chains)} chains, router + both replicas")
    router.shutdown(drain=True)
    del reps, router
    free_device_memory()
    return dict(launches=launches, own=own, wall=wall, peak=peak,
                **handoff)


def production_failover(model, prompts, solo):
    """Phase 19(c): kill the mixed replica serving a stream after 3
    tokens; the survivor, holding the prompt's prefix, finishes it."""
    from paddle_tpu_torch.observability import requests as obs_requests
    from paddle_tpu_torch.serving import FleetRouter, build_fleet

    led = obs_requests.active()
    reps = build_fleet(lambda: model, 2, max_batch=8, block_size=16,
                       prefill_chunk=512, max_blocks=2048)
    router = FleetRouter(reps)
    router.start()
    prompt = prompts[4]
    got, seen3, killed = [], threading.Event(), threading.Event()

    def on_tok(_h, t):
        got.append(t)
        if len(got) >= 3:
            seen3.set()
            if not killed.is_set():
                killed.wait(30)  # hold the victim's step until the kill

    tid = "c" * 32
    try:
        h = router.submit(prompt, max_new_tokens=PROD_NEW_TOKENS,
                          on_token=on_tok, trace_id=tid)
        if not seen3.wait(300):
            raise AssertionError("no third token")
        victim = h._attempt_replica
        survivor = reps[1] if victim is reps[0] else reps[0]
        survivor.engine.submit(prompt, max_new_tokens=2).result(300)
        killer = threading.Thread(target=victim.kill)
        killer.start()
        time.sleep(0.1)
        killed.set()
        killer.join(60)
        res = h.result(300)
    finally:
        router.shutdown(drain=True)
    rec = [d for d in led.exemplars()
           if d["trace_id"] == tid and d["error"] is None][-1]
    exact, ties = _check_streams("(c)", {4: res["token_ids"]}, solo)
    if res["token_ids"] != got or res["failovers"] != 1 or rec["cached_tokens"] < len(prompt) // \
            16 * 16 or rec["cached_tokens"] + rec["prefilled_tokens"] != \
            rec["prompt_len"]:
        raise AssertionError(f"failover: {res} {got} {rec}")
    log(f"serving prod (c): the replica serving a {len(prompt)}-token "
        f"prompt killed after its third token; the survivor "
        f"finished all {len(got)}, each streamed once (against the solo "
        f"stream: {'equal' if exact else ties}; failovers "
        f"{res['failovers']}), its attempt cached {rec['cached_tokens']} "
        f"of {rec['prompt_len']} tokens and prefilled "
        f"{rec['prefilled_tokens']}")
    del reps, router
    free_device_memory()


def phase_serving_production():
    """Phase 19. Returns the launch counts of (a) and (b)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import profile as obs_profile
    from paddle_tpu_torch.observability import requests as obs_requests

    free_device_memory()
    t_phase = time.perf_counter()
    parts = {}
    cfg = LlamaConfig.llama3_8b()
    rng = np.random.RandomState(SEED)
    prompts = _phase4_prompts(cfg, rng)
    # every completed record kept, so each request's can be read back
    obs_requests.disable()
    obs_requests.maybe_arm(sample_rate=1.0)
    work_dir = tempfile.mkdtemp(prefix="phase19_", dir=REPO_ROOT)
    try:
        t = time.perf_counter()
        f32_exactness(prompts)
        parts["f32 oracle"] = time.perf_counter() - t
        model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
        t = time.perf_counter()
        solo = _solo_streams(model, prompts, PROD_NEW_TOKENS)
        parts["solo streams"] = time.perf_counter() - t
        gaps = sorted(g for _, gs in solo for g in gs)
        log(f"serving prod: solo greedy streams of phase 4's 8 prompts x "
            f"{PROD_NEW_TOKENS} tokens; top-2 logit gap over their "
            f"{len(gaps)} choices: min {gaps[0]:.5f}, 5th percentile "
            f"{gaps[len(gaps) // 20]:.5f}, median "
            f"{statistics.median(gaps):.5f}, max {gaps[-1]:.5f}")
        t = time.perf_counter()
        cost = _ledger_step_cost(model, prompts)
        parts["ledger cost"] = time.perf_counter() - t
        log("serving prod: mean engine step over phase 4's 8 requests x 8 "
            "tokens, ledger armed / disarmed in turns A B B A: armed "
            + " / ".join(f"{x:.3f}" for x in cost[True]) + " ms, disarmed "
            + " / ".join(f"{x:.3f}" for x in cost[False]) + " ms")
        t = time.perf_counter()
        a = production_server(model, cfg, prompts, solo, work_dir)
        parts["(a) server"] = time.perf_counter() - t
        t = time.perf_counter()
        b = production_fleet(model, cfg, prompts, solo, work_dir)
        parts["(b) fleet"] = time.perf_counter() - t
        t = time.perf_counter()
        production_failover(model, prompts, solo)
        parts["(c) failover"] = time.perf_counter() - t
    finally:
        obs_profile.set_trace_dir(None)
        obs_requests.disable()
        shutil.rmtree(work_dir, ignore_errors=True)
    del model
    free_device_memory()
    log("phase 19 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) +
        f"; phase 19 {time.perf_counter() - t_phase:.1f} s")
    return {"serving_prod": a["launches"], "fleet": b["launches"]}, \
        {"armed_ms": cost[True], "disarmed_ms": cost[False]}


# --------------------------------------------------------------------------
# phase 20: training in production
PROD_STEPS = 8            # fit steps of (a); saves at 4 and 8
PROD_SAVE_EVERY = 4
PROD_POISON = 6           # the chaos harness poisons this step's batch
PROD_NUMERICS_EVERY = 4   # numerics samples at optimizer steps 1 and 4
PROD_WINDOW = (3, 4)      # the fit's device-profiler window
PROD_TRACE_KERNELS = ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                      "flash_dkv_wgmma_kernel", "fused_adam_kernel")


def _prod_model(cfg, device, dtype):
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    net = LlamaForCausalLM(cfg, dtype=dtype, seed=SEED, device=device)
    opt = AdamW(learning_rate=1e-4, parameters=net.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    return net, opt, Model(net).prepare(opt, loss=None)


def _prod_recorder(model, device):
    """A callback (after ``StepTelemetry``) that times each fit step with
    CUDA events (perf_counter on the CPU) and keeps each numerics sample
    the step produced."""
    from paddle_tpu_torch.hapi import Callback

    class Recorder(Callback):
        def __init__(self):
            self.rows, self.samples = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._data = logs["data_time"]
            self._seen = model._train_step.last_numerics
            if device.type == "cuda":
                self._ev = torch.cuda.Event(enable_timing=True)
                self._ev.record()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            if device.type == "cuda":
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                ms = self._ev.elapsed_time(end)
            else:
                ms = 1e3 * (time.perf_counter() - self._t0)
            self.rows.append(dict(step=step, loss=logs["loss"], ms=ms,
                                  data_ms=1e3 * self._data))
            s = model._train_step.last_numerics
            if s is not None and s is not self._seen:
                self.samples.append((step, s))

    return Recorder()


class _LastBatch:
    """The pipeline's batches as delivered, the last one kept (the
    batch the steps after the fit run on)."""

    def __init__(self, pipe):
        self.pipe, self.last = pipe, None

    def __iter__(self):
        for b in self.pipe:
            self.last = b
            yield b


def _ckpt_entry(root, key):
    """One non-tensor entry of a checkpoint's latest committed step, read
    from its pickled skeleton alone (no tensor is read)."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint.layout import (AUX_FILE,
                                                    loads_skeleton)
    mgr = CheckpointManager(root)
    step = mgr.latest_step()
    with open(os.path.join(mgr.step_dir(step), AUX_FILE), "rb") as f:
        return step, loads_skeleton(f.read())[key]


def _trace_names(path):
    with open(path) as f:
        return {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}


def prod_fit(cfg, device, dtype, B, S, corpus, work):
    """20(a): ``Model.fit`` with everything armed. Returns the model, its
    optimizer, what the checks read, and the fit's launch counts."""
    from paddle_tpu_torch.data import DataPipeline
    from paddle_tpu_torch.hapi import StepTelemetry, VisualDL
    from paddle_tpu_torch.observability import (flight_recorder, goodput,
                                                numerics, profile)
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    from paddle_tpu_torch.observability.step_timer import peak_flops
    from paddle_tpu_torch.resilience import FitResilience, chaos

    net, opt, model = _prod_model(cfg, device, dtype)
    pipe = DataPipeline(corpus, batch_size=B, seq_len=S, pack=True,
                        base_seed=SEED, drop_last=True,
                        device_prefetch=2 if device.type == "cuda" else 0,
                        **({"device": device} if device.type == "cuda"
                           else {}))
    reg = MetricsRegistry()
    flops = train_flops_per_step(cfg, B, S)
    peak = peak_flops(device)
    tel = StepTelemetry(flops_per_sample=flops / B, registry=reg)
    rec = _prod_recorder(model, device)
    vdl_dir = os.path.join(work, "vdl")
    # the checkpoint's metrics go to the default registry, which the
    # goodput ledger's checkpoint bin reads
    fr = FitResilience(checkpoint_dir=os.path.join(work, "ckpt"),
                       save_every_steps=PROD_SAVE_EVERY, keep_last_k=1,
                       step_timeout=600.0, nan_guard=True, pipeline=pipe)
    profile.set_trace_dir(os.path.join(work, "trace"))
    profile.set_fit_window(*PROD_WINDOW)
    numerics.configure(armed=True, every=PROD_NUMERICS_EVERY)
    chaos.configure(poison_batch=[PROD_POISON])
    # this fit's ledger: the one-time costs stamped by earlier phases
    # (kernel builds, captures, first steps) are not its own
    goodput.reset_ledger()
    goodput._drain_pending_compile()
    rec_fr = flight_recorder.enable(capacity=4096)
    _reset_flash_counts()
    _reset_fused_counts()
    t0 = time.perf_counter()
    try:
        kept = _LastBatch(pipe)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model.fit(kept, epochs=PROD_STEPS, num_iters=PROD_STEPS,
                      verbose=0, callbacks=[tel, rec, VisualDL(vdl_dir), fr])
        counts = {**_flash_counts(), **_fused_counts()}
        wall = time.perf_counter() - t0
        events = rec_fr.events()
    finally:
        chaos.configure()
        profile.set_fit_window()
    return dict(net=net, opt=opt, model=model, reg=reg, tel=tel, rec=rec,
                fr=fr, flops=flops, peak=peak, vdl_dir=vdl_dir,
                counts=counts, wall=wall, events=events,
                warnings=[str(w.message) for w in caught],
                batch={k: torch.as_tensor(v).to(device)
                       for k, v in kept.last.items()})


def prod_fit_checks(cfg, a, work):
    """20(a)'s checks on what :func:`prod_fit` returned."""
    from paddle_tpu_torch.observability import goodput, numerics
    rows, steps = a["rec"].rows, PROD_STEPS
    losses = [r["loss"] for r in rows]
    bad = [i + 1 for i, v in enumerate(losses) if not math.isfinite(v)]
    if bad != [PROD_POISON]:
        raise AssertionError(f"prod fit: non-finite losses at steps {bad}, "
                             f"expected only the poisoned {PROD_POISON}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"prod fit: loss did not fall: {losses}")
    guard = a["fr"].nan_guard
    if guard.rollbacks != 1 or guard.trips[0]["step"] != PROD_POISON:
        raise AssertionError(f"prod fit: guard trips {guard.trips}")
    provs = [f for f in os.listdir(os.path.join(work, "trace"))
             if f.startswith("nan_provenance_")]
    if len(provs) != 1:
        raise AssertionError(f"prod fit: provenance files {provs}")
    prov = json.load(open(os.path.join(work, "trace", provs[0])))
    if prov["verdict"] != "finite_in_graph" or not prov["replay"]["taps"]:
        raise AssertionError(f"prod fit: the host-side loss corruption's "
                             f"replay gave {prov['verdict']} with "
                             f"{len(prov['replay']['taps'])} taps")
    snap = goodput.snapshot()
    bins = snap["bins"]
    if not bins["rollback_discarded"] > 0:
        raise AssertionError(f"prod fit: no rollback seconds: {bins}")
    total = sum(bins.values())
    if abs(total - snap["wall_s"]) > 0.01 * snap["wall_s"]:
        raise AssertionError(f"prod fit: goodput bins sum to {total} s, "
                             f"the ledger's wall {snap['wall_s']} s")
    st = a["tel"].last_stats
    mfu = a["reg"].get("train_mfu_ratio").value()
    want = a["flops"] / st["step_time_s"] / a["peak"]
    if abs(mfu - want) > 0.01 * want:
        raise AssertionError(f"prod fit: train_mfu_ratio {mfu} against "
                             f"{want}")
    # the same steps, both clocks: all but the first (the compile bin)
    tel_ms = [1e3 * t for t in list(a["tel"].timer.recent)[1:]]
    ev_ms = [r["ms"] + r["data_ms"] for r in rows[1:]]
    med_t, med_e = statistics.median(tel_ms), statistics.median(ev_ms)
    if abs(med_t - med_e) > 0.10 * med_e:
        raise AssertionError(f"prod fit: train_step_seconds median "
                             f"{med_t:.3f} ms against CUDA events "
                             f"{med_e:.3f} ms")
    (vdl,) = os.listdir(a["vdl_dir"])
    recs = [json.loads(line) for line in open(
        os.path.join(a["vdl_dir"], vdl))]
    loss_recs = [r for r in recs if r["tag"] == "train/loss"]
    if [r["step"] for r in loss_recs] != list(range(1, steps + 1)):
        raise AssertionError(f"prod fit: VisualDL train/loss records at "
                             f"steps {[r['step'] for r in loss_recs]}")
    samples = a["rec"].samples
    if [s for s, _ in samples] != [1, PROD_NUMERICS_EVERY]:
        raise AssertionError(f"prod fit: numerics samples at fit steps "
                             f"{[s for s, _ in samples]}")
    for s, sample in samples:
        for name, (absmax, mean, rms, nonf) in sample["taps"].items():
            if nonf or not all(map(math.isfinite, (absmax, mean, rms))):
                raise AssertionError(f"prod fit: sample of step {s}: tap "
                                     f"{name} not finite")
    ck_step, ck_num = _ckpt_entry(os.path.join(work, "ckpt"), "numerics")
    summary = numerics.get_observatory().calibration_summary()
    if ck_num != summary:
        raise AssertionError(f"prod fit: the step-{ck_step} checkpoint's "
                             f"numerics entry differs from "
                             f"calibration_summary()")
    names = _trace_names(os.path.join(_fit_capture_dir(work),
                                      "trace.json"))
    missing = [k for k in PROD_TRACE_KERNELS
               if not any(k in n for n in names)]
    if missing:
        raise AssertionError(f"prod fit: the window's trace lacks {missing}")
    kinds = {e["kind"] for e in a["events"]}
    if not {"step", "ckpt", "data"} <= kinds:
        raise AssertionError(f"prod fit: flight recorder kinds {kinds}")
    n = cfg.num_hidden_layers
    flash = {k: a["counts"][k] for k in ("flash_attention_fwd",
                                         "flash_attention_dq",
                                         "flash_attention_dkv")}
    # each fit step and the guard's one provenance replay (forward and
    # backward) launch K1-K3 once a layer
    if set(flash.values()) != {n * (steps + 1)}:
        raise AssertionError(f"prod fit: launches {flash}, expected "
                             f"{n} x ({steps} steps + 1 replay)")
    for k in ("fused_adam_update", "fused_sqnorm"):
        if a["counts"][k] != steps:
            raise AssertionError(f"prod fit: {k} launched "
                                 f"{a['counts'][k]} times in {steps} steps")
    step_ms = statistics.median(r["ms"] for r in rows[1:])
    return dict(losses=losses, prov=prov, bins=bins, wall_s=snap["wall_s"],
                step_ms=step_ms,
                fraction=snap["job_goodput_fraction"], mfu=mfu,
                med_tel=med_t, med_ev=med_e, samples=len(samples),
                taps=len(samples[0][1]["taps"]), ckpt_step=ck_step,
                trace_names=len(names), kinds=sorted(kinds),
                events=len(a["events"]), flash=flash)


def _fit_capture_dir(work):
    root = os.path.join(work, "trace")
    (d,) = [f for f in os.listdir(root) if f.startswith("profile_fit_")]
    return os.path.join(root, d)


def prod_provenance_names_a_tap(a, cfg):
    """A NaN in one layer's down projection: the replay names that
    layer's ``mlp`` tap first. The weight is put back after."""
    from paddle_tpu_torch.observability import numerics
    layer = cfg.num_hidden_layers // 2
    w = a["net"].model.layers[layer].mlp.down_proj.weight
    held = w.detach().clone()
    with torch.no_grad():
        w[0, 0] = float("nan")
    try:
        path = numerics.write_provenance(a["model"]._train_step, 0,
                                         "weight_nan")
    finally:
        with torch.no_grad():
            w.copy_(held)
    doc = json.load(open(path))
    want = f"layers.{layer}.mlp"
    if doc["first_nonfinite"] is None or \
            doc["first_nonfinite"]["name"] != want:
        raise AssertionError(f"provenance: named {doc['first_nonfinite']}, "
                             f"expected {want}")
    return doc["first_nonfinite"]


def prod_costs(a, blocks=("A", "B", "B", "A"), n=4):
    """The mean step (wall, loss read back) with StepTimer and the flight
    recorder armed (A) against disarmed (B), in turns; then a sampled
    numerics step against an unsampled one. Launches here are not on a
    path: the counters are put back."""
    from paddle_tpu_torch.observability import flight_recorder, numerics
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    from paddle_tpu_torch.observability.step_timer import StepTimer
    step = a["model"]._train_step
    batch = a["batch"]
    held = {**_flash_counts(), **_fused_counts()}

    def run(armed):
        timer = StepTimer(registry=MetricsRegistry(), peak=0) \
            if armed else None
        if armed:
            flight_recorder.enable(capacity=4096)
        ts = []
        try:
            for _ in range(n):
                t = time.perf_counter()
                if armed:
                    timer.begin_step()
                float(step(**batch))
                if armed:
                    timer.end_step(samples=1)
                ts.append(1e3 * (time.perf_counter() - t))
        finally:
            flight_recorder.disable()
        return statistics.mean(ts)

    cost = {"armed": [], "disarmed": []}
    for b in blocks:
        cost["armed" if b == "A" else "disarmed"].append(run(b == "A"))
    numerics.configure(armed=True, every=1)
    sampled = run(False)
    numerics.configure(armed=False)
    unsampled = run(False)
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    from paddle_tpu_torch.jit import fused_update as fu
    fa.launches_fwd, fa.launches_dq, fa.launches_dkv = (
        held["flash_attention_fwd"], held["flash_attention_dq"],
        held["flash_attention_dkv"])
    fu.launches_adam, fu.launches_sqnorm = held["fused_adam_update"], \
        held["fused_sqnorm"]
    return dict(cost, sampled=sampled, unsampled=unsampled)


def prod_attribution(a, cfg, B, S, step_ms):
    """20(b): ``attribute_train_step`` on the fit's model and a batch of
    its pipeline, fused (its TrainStep) and ``fused=False``; the fused
    table must sum to ``step_ms``, the same TrainStep's step measured
    with its loss read back, within 10%."""
    from paddle_tpu_torch.observability.attribution import \
        attribute_train_step
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    batch = a["batch"]
    out = {}
    for fused in (True, False):
        rep = attribute_train_step(
            a["net"], a["opt"], batch, steps=2, warmup=1, reps=2,
            fused=fused, registry=MetricsRegistry(),
            train_step=a["model"]._train_step if fused else None)
        out[fused] = rep
        log(f"prod attribution ({'fused' if fused else 'fused=False'}; "
            f"CUDA events, best of 2 x 2 calls a sub-step):\n"
            + rep.table())
    # bench.py counts the loss head over B*S rows; the fused cross
    # entropy computes the B*(S-1) that have a next token
    want = train_flops_per_step(cfg, B, S)
    head_rows = 3 * 2 * B * cfg.hidden_size * cfg.vocab_size
    for fused, rep in out.items():
        if rep.total_flops not in (want, want - head_rows):
            raise AssertionError(f"attribution: counted {rep.total_flops}"
                                 f" flop, bench.py's count is {want}")
    got = out[True].sum_seconds * 1e3
    if abs(got - step_ms) > 0.10 * step_ms:
        raise AssertionError(f"attribution: the fused phases sum to "
                             f"{got:.3f} ms, the measured step {step_ms:.3f}"
                             f" ms")
    if not out[True].phases["optimizer"]["seconds"] < \
            out[False].phases["optimizer"]["seconds"]:
        raise AssertionError("attribution: the fused optimizer phase is not "
                             "shorter than the looped one")
    return out


def prod_profiler(a, work, steps=5):
    """20(c): ``paddle.profiler.Profiler`` with the CPU and GPU targets
    and a (closed 1, ready 1, record 2) schedule over five calls of a
    ``TrainStep`` whose loss goes through the op library
    (``paddle.mean``). Returns its launch counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.jit import TrainStep
    try:
        profiler.Profiler(targets=[profiler.ProfilerTarget.TPU])
        raise AssertionError("profiler: ProfilerTarget.TPU did not raise")
    except ValueError:
        pass
    step = TrainStep(a["net"], lambda m, **b: paddle.mean(m(**b)[1]),
                     a["opt"])
    batch = a["batch"]
    _reset_flash_counts()
    _reset_fused_counts()
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2))
    prof.start()
    for i in range(steps):
        float(step(**batch))
        if i < steps - 1:
            prof.step()
    prof.stop()
    counts = {**_flash_counts(), **_fused_counts()}
    info = prof.step_info()
    if info["steps"] != steps:
        raise AssertionError(f"profiler: step_info {info}")
    out = os.path.join(work, "profiler")
    host = prof.export_chrome_tracing(out, "w0")
    host_names = [str(e["name"]) for e in
                  json.load(open(host))["traceEvents"]]
    devs = [f for f in os.listdir(out) if ".device" in f]
    names = _trace_names(os.path.join(out, devs[0])) if devs else set()
    missing = [k for k in PROD_TRACE_KERNELS[:3]
               if not any(k in n for n in names)]
    if host_names.count("TrainStep") != 2 or "mean" not in host_names or \
            missing or len(devs) != 1:
        raise AssertionError(f"profiler: {host_names.count('TrainStep')} "
                             f"TrainStep spans, op spans "
                             f"{sorted(set(host_names))[:10]}, device "
                             f"traces {devs}, missing {missing}")
    ops = sorted({n for n in host_names if n != "TrainStep"})
    return dict(counts=counts, info=info, host_spans=len(host_names),
                ops=ops, device_events=len(names))


def prod_subprocesses(work, device):
    """20(d): the watchdog's kill and the chaos harness's kill and resume,
    each in its own process on the card (``tests/torch_chaos_worker.py``,
    a tiny Llama)."""
    import subprocess
    worker = os.path.join(REPO_ROOT, "tests", "torch_chaos_worker.py")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO_ROOT, os.path.join(REPO_ROOT, "tests")]))

    def start(*args):
        return subprocess.Popen(
            [sys.executable, worker, *map(str, args)], cwd=REPO_ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def done(p, timeout=300):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        return p.returncode, out, err

    def losses(out):
        return {int(ln.split()[1]): float(ln.split()[2])
                for ln in out.splitlines() if ln.startswith("step ")}

    dev = device.type
    procs = {"hang": start("hang", os.path.join(work, "hang"), dev),
             "whole": start("run", os.path.join(work, "whole"), dev, 6),
             "killed": start("run", os.path.join(work, "killed"), dev, 6, 3)}
    res = {k: done(p) for k, p in procs.items()}
    res["resumed"] = done(start("run", os.path.join(work, "killed"), dev, 6,
                                3))
    from paddle_tpu_torch.resilience import RESUMABLE_EXIT_CODE
    want = {"hang": RESUMABLE_EXIT_CODE, "whole": 0, "killed": -9,
            "resumed": 0}
    for k, rc in want.items():
        if res[k][0] != rc:
            raise AssertionError(f"worker {k}: exit {res[k][0]}, expected "
                                 f"{rc}:\n{res[k][2][-3000:]}")
    trace = os.path.join(work, "hang", "trace")
    (dump,) = [f for f in os.listdir(trace) if f.startswith("watchdog_")]
    doc = json.load(open(os.path.join(trace, dump)))
    kinds = {e["kind"] for e in doc["events"]}
    if doc["stuck_span"]["context"].get("step") != 2 or \
            not {"op", "data"} <= kinds:
        raise AssertionError(f"watchdog dump: {doc['stuck_span']}, kinds "
                             f"{kinds}")
    w, k, r = (losses(res[n][1]) for n in ("whole", "killed", "resumed"))
    got = {**k, **r}
    if sorted(k) != [1, 2, 3] or sorted(got) != list(range(1, 7)):
        raise AssertionError(f"chaos resume: steps {sorted(k)} then "
                             f"{sorted(r)}")
    diff = max(abs(got[s] - w[s]) / abs(w[s]) for s in w)
    if not np.allclose([got[s] for s in range(1, 7)],
                       [w[s] for s in range(1, 7)], rtol=1e-5, atol=0):
        raise AssertionError(f"chaos resume: losses {got} against the "
                             f"uninterrupted {w}")
    return dict(dump_events=len(doc["events"]), kinds=sorted(kinds),
                resumed_from=min(r), rel_diff=diff)


def _phase_production(cfg, device, dtype, B, S, corpus, work,
                      train_step_ms):
    from paddle_tpu_torch.observability import (fleet, flight_recorder,
                                                numerics, profile)
    parts, t = {}, time.perf_counter()
    a = prod_fit(cfg, device, dtype, B, S, corpus, work)
    parts["(a) fit"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        res = prod_fit_checks(cfg, a, work)
    finally:
        flight_recorder.disable()
        numerics.configure(armed=False)
    fz = fleet.fleetz_snapshot()
    if fz["local_goodput"] is None or \
            fz["local_goodput"]["steps"] != PROD_STEPS:
        raise AssertionError(f"fleetz: {fz['local_goodput']}")
    tap = prod_provenance_names_a_tap(a, cfg)
    log_fit(a, res, tap, fz, train_step_ms)
    costs = prod_costs(a)
    log_costs(costs)
    parts["(a) checks, costs"] = time.perf_counter() - t
    t = time.perf_counter()
    # the measured step: the same TrainStep, loss read back each step
    step_ms = statistics.mean(costs["disarmed"])
    rep = prod_attribution(a, cfg, B, S, step_ms)
    log_attribution(rep, step_ms, res["step_ms"])
    parts["(b) attribution"] = time.perf_counter() - t
    t = time.perf_counter()
    prof = prod_profiler(a, work) if device.type == "cuda" else None
    if prof is not None:
        log_profiler(prof)
    parts["(c) profiler"] = time.perf_counter() - t
    del a["net"], a["opt"], a["model"]
    profile.set_trace_dir(None)
    return a, res, costs, rep, prof, parts


def phase_production(train_step_ms):
    """Phase 20. Returns the launch counts of (a) and (c) by path and
    what the JSON line carries of the phase."""
    from paddle_tpu_torch.observability import goodput
    cfg = llama_bench_config()
    corpus = SyntheticCorpus(FIT_DOCUMENTS, cfg.vocab_size, SEED)
    device = torch.device("cuda")
    free_device_memory()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="phase20_", dir=REPO_ROOT)
    try:
        a, res, costs, rep, prof, parts = _phase_production(
            cfg, device, torch.bfloat16, 4, 2048, corpus, work,
            train_step_ms)
        free_device_memory()
        t = time.perf_counter()
        sub = prod_subprocesses(work, device)
        log_subprocesses(sub)
        parts["(d) subprocesses"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_device_memory()
    log("phase 20 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) +
        f"; phase 20 {time.perf_counter() - t_phase:.1f} s")
    goodput.reset_ledger()
    return {"train_prod": a["counts"], "profiler": prof["counts"]}, dict(
        fit_step_ms=res["med_ev"], mfu=res["mfu"],
        goodput_fraction=res["fraction"],
        telemetry_armed_ms=costs["armed"],
        telemetry_disarmed_ms=costs["disarmed"],
        numerics_sampled_ms=costs["sampled"],
        numerics_unsampled_ms=costs["unsampled"])


def log_fit(a, res, tap, fz, train_step_ms):
    bins = res["bins"]
    log(f"prod fit (a): {PROD_STEPS} steps, losses "
        f"{[round(v, 4) for v in res['losses']]} (step {PROD_POISON} "
        f"poisoned: a packed batch holds no float, so its loss was "
        f"corrupted); guard tripped once, rolled back to step "
        f"{PROD_POISON - 2}; provenance {res['prov']['verdict']} over "
        f"{len(res['prov']['replay']['taps'])} taps; a NaN weight's replay "
        f"named {tap['name']} ({tap['nonfinite_count']} non-finite)")
    log(f"prod fit (a): step median {res['med_ev']:.3f} ms by CUDA events "
        f"(steps 2-{PROD_STEPS}, data wait included; "
        f"{res['step_ms']:.3f} ms without it), train_step_seconds median "
        f"{res['med_tel']:.3f} ms; phase 7's TrainStep {train_step_ms:.3f} "
        f"ms; train_mfu_ratio {res['mfu']:.4f} of "
        f"{a['peak'] / 1e12:.1f} TFLOP/s for {a['flops']:.4e} flop a step;"
        f" step rows (step, ms, data ms): " + ", ".join(
            f"({r['step']}, {r['ms']:.3f}, {r['data_ms']:.3f})"
            for r in a["rec"].rows))
    log(f"prod fit (a): goodput over {res['wall_s']:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in bins.items()) +
        f"; job_goodput_fraction {res['fraction']:.4f}; fit wall "
        f"{a['wall']:.3f} s")
    log(f"prod fit (a): {res['samples']} numerics samples of {res['taps']} "
        f"taps, all finite; the step-{res['ckpt_step']} checkpoint's "
        f"numerics entry equals calibration_summary(); the window's trace "
        f"({res['trace_names']} names) holds {', '.join(PROD_TRACE_KERNELS)}"
        f"; flight recorder {res['events']} events of kinds "
        f"{res['kinds']}; launches {a['counts']}")
    log(f"prod fleetz (e): local_goodput steps {fz['local_goodput']['steps']}"
        f", fraction {fz['local_goodput']['job_goodput_fraction']}")


def log_costs(costs):
    log("prod costs: mean step of 4 (wall, loss read back), StepTimer + "
        "flight recorder armed / disarmed in turns A B B A: armed " +
        " / ".join(f"{x:.3f}" for x in costs["armed"]) + " ms, disarmed " +
        " / ".join(f"{x:.3f}" for x in costs["disarmed"]) +
        f" ms; a sampled numerics step {costs['sampled']:.3f} ms against "
        f"an unsampled {costs['unsampled']:.3f} ms")


def log_attribution(rep, step_ms, fit_ms):
    for fused, r in rep.items():
        log(f"prod attribution ({'fused' if fused else 'fused=False'}): "
            + json.dumps(r.to_json()["phases"]) +
            f"; sum {r.sum_seconds * 1e3:.3f} ms against the disarmed "
            f"step {step_ms:.3f} ms (fit step {fit_ms:.3f} ms); "
            f"{r.total_flops:.4e} flop")


def log_profiler(prof):
    log(f"prod profiler (c): step_info {prof['info']}; {prof['host_spans']} "
        f"host spans (op spans: {prof['ops'][:12]}), "
        f"{prof['device_events']} device event names; launches "
        f"{prof['counts']}")


def log_subprocesses(sub):
    log(f"prod subprocesses (d): watchdog kill -> exit 79 with "
        f"{sub['dump_events']} events of kinds {sub['kinds']} in its dump; "
        f"SIGKILL after step 3, resumed from step {sub['resumed_from'] - 1}"
        f": losses of steps 1-6 within {sub['rel_diff']:.2e} (rtol 1e-5) "
        f"of the uninterrupted run")


# --------------------------------------------------------------------------
# phase 21: data, tensor and sharded parallelism over torch.distributed
DIST_STEPS = (2, 5)      # (a): warm-up and timed steps
DIST_TWO_STEPS = 3       # (b): steps of each two-rank run
DIST_TWO_LAYERS = 2      # (b): the bench's widths cut to 2 layers, f32


def dist_timed(step, x, warmup, timed):
    """``warmup`` + ``timed`` steps of ``step`` on ``x``: the losses and
    each timed step's ms by CUDA events."""
    losses = [float(step(x)) for _ in range(warmup)]
    marks, outs = [], []
    for _ in range(timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs.append(step(x))
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return dict(losses=losses + [float(v) for v in outs],
                ms=[a.elapsed_time(b) for a, b in marks])


def _dist_batch(vocab, B=4, S=2048):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (B, S))).cuda()


def _dist_opt(model):
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=1e-4, parameters=model.parameters(),
                 multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))


def _dist_loss(m, x):
    return m(x, labels=x)[1]


def dist_one_rank():
    """Phase 21(a): the bench's recipe (phase 7's model, batch and
    optimizer) through ``init_parallel_env()`` (NCCL, world size 1),
    ``fleet.init`` -> ``distributed_model`` -> ``distributed_optimizer``
    -> ``TrainStep(mesh=init_mesh({"dp": 1}), bucketed=True)``, 2 + 5
    steps, against the unmeshed fused ``TrainStep`` of the same seed and
    batch (rtol 1e-3). Returns K1-K3's launches in the meshed run and its
    record."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.observability.comm import comm_totals
    from paddle_tpu_torch.observability.metrics import get_registry
    cfg = llama_bench_config()
    x = _dist_batch(cfg.vocab_size)
    free_device_memory()
    model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED)
    plain = dist_timed(TrainStep(model, _dist_loss, _dist_opt(model)), x,
                       *DIST_STEPS)
    del model
    free_device_memory()
    t = time.perf_counter()
    dist.init_parallel_env()
    fleet.init(is_collective=True)
    init_s = time.perf_counter() - t
    model = fleet.distributed_model(
        LlamaForCausalLM(cfg, dtype="bfloat16", seed=SEED))
    opt = fleet.distributed_optimizer(_dist_opt(model))
    step = TrainStep(model, _dist_loss, opt,
                     mesh=dist.init_mesh({"dp": 1}), bucketed=True)
    # the warm-up steps make the NCCL communicators: the counts and the
    # comm totals are the timed steps'
    warm = dist_timed(step, x, DIST_STEPS[0], 0)
    calls = get_registry().get("comm_calls_total")
    _reset_flash_counts()
    _reset_fused_counts()
    ar0, c0 = calls.value(op="all_reduce", axes="dp"), comm_totals()
    meshed = dist_timed(step, x, 0, DIST_STEPS[1])
    meshed["losses"] = warm["losses"] + meshed["losses"]
    counts = _flash_counts()
    fused_counts = _fused_counts()
    c1 = comm_totals()
    n = DIST_STEPS[1]
    all_reduces = (calls.value(op="all_reduce", axes="dp") - ar0) / n
    plan = step._mesh_plan
    buckets = len(plan.comm_buckets)
    if all_reduces != buckets:
        raise AssertionError(f"dist (a): {all_reduces} all-reduces a step "
                             f"for {buckets} buckets")
    for kname, c in counts.items():
        if c != n * cfg.num_hidden_layers:
            raise AssertionError(f"dist (a): {kname} launched {c} times in "
                                 f"{n} steps")
    if not np.allclose(meshed["losses"], plain["losses"], rtol=1e-3,
                       atol=0):
        raise AssertionError(f"dist (a): meshed losses {meshed['losses']} "
                             f"and unmeshed {plain['losses']} differ by "
                             f"more than rtol 1e-3")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    nccl = [(us, key, c) for us, key, c in rows if "nccl" in key.lower()]
    nccl_ms = sum(us for us, _, _ in nccl) / 1e3
    dev_ms = sum(us for us, _, _ in rows) / 1e3
    per = {k: (c1[k] - c0[k]) / n for k in c0}
    med_plain = statistics.median(plain["ms"])
    med_mesh = statistics.median(meshed["ms"])
    bucket_bytes = [sum(plan._params[nm].numel() *
                        plan._params[nm].element_size() for nm in b)
                    for b in plan.comm_buckets]
    log(f"dist (a): init_parallel_env (nccl, world 1) + fleet.init "
        f"{init_s:.2f} s; mesh {dict(zip(step._mesh_plan.mesh.mesh_dim_names, step._mesh_plan.mesh.shape))}, "
        f"distributed_model -> {type(model).__name__}; {buckets} gradient "
        f"buckets of 25 MB (bytes: min {min(bucket_bytes)}, max "
        f"{max(bucket_bytes)}, sum {sum(bucket_bytes)})")
    log(f"dist (a): losses {[round(v, 5) for v in meshed['losses']]} "
        f"against the unmeshed step's "
        f"{[round(v, 5) for v in plain['losses']]} (rtol 1e-3)")
    log(f"dist (a): step ms by CUDA events, meshed "
        f"{[round(v, 3) for v in meshed['ms']]} (median {med_mesh:.3f}) "
        f"against unmeshed {[round(v, 3) for v in plain['ms']]} (median "
        f"{med_plain:.3f}); {all_reduces:.0f} all-reduces a step (= the "
        f"bucket count), {per['comm_bytes_total']:.0f} B a step through "
        f"them, host seconds a step inside the collectives' spans "
        f"{per['comm_seconds_total']:.6f} (exposed "
        f"{per['comm_exposed_seconds_total']:.6f}, overlapped "
        f"{per['comm_overlapped_seconds_total']:.6f})")
    log(f"dist (a): a profiled step: NCCL kernels {nccl_ms:.3f} device ms "
        f"in {sum(c for _, _, c in nccl)} launches of "
        f"{sorted({k for _, k, _ in nccl})[:3]}, of {dev_ms:.3f} device ms "
        f"(the largest kernels: "
        f"{[(k[:40], round(us / 1e3, 3)) for us, k, _ in rows[:6]]}); "
        f"counts over the {n} timed steps: "
        f"K1-K3 {counts['flash_attention_fwd'] // n}, "
        f"{counts['flash_attention_dq'] // n}, "
        f"{counts['flash_attention_dkv'] // n} a step; fused_adam_update "
        f"{fused_counts['fused_adam_update']} and fused_sqnorm "
        f"{fused_counts['fused_sqnorm']} in {n} steps")
    del step, opt, model
    free_device_memory()
    dist.destroy_process_group()
    return {**counts, **fused_counts}, dict(
        step_ms=med_mesh, unmeshed_step_ms=med_plain,
        all_reduces_per_step=all_reduces, buckets=buckets,
        nccl_ms_per_step=nccl_ms,
        comm_bytes_per_step=per["comm_bytes_total"])


def dist_two_rank_config():
    return dataclasses.replace(llama_bench_config(),
                               num_hidden_layers=DIST_TWO_LAYERS)


def _two_rank_worker(out_dir):
    """One of phase 21(b)'s two processes on the one card: dp 2, then mp
    2, each through fleet and a meshed ``TrainStep`` over gloo, in f32;
    writes its losses, step ms and K1-K3 launches to
    ``out_dir/rank<r>.json``."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    cfg = dist_two_rank_config()
    x = _dist_batch(cfg.vocab_size)
    res = {}
    for name, degrees in (("dp2", {"dp_degree": 2}),
                          ("mp2", {"mp_degree": 2})):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                            "sharding_degree": 1, **degrees}
        fleet.init(is_collective=True, strategy=s)
        model = fleet.distributed_model(LlamaForCausalLM(
            dataclasses.replace(cfg, tensor_parallel=name == "mp2"),
            dtype="float32", seed=SEED))
        opt = fleet.distributed_optimizer(_dist_opt(model))
        step = TrainStep(model, _dist_loss, opt, mesh=dist.get_mesh(),
                         bucketed=True)
        _reset_flash_counts()
        run = dist_timed(step, x, 0, DIST_TWO_STEPS)
        res[name] = dict(run, launches=_flash_counts(),
                         model=type(model).__name__)
        del step, opt, model
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dist_two_ranks():
    """Phase 21(b): two processes started by the port's ``spawn`` share
    the card over gloo (NCCL refuses two ranks on one device): the
    bench's widths at 2 layers in f32, 3 steps at dp 2 and 3 at mp 2,
    each rank's losses against one process's on the same global batch
    at rtol 1e-4. Returns K1-K3's launches on both ranks and the
    record."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cfg = dist_two_rank_config()
    free_device_memory()
    model = LlamaForCausalLM(cfg, dtype="float32", seed=SEED)
    one = dist_timed(TrainStep(model, _dist_loss, _dist_opt(model)),
                     _dist_batch(cfg.vocab_size), 0, DIST_TWO_STEPS)
    del model
    free_device_memory()
    out_dir = tempfile.mkdtemp(prefix="phase21_", dir=REPO_ROOT)
    try:
        t = time.perf_counter()
        procs = dist.spawn(_two_rank_worker, args=(out_dir,), nprocs=2,
                           join=False)
        for p in procs:
            p.join(timeout=max(420 - (time.perf_counter() - t), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"dist (b): ranks exited "
                                 f"{[p.exitcode for p in procs]}")
        wall = time.perf_counter() - t
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    counts = dict.fromkeys(ranks[0]["dp2"]["launches"], 0)
    for r, res in enumerate(ranks):
        for name in ("dp2", "mp2"):
            got = res[name]["losses"]
            if not np.allclose(got, one["losses"], rtol=1e-4, atol=0):
                raise AssertionError(
                    f"dist (b): rank {r} {name} losses {got} and one "
                    f"process's {one['losses']} differ by more than rtol "
                    f"1e-4")
            for kname, c in res[name]["launches"].items():
                if c != DIST_TWO_STEPS * cfg.num_hidden_layers:
                    raise AssertionError(f"dist (b): rank {r} {name} "
                                         f"{kname} launched {c} times")
                counts[kname] += c
    log(f"dist (b): two processes on one card over gloo (spawn, "
        f"{wall:.1f} s with their start), the bench's widths at "
        f"{cfg.num_hidden_layers} layers in f32, {DIST_TWO_STEPS} steps "
        f"each: losses dp 2 {[round(v, 6) for v in ranks[0]['dp2']['losses']]}"
        f" ({ranks[0]['dp2']['model']}), mp 2 "
        f"{[round(v, 6) for v in ranks[0]['mp2']['losses']]}, one process "
        f"{[round(v, 6) for v in one['losses']]} (rtol 1e-4, both ranks)")
    log(f"dist (b): step ms by CUDA events (two processes share one card "
        f"and gloo stages every collective through the host, so these are "
        f"no measure of scaling): one process "
        f"{[round(v, 3) for v in one['ms']]}; dp 2 rank 0 "
        f"{[round(v, 3) for v in ranks[0]['dp2']['ms']]}, rank 1 "
        f"{[round(v, 3) for v in ranks[1]['dp2']['ms']]}; mp 2 rank 0 "
        f"{[round(v, 3) for v in ranks[0]['mp2']['ms']]}, rank 1 "
        f"{[round(v, 3) for v in ranks[1]['mp2']['ms']]}; K1-K3 launches "
        f"on both ranks {counts}")
    return counts, dict(one_process_ms=one["ms"],
                        dp2_ms=ranks[0]["dp2"]["ms"],
                        mp2_ms=ranks[0]["mp2"]["ms"])


def phase_distributed():
    """Phase 21. Returns K1-K3's launches by path and the record."""
    t0 = time.perf_counter()
    a_counts, a_rec = dist_one_rank()
    t1 = time.perf_counter()
    b_counts, b_rec = dist_two_ranks()
    t2 = time.perf_counter()
    log(f"phase 21 seconds by part: (a) one rank {t1 - t0:.1f}, (b) two "
        f"ranks {t2 - t1:.1f}; phase 21 {t2 - t0:.1f} s")
    return {"dist_one_rank": a_counts, "dist_two_ranks": b_counts}, \
        dict(one_rank=a_rec, two_ranks=b_rec)

# --------------------------------------------------------------------------
# phase 22: pipeline and sequence parallelism over torch.distributed
SP_SHAPE = (1, 32768, 32, 128)  # B, S, heads (Llama-3-8B's q heads), hd
PP_ERNIE = dict(vocab=18000, d=768, heads=12, ff=3072, layers=12)
PP_BATCH = (16, 512)              # rows x tokens
PP_MICRO = 4                      # accumulate_steps
PP_STEPS = 3


def _sp_global(device="cuda"):
    """Phase 22(a)'s global q, k, v and output gradient, bf16, drawn from
    one seeded generator (every rank draws the same)."""
    g = torch.Generator(device=device).manual_seed(SEED + 22)
    return [torch.randn(SP_SHAPE, generator=g, device=device,
                        dtype=torch.bfloat16) for _ in range(4)]


def _events_ms(fn):
    """``fn()``'s result and its ms by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


# Phase 22(a)'s limits. At 16384-32768 keys the values compared are about
# as small as FLASH_TOL's absolute bf16 limits (o and dq near 1e-2, rank
# 1's dk and dv near 6e-3), which would pass a block dropped or weighted
# by the wrong lse. So each tensor is held by its norm, ||got - want|| /
# ||want|| within SP_REL, and everywhere by |got - want| within
# SP_ATOL_RMS times want's RMS plus FLASH_TOL's rtol times |want|; lse
# (f32, near ln S) keeps FLASH_TOL's limits. Measured on the card (H100
# 80GB HBM3, 700.00 W; PERF.md): norm-relative errors up to 3.4e-3 and
# excesses up to 0.073 RMS (the whole sequence's dq, where the first
# rows' large values cancel), against 0.475-3.33 and 3.5-322 RMS for
# the faults these limits are for, which the phase also runs as
# controls that must fail (``_must_fail``): K2/K3 fed a block's own lse,
# the past block skipped, dk and dv at half their value
SP_REL = 1e-2
SP_ATOL_RMS = 0.25


def _norm_err(got, want, rtol):
    """Phase 22(a)'s measures of ``got`` against ``want``: max |err|, the
    norm-relative error, want's RMS, the largest |err| - rtol * |want| in
    units of that RMS, and whether all are within the limits."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    rms = float(want.square().mean().sqrt())
    rel = float(err.square().sum().sqrt()) / max(
        float(want.square().sum().sqrt()), 1e-30)
    excess = float((err - rtol * want.abs()).max()) / max(rms, 1e-30)
    ok = bool(torch.isfinite(got).all()) and rel <= SP_REL and \
        excess <= SP_ATOL_RMS
    return dict(max_abs_err=float(err.max()), rel_err=rel, rms=rms,
                excess_rms=excess, ok=ok)


def _fmt_err(rec):
    return (f"max |err| {rec['max_abs_err']:.3e}, rel {rec['rel_err']:.3e}, "
            f"excess {rec['excess_rms']:.3e} rms (rms {rec['rms']:.3e})")


def _norm_check(what, got, want, rtol):
    """Phase 22(a)'s comparison (``_norm_err``); raises unless within the
    limits."""
    rec = _norm_err(got, want, rtol)
    if not rec["ok"]:
        raise AssertionError(
            f"{what}: disagrees with its reference: {_fmt_err(rec)} (limits "
            f"rel {SP_REL}, excess {SP_ATOL_RMS} rms, rtol {rtol})")
    return rec


def _must_fail(what, got, want, rtol):
    """A control: a wrong result that phase 22(a)'s limits must reject."""
    rec = _norm_err(got, want, rtol)
    if rec["ok"]:
        raise AssertionError(
            f"control {what} passes phase 22(a)'s limits ({_fmt_err(rec)}): "
            f"they would not see the fault")
    return rec


def ring_block_check(q, k, v, do):
    """Phase 22(a), one process: the block calls rank 1 of the ring makes,
    at their shape (the global q, k, v and do of ``_sp_global``: 32
    heads, 16384 queries, hd 128, bf16): K1 on the diagonal block
    (causal) and on the past block, merged through their lse, and K2/K3
    on each block with the merged output and the global lse. Held
    against the plain versions, run 2 heads at a time for their [S, S]
    scores: each block's o and lse, the merged o and lse against the
    plain forward over both blocks' keys, each block's dq, dk and dv.
    Controls that must fail: the diagonal block's o as the merged one
    (the past block skipped), and K2/K3 on the past block paired with
    that block's own o and lse (not the global ones). Uncounted. Returns
    {kernel: max |err|} and every measure."""
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import (
        _merge, _to_k)
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    S, hd = SP_SHAPE[1], SP_SHAPE[3]
    half = S // 2
    q1, kd, vd, do1 = (_to_k(t[:, half:]) for t in (q, k, v, do))
    kp, vp = (_to_k(t[:, :half]) for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    o_rtol, g_rtol = (t[1] for t in FLASH_TOL[torch.bfloat16])
    o_tol = FLASH_TOL[torch.bfloat16][0]

    def run():
        o1, lse1 = fa.flash_block_fwd(q1, kd, vd, True, scale)
        o2, lse2 = fa.flash_block_fwd(q1, kp, vp, False, scale)
        acc, lse = _merge(o1.float(), lse1, o2, lse2)
        o = acc.to(torch.bfloat16)
        delta = (do1.float() * o.float()).sum(-1)
        return dict(
            o1=o1, lse1=lse1, o2=o2, lse2=lse2, o=o, lse=lse, delta=delta,
            diag=fa.flash_block_bwd(q1, kd, vd, o, lse, do1, True, scale,
                                    delta),
            past=fa.flash_block_bwd(q1, kp, vp, o, lse, do1, False, scale,
                                    delta),
            past_own=fa.flash_block_bwd(q1, kp, vp, o2, lse2, do1, False,
                                        scale))
    got = _uncounted_flash(run)
    gc_ = fa.FlashGeometry(hq=1, hkv=1, causal=True, sm_scale=scale)
    gf = fa.FlashGeometry(hq=1, hkv=1, causal=False, sm_scale=scale)
    kw, vw = torch.cat([kp, kd], 1), torch.cat([vp, vd], 1)
    want = {}
    for i in range(0, q1.shape[0], 2):
        h = slice(i, i + 2)
        parts = dict(zip(("o1", "lse1"),
                         fa._forward_plain(q1[h], kd[h], vd[h], gc_)))
        parts.update(zip(("o2", "lse2"),
                         fa._forward_plain(q1[h], kp[h], vp[h], gf)))
        # keys [past, diagonal], causal at offset 16384: the whole row
        parts.update(zip(("o", "lse"),
                         fa._forward_plain(q1[h], kw[h], vw[h], gc_)))
        for blk, kk, vv, g in (("diag", kd, vd, gc_), ("past", kp, vp, gf)):
            args = (q1[h], kk[h], vv[h], do1[h], got["lse"][h],
                    got["delta"][h], g)
            parts[blk] = (fa._dq_plain(*args), *fa._dkv_plain(*args))
        for key, t in parts.items():
            want.setdefault(key, []).append(t)
        del parts, args
    want = {key: (torch.cat(ts) if torch.is_tensor(ts[0]) else
                  [torch.cat(c) for c in zip(*ts)])
            for key, ts in want.items()}
    free_device_memory()
    rec = {}
    for blk in ("1", "2"):
        name = "diagonal" if blk == "1" else "past"
        rec[f"K1 o {name}"] = _norm_check(
            f"ring block {name} K1 o", got["o" + blk], want["o" + blk], o_rtol)
        rec[f"K1 lse {name}"] = dict(max_abs_err=_check(
            f"ring block {name} K1 lse", got["lse" + blk], want["lse" + blk],
            *o_tol))
    rec["merged o"] = _norm_check("ring blocks merged o", got["o"],
                                  want["o"], o_rtol)
    rec["merged lse"] = dict(max_abs_err=_check(
        "ring blocks merged lse", got["lse"], want["lse"], *o_tol))
    for blk in ("diag", "past"):
        for what, g_, w_ in zip(("dq", "dk", "dv"), got[blk], want[blk]):
            kname = "K2" if what == "dq" else "K3"
            rec[f"{kname} {what} {blk}"] = _norm_check(
                f"ring block {blk} {kname} {what} (global lse)", g_, w_,
                g_rtol)
    controls = {"past block skipped: o": _must_fail(
        "the diagonal block's o as the merged o", got["o1"], want["o"],
        o_rtol)}
    for what, g_, w_ in zip(("dq", "dk", "dv"), got["past_own"],
                            want["past"]):
        controls[f"own lse: {what}"] = _must_fail(
            f"K2/K3 on the past block with its own o and lse: {what}", g_,
            w_, g_rtol)
    errs = {
        "flash_attention_fwd": max(rec[k_]["max_abs_err"] for k_ in rec
                                   if k_.startswith(("K1", "merged"))),
        "flash_attention_dq": max(rec[k_]["max_abs_err"] for k_ in rec
                                  if k_.startswith("K2")),
        "flash_attention_dkv": max(rec[k_]["max_abs_err"] for k_ in rec
                                   if k_.startswith("K3"))}
    log(f"seq (a): ring-flash's block calls (rank 1's) at "
        f"{list(q1.shape)} bf16 against the plain versions, 2 heads at a "
        f"time (the diagonal block causal, the past block full, K2/K3 on "
        f"the merged output with the global lse):")
    for key, r in rec.items():
        log(f"  {key}: " + (_fmt_err(r) if "rel_err" in r else
                            f"max |err| {r['max_abs_err']:.3e}"))
    for key, r in controls.items():
        log(f"  control {key}: rejected, {_fmt_err(r)}")
    del got, want
    free_device_memory()
    return errs, dict(checks=rec, controls=controls)


def whole_sequence_check(q, k, v, do):
    """Phase 22(a)'s reference, one process: K1-K3 through
    ``flash_attention_bshd`` on the whole causal sequence (what each
    rank's shards are held against) against the plain versions at
    [32 heads, 32768, 128], one head at a time (the plain backward from
    the plain forward's o and lse). Uncounted. Returns the measures."""
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import _to_k
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    o_rtol, g_rtol = (t[1] for t in FLASH_TOL[torch.bfloat16])

    def whole():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention_bshd(qq, kk, vv, causal=True)
        o.backward(do)
        return [_to_k(t) for t in (o.detach(), qq.grad, kk.grad, vv.grad)]
    got = _uncounted_flash(whole)
    qk, kk, vk, dok = (_to_k(t) for t in (q, k, v, do))
    g = fa.FlashGeometry(hq=1, hkv=1, causal=True,
                         sm_scale=1.0 / math.sqrt(SP_SHAPE[3]))
    want = [[], [], [], []]
    for i in range(qk.shape[0]):
        h = slice(i, i + 1)
        o_, lse_ = fa._forward_plain(qk[h], kk[h], vk[h], g)
        delta_ = (dok[h].float() * o_.float()).sum(-1)
        args = (qk[h], kk[h], vk[h], dok[h], lse_, delta_, g)
        for w, t in zip(want, (o_, fa._dq_plain(*args),
                               *fa._dkv_plain(*args))):
            w.append(t)
        del o_, lse_, delta_, args
    want = [torch.cat(w) for w in want]
    free_device_memory()
    rec = {what: _norm_check(f"seq (a) the whole sequence's {what}", g_, w_,
                             tol)
           for what, g_, w_, tol in zip(
               ("o", "dq", "dk", "dv"), got, want,
               (o_rtol, g_rtol, g_rtol, g_rtol))}
    log(f"seq (a): K1-K3 on the whole sequence {list(qk.shape)} bf16 causal "
        f"against the plain versions, one head at a time: " + "; ".join(
            f"{k_} {_fmt_err(r)}" for k_, r in rec.items()))
    del got, want
    free_device_memory()
    return rec


def _sp_part(rank, n):
    """Phase 22(a) on one rank: ring-flash (``use_flash=None``, so the
    kernel path) and Ulysses at SP_SHAPE, causal, each forward and
    backward, this rank's output and q/k/v gradient shards held against
    K1-K3 on the whole sequence in this process (which the parent holds
    against the plain versions). Controls that must fail: dk and dv at
    half their value and, on a rank with a past block, its diagonal
    block's output alone. Returns the record."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import (
        _from_k, _to_k)
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    dist.init_mesh({"sp": n})
    q, k, v, do = _sp_global()
    B, S, H, hd = SP_SHAPE
    lo, hi = rank * S // n, (rank + 1) * S // n

    def whole():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention_bshd(qq, kk, vv, causal=True)
        o.backward(do)
        return [t[:, lo:hi].contiguous() for t in
                (o.detach(), qq.grad, kk.grad, vv.grad)]
    want = _uncounted_flash(whole)  # the process's first K1-K3 calls
    _, whole_ms = _events_ms(lambda: _uncounted_flash(whole))
    free_device_memory()
    o_rtol, g_rtol = (t[1] for t in FLASH_TOL[torch.bfloat16])
    rtols = (o_rtol, g_rtol, g_rtol, g_rtol)
    rec = dict(whole_ms=whole_ms)
    for name, fn in (("ring", fleet.ring_attention),
                     ("ulysses", fleet.ulysses_attention)):
        ql, kl, vl = (t[:, lo:hi].contiguous().requires_grad_()
                      for t in (q, k, v))
        dist.barrier()
        _reset_flash_counts()
        out, fwd_ms = _events_ms(lambda: fn(ql, kl, vl, causal=True))
        _, bwd_ms = _events_ms(
            lambda: out.backward(do[:, lo:hi].contiguous()))
        counts = _flash_counts()
        errs = {what: _norm_check(f"seq (a) {name} rank {rank} {what}", got,
                                  ref, tol)
                for what, got, ref, tol in zip(
                    ("o", "dq", "dk", "dv"),
                    (out, ql.grad, kl.grad, vl.grad), want, rtols)}
        controls = {}
        if name == "ring":
            for what, got, ref in (("dk", kl.grad, want[2]),
                                   ("dv", vl.grad, want[3])):
                controls[f"{what} halved"] = _must_fail(
                    f"rank {rank}'s {what} at half its value", 0.5 * got,
                    ref, g_rtol)
            if rank > 0:
                diag = _uncounted_flash(lambda: fa.flash_block_fwd(
                    *(_to_k(t.detach()) for t in (ql, kl, vl)), True,
                    1.0 / math.sqrt(hd))[0])
                controls["past blocks skipped: o"] = _must_fail(
                    f"rank {rank}'s diagonal block alone as its output",
                    _from_k(diag, B, H), want[0], o_rtol)
        rec[name] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, launches=counts,
                         max_abs_err={k_: r["max_abs_err"]
                                      for k_, r in errs.items()},
                         measures=errs, controls=controls)
        del out, ql, kl, vl
        free_device_memory()
    del q, k, v, do, want
    free_device_memory()
    return rec


class _PpEmbed(torch.nn.Module):
    def __init__(self, vocab, d):
        super().__init__()
        from paddle_tpu_torch import nn
        self.word = nn.Embedding(vocab, d)

    def forward(self, ids):
        return self.word(ids)


class _PpHead(torch.nn.Module):
    def __init__(self, d, vocab):
        super().__init__()
        from paddle_tpu_torch import nn
        self.out = nn.Linear(d, vocab)

    def forward(self, h):
        return self.out(h)


def _pp_items(desc):
    """Phase 22(b)'s stack as ``(class, args, kwargs)``: an embedding,
    ERNIE-base's 12 encoder layers (dropout 0) and a vocabulary head."""
    from paddle_tpu_torch import nn
    c = PP_ERNIE
    enc = (nn.TransformerEncoderLayer, (c["d"], c["heads"], c["ff"]),
           dict(dropout=0.0))
    return [(_PpEmbed, (c["vocab"], c["d"]), {})] + [enc] * c["layers"] + \
        [(_PpHead, (c["d"], c["vocab"]), {})]


def _pp_init(layer, position):
    """Weights of the layer at ``position`` of the stack, the same in every
    process whichever rank builds it: 2-D weights ~ N(0, 0.02) from a
    generator seeded by the position (ERNIE's recipe), biases 0,
    LayerNorm scales 1."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1000 + position)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if p.dim() >= 2:
                p.copy_(0.02 * torch.randn(p.shape, generator=g,
                                           device="cuda"))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def _pp_batch():
    g = torch.Generator(device="cuda").manual_seed(SEED + 2200)
    ids = torch.randint(0, PP_ERNIE["vocab"], PP_BATCH, generator=g,
                        device="cuda")
    labels = torch.randint(0, PP_ERNIE["vocab"], PP_BATCH, generator=g,
                           device="cuda")
    return ids, labels


def _pp_loss(logits, labels):
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def _spmd_batch():
    g = torch.Generator(device="cuda").manual_seed(SEED + 2201)
    shape = (*PP_BATCH, PP_ERNIE["d"])
    return (torch.randn(shape, generator=g, device="cuda"),
            torch.randn(shape, generator=g, device="cuda"))


def _pp_opt(params):
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=1e-4, parameters=params,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def _pp_part(rank, n):
    """Phase 22(b) on one rank (pp 2, f32): ``PipelineParallel`` over the
    ERNIE-width ``PipelineLayer`` at v 1 and v 2, then
    ``SpmdPipelineParallel`` with the encoder layer as its block (v 6:
    12 chunks, ``remat=False``), PP_STEPS steps each. Returns the
    record."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    dist.init_mesh({"pp": n})
    ids, labels = _pp_batch()
    rec = {}
    for v in (1, 2):
        descs = [fleet.LayerDesc(cls, *a, **kw)
                 for cls, a, kw in _pp_items(None)]
        pl = fleet.PipelineLayer(descs, num_virtual_pipeline_stages=v,
                                 loss_fn=_pp_loss)
        for key, layer in pl.layers.named_children():
            _pp_init(layer, int(key))
        local = sum(isinstance(m, nn.TransformerEncoderLayer)
                    for m in pl.layers.children())
        pp = fleet.PipelineParallel(pl, accumulate_steps=PP_MICRO)
        opt = _pp_opt(pp.parameters())
        dist.barrier()
        _reset_flash_counts()
        losses, ms = [], []
        for _ in range(PP_STEPS):
            loss, t = _events_ms(lambda: pp.train_batch((ids, labels), opt))
            losses.append(float(loss.detach()))
            ms.append(t)
        rec[f"v{v}"] = dict(losses=losses, ms=ms, launches=_flash_counts(),
                            local_layers=local,
                            stats=pp.last_schedule_stats)
        del pl, pp, opt
        free_device_memory()
    x, y = _spmd_batch()
    c = PP_ERNIE
    spl = fleet.SpmdPipelineLayer(
        lambda: nn.TransformerEncoderLayer(c["d"], c["heads"], c["ff"],
                                           dropout=0.0),
        num_virtual_stages=c["layers"] // n, remat=False,
        loss_fn=nn.MSELoss())
    spl.set_state_dict(_spmd_state(n))
    eng = fleet.SpmdPipelineParallel(spl, accumulate_steps=PP_MICRO)
    opt = _pp_opt(eng.parameters())
    dist.barrier()
    _reset_flash_counts()
    losses, ms = [], []
    for _ in range(PP_STEPS):
        loss, t = _events_ms(lambda: eng.train_batch((x, y), opt))
        losses.append(float(loss.detach()))
        ms.append(t)
    rec["spmd"] = dict(losses=losses, ms=ms, launches=_flash_counts(),
                       local_layers=spl.num_virtual_stages,
                       stats=eng.last_schedule_stats)
    del spl, eng, opt
    free_device_memory()
    return rec


def _spmd_state(n):
    """The stacked ``[v, S, ...]`` state of phase 22(b)'s SPMD trunk:
    chunk c = r*S + s is the stack's encoder layer c (position c + 1),
    initialised by ``_pp_init``."""
    from paddle_tpu_torch import nn
    c = PP_ERNIE
    v = c["layers"] // n
    per = []
    for i in range(c["layers"]):
        layer = nn.TransformerEncoderLayer(c["d"], c["heads"], c["ff"],
                                           dropout=0.0)
        _pp_init(layer, i + 1)
        per.append({k.replace(".", "__"): p.detach()
                    for k, p in layer.named_parameters()})
    return {k: torch.stack([d[k] for d in per]).reshape(
        v, n, *per[0][k].shape) for k in per[0]}


def _seq_pipe_worker(out_dir):
    """One of phase 22's two processes sharing the card over gloo: (a)
    then (b); writes its record to ``out_dir/rank<r>.json``."""
    import paddle_tpu_torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    rec = dict(a=_sp_part(rank, n))
    t1 = time.perf_counter()
    rec["b"] = _pp_part(rank, n)
    rec["seconds"] = dict(a=t1 - t0, b=time.perf_counter() - t1)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _pp_reference():
    """Phase 22(b) unpipelined, in this process: the same stack and
    initial weights, 4 micro-batches a step with their gradients summed,
    then the SPMD trunk's 12 layers on the whole batch. Returns both
    runs' losses."""
    from paddle_tpu_torch import nn
    ids, labels = _pp_batch()
    layers = []
    for i, (cls, a, kw) in enumerate(_pp_items(None)):
        layer = cls(*a, **kw)
        _pp_init(layer, i)
        layers.append(layer.cuda())
    model = torch.nn.Sequential(*layers)
    opt = _pp_opt(list(model.parameters()))
    pp = []
    for _ in range(PP_STEPS):
        mb = []
        for xb, yb in zip(ids.chunk(PP_MICRO), labels.chunk(PP_MICRO)):
            loss = _pp_loss(model(xb), yb)
            (loss / PP_MICRO).backward()
            mb.append(float(loss.detach()))
        opt.step()
        opt.clear_grad()
        pp.append(sum(mb) / PP_MICRO)
    trunk = torch.nn.Sequential(*layers[1:-1])
    for i, layer in enumerate(trunk):
        _pp_init(layer, i + 1)
    opt = _pp_opt(list(trunk.parameters()))
    x, y = _spmd_batch()
    spmd = []
    for _ in range(PP_STEPS):
        loss = torch.nn.functional.mse_loss(trunk(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        spmd.append(float(loss.detach()))
    del model, trunk, layers, opt
    free_device_memory()
    return pp, spmd


def phase_seq_pipe():
    """Phase 22: two processes started by the port's ``spawn`` share the
    card over gloo: (a) ring-flash and Ulysses at sp 2 on a 32768-token
    causal sequence of 32 heads at hd 128 in bf16, each rank's shards
    against K1-K3 on the whole sequence; (b) pp 2 in f32 at ERNIE-base
    widths: ``PipelineParallel`` (v 1, v 2) and ``SpmdPipelineParallel``,
    their losses against one process's at rtol 1e-4. Returns K1-K3's
    launches by path and the record."""
    import paddle_tpu_torch.distributed as dist
    t0 = time.perf_counter()
    sp = _sp_global()
    block_errs, block_rec = ring_block_check(*sp)
    whole_rec = whole_sequence_check(*sp)
    del sp
    free_device_memory()
    ref_pp, ref_spmd = _uncounted_flash(_pp_reference)
    t1 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="phase22_", dir=REPO_ROOT)
    try:
        procs = dist.spawn(_seq_pipe_worker, args=(out_dir,), nprocs=2,
                           join=False)
        for p in procs:
            p.join(timeout=max(300 - (time.perf_counter() - t1), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 22: ranks exited "
                                 f"{[p.exitcode for p in procs]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    t2 = time.perf_counter()
    paths = {"ring_flash": {}, "ulysses": {}, "pipeline": {},
             "spmd_pipeline": {}}
    kernels = ("flash_attention_fwd", "flash_attention_dq",
               "flash_attention_dkv")
    for r, rec in enumerate(ranks):
        # ring: rank r runs its diagonal block and the r past ones
        for part, want in (("ring", r + 1), ("ulysses", 1)):
            got = rec["a"][part]["launches"]
            if any(got[k] != want for k in kernels):
                raise AssertionError(f"seq (a) {part} rank {r}: launches "
                                     f"{got}, not {want} each")
            key = "ring_flash" if part == "ring" else "ulysses"
            for k in kernels:
                paths[key][k] = paths[key].get(k, 0) + got[k]
        for part, ref in (("v1", ref_pp), ("v2", ref_pp),
                          ("spmd", ref_spmd)):
            b = rec["b"][part]
            if not np.allclose(b["losses"], ref, rtol=1e-4, atol=0):
                raise AssertionError(
                    f"seq (b) {part} rank {r}: losses {b['losses']} and "
                    f"one process's {ref} differ by more than rtol 1e-4")
            want = PP_STEPS * PP_MICRO * b["local_layers"]
            if b["local_layers"] != PP_ERNIE["layers"] // 2 or any(
                    b["launches"][k] != want for k in kernels):
                raise AssertionError(
                    f"seq (b) {part} rank {r}: launches {b['launches']} "
                    f"over {b['local_layers']} local layers, not {want}")
            key = "spmd_pipeline" if part == "spmd" else "pipeline"
            for k in kernels:
                paths[key][k] = paths[key].get(k, 0) + b["launches"][k]
    for r, rec in enumerate(ranks):
        a = rec["a"]
        log(f"seq (a) rank {r}: ring-flash sp 2 at {list(SP_SHAPE)} bf16 "
            f"causal: fwd {a['ring']['fwd_ms']:.1f} ms, bwd "
            f"{a['ring']['bwd_ms']:.1f} ms, K1/K2/K3 launches "
            f"{a['ring']['launches']}; Ulysses fwd "
            f"{a['ulysses']['fwd_ms']:.1f} ms, bwd "
            f"{a['ulysses']['bwd_ms']:.1f} ms, launches "
            f"{a['ulysses']['launches']}; the whole sequence in one "
            f"process (fwd + bwd, a second run) {a['whole_ms']:.1f} ms (ms "
            f"by CUDA events; "
            f"two processes share one card and gloo stages every hop "
            f"through the host, so these are no measure of scaling)")
        for part in ("ring", "ulysses"):
            for what, m in a[part]["measures"].items():
                log(f"  {part} rank {r} {what} against the whole sequence's "
                    f"K1-K3: {_fmt_err(m)}")
            for what, m in a[part]["controls"].items():
                log(f"  {part} rank {r} control {what}: rejected, "
                    f"{_fmt_err(m)}")
    for r, rec in enumerate(ranks):
        for part in ("v1", "v2", "spmd"):
            b = rec["b"][part]
            log(f"seq (b) rank {r} {part}: losses "
                f"{[round(x, 6) for x in b['losses']]} (one process: "
                f"{[round(x, 6) for x in (ref_spmd if part == 'spmd' else ref_pp)]}, "
                f"rtol 1e-4), step ms {[round(x, 1) for x in b['ms']]}, "
                f"K1-K3 launches {b['launches']} over {b['local_layers']} "
                f"local encoder layers, last_schedule_stats {b['stats']}")
    secs = [rec["seconds"] for rec in ranks]
    log(f"phase 22 seconds by part: the block and whole-sequence checks "
        f"and the one-process pipeline reference "
        f"{t1 - t0:.1f}; the two ranks {t2 - t1:.1f} (with their start; "
        f"rank 0's (a) {secs[0]['a']:.1f}, (b) {secs[0]['b']:.1f}); phase "
        f"22 {t2 - t0:.1f} s")
    return paths, dict(block_max_abs_err=block_errs, blocks=block_rec,
                       whole_sequence=whole_rec,
                       ranks=[rec["a"] for rec in ranks],
                       pipeline=[{k: dict(losses=rec["b"][k]["losses"],
                                          ms=rec["b"][k]["ms"],
                                          stats=rec["b"][k]["stats"])
                                  for k in ("v1", "v2", "spmd")}
                                 for rec in ranks],
                       seconds=dict(setup=t1 - t0, ranks=t2 - t1))




# --------------------------------------------------------------------------
# phase 23: the multi-process job lifecycle under the port's launcher
JOB_STEPS = 6            # global steps of each launched job
JOB_BATCH = (4, 2048)    # (a): rows x tokens of each global batch
JOB_KILL = (1, 2)        # (a): the chaos harness SIGKILLs rank 1 after step 2
JOB_PREEMPT = (0, 4)     # (a): SIGUSR1 reaches rank 0 as step 4 begins
JOB_RESIZE_AT = 3        # (b): rank 0 asks for world 1 during step 3
JOB_TINY_BATCH = (4, 16)


def _job_batches(vocab, B, S):
    """JOB_STEPS seeded global batches of token ids (the labels are the
    ids), as the launched ranks and the one-process run see them."""
    return [torch.from_numpy(np.random.RandomState(SEED + 100 + s).randint(
        0, vocab, (B, S))) for s in range(JOB_STEPS)]


def _job_config(mode):
    from paddle_tpu_torch.models.llama import LlamaConfig
    if mode == "lifecycle":
        return dist_two_rank_config(), JOB_BATCH
    return LlamaConfig.tiny(), JOB_TINY_BATCH


def _job_shard_crcs(state, index):
    """sha256 over the crc32 of every shard of ``state``'s leaves, cut by
    the grids of a committed step's manifest (``index``): the digest of
    a restored state, comparable with the committed step's own crc32s."""
    import hashlib
    import zlib

    from paddle_tpu_torch.checkpoint.layout import flatten_state
    _, leaves = flatten_state(state)
    h = hashlib.sha256()
    for key in sorted(index["tensors"]):
        value = leaves[key][0]
        for rec in index["tensors"][key]["shards"]:
            sl = tuple(slice(o, o + n) for o, n in zip(rec["offset"],
                                                       rec["shape"]))
            if isinstance(value, torch.Tensor):
                t = value.detach()[sl].contiguous().cpu()
                data = t.reshape(-1).view(torch.uint8).numpy()
            else:
                data = np.ascontiguousarray(value[sl]).reshape(-1).view(
                    np.uint8)
            h.update(f"{key}:{zlib.crc32(data) & 0xFFFFFFFF};".encode())
    return h.hexdigest()


def _job_manifest_digest(index):
    """The same digest, from the committed step's recorded crc32s."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(index["tensors"]):
        for rec in index["tensors"][key]["shards"]:
            h.update(f"{key}:{rec['crc32']};".encode())
    return h.hexdigest()


def job_trainer(mode, out):
    """One rank of phase 23's launched jobs (``chip_smoke.py --job-trainer
    MODE OUT``, started by ``python -m paddle_tpu_torch.distributed.launch``):
    the Llama of ``_job_config(mode)`` in f32 on the card at dp over the
    world (``fleet.distributed_model``, gloo), ``Model.fit`` over the
    JOB_STEPS global batches under ``FitResilience`` with an asynchronous
    save every step (the killed rank waits for step JOB_KILL's commit
    before the harness kills it), resumed from the latest step. ``lifecycle``: the
    chaos harness and SIGUSR1 as JOB_KILL and JOB_PREEMPT say;
    ``elastic``: rank 0 asks for world 1 during step JOB_RESIZE_AT, rank
    1 departs (83) and rank 0 fits on in place. After every step each
    rank writes ``OUT/rank<r>.e<epoch>.json``: its losses, K1-K3's
    launches, the goodput bins and its seconds by part."""
    t_main = time.perf_counter()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Callback, StepTelemetry
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.observability import fleet as fleet_bus
    from paddle_tpu_torch.observability import goodput
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    from paddle_tpu_torch.resilience import (ElasticResizeListener,
                                             FitResilience, chaos)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank, epoch = dist.get_rank(), os.environ["PADDLE_RESTART_EPOCH"]
    cfg, (B, S) = _job_config(mode)
    fleet.init(is_collective=True)
    net = LlamaForCausalLM(cfg, dtype="float32", seed=SEED)
    opt = _dist_opt(net)
    model = hapi.Model(fleet.distributed_model(net))
    model.prepare(fleet.distributed_optimizer(opt), loss=None)
    listener = ElasticResizeListener() if mode == "elastic" else None
    ckpt = os.path.join(out, "ckpt")
    fr = FitResilience(manager=CheckpointManager(ckpt, keep_last_k=2),
                       save_every_steps=1, elastic_listener=listener)
    fr.set_model(model)
    secs = dict(start=time.perf_counter() - t_main, restore=0.0, save=0.0,
                steps=0.0, digest=0.0, fit=0.0)
    t = time.perf_counter()
    restored = fr.restore(model)
    secs["restore"] = time.perf_counter() - t
    res = dict(rank=rank, epoch=epoch, restored=restored, losses={},
               seconds=secs)
    if restored is not None:
        t = time.perf_counter()
        with open(os.path.join(ckpt, f"step_{restored}", "index.json")) as f:
            index = f.read()
        res["digest"] = _job_shard_crcs(fr._state(), json.loads(index))
        # the committed manifest, for the parent (retention may remove
        # the step before the job ends)
        with open(os.path.join(out, f"index.step{restored}.r{rank}.json"),
                  "w") as f:
            f.write(index)
        secs["digest"] = time.perf_counter() - t
    marks = os.path.join(out, "marks")
    os.makedirs(marks, exist_ok=True)
    if mode == "lifecycle" and rank == JOB_KILL[0]:
        chaos.configure(kill_at_step=JOB_KILL[1], mark_dir=marks)
    _reset_flash_counts()

    def dump():
        snap = goodput.snapshot()
        res.update(launches=_flash_counts(),
                   goodput=None if snap is None else snap["bins"])
        with open(os.path.join(out, f"rank{rank}.e{epoch}.json"), "w") as f:
            json.dump(res, f)
    marks_t = {}

    class Before(Callback):
        def on_train_batch_begin(self, step, logs=None):
            gs = fr._step0 + step
            marks_t["begin"] = time.perf_counter()
            if mode == "lifecycle" and rank == JOB_PREEMPT[0] and \
                    gs == JOB_PREEMPT[1] and \
                    not os.path.exists(os.path.join(marks, "preempt")):
                open(os.path.join(marks, "preempt"), "w").close()
                os.kill(os.getpid(), signal.SIGUSR1)
            if listener is not None and rank == 0 and gs == JOB_RESIZE_AT:
                listener.request(1, "phase23")

        def on_train_batch_end(self, step, logs=None):
            res["losses"][str(fr._step0 + step)] = logs["loss"]
            marks_t["end"] = time.perf_counter()
            secs["steps"] += marks_t["end"] - marks_t["begin"]

    class After(Callback):
        def on_train_batch_end(self, step, logs=None):
            secs["save"] += time.perf_counter() - marks_t["end"]
            if mode == "lifecycle" and rank == JOB_KILL[0] and \
                    fr._step0 + step == JOB_KILL[1]:
                fr.manager.wait_all()  # the kill comes after the commit
            dump()
    callbacks = [Before(), fr, After(), StepTelemetry(
        registry=MetricsRegistry())]
    batches = [{"input_ids": x, "labels": x} for x in
               _job_batches(cfg.vocab_size, B, S)]
    t = time.perf_counter()
    model.fit(batches[restored or 0:], callbacks=callbacks, verbose=0)
    secs["fit"] = time.perf_counter() - t
    res["ended"] = "preempted" if fr.preempted else \
        "resized" if fr.resized else "done"
    if fr.resized:
        res["boundary"] = fr.resize_boundary_step
        dump()  # a departing rank exits 83 inside complete_resize
        t = time.perf_counter()
        res["new_world"] = fr.complete_resize()
        secs["resize"] = time.perf_counter() - t
        single = hapi.Model(model.network._layers)
        single.prepare(model._optimizer, loss=None)
        single.fit(batches[fr._step0:], callbacks=callbacks, verbose=0)
        res["fleetz"] = fleet_bus.fleetz_snapshot()
    dump()
    dist.destroy_process_group()
    fr.exit_if_preempted()
    return 0


def _run_launched(mode, out, timeout):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
    --max_restarts 1 chip_smoke.py --job-trainer MODE OUT`` in a session
    of its own (killed whole on a timeout); (exit code, seconds, the
    per-attempt records {(rank, epoch): record})."""
    import signal as _signal
    import subprocess
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    with open(os.path.join(out, "launcher.log"), "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", "--max_restarts", "1",
             os.path.join(REPO_ROOT, "chip_smoke.py"), "--job-trainer",
             mode, out], cwd=REPO_ROOT, env=env, stdout=logf,
            stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, _signal.SIGKILL)
            proc.wait()
            raise AssertionError(f"job (phase 23 {mode}): the launcher "
                                 f"ran past {timeout} s")
    wall = time.perf_counter() - t
    recs = {}
    for name in os.listdir(out):
        if name.startswith("rank") and name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                rec = json.load(f)
            recs[(rec["rank"], int(rec["epoch"]))] = rec
    if rc != 0:
        with open(os.path.join(out, "launcher.log")) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"job (phase 23 {mode}): the launcher exited "
                             f"{rc}:\n{tail}")
    return rc, wall, recs


def _one_process_losses(mode):
    """The uninterrupted run of a launched job's recipe in this process:
    one rank, the whole global batch each step."""
    from paddle_tpu_torch.jit import TrainStep
    cfg, (B, S) = _job_config(mode)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, dtype="float32", seed=SEED)
    step = TrainStep(model, _dist_loss, _dist_opt(model))
    losses = [float(step(x.cuda())) for x in
              _job_batches(cfg.vocab_size, B, S)]
    del step, model
    free_device_memory()
    return losses


def _merged_losses(recs, rank):
    merged = {}
    for (r, e), rec in sorted(recs.items()):
        if r == rank:
            merged.update({int(k): v for k, v in rec["losses"].items()})
    return [merged.get(s) for s in range(1, JOB_STEPS + 1)]


def _launch_job(mode, timeout):
    """One launched job of phase 23 in a fresh ``phase23_*`` directory
    (deleted after): (seconds, the per-attempt records, each with the
    committed digest of the step it restored, and step JOB_STEPS's
    manifest)."""
    out = tempfile.mkdtemp(prefix="phase23_", dir=REPO_ROOT)
    try:
        _, wall, recs = _run_launched(mode, out, timeout)
        for (r, e), rec in recs.items():
            if rec["restored"] is not None:
                with open(os.path.join(out, f"index.step{rec['restored']}"
                                       f".r{r}.json")) as f:
                    rec["committed_digest"] = _job_manifest_digest(
                        json.load(f))
        with open(os.path.join(out, "ckpt", f"step_{JOB_STEPS}",
                               "index.json")) as f:
            last = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return wall, recs, last


def job_lifecycle(one, launched):
    """Phase 23(a)'s checks: the bench's widths at 2 layers in f32, two
    trainers under the launcher over gloo on the card, a save every step:
    a crash relaunch, a preemption relaunch, the finish; losses against
    one process's (``one``) at rtol 1e-4, restored digests against the
    committed steps. Returns K1-K3's launches (both ranks, every attempt)
    and the record."""
    cfg, (B, S) = _job_config("lifecycle")
    wall, recs, last = launched
    if sorted(recs) != [(r, e) for r in (0, 1) for e in range(3)]:
        raise AssertionError(f"job (a): attempts {sorted(recs)}, not three "
                             "epochs of two ranks")
    ended = {k: rec.get("ended") for k, rec in recs.items()}
    if [recs[(r, 1)]["restored"] for r in (0, 1)] != [JOB_KILL[1]] * 2:
        raise AssertionError(f"job (a): epoch 1 restored "
                             f"{[recs[(r, 1)]['restored'] for r in (0, 1)]}")
    stop = JOB_PREEMPT[1] + 1
    if [recs[(r, 2)]["restored"] for r in (0, 1)] != [stop] * 2 or \
            [ended[(r, 1)] for r in (0, 1)] != ["preempted"] * 2:
        raise AssertionError(f"job (a): the preemption did not stop both "
                             f"ranks at step {stop}: {ended}, restored "
                             f"{[recs[(r, 2)]['restored'] for r in (0, 1)]}")
    for (r, e), rec in recs.items():
        if e and rec["digest"] != rec["committed_digest"]:
            raise AssertionError(f"job (a): rank {r} epoch {e} restored a "
                                 f"state whose digest is not step "
                                 f"{rec['restored']}'s")
    counts = dict.fromkeys(FLASH_KERNELS_NAMES, 0)
    for r in (0, 1):
        got = _merged_losses(recs, r)
        if None in got or not np.allclose(got, one, rtol=1e-4, atol=0):
            raise AssertionError(f"job (a): rank {r} losses {got} and one "
                                 f"process's {one} differ by more than "
                                 "rtol 1e-4")
        for e in range(3):
            for k, c in recs[(r, e)]["launches"].items():
                counts[k] += c
    want = 2 * JOB_STEPS * cfg.num_hidden_layers
    if any(c != want for c in counts.values()):
        raise AssertionError(f"job (a): K1-K3 launched {counts} over both "
                             f"ranks and every attempt, not {want} each")
    gb = last["metadata"]
    log(f"job (a): the bench's widths at {cfg.num_hidden_layers} layers in "
        f"f32, {B} x {S} global batches at dp 2, two trainers under "
        f"`python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 "
        f"--max_restarts 1` over gloo on one card, an asynchronous save "
        f"every step ({last['world_size']} writers, topology "
        f"{last['topology']}): attempts {sorted(set(e for _, e in recs))}, "
        f"how each ended {dict((f'r{r}e{e}', v) for (r, e), v in sorted(ended.items()))} "
        f"(rank 1 of epoch 0 was SIGKILLed after step {JOB_KILL[1]}; the "
        f"launcher exited 0); step {JOB_STEPS}'s metadata {gb}")
    log(f"job (a): losses {[round(v, 6) for v in _merged_losses(recs, 0)]}"
        f" on both ranks, one process {[round(v, 6) for v in one]} (rtol "
        f"1e-4); restored digests equal to the committed steps' crc32s "
        f"({sum(1 for (_, e) in recs if e)} relaunched ranks); K1-K3 "
        f"launches {counts} (rank 0 "
        f"{[recs[(0, e)]['launches']['flash_attention_fwd'] for e in range(3)]}"
        f" and rank 1 "
        f"{[recs[(1, e)]['launches']['flash_attention_fwd'] for e in range(3)]}"
        f" K1 launches by epoch)")
    for (r, e), rec in sorted(recs.items()):
        sec = rec["seconds"]
        log(f"job (a) rank {r} epoch {e}: seconds start "
            f"{sec['start']:.2f}, restore {sec['restore']:.2f}, digest "
            f"{sec['digest']:.2f}, the saves' stall on the loop "
            f"{sec['save']:.2f}, steps {sec['steps']:.2f}, fit with the "
            f"last commits {sec['fit']:.2f}; goodput bins "
            f"{ {k: round(v, 3) for k, v in (rec['goodput'] or {}).items()} }")
    log(f"job (a): the launched job {wall:.1f} s (both ranks share the "
        "card, with (b)'s two: no measure of scaling)")
    return counts, dict(one_process_losses=one,
                        losses=_merged_losses(recs, 0), launched_s=wall,
                        seconds={f"r{r}e{e}": rec["seconds"]
                                 for (r, e), rec in recs.items()},
                        goodput={f"r{r}e{e}": rec["goodput"]
                                 for (r, e), rec in recs.items()})


def job_elastic(one, launched):
    """Phase 23(b)'s checks: the tiny Llama in f32, elastic 2 -> 1 under
    the launcher: rank 1 departs (83), rank 0 continues in place; its
    losses against one process's (``one``), rank 1 ``departed`` on rank
    0's aggregator. Returns K1-K3's launches and the record."""
    wall, recs, _ = launched
    if sorted(recs) != [(0, 0), (1, 0)]:
        raise AssertionError(f"job (b): attempts {sorted(recs)}: the resize "
                             "was not in place")
    r0, r1 = recs[(0, 0)], recs[(1, 0)]
    boundary = JOB_RESIZE_AT + 1
    if r0.get("boundary") != boundary or r1.get("boundary") != boundary or \
            r1["ended"] != "resized" or r0.get("new_world") != 1:
        raise AssertionError(f"job (b): boundaries {r0.get('boundary')}, "
                             f"{r1.get('boundary')}, rank 1 "
                             f"{r1['ended']}, new world "
                             f"{r0.get('new_world')}")
    got = _merged_losses(recs, 0)
    if None in got or not np.allclose(got, one, rtol=1e-4, atol=0):
        raise AssertionError(f"job (b): rank 0 losses {got} and one "
                             f"process's {one} differ by more than rtol "
                             "1e-4")
    lane = r0["fleetz"]["ranks"].get("1", {})
    if lane.get("status") != "departed":
        raise AssertionError(f"job (b): rank 1's lane on rank 0's "
                             f"aggregator is {lane.get('status')}")
    counts = {k: r0["launches"][k] + r1["launches"][k]
              for k in FLASH_KERNELS_NAMES}
    if any(c == 0 for c in counts.values()):
        raise AssertionError(f"job (b): K1-K3 launches {counts}")
    log(f"job (b): the tiny Llama in f32, elastic 2 -> 1 at step "
        f"{boundary} under the launcher ({wall:.1f} s): rank 1 departed "
        f"(83) after publishing its shards, rank 0 continued in place on "
        f"the exchanged state in {r0['seconds'].get('resize', 0):.2f} s of "
        f"resize; rank 0 losses {[round(v, 6) for v in got]}, one process "
        f"{[round(v, 6) for v in one]} (rtol 1e-4); rank 1 on rank 0's "
        f"aggregator: {lane.get('status')} at step {lane.get('step')}; "
        f"K1-K3 launches {counts}")
    return counts, dict(losses=got, one_process_losses=one, launched_s=wall,
                        resize_s=r0["seconds"].get("resize"))


def phase_job_lifecycle():
    """Phase 23: the one-process runs of both jobs in this process, then
    (a) and (b) under two launchers at once (four processes share the
    card). Returns K1-K3's launches by path and the record."""
    t0 = time.perf_counter()
    ones = {mode: _uncounted_flash(lambda: _one_process_losses(mode))
            for mode in ("lifecycle", "elastic")}
    t1 = time.perf_counter()
    elastic = {}

    def run_elastic():
        try:
            elastic["out"] = _launch_job("elastic", 400)
        except BaseException as e:  # re-raised below, in this thread
            elastic["error"] = e
    th = threading.Thread(target=run_elastic)
    th.start()
    try:
        lifecycle = _launch_job("lifecycle", 900)
    finally:
        th.join()
    if "error" in elastic:
        raise elastic["error"]
    t2 = time.perf_counter()
    a_counts, a_rec = job_lifecycle(ones["lifecycle"], lifecycle)
    b_counts, b_rec = job_elastic(ones["elastic"], elastic["out"])
    log(f"phase 23 seconds by part: the one-process runs {t1 - t0:.1f}, "
        f"the two launched jobs at once {t2 - t1:.1f} ((a) "
        f"{lifecycle[0]:.1f}, (b) {elastic['out'][0]:.1f}); phase 23 "
        f"{t2 - t0:.1f} s")
    return {"launch": a_counts, "elastic": b_counts}, \
        dict(lifecycle=a_rec, elastic=b_rec, seconds=t2 - t0)


# --------------------------------------------------------------------------
# phase 24: expert-parallel MoE training and tensor-parallel serving
EP_LAYERS = 2              # DeepSeekMoE-16B cut to layer 0 dense, layer 1 MoE
EP_BATCH = (2, 2048)       # global ids
EP_STEPS = 3
EP_LR = 1e-4
TP_NEW_TOKENS = 32
TP_LAYERS = 16             # (b): Llama-3-8B cut to 16 of its 32 layers, to
                           # keep phases 1-24 within the script's limit
TP_EXACT_LAYERS = 2        # (b)'s exact check: Llama-3-8B widths at 2 layers,
TP_EXACT_TOKENS = 16       # 16 greedy tokens a request
TP_BF16_LOGITS_RTOL = 0.1  # (b)'s bf16 first-step logits at mp 2 against
                           # one process's, as ||a - b|| / ||b||: 3.3x the
                           # sound run's 0.0306 and 1/12.7 of the 1.268 of
                           # a row-parallel sum that drops one rank's half
                           # (NVIDIA H100 80GB HBM3, 700.00 W)


def ep_config():
    from paddle_tpu_torch.models import MoeConfig
    return MoeConfig.deepseek_moe_16b(num_hidden_layers=EP_LAYERS)


def _ep_batch(vocab):
    rng = np.random.RandomState(SEED + 24)
    return torch.as_tensor(rng.randint(0, vocab, EP_BATCH), device="cuda")


def ep_train(mesh=None, input_spec=None):
    """24(a): phase 24's MoE (f32, seeded, AdamW, clip 1.0) through
    ``TrainStep`` for EP_STEPS steps on the seeded global batch, over
    ``mesh`` with ``input_spec`` (one process without). Returns each
    step's loss, the routed layer's drops and the step ms by CUDA
    events."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoeForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = ep_config()
    torch.cuda.reset_peak_memory_stats()
    model = MoeForCausalLM(cfg, dtype="float32", seed=SEED)
    opt = AdamW(learning_rate=EP_LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda m, x: m(x, labels=x)[1], opt, mesh=mesh,
                     input_spec=input_spec)
    x = _ep_batch(cfg.vocab_size)
    moe = model.layers[1].mlp
    losses, dropped, ms = [], [], []
    for _ in range(EP_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(x)
        b.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        dropped.append(int(moe.last_dropped))
        ms.append(a.elapsed_time(b))
    out = dict(losses=losses, dropped=dropped, ms=ms,
               capacity=moe.last_capacity, local_experts=moe.w1.shape[0],
               peak=torch.cuda.max_memory_allocated())
    del step, opt, model, moe
    free_device_memory()
    return out


def _gap_recorder(eng):
    """Wrap the engine's sampler: each request's top-2 logit gaps, in
    order of its tokens."""
    gaps = {}
    sample = eng._sample

    def recording(row, seq):
        top2 = np.partition(row, -2)[-2:]
        gaps.setdefault(seq.req_id, []).append(
            float(top2[1] - top2[0]) if np.isfinite(row).all()
            else float("nan"))
        return sample(row, seq)
    eng._sample = recording
    return gaps


def _first_step_recorder(eng):
    """Wrap the engine's forward: the first step's inputs and its f32
    logits ``[max_batch, V]`` on the host."""
    first = {}
    forward = eng._forward

    def recording(tokens, caches, last_idx, adapters):
        out = forward(tokens, caches, last_idx, adapters)
        if not first:
            first.update(args=(tokens, caches, last_idx),
                         logits=out.cpu().numpy())
        return out
    eng._forward = recording
    return first


def _replay_first_step(eng, first, drop_other_half):
    """The first step again on this rank's engine (every rank calls it
    at once), its logits on the host; with ``drop_other_half`` every
    row-parallel sum over ``mp`` keeps this rank's half only: the
    control of a wrong collective. The step's tokens start their
    sequences, so the K/V it reads are those it writes."""
    from paddle_tpu_torch.distributed.fleet import mpu
    keep = mpu.reduce_from_group
    if drop_other_half:
        mpu.reduce_from_group = lambda x, group: x
    try:
        return eng._forward(*first["args"],
                            contextlib.nullcontext()).cpu().numpy()
    finally:
        mpu.reduce_from_group = keep


def bf16_collectives(mesh):
    """gloo's bf16 all-reduce and all-gather over ``mp`` on CUDA tensors
    of a row-parallel output's shape (a 520-token step at hidden 4096),
    against the sum in f32 rounded once and the concatenation, made here
    from the same seed on every rank: (the all-reduce's largest error in
    units of the result's bf16 spacing, bit-equal, the all-gather
    bit-equal)."""
    from paddle_tpu_torch.distributed import collective as C
    group = C.Group(("mp",), mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.randn(520, 4096, generator=gen, device="cuda").bfloat16()
          for _ in range(2)]
    got = xs[group.rank].clone()
    C.all_reduce(got, group=group)
    want = (xs[0].float() + xs[1].float()).bfloat16()
    spacing = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    ulps = float(((got.float() - want.float()).abs() / spacing).max())
    gathered = C.all_gather(xs[group.rank].clone(), group=group)
    return ulps, bool(torch.equal(got, want)), bool(
        torch.equal(gathered, torch.cat(xs)))


def _rel_norm(a, b):
    """``||a - b|| / ||b||`` in f64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def row_parallel_halves():
    """The scale of what mp 2 changes in one bf16 row-parallel product:
    Llama-3-8B's ``down_proj`` at a 520-token step ([520, 14336] @
    [14336, 4096], seeded), whole and as two halves of the inner axis,
    each half's product rounded to bf16 and the two summed in bf16,
    each against the product in f32: (whole, halves) as
    ``||a - f32|| / ||f32||``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(520, 14336, generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn(14336, 4096, generator=gen, device="cuda")
         ).bfloat16()
    ref = (x.float() @ w.float()).cpu().numpy()
    whole = (x @ w).float().cpu().numpy()
    halves = (x[:, :7168] @ w[:7168] + x[:, 7168:] @ w[7168:]
              ).float().cpu().numpy()
    return _rel_norm(whole, ref), _rel_norm(halves, ref)


def tp_serve(mesh, layers=TP_LAYERS, dtype="bfloat16", quantize=None,
             new_tokens=TP_NEW_TOKENS, controls=False):
    """24(b): Llama-3-8B widths at ``layers`` of its 32 layers
    behind ``ServingEngine(mesh=)`` at phase 4's geometry and prompts,
    ``new_tokens`` greedy tokens; every rank calls it (rank 0 of ``mp``
    drives, the other follows). Returns the driver's streams and top-2
    gaps, the first step's logits, the engine's steps, K4's launches, the
    wall, the peak memory and pool bytes, and the collectives a step;
    with ``controls`` also the first step replayed as it ran and with
    each row-parallel sum cut to this rank's half."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import ServingEngine
    cfg = LlamaConfig.llama3_8b(tensor_parallel=mesh is not None,
                                num_hidden_layers=layers)
    held = torch.cuda.memory_allocated()
    model = LlamaForCausalLM(cfg, dtype=dtype, seed=SEED)
    weights = torch.cuda.memory_allocated() - held
    eng = ServingEngine(model, max_batch=8, block_size=16, prefill_chunk=512,
                        max_blocks=2048, mesh=mesh, quantize=quantize,
                        request_ledger=False)
    del model
    resident = torch.cuda.memory_allocated()
    prompts = _phase4_prompts(cfg, np.random.RandomState(SEED))
    gaps = _gap_recorder(eng) if eng.is_driver else {}
    first = _first_step_recorder(eng)
    calls = get_registry().get("comm_calls_total")

    def ncalls():
        return {op: calls.value(op=op, axes="mp") for op in
                ("broadcast", "all_reduce", "all_gather")} \
            if mesh is not None else {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0, steps0 = ncalls(), eng.steps
    rpa.ragged_paged_attention.launches = 0
    t = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts] \
        if eng.is_driver else []
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = rpa.ragged_paged_attention.launches
    steps = eng.steps - steps0
    streams = [h.result(60)["token_ids"] for h in hs]
    c1 = ncalls()
    eng.cache.allocator.assert_no_leaks()
    out = dict(streams=streams, gaps=[gaps[h.req_id] for h in hs],
               first_logits=first["logits"],
               steps=steps, launches=launches, wall=wall,
               mean_step_ms=1e3 * wall / max(steps, 1),
               peak=torch.cuda.max_memory_allocated(),
               held=held, weights=weights, resident=resident,
               pool_bytes=eng.cache.pool_bytes(),
               pool_heads=int(eng.cache.k_pools[0].shape[2]),
               tensor_parallel=eng.stats()["tensor_parallel"],
               per_step={op: (c1[op] - c0[op]) / max(steps, 1)
                         for op in c0},
               layers=cfg.num_hidden_layers)
    if controls:
        out["replay_logits"] = _replay_first_step(eng, first, False)
        out["half_logits"] = _replay_first_step(eng, first, True)
    first.clear()
    eng.shutdown()
    del eng
    free_device_memory()
    return out


def _gloo_rank():
    """A spawned rank of phase 24 on the one card, in the world ``spawn``
    set up; its rank."""
    import paddle_tpu_torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    return dist.get_rank()


def _ep_worker(out_dir):
    """One of 24(a)'s two processes: the MoE at ep 2 with the rows split
    (``P("ep")``) and whole (``P()``); writes ``out_dir/rank<r>.json``."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import P
    from paddle_tpu_torch.observability.metrics import get_registry
    rank = _gloo_rank()
    reg = get_registry()
    res = {"held_at_start": torch.cuda.memory_allocated()}
    a2a = (reg.get("comm_calls_total"), reg.get("comm_bytes_total"))
    mesh = dist.init_mesh({"ep": 2})
    for layout, spec in (("rows", P("ep")), ("whole", P())):
        n0 = [c.value(op="all_to_all", axes="ep") for c in a2a]
        _reset_flash_counts()
        t = time.perf_counter()
        run = ep_train(mesh, spec)
        run["seconds"] = time.perf_counter() - t
        run["launches"] = _flash_counts()
        run["a2a_calls"], run["a2a_bytes"] = [
            (c.value(op="all_to_all", axes="ep") - v) / EP_STEPS
            for c, v in zip(a2a, n0)]
        res[layout] = run
    res["held_after_ep"] = torch.cuda.memory_allocated()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _tp_worker(out_dir):
    """One of 24(b)'s two processes: the exact f32 check at 2 layers
    (plain and ``int8_wo``), then Llama-3-8B at mp 2 in bf16; writes
    ``out_dir/rank<r>.json``."""
    import paddle_tpu_torch.distributed as dist
    rank = _gloo_rank()
    mesh = dist.init_mesh({"mp": 2})
    t = time.perf_counter()
    res = {"exact": {q or "plain": tp_serve(
        mesh, TP_EXACT_LAYERS, "float32", q, TP_EXACT_TOKENS)["streams"]
        for q in (None, "int8_wo")}}
    res["exact_seconds"] = time.perf_counter() - t
    res["collectives"] = bf16_collectives(mesh)
    t = time.perf_counter()
    res["serve"] = tp_serve(mesh, controls=True)
    res["serve"]["seconds"] = time.perf_counter() - t
    for k in ("first_logits", "replay_logits", "half_logits"):
        np.save(os.path.join(out_dir, f"{k}.rank{rank}.npy"),
                res["serve"].pop(k))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _spawn_pairs(workers, timeout):
    """Each of ``workers`` in its own pair of spawned processes, every
    pair at once (each ``spawn`` its own world); their ``rank<r>.json``
    by worker, each with the arrays its rank saved beside it
    (``NAME.rank<r>.npy``) under ``arrays``."""
    import paddle_tpu_torch.distributed as dist
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase24_", dir=REPO_ROOT)
    try:
        started = []
        for w in workers:
            out = os.path.join(root, w.__name__)
            os.makedirs(out)
            started.append((w, out, dist.spawn(w, args=(out,), nprocs=2,
                                               join=False)))
        for _, _, procs in started:
            for p in procs:
                p.join(timeout=max(timeout - (time.perf_counter() - t0), 1))
        for _, _, procs in started:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = {w.__name__: [p.exitcode for p in procs]
               for w, _, procs in started
               if any(p.exitcode != 0 for p in procs)}
        if bad:
            raise AssertionError(f"ep/tp: ranks exited {bad}")
        out = {}
        for w, d, _ in started:
            out[w] = []
            for r in range(2):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    out[w].append(json.load(f))
                out[w][r]["arrays"] = {
                    n.split(".")[0]: np.load(os.path.join(d, n))
                    for n in os.listdir(d) if n.endswith(f".rank{r}.npy")}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _stream_agreement(streams, one):
    """``(exact streams, [(request, first differing token, the one
    process's top-2 gap there)])`` of ``streams`` against the one
    process's ``(streams, gaps)``."""
    exact, parts = 0, []
    for i, (s, want) in enumerate(zip(streams, one["streams"])):
        if s == want:
            exact += 1
            continue
        j = next((j for j, (a, b) in enumerate(zip(s, want)) if a != b),
                 min(len(s), len(want)))
        gap = one["gaps"][i][j] if j < len(one["gaps"][i]) else None
        parts.append((i, j, None if gap is None else round(gap, 5)))
    return exact, parts


def rpa_local_heads():
    """K4 at a tensor-parallel rank's heads of Llama-3-8B at mp 2 (16
    query and 4 KV heads, group 4, hd 128; phase 3's mix) against its
    plain version, timed."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)
    args, valid, need = rpa_mix(torch.bfloat16, n_heads=16, n_kv=4)
    held = ragged_paged_attention.launches
    out = ragged_paged_attention(**args)
    ref = ragged_paged_attention_reference(**args)
    err = _rpa_check("bfloat16, one mp-2 rank's heads", out, ref, valid,
                     RPA_TOL[torch.bfloat16])
    ms = cuda_ms(lambda: ragged_paged_attention(**args))
    plain_ms = cuda_ms(lambda: ragged_paged_attention_reference(**args))
    ragged_paged_attention.launches = held
    log(f"rpa bfloat16 at one mp-2 rank's heads of Llama-3-8B (16 query "
        f"and 4 KV heads, group 4, hd 128; phase 3's mix, tile_q 8): "
        f"T={need['T']} live pages={need['pages']} max|err|={err:.3e} "
        f"(atol {RPA_TOL[torch.bfloat16]}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {need['bound_ms']:.4f} ms "
        f"({need['bound_by']}: {need['bytes']} B, {need['flops']} flop)")
    del args, out, ref
    free_device_memory()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=need["bound_ms"], bound_by=need["bound_by"])


def phase_ep_tp():
    """Phase 24: the one-process runs in this process (the MoE's 3 steps,
    Llama-3-8B's bf16 engine and the 2-layer f32 engines), K4 at one
    rank's heads, then (a) and (b) each in a pair of processes started by
    the port's ``spawn``, both pairs at once, sharing the card over gloo.
    Returns K1-K3's launches on ``ep_train``, K4's on ``tp_serving``, and
    the records."""
    t0 = time.perf_counter()
    free_device_memory()
    one = _uncounted_flash(ep_train)
    serve_one = _uncounted_flash(lambda: tp_serve(None))
    exact_one = {q or "plain": tp_serve(None, TP_EXACT_LAYERS, "float32",
                                        q, TP_EXACT_TOKENS)["streams"]
                 for q in (None, "int8_wo")}
    local = rpa_local_heads()
    halves = row_parallel_halves()
    t1 = time.perf_counter()
    pairs = _spawn_pairs((_ep_worker, _tp_worker), 600)
    ranks = [{**a, **b} for a, b in zip(pairs[_ep_worker],
                                        pairs[_tp_worker])]
    t2 = time.perf_counter()
    cfg = ep_config()
    # (a): every rank's losses and drops against one process's
    ep_counts = dict.fromkeys(FLASH_KERNELS_NAMES, 0)
    for r, res in enumerate(ranks):
        for layout in ("rows", "whole"):
            got = res[layout]
            if not np.allclose(got["losses"], one["losses"], rtol=1e-4,
                               atol=0):
                raise AssertionError(
                    f"ep (a): rank {r} {layout} losses {got['losses']} and "
                    f"one process's {one['losses']} differ by more than "
                    f"rtol 1e-4")
            if got["dropped"] != one["dropped"]:
                raise AssertionError(
                    f"ep (a): rank {r} {layout} drops {got['dropped']} != "
                    f"one process's {one['dropped']}")
            for kname, c in got["launches"].items():
                if c != EP_STEPS * EP_LAYERS:
                    raise AssertionError(f"ep (a): rank {r} {layout} "
                                         f"{kname} launched {c} times")
                ep_counts[kname] += c
    rows, whole = ranks[0]["rows"], ranks[0]["whole"]
    log(f"ep (a): DeepSeekMoE-16B widths at {EP_LAYERS} layers (layer 0 "
        f"dense, layer 1 {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}), f32, {EP_BATCH[0]} x {EP_BATCH[1]} "
        f"global ids, {EP_STEPS} steps: losses one process "
        f"{[round(v, 6) for v in one['losses']]}, ep 2 rows split "
        f"{[round(v, 6) for v in rows['losses']]}, whole "
        f"{[round(v, 6) for v in whole['losses']]} (rtol 1e-4, both "
        f"ranks); drops a step {one['dropped']} in all three (capacity "
        f"{rows['capacity']}, {rows['local_experts']} experts a rank)")
    log(f"ep (a): step ms by CUDA events (two processes on one card over "
        f"gloo beside (b)'s two, every all-to-all and all-gather staged "
        f"through the host: no measure of scaling): one process "
        f"{[round(v, 3) for v in one['ms']]}; rows split rank 0 "
        f"{[round(v, 3) for v in rows['ms']]}, rank 1 "
        f"{[round(v, 3) for v in ranks[1]['rows']['ms']]}; whole rank 0 "
        f"{[round(v, 3) for v in whole['ms']]}, rank 1 "
        f"{[round(v, 3) for v in ranks[1]['whole']['ms']]}; all-to-alls "
        f"a step rows {rows['a2a_calls']:.0f} ({rows['a2a_bytes']:.0f} B), "
        f"whole {whole['a2a_calls']:.0f}; peak memory a rank rows "
        f"{[res['rows']['peak'] for res in ranks]} B, whole "
        f"{[res['whole']['peak'] for res in ranks]} B, one process "
        f"{one['peak']} B; allocated a rank at its start "
        f"{[res['held_at_start'] for res in ranks]} B and after (a) "
        f"{[res['held_after_ep'] for res in ranks]} B; K1-K3 on both ranks "
        f"{ep_counts}")
    # (b): the exact f32 check, then the bf16 streams' agreement
    for q, want in exact_one.items():
        if ranks[0]["exact"][q] != want:
            raise AssertionError(
                f"tp (b): {q} f32 streams at mp 2 {ranks[0]['exact'][q]} "
                f"differ from one process's {want}")
    sv = [res["serve"] for res in ranks]
    for r, s in enumerate(sv):
        if s["launches"] != s["layers"] * sv[0]["steps"] or \
                s["steps"] != sv[0]["steps"] or s["tensor_parallel"] != 2:
            raise AssertionError(
                f"tp (b): rank {r} K4 launches {s['launches']} over "
                f"{s['steps']} steps ({s['layers']} layers; the driver "
                f"took {sv[0]['steps']})")
    for i, toks in enumerate(sv[0]["streams"]):
        if len(toks) != TP_NEW_TOKENS or not all(
                0 <= t < 128256 for t in toks) or not all(
                math.isfinite(g) for g in sv[0]["gaps"][i]):
            raise AssertionError(f"tp (b): request {i} returned {toks}")
    # the bf16 collectives themselves, on CUDA tensors
    for r, res in enumerate(ranks):
        ulps, _, gathered = res["collectives"]
        if ulps > 1.0 or not gathered:
            raise AssertionError(
                f"tp (b): rank {r}: gloo's bf16 all-reduce off by {ulps} "
                f"ulp, all-gather equal: {gathered}")
    # the bf16 first step (every prompt's first chunk) against one
    # process's: norm-relative, with the replay of that step as it ran
    # and with each row-parallel sum cut to one rank's half (the control
    # of a wrong collective) beside it
    arrs = [res["arrays"] for res in ranks]
    if not np.array_equal(arrs[0]["replay_logits"],
                          arrs[0]["first_logits"]) or not np.array_equal(
                              arrs[1]["first_logits"],
                              arrs[0]["first_logits"]):
        raise AssertionError("tp (b): the first step's logits differ "
                             "between the ranks or from its replay")
    first_err = _rel_norm(arrs[0]["first_logits"], serve_one["first_logits"])
    half_err = [_rel_norm(a["half_logits"], serve_one["first_logits"])
                for a in arrs]
    if not first_err <= TP_BF16_LOGITS_RTOL < min(half_err):
        raise AssertionError(
            f"tp (b): bf16 first-step logits at mp 2 against one process's: "
            f"{first_err:.3e} (limit {TP_BF16_LOGITS_RTOL}); with each "
            f"row-parallel sum cut to one rank's half {half_err}, which "
            f"must exceed the limit")
    exact, parts = _stream_agreement(sv[0]["streams"], serve_one)
    # a bf16 stream may part from one process's only at a near-tie there
    # (phase 19's rule): mp 2 sums the row-parallel products in halves
    clear = [p for p in parts if p[2] is None or p[2] > NEAR_TIE]
    if clear:
        raise AssertionError(f"tp (b): bf16 streams part from one process's "
                             f"where its top-2 gap exceeds {NEAR_TIE}: "
                             f"{clear}")
    tp_counts = {"ragged_paged_attention": sum(s["launches"] for s in sv)}
    log(f"tp (b): f32 at {TP_EXACT_LAYERS} layers, mp 2: greedy streams "
        f"equal one process's, plain and int8_wo ({len(exact_one['plain'])}"
        f" requests x {TP_EXACT_TOKENS} tokens each)")
    log(f"tp (b): bf16 collectives over gloo on CUDA tensors [520, 4096]: "
        f"all-reduce against the f32 sum rounded once, largest error "
        f"{[res['collectives'][0] for res in ranks]} ulp (bit-equal "
        f"{[res['collectives'][1] for res in ranks]}), all-gather "
        f"bit-equal {[res['collectives'][2] for res in ranks]}; first-step "
        f"logits [{arrs[0]['first_logits'].shape[0]}, "
        f"{arrs[0]['first_logits'].shape[1]}] at mp 2 against one "
        f"process's, ||a - b|| / ||b||: {first_err:.4e} (limit "
        f"{TP_BF16_LOGITS_RTOL}; the ranks' logits and the step's replay "
        f"bit-equal); the control with each row-parallel sum cut to one "
        f"rank's half {[round(e, 4) for e in half_err]}; one down_proj "
        f"product in bf16 against f32: whole {halves[0]:.4e}, in two "
        f"halves summed in bf16 {halves[1]:.4e}")
    log(f"tp (b): Llama-3-8B bf16 at mp 2 ({sv[0]['layers']} of 32 layers, "
        f"{sv[0]['pool_heads']} of 8 KV heads a rank), phase 4's prompts x "
        f"{TP_NEW_TOKENS} tokens: {exact} of {len(sv[0]['streams'])} streams "
        f"equal one process's, the others part at (request, token, one "
        f"process's top-2 gap) {parts}; mean step {sv[0]['mean_step_ms']:.3f}"
        f" ms over {sv[0]['steps']} steps (one process "
        f"{serve_one['mean_step_ms']:.3f} ms over {serve_one['steps']}); "
        f"a step: {sv[0]['per_step']} (over mp); peak memory a rank "
        f"{[s['peak'] for s in sv]} B (one process {serve_one['peak']} B; "
        f"before the model a rank {[s['held'] for s in sv]} B, its weights "
        f"{[s['weights'] for s in sv]} B, with the engine "
        f"{[s['resident'] for s in sv]} B; one process "
        f"{serve_one['held']}, {serve_one['weights']}, "
        f"{serve_one['resident']} B), "
        f"pool bytes a rank {[s['pool_bytes'] for s in sv]} (one process "
        f"{serve_one['pool_bytes']}); K4 launches rank 0 {sv[0]['launches']},"
        f" rank 1 {sv[1]['launches']} (= {sv[0]['layers']} x steps each)")
    log(f"phase 24 seconds by part: the one-process runs and K4 "
        f"{t1 - t0:.1f}, the two pairs of ranks at once {t2 - t1:.1f} (rank "
        f"0 of (a): rows {rows['seconds']:.1f}, whole "
        f"{whole['seconds']:.1f}; of (b): bf16 "
        f"{ranks[0]['serve']['seconds']:.1f}, exact "
        f"{ranks[0]['exact_seconds']:.1f}); phase 24 {t2 - t0:.1f} s")
    rec = dict(ep_losses=one["losses"], ep_dropped=one["dropped"],
               ep_step_ms=dict(one_process=one["ms"], rows=rows["ms"],
                               whole=whole["ms"]),
               a2a_per_step=dict(calls=rows["a2a_calls"],
                                 bytes=rows["a2a_bytes"]),
               seconds=t2 - t0)
    serve_rec = dict(local, streams_exact=exact, streams_parted=parts,
                     first_step_logits_rel_err=first_err,
                     first_step_logits_rtol=TP_BF16_LOGITS_RTOL,
                     half_sum_control_rel_err=half_err,
                     down_proj_rel_err=dict(whole=halves[0],
                                            halves=halves[1]),
                     bf16_all_reduce_ulps=[res["collectives"][0]
                                           for res in ranks],
                     mean_step_ms=sv[0]["mean_step_ms"],
                     one_process_step_ms=serve_one["mean_step_ms"],
                     per_step=sv[0]["per_step"],
                     peak=[s["peak"] for s in sv],
                     pool_bytes=[s["pool_bytes"] for s in sv])
    return {"ep_train": ep_counts}, {"tp_serving": tp_counts["ragged_paged_attention"]}, \
        rec, serve_rec


# --------------------------------------------------------------------------
# phase 25: the per-row paged path, vision.ops and the layer census
PAGED_LENS = (1024, 640, 384, 128)  # prompt tokens of (a)'s four rows
PAGED_CHUNK, PAGED_BLOCK, PAGED_NEW = 256, 16, 32
# a paged stream may part from eager generate's only where generate's
# top-2 logit gap is at most this (f32 sums in other orders)
PAGED_GAP = 1e-3
MOE_ROW_LENS = (256, 200, 97, 31)  # (a)'s MoE chunk: one padded row each
MOE_TIGHT_CF = 0.5  # a capacity factor at which the chunk drops
CENSUS_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_layers.py
# the census's card-vs-CPU limit: the two devices sum f32 terms in other
# orders (Bilinear's 4096-term contractions differ by 1.3e-5, the losses'
# means over 4M values more), so atol is ten times the layers'
CENSUS_SUM_TOL = dict(rtol=1e-4, atol=1e-4)


def _peak_gb(device):
    return torch.cuda.max_memory_allocated(device) / 1e9 \
        if device.type == "cuda" else 0.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def paged_rows_greedy(model, prompts, new_tokens, chunk, block, logits):
    """Greedy decoding of ``prompts`` side by side through per-row
    ``PagedLayerCache``s: the prompts prefilled ``chunk`` tokens a step
    (rows that are done carry ``new_lens`` 0, a short last chunk a padded
    tail), each row's first token from its last prompt position, then
    ``new_tokens - 1`` decode steps of one token a row. ``logits(h)`` maps
    hidden states to logits. Returns the streams, each prefill step's ms
    and the median decode step ms."""
    from paddle_tpu_torch.ops import paged_attention as pa
    cfg = model.cfg
    dev = next(iter(model.parameters())).device
    B = len(prompts)
    nblk = -(-(max(map(len, prompts)) + new_tokens) // block)
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (B * nblk + 1, block, cfg.num_key_value_heads, hd)
    pools = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
             for _ in range(cfg.num_hidden_layers)]
    bt = (1 + torch.arange(B * nblk, dtype=torch.int32, device=dev)).reshape(
        B, nblk)
    ctx = torch.zeros(B, dtype=torch.int32, device=dev)
    trunk = getattr(model, "model", model)

    def step(ids, new_lens):
        nl = torch.tensor(new_lens, dtype=torch.int32, device=dev)
        caches = [pa.PagedLayerCache(k, v, bt, ctx, nl) for k, v in pools]
        h, _ = trunk(ids, caches=caches)
        ctx.add_(nl)
        return h

    first = [None] * B
    done = [0] * B
    prefill_ms = []
    with torch.no_grad():
        while any(d < len(p) for d, p in zip(done, prompts)):
            ids = torch.zeros(B, chunk, dtype=torch.long)
            nl = []
            for b, p in enumerate(prompts):
                k = min(chunk, len(p) - done[b])
                ids[b, :k] = torch.as_tensor(p[done[b]:done[b] + k])
                done[b] += k
                nl.append(k)
            _sync(dev)
            t = time.perf_counter()
            h = step(ids.to(dev), nl)
            for b, k in enumerate(nl):
                if k and done[b] == len(prompts[b]):
                    first[b] = int(logits(h[b:b + 1, k - 1:k]).argmax(-1))
            _sync(dev)
            prefill_ms.append(1e3 * (time.perf_counter() - t))
        streams = [[f] for f in first]
        decode_ms = []
        for _ in range(new_tokens - 1):
            ids = torch.tensor([[s[-1]] for s in streams], device=dev)
            _sync(dev)
            t = time.perf_counter()
            nxt = logits(step(ids, [1] * B)).argmax(-1)[:, 0].tolist()
            _sync(dev)
            decode_ms.append(1e3 * (time.perf_counter() - t))
            for s, n in zip(streams, nxt):
                s.append(n)
    return streams, prefill_ms, statistics.median(decode_ms)


def _eager_gap(model, tokens, logits):
    """Top-2 gap of the eager (growing-cache) logits after ``tokens``."""
    trunk = getattr(model, "model", model)
    dev = next(iter(model.parameters())).device
    with torch.no_grad():
        h, _ = trunk(torch.tensor([tokens], device=dev),
                     caches=[(None, None)] * model.cfg.num_hidden_layers)
        top = torch.topk(logits(h[:, -1:]).float().flatten(), 2).values
    return float(top[0] - top[1])


def paged_rows_llama(cfg, device, lens=PAGED_LENS, new=PAGED_NEW,
                     chunk=PAGED_CHUNK, block=PAGED_BLOCK):
    """25(a), Llama: the per-row paged greedy streams against eager
    ``generate``'s (K1 on the card), row by row. Returns K1-K3's launches
    on the per-row run (``paged_rows``) and on the generate runs
    (``paged_rows_generate``), and the record."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, device=device, dtype="float32",
                             seed=SEED + 25)
    model.eval()
    rng = np.random.RandomState(SEED + 25)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_flash_counts()
    streams, pre_ms, dec_ms = paged_rows_greedy(model, prompts, new, chunk,
                                                block, model._logits)
    own = _flash_counts()
    peak = _peak_gb(device)
    _reset_flash_counts()
    with torch.no_grad():
        solo = [model.generate(torch.tensor([p], device=device), new,
                               temperature=0.0)[0, len(p):].tolist()
                for p in prompts]
    counts = _flash_counts()
    parted = []
    for b, (s, g) in enumerate(zip(streams, solo)):
        if s == g:
            continue
        j = next(j for j, (x, y) in enumerate(zip(s, g)) if x != y)
        gap = _eager_gap(model, prompts[b] + g[:j], model._logits)
        log(f"paged rows (a): row {b} parts from eager generate at token "
            f"{j}, where generate's top-2 gap is {gap:.3e}")
        if gap > PAGED_GAP:
            raise AssertionError(
                f"paged rows (a): row {b} parts from eager generate at "
                f"token {j} with a top-2 gap of {gap} > {PAGED_GAP}")
        parted.append((b, j, gap))
    if device.type == "cuda" and counts["flash_attention_fwd"] == 0:
        raise AssertionError("eager generate launched no K1")
    log(f"paged rows (a): Llama-3-8B widths x {cfg.num_hidden_layers} "
        f"layers f32, rows {list(lens)} prefilled in chunks of {chunk} "
        f"(block {block}) then {new} greedy tokens: "
        f"{len(lens) - len(parted)}/{len(lens)} streams equal eager "
        f"generate's, partings {parted}; prefill steps "
        f"{[round(m, 2) for m in pre_ms]} ms, decode step (median) "
        f"{dec_ms:.2f} ms, peak {peak:.2f} GB; generate's K1 launches "
        f"{counts['flash_attention_fwd']}")
    del model
    free_device_memory()
    return dict(paged_rows=own, paged_rows_generate=counts), dict(
        prefill_step_ms=pre_ms, decode_step_ms=dec_ms, peak_gb=peak,
        parted=parted)


def _moe_rows(model, ids, lens, device):
    """One per-row paged chunk of the MoE LM: ``(logits [B, S, V], the
    routed layers' (capacity, drops), the routed layers' inputs)``."""
    from paddle_tpu_torch.ops import paged_attention as pa
    cfg = model.cfg
    B, S = ids.shape
    nblk = -(-S // PAGED_BLOCK)
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (B * nblk + 1, PAGED_BLOCK, cfg.num_key_value_heads, hd)
    bt = (1 + torch.arange(B * nblk, dtype=torch.int32,
                           device=device)).reshape(B, nblk)
    nl = torch.tensor(lens, dtype=torch.int32, device=device)
    ctx = torch.zeros(B, dtype=torch.int32, device=device)
    caches = [pa.PagedLayerCache(torch.zeros(shape, device=device),
                                 torch.zeros(shape, device=device), bt, ctx,
                                 nl) for _ in range(cfg.num_hidden_layers)]
    routed = [l.mlp for l in model.layers if not l.is_dense]
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, kw: seen.append((a[0].detach(), kw["token_mask"])),
        with_kwargs=True) for m in routed]
    try:
        with torch.no_grad():
            h, _ = model(ids.to(device), caches=caches)
            out = model.lm_head(h)
    finally:
        for hk in hooks:
            hk.remove()
    return out, [(m.last_capacity, int(m.last_dropped)) for m in routed], seen


def paged_rows_moe(cfg, device, lens=MOE_ROW_LENS):
    """25(a), MoE: one padded per-row chunk through the routed layer's
    token mask. (i) At the config's capacity factor and at a binding one
    (``MOE_TIGHT_CF``, which drops), the routed layer on the chunk's
    hidden states and mask equals the same layer on the valid tokens
    alone, packed in the same order, at the same capacity: equal drops
    and equal outputs, so the padded tails claimed no slot. (ii)
    With the capacity factor raised until nothing drops, each valid row's
    logits equal the same row run alone and unpadded."""
    from paddle_tpu_torch.models import MoeForCausalLM
    model = MoeForCausalLM(cfg, device=device, dtype="float32",
                           seed=SEED + 26)
    model.eval()
    B, S = len(lens), max(lens)
    rng = np.random.RandomState(SEED + 26)
    ids = torch.zeros(B, S, dtype=torch.long)
    for b, n in enumerate(lens):
        ids[b, :n] = torch.from_numpy(rng.randint(1, cfg.vocab_size, n))
    valid = torch.arange(S)[None, :] < torch.tensor(lens)[:, None]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t = time.perf_counter()
    _, caps, seen = _moe_rows(model, ids, lens, device)
    _sync(device)
    step_ms = 1e3 * (time.perf_counter() - t)
    routed = [l.mlp for l in model.layers if not l.is_dense]
    same = []
    for m, (x, mask) in zip(routed, seen):
        cf = m.capacity_factor
        for chunk_cf in (cf, MOE_TIGHT_CF):
            with torch.no_grad():
                m.capacity_factor = chunk_cf
                pad_out = m(x, token_mask=mask)
                C, dropped = m.last_capacity, int(m.last_dropped)
                packed = x[valid.to(device)][None]
                # the packed tokens' factor that gives the chunk's C
                m.capacity_factor = (C + 0.5) * m.num_experts / (
                    m.gate.top_k * packed.shape[1])
                try:
                    out = m(packed)
                    if m.last_capacity != C:
                        raise AssertionError(
                            f"moe rows: capacity {m.last_capacity} != {C}")
                    drops = int(m.last_dropped)
                finally:
                    m.capacity_factor = cf
            if drops != dropped:
                raise AssertionError(f"moe rows: the padded chunk drops "
                                     f"{dropped}, its valid tokens {drops}")
            _close("moe rows: routed layer, padded vs packed",
                   pad_out[valid.to(device)], out[0], CENSUS_TOL)
            same.append((chunk_cf, C, dropped))
    for m in routed:  # (ii): a capacity of at least T, so nothing drops
        m.capacity_factor = float(m.num_experts) / m.gate.top_k + 1.0
    logits, caps2, _ = _moe_rows(model, ids, lens, device)
    if any(d for _, d in caps2):
        raise AssertionError(f"moe rows: drops at capacity >= T: {caps2}")
    for b, n in enumerate(lens):
        alone, _, _ = _moe_rows(model, ids[b:b + 1, :n], [n], device)
        _close(f"moe rows: row {b} padded vs alone", logits[b, :n],
               alone[0], CENSUS_TOL)
    peak = _peak_gb(device)
    log(f"paged rows (a): DeepSeekMoE-16B widths x "
        f"{cfg.num_hidden_layers} layers f32, one per-row chunk of rows "
        f"{list(lens)} (S {S}): the routed layer's (capacity factor, C, "
        f"drops) {same}, each equal to the valid tokens' alone at that C "
        f"(outputs too); valid rows' logits equal each row alone; chunk "
        f"step {step_ms:.2f} ms, peak {peak:.2f} GB")
    del model
    free_device_memory()
    return dict(capacity_drops=same, step_ms=step_ms, peak_gb=peak)


def _close(what, got, want, tol):
    """``got`` against ``want`` (moved to ``got``'s device) by ``tol``;
    returns the largest absolute difference."""
    got, want = got.double(), want.to(got.device).double()
    if not torch.allclose(got, want, **tol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{what}: max |diff| {err:.3e} outside {tol}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def _timed_peak(fn, device):
    """``(fn(), ms, peak GB)``: one call, synchronised, its peak memory
    above what was allocated before it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t)
    peak = (torch.cuda.max_memory_allocated(device) - base) / 1e9 \
        if device.type == "cuda" else 0.0
    return out, ms, peak


def _detection_inputs(rng, scale=1.0):
    """Mask R-CNN R50-FPN's P2 level (stride 4 of an 800 x 1344 image,
    256 channels, batch 2), 512 RoIs an image, RPN anchors (size 32,
    ratios 0.5/1/2 at every P2 cell), 50 ground-truth boxes an image."""
    H, W = int(200 * scale), int(336 * scale)
    feat = rng.randn(2, 256, H, W).astype(np.float32)
    img_h, img_w = 4 * H, 4 * W

    def boxes(n, lo, hi):
        xy = rng.uniform(0, 1, (n, 2)) * [img_w, img_h]
        wh = rng.uniform(lo, hi, (n, 2)) * [img_w, img_h]
        b = np.concatenate([xy, np.minimum(xy + wh, [img_w, img_h])], 1)
        return b.astype(np.float32)
    rois = boxes(1024, 0.02, 0.6)
    cy, cx = np.meshgrid((np.arange(H) + 0.5) * 4, (np.arange(W) + 0.5) * 4,
                         indexing="ij")
    anchors = []
    for r in (0.5, 1.0, 2.0):
        w, h = 32 / np.sqrt(r), 32 * np.sqrt(r)
        anchors.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2], -1).reshape(-1, 4))
    anchors = np.concatenate(anchors).astype(np.float32)
    return feat, rois, anchors, boxes(100, 0.05, 0.5), boxes


def vision_ops_census(device, scale=1.0, check_rois=64):
    """25(b): ``vision.ops`` at Mask R-CNN R50-FPN's sizes on ``device``,
    each call timed with its peak memory; each checked against the same
    call on the CPU in f32 (``roi_align``/``roi_pool`` on the first
    ``check_rois`` RoIs of each image, at the card's sampling ratio)."""
    from paddle_tpu_torch.vision import ops as V
    rng = np.random.RandomState(SEED + 27)
    feat, rois, anchors, gt, boxes = _detection_inputs(rng, scale)
    num = torch.tensor([512, 512])
    x = torch.from_numpy(feat).to(device).requires_grad_()
    r = torch.from_numpy(rois).to(device)
    rec = {}
    cot_rng = np.random.RandomState(SEED + 28)
    t_part = time.perf_counter()
    for out_size, ratio in ((7, 2), (14, 2), (7, -1), (14, -1)):
        # the CPU checks fewer RoIs at the adaptive ratio (8 here: 16
        # times ratio 2's samples)
        n_chk = check_rois if ratio > 0 else max(check_rois // 16, 1)
        sub = np.r_[0:n_chk, 512:512 + n_chk]
        sub_num = torch.tensor([n_chk, n_chk])
        out, ms, peak = _timed_peak(lambda: V.roi_align(
            x, r, num.to(device), out_size, 0.25, ratio), device)
        cot = torch.from_numpy(cot_rng.rand(*out.shape).astype(
            np.float32)).to(device)
        _, bms, bpeak = _timed_peak(
            lambda: (out * cot).sum().backward(), device)
        used = ratio
        if ratio <= 0:  # the adaptive ratio of all 1024 boxes, on the CPU
            b = rois * 0.25
            used = int(min(math.ceil(max(
                float(np.max(b[:, 3] - b[:, 1])) / out_size,
                float(np.max(b[:, 2] - b[:, 0])) / out_size, 1.0)), 8))
        # the check: both devices on the subset, at the same ratio
        xs = {}
        for dev in ("cpu", device):
            xd = torch.from_numpy(feat).to(dev).requires_grad_()
            o = V.roi_align(xd, torch.from_numpy(rois[sub]).to(dev),
                            sub_num.to(dev), out_size, 0.25, used)
            (o * cot[sub].to(dev)).sum().backward()
            xs[str(dev)] = (o.detach(), xd.grad)
        (oc, gc_), (og, gg) = xs["cpu"], xs[str(device)]
        e1 = _close("vision (b) roi_align", og, oc, CENSUS_TOL)
        e2 = _close("vision (b) roi_align grad", gg, gc_, CENSUS_TOL)
        key = f"roi_align_{out_size}_r{ratio}"
        rec[key] = dict(ms=ms, backward_ms=bms, peak_gb=peak,
                        backward_peak_gb=bpeak, ratio=used,
                        max_abs_err=max(e1, e2),
                        wall_s=time.perf_counter() - t_part)
        t_part = time.perf_counter()
        x.grad = None
        del out, cot
    sub = np.r_[0:check_rois, 512:512 + check_rois]
    sub_num = torch.tensor([check_rois, check_rois])
    out, ms, peak = _timed_peak(
        lambda: V.roi_pool(x.detach(), r, num.to(device), 7, 0.25), device)
    want = V.roi_pool(torch.from_numpy(feat), torch.from_numpy(rois[sub]),
                      sub_num, 7, 0.25)
    got = V.roi_pool(x.detach(), r[torch.from_numpy(sub).to(device)],
                     sub_num.to(device), 7, 0.25)
    rec["roi_pool_7"] = dict(ms=ms, peak_gb=peak, max_abs_err=_close(
        "vision (b) roi_pool", got, want, CENSUS_TOL))
    if not torch.equal(got, out[torch.from_numpy(sub).to(device)]):
        raise AssertionError("vision (b) roi_pool: the subset's call "
                             "differs from the whole call")
    # RPN NMS: 2000 proposals an image at 0.7; per-class NMS: 1000 boxes
    # of 80 categories at 0.5
    for name, n, thr, ncat in (("nms_rpn", 2000, 0.7, 0),
                               ("nms_per_class", 1000, 0.5, 80)):
        bx = torch.from_numpy(boxes(n, 0.01, 0.3))
        sc = torch.from_numpy(rng.rand(n).astype(np.float32))
        kw = {}
        if ncat:
            cat = torch.from_numpy(rng.randint(0, ncat, n))
            kw = dict(category_idxs=cat, categories=list(range(ncat)))
        want = V.nms(bx, thr, sc, **kw)
        got, ms, peak = _timed_peak(lambda: V.nms(
            bx.to(device), thr, sc.to(device),
            **{k: (v.to(device) if torch.is_tensor(v) else v)
               for k, v in kw.items()}), device)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"vision (b) {name}: kept indices differ")
        rec[name] = dict(ms=ms, peak_gb=peak, kept=int(got.numel()))
    var = torch.tensor([0.1, 0.1, 0.2, 0.2]).expand(len(anchors), 4)
    a = torch.from_numpy(anchors)
    deltas = torch.from_numpy(rng.randn(2, len(anchors), 4).astype(
        np.float32) * 0.2)
    for name, args, kw in (
            ("box_coder_encode", (a, var, torch.from_numpy(gt)),
             dict(code_type="encode_center_size")),
            ("box_coder_decode", (a, None, deltas),
             dict(code_type="decode_center_size"))):
        want = V.box_coder(*args, **kw)
        got, ms, peak = _timed_peak(lambda: V.box_coder(
            *[None if t is None else t.to(device) for t in args], **kw),
            device)
        rec[name] = dict(ms=ms, peak_gb=peak, max_abs_err=_close(
            f"vision (b) {name}", got, want, dict(rtol=1e-4, atol=1e-4)))
    for k, v in rec.items():
        log(f"vision (b) {k}: " + ", ".join(
            f"{n} {x:.4g}" if isinstance(x, float) else f"{n} {x}"
            for n, x in v.items()))
    del x
    free_device_memory()
    return rec


def _census_inputs(arrays, device, grad):
    """The numpy ``arrays`` on ``device``, those that ``grad`` names
    requiring a gradient."""
    return [torch.from_numpy(a).to(device).requires_grad_(i in grad)
            for i, a in enumerate(arrays)]


def _census_cot(shape, device):
    """A cotangent in [0.5, 1.5) made on ``device`` from an integer hash
    of each element's flat index, so every device makes the same values
    and a batch's first sample is the cotangent of that sample alone."""
    i = torch.arange(math.prod(shape), device=device, dtype=torch.int64)
    frac = ((i * 2654435761) % 1000003).float() * (1.0 / 1000003)
    return (0.5 + frac).reshape(shape)


def _fwd_bwd(fn, ts, grad):
    """``fn`` on the tensors ``ts``: the output and the gradients of
    ``sum(out * cot)`` in the tensors ``grad`` names."""
    out = fn(*ts)
    if grad:
        (out * _census_cot(tuple(out.shape), out.device)).sum().backward()
    return [out.detach()] + [ts[i].grad for i in grad]


def _census_table(rng, s=1):
    """(name, fn of the functional module or a layer built for a device,
    inputs, indices of the differentiated inputs, the first-sample-only
    CPU check): every functional and layer this slice ported. The resize,
    shuffle, grid and fold rows run the sizes of a Cityscapes
    segmentation head, an ESPCN x3 upscaler, a spatial transformer and a
    3x3 im2col; the losses run over [4096, 1024]. ``s`` divides the
    batch and spatial sizes (a rehearsal on the CPU)."""
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.nn.functional as F
    N, D = 4096 // s, 1024 // s

    def r(*s):
        return rng.randn(*s).astype(np.float32)

    def u(*s, lo=0.05, hi=0.95):
        return rng.uniform(lo, hi, s).astype(np.float32)

    sign = np.where(rng.rand(N) > 0.5, 1.0, -1.0).astype(np.float32)
    bits = (rng.rand(N, D) > 0.5).astype(np.float32)
    seg = r(8, 19, 128 // s, 256 // s)
    rows = []
    for mode in ("nearest", "bilinear", "bicubic", "area"):
        rows.append((f"interpolate {mode} x4", lambda v, m=mode:
                     F.interpolate(v, scale_factor=4, mode=m), [seg], (0,),
                     True))
        rows.append((f"interpolate {mode} 1/2", lambda v, m=mode:
                     F.interpolate(v, size=(64 // s, 128 // s), mode=m), [seg], (0,),
                     True))
    th = (np.eye(2, 3)[None] + 0.1 * rng.randn(8, 2, 3)).astype(np.float32)
    rows += [
        ("Upsample bilinear x4", lambda d: tnn.Upsample(
            scale_factor=4, mode="bilinear"), [seg], (0,), True),
        ("UpsamplingNearest2D x4", lambda d: tnn.UpsamplingNearest2D(
            scale_factor=4), [seg], (0,), True),
        ("pixel_shuffle x3", lambda v: F.pixel_shuffle(v, 3),
         [r(16 // s, 576, 64 // s, 64 // s)], (0,), True),
        ("PixelUnshuffle 3", lambda d: tnn.PixelUnshuffle(3),
         [r(16 // s, 64, 192 // s, 192 // s)], (0,), True),
        ("affine_grid + grid_sample", lambda v, t: F.grid_sample(
            v, F.affine_grid(t, [8, 3, 512 // s, 512 // s])),
         [r(8, 3, 512 // s, 512 // s), th],
         (0, 1), True),
        ("unfold k3", lambda v: F.unfold(v, 3, paddings=1),
         [r(8, 64, 128 // s, 128 // s)], (0,), True),
        ("fold k3", lambda v: F.fold(v, [128 // s, 128 // s], 3, paddings=1),
         [r(8, 576, (128 // s) ** 2)], (0,), True),
        ("ChannelShuffle 4", lambda d: tnn.ChannelShuffle(4),
         [r(8, 64, 128 // s, 128 // s)], (0,), True),
        ("temporal_shift", lambda v: F.temporal_shift(v, 8),
         [r(16, 64, 56 // s, 56 // s)], (0,), False),
        ("swiglu", lambda v: F.swiglu(v), [r(N, 2 * D)], (0,), False),
        ("label_smooth", lambda v: F.label_smooth(v, epsilon=0.1),
         [u(N, D)], (0,), False),
        ("LabelSmooth", lambda d: tnn.LabelSmooth(0.1), [u(N, D)], (0,),
         False),
        ("normalize", lambda v: F.normalize(v, axis=-1), [r(N, D)], (0,),
         False),
        ("CosineSimilarity", lambda d: tnn.CosineSimilarity(axis=-1),
         [r(N, D), r(N, D)], (0, 1), False),
        ("PairwiseDistance", lambda d: tnn.PairwiseDistance(),
         [r(N, D), r(N, D)], (0, 1), False),
        ("Bilinear", lambda d: _seeded(tnn.Bilinear(64, 64, 32, device=d)),
         [r(N, 64), r(N, 64)], (0, 1), False),
        ("pad reflect", lambda v: F.pad(v, [2, 3, 1, 1], mode="reflect"),
         [r(8, 64, 128 // s, 128 // s)], (0,), False),
        ("Pad2D replicate", lambda d: tnn.Pad2D(2, mode="replicate"),
         [r(8, 64, 128 // s, 128 // s)], (0,), False),
        ("ZeroPad2D", lambda d: tnn.ZeroPad2D([1, 2, 3, 4]),
         [r(8, 64, 128 // s, 128 // s)], (0,), False),
        ("Pad1D circular", lambda d: tnn.Pad1D(3, mode="circular"),
         [r(64, 128, 512 // s)], (0,), False),
        ("Pad3D", lambda d: tnn.Pad3D(1), [r(4, 16, 32 // s, 32 // s, 32 // s)], (0,),
         False),
        ("diag_embed", lambda v: F.diag_embed(v), [r(64, 256)], (0,),
         False),
        ("gaussian_nll_loss", lambda a, b, v: F.gaussian_nll_loss(a, b, v),
         [r(N, D), r(N, D), u(N, D, lo=0.1, hi=2.0)], (0, 1, 2), False),
        ("GaussianNLLLoss", lambda d: tnn.GaussianNLLLoss(),
         [r(N, D), r(N, D), u(N, D, lo=0.1, hi=2.0)], (0, 1, 2), False),
        ("poisson_nll_loss", lambda a, b: F.poisson_nll_loss(a, b),
         [r(N, D), np.floor(u(N, D, lo=0, hi=6))], (0,), False),
        ("PoissonNLLLoss", lambda d: tnn.PoissonNLLLoss(full=True),
         [r(N, D), np.floor(u(N, D, lo=0, hi=6))], (0,), False),
        ("multi_label_soft_margin_loss", lambda a, b:
         F.multi_label_soft_margin_loss(a, b), [r(N, D), bits], (0,),
         False),
        ("MultiLabelSoftMarginLoss", lambda d:
         tnn.MultiLabelSoftMarginLoss(), [r(N, D), bits], (0,), False),
        ("sigmoid_focal_loss", lambda a, b: F.sigmoid_focal_loss(a, b),
         [r(N, D), bits], (0,), False),
        ("dice_loss", lambda a, b: F.dice_loss(a, b),
         [np.abs(u(N, D)), rng.randint(0, D, (N, 1))], (0,), False),
        ("npair_loss", lambda a, p, y: F.npair_loss(a, p, y),
         [r(N, 64), r(N, 64), rng.randint(0, 64, N)], (0, 1), False),
        ("margin_ranking_loss", lambda a, b, t: F.margin_ranking_loss(
            a, b, t, 0.1), [r(N), r(N), sign], (0, 1), False),
        ("MarginRankingLoss", lambda d: tnn.MarginRankingLoss(0.1),
         [r(N), r(N), sign], (0, 1), False),
        ("hinge_embedding_loss", lambda a, t: F.hinge_embedding_loss(
            a, t[:, None]), [r(N, D), sign], (0,), False),
        ("HingeEmbeddingLoss", lambda d: tnn.HingeEmbeddingLoss(),
         [r(N, D), np.repeat(sign[:, None], D, 1)], (0,), False),
        ("cosine_embedding_loss", lambda a, b, t: F.cosine_embedding_loss(
            a, b, t), [r(N, D), r(N, D), sign], (0, 1), False),
        ("CosineEmbeddingLoss", lambda d: tnn.CosineEmbeddingLoss(0.1),
         [r(N, D), r(N, D), sign], (0, 1), False),
        ("triplet_margin_loss", lambda a, p, n: F.triplet_margin_loss(
            a, p, n), [r(N, D), r(N, D), r(N, D)], (0, 1, 2), False),
        ("TripletMarginLoss", lambda d: tnn.TripletMarginLoss(swap=True),
         [r(N, D), r(N, D), r(N, D)], (0, 1, 2), False),
        ("SoftMarginLoss", lambda d: tnn.SoftMarginLoss(),
         [r(N, D), np.repeat(sign[:, None], D, 1)], (0,), False),
        ("log_loss", lambda p, t: F.log_loss(p, t), [u(N, D), bits], (0,),
         False),
        ("LogLoss", lambda d: tnn.LogLoss(), [u(N, D), bits], (0,), False),
        ("Unfold", lambda d: tnn.Unfold(3, paddings=1),
         [r(8, 64, 128 // s, 128 // s)], (0,), True),
        ("Fold", lambda d: tnn.Fold([128 // s, 128 // s], 3, paddings=1),
         [r(8, 576, (128 // s) ** 2)], (0,), True),
        ("PixelShuffle 3", lambda d: tnn.PixelShuffle(3),
         [r(16 // s, 576, 64 // s, 64 // s)], (0,), True),
        ("one_hot", lambda v: F.one_hot(v, 1000),
         [rng.randint(0, 1000, N)], (), False),
        ("sequence_mask", lambda v: F.sequence_mask(v, 512),
         [rng.randint(0, 512, N)], (), False),
        ("max_pool2d padding over half", lambda v: F.max_pool2d(
            v, 2, 1, padding=2), [r(8, 64, 128 // s, 128 // s)], (0,), False),
        ("avg_pool2d padding over half", lambda v: F.avg_pool2d(
            v, 3, 2, padding=2, ceil_mode=True), [r(8, 64, 128 // s, 128 // s)], (0,),
         False),
    ]
    return rows


def _seeded(layer):
    """A layer's parameters drawn again from a seeded CPU generator, so
    the CPU and the card copies hold the same weights."""
    g = torch.Generator().manual_seed(SEED + 29)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return layer


_LAYER_NAMES = ("Upsample", "UpsamplingNearest2D", "PixelUnshuffle",
                "PixelShuffle", "ChannelShuffle", "LabelSmooth",
                "CosineSimilarity", "PairwiseDistance", "Bilinear", "Pad1D",
                "Pad2D", "Pad3D", "ZeroPad2D", "GaussianNLLLoss",
                "PoissonNLLLoss", "MultiLabelSoftMarginLoss",
                "MarginRankingLoss", "HingeEmbeddingLoss",
                "CosineEmbeddingLoss", "TripletMarginLoss", "SoftMarginLoss",
                "LogLoss", "Unfold", "Fold")


def layer_census(device, s=1):
    """25(c): each row of :func:`_census_table` forward and backward on
    ``device`` against the CPU in f32 (the rows marked so on their first
    sample); the random layers by their statistics; a weight-normed conv
    three steps under ``clip_grad_norm_`` on both; the five dtypes
    through ``to_tensor`` on ``device``. ``s`` as in
    :func:`_census_table`."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.core.dtype import convert_dtype
    rng = np.random.RandomState(SEED + 30)
    rec = {}
    worst = (0.0, None)
    for name, make, arrays, grad, first in _census_table(rng, s):
        t_row = time.perf_counter()
        is_layer = name.split()[0] in _LAYER_NAMES
        fn = {}
        for dev in ("cpu", device):
            fn[str(dev)] = make(dev) if is_layer else make
        ts = _census_inputs(arrays, device, grad)
        (got, ms, peak) = _timed_peak(
            lambda: _fwd_bwd(fn[str(device)], ts, grad), device)
        cpu_arrays = [a[:1] for a in arrays] if first else arrays
        want = _fwd_bwd(fn["cpu"], _census_inputs(cpu_arrays, "cpu", grad),
                        grad)
        if first:  # the per-sample rows' first sample (grid's theta too)
            got = [t[:1] for t in got]
        err = max(_close(f"census (c) {name}", g, w, CENSUS_SUM_TOL)
                  for g, w in zip(got, want))
        rec[name] = dict(ms=ms, peak_gb=peak, max_abs_err=err,
                         wall_s=time.perf_counter() - t_row)
        worst = max(worst, (err, name), key=lambda t: t[0])
        del got, want, ts
    log(f"census (c): {len(rec)} functionals and layers forward+backward "
        f"on the card equal the CPU's (largest |diff| {worst[0]:.3e} at "
        f"{worst[1]}); slowest: " + ", ".join(
            f"{n} {v['ms']:.1f} ms ({v['peak_gb']:.2f} GB)" for n, v in
            sorted(rec.items(), key=lambda kv: -kv[1]["ms"])[:6])
        + "; longest with the CPU's side: " + ", ".join(
            f"{n} {v['wall_s']:.2f} s" for n, v in
            sorted(rec.items(), key=lambda kv: -kv[1]["wall_s"])[:6]))
    # the random ones: by their statistics (their streams differ from the
    # CPU's by contract)
    ptt.seed(SEED)
    ones = torch.ones(256, 128, 8, 8, device=device)
    d2 = F.dropout2d(ones, 0.3).reshape(256, 128, -1)
    if not torch.all((d2 == 0).all(-1) | (d2 == 1 / 0.7).all(-1)):
        raise AssertionError("census (c) dropout2d: a channel half dropped")
    d3 = F.dropout3d(torch.ones(64, 32, 4, 8, 8, device=device), 0.5)
    keep2 = float((d2[..., 0] != 0).float().mean())
    keep3 = float((d3.reshape(64, 32, -1)[..., 0] != 0).float().mean())
    z = torch.randn(1 << 22, device=device)
    a = F.alpha_dropout(z, 0.2)
    g = F.gumbel_softmax(torch.tensor([[2.0, 0.0, -1.0, 0.5]],
                                      device=device).repeat(1 << 18, 1))
    freq = torch.bincount(g.argmax(-1), minlength=4).float() / (1 << 18)
    want = torch.softmax(torch.tensor([2.0, 0.0, -1.0, 0.5]), -1)
    stats = dict(dropout2d_keep=keep2, dropout3d_keep=keep3,
                 alpha_mean=float(a.mean()), alpha_std=float(a.std()),
                 gumbel_freq_err=float((freq.cpu() - want).abs().max()))
    if not (abs(keep2 - 0.7) < 0.02 and abs(keep3 - 0.5) < 0.04
            and abs(stats["alpha_mean"]) < 5e-3
            and abs(stats["alpha_std"] - 1) < 5e-3
            and stats["gumbel_freq_err"] < 5e-3):
        raise AssertionError(f"census (c) random layers: {stats}")
    log("census (c) random: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in stats.items()))
    # a weight-normed conv, three SGD steps under clip_grad_norm_
    x = torch.from_numpy(rng.randn(16, 32, 64, 64).astype(np.float32))
    params = {}
    for dev in ("cpu", device):
        conv = _seeded(tnn.Conv2D(32, 64, 3, padding=1, device=dev))
        tnn.utils.weight_norm(conv)
        norms = []
        for _ in range(3):
            (conv(x.to(dev)) ** 2).mean().backward()
            norms.append(float(tnn.clip_grad_norm_(
                list(conv.parameters()), 0.05)))
            with torch.no_grad():
                for p in conv.parameters():
                    p -= 0.5 * p.grad
                    p.grad = None
        params[str(dev)] = (dict(conv.named_parameters()), norms)
    (pc, nc), (pd, nd) = params["cpu"], params[str(device)]
    for n in pc:
        _close(f"census (c) weight_norm {n}", pd[n].detach(),
               pc[n].detach(), CENSUS_SUM_TOL)
    np.testing.assert_allclose(nd, nc, rtol=1e-4)
    log(f"census (c) weight_norm conv: 3 steps under clip_grad_norm_ "
        f"equal the CPU's (grad norms {[round(v, 5) for v in nd]})")
    vals = np.array([[0.0, 1.5, 3.0], [17.0, 200.0, 448.0]], np.float32)
    for name in ("float8_e4m3fn", "float8_e5m2", "uint16", "uint32",
                 "uint64"):
        data = np.floor(vals) if name.startswith("uint") else vals
        t = ptt.to_tensor(data, dtype=name, place=str(device))
        if t.device.type != device.type or \
                convert_dtype(t.dtype) is not getattr(torch, name):
            raise AssertionError(f"census (c) to_tensor {name}: {t.dtype} "
                                 f"on {t.device}")
        back = t.astype("float32").cpu().numpy()
        want = ptt.to_tensor(data, dtype=name, place="cpu").astype(
            "float32").numpy()
        np.testing.assert_array_equal(back, want)
    log("census (c) dtypes: float8_e4m3fn, float8_e5m2, uint16, uint32 "
        "and uint64 round-trip through to_tensor on the card")
    free_device_memory()
    return dict(rows=rec, random=stats)


def phase_leftovers():
    """Phase 25: (a) the per-row paged path at Llama-3-8B and
    DeepSeekMoE-16B widths, (b) ``vision.ops`` at Mask R-CNN's sizes,
    (c) the layer census. Returns K1-K3's launches on (a)'s per-row runs
    (``paged_rows``: none, since the path reads through the gather path
    as the reference's does, and the phase fails if one launches) and on
    its eager ``generate`` runs (``paged_rows_generate``), and the
    record."""
    from paddle_tpu_torch.models import MoeConfig
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    t0 = time.perf_counter()
    free_device_memory()
    dev = torch.device("cuda")
    rpa0 = rpa.ragged_paged_attention.launches
    paths, llama = paged_rows_llama(
        LlamaConfig.llama3_8b(num_hidden_layers=4), dev)
    ta = time.perf_counter()
    _reset_flash_counts()
    moe = paged_rows_moe(MoeConfig.deepseek_moe_16b(num_hidden_layers=2),
                         dev)
    paths["paged_rows"] = {k: v + _flash_counts()[k]
                           for k, v in paths["paged_rows"].items()}
    if any(paths["paged_rows"].values()) or \
            rpa.ragged_paged_attention.launches != rpa0:
        raise AssertionError(
            f"the per-row paged path launched a kernel (K1-K3 "
            f"{paths['paged_rows']}, K4 "
            f"{rpa.ragged_paged_attention.launches - rpa0}); it reads "
            f"through the gather path")
    t1 = time.perf_counter()
    vision = vision_ops_census(dev)
    t2 = time.perf_counter()
    census = layer_census(dev)
    t3 = time.perf_counter()
    log(f"phase 25 seconds: {t3 - t0:.1f} ((a) {t1 - t0:.1f}: Llama "
        f"{ta - t0:.1f}, MoE {t1 - ta:.1f}; (b) {t2 - t1:.1f}, (c) "
        f"{t3 - t2:.1f})")
    return paths, dict(llama=llama, moe=moe, vision=vision,
                       census=census["random"])


_PHASE_SECONDS = []


def _timed(fn, *args):
    """``fn(*args)``, its seconds kept for the closing line."""
    t = time.perf_counter()
    out = fn(*args)
    _PHASE_SECONDS.append((fn.__name__, round(time.perf_counter() - t, 1)))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401 — fails outside a checkout
    t0 = time.perf_counter()
    _timed(phase_environment)
    _timed(phase_build)
    rec, rec_f16 = _timed(phase_kernel)
    launches, serving_peak, llama_sweep = _timed(phase_serving)
    _timed(phase_parity)
    flash = _timed(phase_flash)
    counts, train_step_ms = _timed(phase_training)
    fused = _timed(phase_fused_update)
    gmm = _timed(phase_gmm)
    moe = _timed(phase_moe_training)
    fit = _timed(phase_fit, flash, train_step_ms)
    ernie = _timed(phase_ernie)
    dit = _timed(phase_dit)
    shapes = {"ernie": flash_model_shape("ernie", 16, 12, 512, 64, 0.1),
              "dit": flash_model_shape("dit", 64, 16, 256, 72, 0.0)}
    ppocr = _timed(phase_ppocr)
    resnet = _timed(phase_resnet)
    api, gen, decode = _timed(phase_api, train_step_ms)
    capture_paths, flash_f16 = _timed(phase_capture_amp_recompute, gen, flash)
    rpa_paths, f16_step_err = _timed(phase_quantized_serving, serving_peak)
    p17 = _timed(phase_moe_and_incubate, llama_sweep)
    export_counts, export_rec = _timed(phase_export_and_deploy)
    prod_launches, ledger_cost = _timed(phase_serving_production)
    train_prod, train_prod_rec = _timed(phase_production, train_step_ms)
    dist_paths, dist_rec = _timed(phase_distributed)
    seq_paths, seq_rec = _timed(phase_seq_pipe)
    job_paths, job_rec = _timed(phase_job_lifecycle)
    ep_paths, tp_launches, ep_rec, tp_rec = _timed(phase_ep_tp)
    left_paths, left_rec = _timed(phase_leftovers)
    # each path's launches were counted from 0 over its own run; a kernel
    # on several paths reports their sum, and each path's count beside it
    paths = {"train": counts, "moe_train": moe, "fit": fit, "ernie": ernie,
             "dit": dit, "ppocr": ppocr, "resnet50": resnet,
             "api_train": api, "generate": gen, **capture_paths,
             "moe_generate": p17["moe_generate"],
             "incubate": p17["incubate"], "export": export_counts,
             **train_prod, **dist_paths, **seq_paths, **job_paths,
             **ep_paths, **left_paths}

    def path_launches(kname):
        by_path = {p: c[kname] for p, c in paths.items() if kname in c}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)
    rpa_paths = {"serving": launches, **rpa_paths,
                 "moe_serving": p17["moe_serving"], **prod_launches,
                 **tp_launches}
    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source="paddle_tpu_torch/ops/pallas/csrc/ragged_paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_paged_attention.py:159",
        launches=sum(rpa_paths.values()), launches_by_path=rpa_paths,
        library_ms=None, **rec, float16=dict(
            rec_f16, launches=rpa_paths["serving_f16"],
            engine_step_max_abs_err=f16_step_err),
        at_moe_heads=p17["rpa_moe"], autotune=p17["autotune"],
        serving_ledger_step_ms=ledger_cost, tp_serving=tp_rec)]
    for kname, replaces in FLASH_KERNELS:
        kernels.append(dict(name=kname, route="cuda", source=FLASH_SRC,
                            replaces=replaces, **path_launches(kname),
                            **flash[kname], float16=flash_f16[kname],
                            at_model_shapes={
                                **{m: r[kname] for m, r in shapes.items()},
                                **(decode if kname == "flash_attention_fwd"
                                   else {})},
                            **({"export": export_rec,
                                "train_prod": train_prod_rec,
                                "dist": dist_rec, "seq_pipe": seq_rec,
                                "job": job_rec, "ep_train": ep_rec,
                                "leftovers": left_rec}
                               if kname == "flash_attention_fwd" else {})))
    for kname, _, replaces in GMM_KERNELS:
        kernels.append(dict(name=kname, route="cuda", source=GMM_SRC,
                            replaces=replaces, launches_by_path={
                                "gmm": gmm[kname]["launches"]},
                            **gmm[kname]))
    for kname in FUSED_KERNELS:
        kernels.append(dict(name=kname, route="cuda", source=FUSED_SRC,
                            replaces=FUSED_REPLACES, **path_launches(kname),
                            **fused[kname]))
    log(f"seconds by phase: {_PHASE_SECONDS}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--job-trainer"]:
        sys.exit(job_trainer(sys.argv[2], sys.argv[3]))
    sys.exit(main())
