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
   K7 and K8 in bf16, K6's split kernel, ``cuobjdump --dump-sass``) must
   hold wgmma (``HGMMA``) and, where an operand comes by TMA, TMA loads
   (``UTMALDG``);
3. kernel vs plain — the ragged-paged-attention (RPA) kernel against its
   plain PyTorch version at Llama-3-8B head geometry on a ragged mix of
   decode rows, a 512-token prefill chunk over 1024 cached tokens and a
   padding tail: the float32 FMA kernel, and the bfloat16 split wgmma
   design at q tiles of 8, 16 and 32 tokens, also on a decode-only mix
   (phase 4's decode steps), with kernel/plain times (CUDA events, median
   of 20) and the least time the card could take;
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
   the optimizer).

It prints its measurements on earlier lines, then one JSON line with a
record per kernel (K1-K3's with their times at ERNIE's and DiT's shapes
under ``at_model_shapes``), and ends with
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
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
SASS_CHECKS = (  # library, kernel, instance -> TMA expected
    ("flash_attention", "flash_fwd_wgmma_kernel",
     {"ILi64EE": True, "ILi128EE": True}),
    ("flash_attention", "flash_dq_wgmma_kernel",
     {"ILi64EE": True, "ILi128EE": True}),
    ("flash_attention", "flash_dkv_wgmma_kernel",
     {"ILi64EE": True, "ILi128EE": True}),
    # <TMA lhs, rhs load>: 0 registers, 1 TMA MN-major, 2 TMA K-major
    ("grouped_matmul", "gmm_wgmma_kernel",
     {"ILb1ELi1EE": True, "ILb1ELi2EE": True, "ILb1ELi0EE": True,
      "ILb0ELi1EE": True, "ILb0ELi2EE": True, "ILb0ELi0EE": False}),
    # <f32 tiles by TMA>, else by cp.async
    ("grouped_matmul", "tgmm_split_kernel", {"ILb1EE": True, "ILb0EE": False}),
    # K8 in bf16 <operands by TMA>, else through registers
    ("grouped_matmul", "tgmm_aligned_wgmma_kernel",
     {"ILb1EE": True, "ILb0EE": False}),
    # K4 in bf16 <head dim, warpgroups>
    ("ragged_paged_attention", "rpa_wgmma_kernel",
     {"ILi64ELi1EE": True, "ILi64ELi2EE": True, "ILi128ELi1EE": True,
      "ILi128ELi2EE": True}))


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


def rpa_mix(dtype, seed=SEED, tile_q=None, decode_only=False):
    """An engine-shaped RPA input at Llama-3-8B head geometry, in the
    token budget of ServingEngine(max_batch=8, prefill_chunk=512): 6
    decode rows with 100-3000 tokens of context, one 512-token prefill
    chunk on top of 1024 cached tokens, and a padding tail; or
    (``decode_only``) phase 4's decode steps, 8 decode rows over its
    prompts with 16 tokens generated."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        DEFAULT_TILE_Q, build_step_maps, rpa_max_steps)
    rng = np.random.RandomState(seed)
    n_heads, n_kv, hd, bs = 32, 8, 128, 16
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


def phase_kernel():
    """RPA kernel vs its plain version: f32 (FMA kernel) at the default q
    tile, bf16 (split wgmma design) at each q tile on phase 3's mix and on
    the decode-only mix. Returns the bf16 record at the default tile."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        DEFAULT_TILE_Q, ragged_paged_attention,
        ragged_paged_attention_reference)
    cases = [(torch.float32, 1e-4, DEFAULT_TILE_Q, False)] + [
        (torch.bfloat16, 4e-3, tq, decode) for decode in (False, True)
        for tq in RPA_TILES]
    record = None
    for dtype, atol, tile_q, decode in cases:
        args, valid, need = rpa_mix(dtype, tile_q=tile_q, decode_only=decode)
        out = ragged_paged_attention(**args)
        torch.cuda.synchronize()
        ref = ragged_paged_attention_reference(**args)
        name = str(dtype).replace("torch.", "")
        mix = "decode-only mix" if decode else "phase 3 mix"
        max_err = _rpa_check(f"{name}, tile_q {tile_q}, {mix}", out, ref,
                             valid, atol)
        ms = cuda_ms(lambda: ragged_paged_attention(**args))
        main = tile_q == DEFAULT_TILE_Q and not decode
        plain_ms = cuda_ms(
            lambda: ragged_paged_attention_reference(**args)) if main \
            else None
        design = "split wgmma design" if dtype == torch.bfloat16 \
            else "FMA kernel"
        log(f"rpa {name} ({design}, tile_q {tile_q}, {mix}): T={need['T']}"
            f" live pages={need['pages']} max|err|={max_err:.3e} (atol "
            f"{atol}, rtol 0) padding rows exactly 0; kernel {ms:.4f} ms"
            + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
            + f", bound {need['bound_ms']:.4f} ms ({need['bound_by']}: "
            f"{need['bytes']} B, {need['flops']} flop)")
        if main and dtype == torch.bfloat16:
            record = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=need["bound_ms"],
                          bound_by=need["bound_by"])
    return record


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


def engine_step_check(engine, cfg, rng):
    """One real engine step's layer-0 RPA output against the plain
    version on the same inputs. Request A0 (a 1024-token prefix P and 50
    more) is served while C decodes; then A1 and A2, both starting with P,
    hit the prefix cache, so a step holds a prefill chunk, C's decode row
    and two sequences sharing P's pages. The model's paged attention step
    is wrapped for this window only: the first layer-0 call with all
    three is checked (the pools then hold exactly what the kernel read),
    at the card tests' bf16 tolerance (atol 4e-3, rtol 8e-3: both sides
    round to bf16 once, and the model's outputs are not all below 1 as
    phase 3's random ones are)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import \
        ragged_paged_attention_reference
    orig = pa.ragged_paged_attention_step
    found = []

    def capturing(q, k, v, k_pool, v_pool, bt, cu, ctx, sid, pos, ssq, sbk,
                  *, scale=None, attn_impl="rpa"):
        out = orig(q, k, v, k_pool, v_pool, bt, cu, ctx, sid, pos, ssq, sbk,
                   scale=scale, attn_impl=attn_impl)
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
                                 4e-3, 8e-3), n[live].tolist(),
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
    log(f"serving: one engine step's layer-0 RPA output (new tokens per "
        f"sequence {news}, shared prefix pages, {tiles} q tiles) agrees "
        f"with the plain version: max|err| {err:.3e} (atol 4e-3, rtol 8e-3: "
        f"a model's outputs reach past 1, where one bf16 unit is 7.8e-3); "
        f"padding rows exactly 0")


def phase_serving():
    """Llama-3-8B widths, 32 layers, bf16, behind the HTTP server."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import ServingEngine, Server

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
    # a check of this script only: every logits tensor must be finite
    bad_logits = []
    orig_project = engine._project

    def checked_project(h):
        logits = orig_project(h)
        if not bool(torch.isfinite(logits).all()):
            bad_logits.append(tuple(logits.shape))
        return logits

    engine._project = checked_project

    rng = np.random.RandomState(SEED)
    lens = SERVING_LENS
    prefix = rng.randint(1, cfg.vocab_size, 1024).tolist()
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    prompts[6] = prefix + prompts[6][1024:]   # two share a 1024-token
    prompts[7] = prefix + prompts[7][1024:]   # prefix
    new_tokens = 32
    results = [None] * len(prompts)
    errors = []
    torch.cuda.reset_peak_memory_stats()
    with Server(engine) as srv:
        def fire(i):
            try:
                results[i] = _post(srv.url + "/generate", {
                    "prompt_ids": prompts[i],
                    "max_new_tokens": new_tokens, "temperature": 0.0,
                    "stream": i % 2 == 1})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")
        steps0 = engine.steps
        rpa.ragged_paged_attention.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = rpa.ragged_paged_attention.launches
        steps = engine.steps - steps0
        with urllib.request.urlopen(srv.url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        plain, profiled = ([rng.randint(1, cfg.vocab_size, n).tolist()
                            for n in (256, 512, 1024, 2048)]
                           for _ in range(2))
        profile_window(engine, plain, profiled, new_tokens)
        engine_step_check(engine, cfg, rng)
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
    if launches != cfg.num_hidden_layers * steps or steps == 0 or \
            health["rpa_launches"] != launches:
        raise AssertionError(
            f"rpa launches {launches} (healthz {health['rpa_launches']}) "
            f"!= {cfg.num_hidden_layers} layers x {steps} steps")
    engine.cache.allocator.assert_no_leaks()
    ttfts = sorted(r["ttft_ms"] for r in results)
    # each request's mean gap between output tokens, from the server's
    # own ttft_ms and latency_ms
    gaps = sorted((r["latency_ms"] - r["ttft_ms"]) / (new_tokens - 1)
                  for r in results)
    log(f"serving: {len(prompts)} requests, prompts {lens}, "
        f"{new_tokens} new tokens each, all returned; {steps} engine steps,"
        f" {launches} RPA launches (= {cfg.num_hidden_layers} x steps)")
    log(f"serving: window wall {wall:.3f} s; mean step (wall / steps) "
        f"{1e3 * wall / steps:.3f} ms; decode tokens/s (generated tokens /"
        f" wall) {len(prompts) * new_tokens / wall:.2f}; gap between output"
        f" tokens per request, p50 {statistics.median(gaps):.3f} ms, max "
        f"{gaps[-1]:.3f} ms; p50 TTFT {statistics.median(ttfts):.3f} ms; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
        f"prefix cache {health['prefix_cache']}")
    del engine
    free_device_memory()
    serving_tile_sweep(model, cfg)
    del model
    free_device_memory()
    return launches


def serving_tile_sweep(model, cfg):
    """The engine's q tile on phase 4's step: the same engine geometry at
    tile_q 8, 16 and 32, then again in reverse order (the engine
    module's DEFAULT_TILE_Q set for each engine's construction, then
    restored),
    each serving 8 fresh requests of phase 4's prompt lengths x 16 tokens
    in process after one warm-up request: mean step ms (wall / engine
    steps)."""
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
    log("serving tile sweep (8 requests of phase 4's prompt lengths x 16 "
        "tokens, in process, in order then reversed): " + "; ".join(
            f"tile_q {t}: step_tokens {T}, mean step {ms:.3f} ms over {n} "
            f"steps" for t, T, ms, n in res))


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


def _reset_flash_counts():
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0


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
    o_tol, g_tol = FLASH_TOL[dtype]

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
            _check(f"K1 o {name}", o, ro.reshape(o.shape), *o_tol),
            _check(f"K1 lse {name}", lse, rlse.reshape(lse.shape), *o_tol)),
        "flash_attention_dq": _check(f"K2 dq {name}", dq,
                                     rgrads[0].reshape(dq.shape), *g_tol),
        "flash_attention_dkv": max(
            _check(f"K3 dk {name}", dk, rgrads[1].reshape(dk.shape),
                   *g_tol),
            _check(f"K3 dv {name}", dv, rgrads[2].reshape(dv.shape),
                   *g_tol))}
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
            design = ("wgmma, tiles by TMA" if dtype == torch.bfloat16
                      else "FMA loops")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401 — fails outside a checkout
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    rec = phase_kernel()
    launches = phase_serving()
    phase_parity()
    flash = phase_flash()
    counts, train_step_ms = phase_training()
    fused = phase_fused_update()
    gmm = phase_gmm()
    moe = phase_moe_training()
    fit = phase_fit(flash, train_step_ms)
    ernie = phase_ernie()
    dit = phase_dit()
    shapes = {"ernie": flash_model_shape("ernie", 16, 12, 512, 64, 0.1),
              "dit": flash_model_shape("dit", 64, 16, 256, 72, 0.0)}
    ppocr = phase_ppocr()
    resnet = phase_resnet()
    # each path's launches were counted from 0 over its own run; a kernel
    # on several paths reports their sum, and each path's count beside it
    paths = {"train": counts, "moe_train": moe, "fit": fit, "ernie": ernie,
             "dit": dit, "ppocr": ppocr, "resnet50": resnet}

    def path_launches(kname):
        by_path = {p: c[kname] for p, c in paths.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)
    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source="paddle_tpu_torch/ops/pallas/csrc/ragged_paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_paged_attention.py:159",
        launches=launches, launches_by_path={"serving": launches},
        library_ms=None, **rec)]
    for kname, replaces in FLASH_KERNELS:
        kernels.append(dict(name=kname, route="cuda", source=FLASH_SRC,
                            replaces=replaces, **path_launches(kname),
                            **flash[kname], at_model_shapes={
                                m: r[kname] for m, r in shapes.items()}))
    for kname, _, replaces in GMM_KERNELS:
        kernels.append(dict(name=kname, route="cuda", source=GMM_SRC,
                            replaces=replaces, launches_by_path={
                                "gmm": gmm[kname]["launches"]},
                            **gmm[kname]))
    for kname in FUSED_KERNELS:
        kernels.append(dict(name=kname, route="cuda", source=FUSED_SRC,
                            replaces=FUSED_REPLACES, **path_launches(kname),
                            **fused[kname]))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
