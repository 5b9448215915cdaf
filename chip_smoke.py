"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which either succeeds or makes the script exit non-zero:

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 is switched off for matmuls and cuDNN;
2. build — every kernel source under ``paddle_tpu_torch/ops/pallas/csrc``
   compiled with ``nvcc`` for ``sm_90a`` (one process per source, all at
   once) into the ignored build directory;
3. kernel vs plain — the ragged-paged-attention (RPA) kernel against its
   plain PyTorch version at Llama-3-8B head geometry on a ragged mix of
   decode rows, a 512-token prefill chunk over 1024 cached tokens and a
   padding tail, in float32 and bfloat16, with kernel/plain times (CUDA
   events, median of 20) and the least time the card could take;
4. serving — a Llama-3-8B-shaped model (all 32 layers, bf16, seeded
   random weights) behind ``ServingEngine`` + HTTP ``Server``, answering
   8 concurrent ``/generate`` requests; every request must return all
   its tokens, every logit must be finite, and the RPA launch count must
   equal ``num_hidden_layers x engine steps``;
5. engine parity — full width, 2 layers, float32: the kernel engine and
   an ``attn_impl="gather"`` engine give identical greedy streams.

It prints its measurements on earlier lines, then one JSON line with a
record per kernel, and ends with
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
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
SEED = 0


def log(*a):
    print(*a, flush=True)


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


def phase_build():
    from paddle_tpu_torch.ops.pallas import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} of {len(_build.sources())} kernel sources "
        f"compiled in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


# --------------------------------------------------------------------------
def rpa_mix(dtype, seed=SEED):
    """An engine-shaped RPA input at Llama-3-8B head geometry: 6 decode
    rows with 100-3000 tokens of context, one 512-token prefill chunk on
    top of 1024 cached tokens, and a padding tail, in the token budget of
    ServingEngine(max_batch=8, prefill_chunk=512)."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        DEFAULT_TILE_Q, build_step_maps, rpa_max_steps)
    rng = np.random.RandomState(seed)
    n_heads, n_kv, hd, bs = 32, 8, 128, 16
    max_seqs, pool_blocks, mbps = 8, 2048, 512
    tile_q = DEFAULT_TILE_Q
    T = -(-(max_seqs + 512) // tile_q) * tile_q
    seqs = [(1, int(c)) for c in rng.randint(100, 3001, 6)] + [(512, 1024)]
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
        block_size=bs, max_steps=rpa_max_steps(tile_q, mbps, pool_blocks),
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


def phase_kernel():
    """RPA kernel vs its plain version; returns the bf16 record."""
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)
    records = {}
    for dtype, atol, rtol in ((torch.float32, 1e-4, 0.0),
                              (torch.bfloat16, 4e-3, 0.0)):
        args, valid, need = rpa_mix(dtype)
        out = ragged_paged_attention(**args)
        torch.cuda.synchronize()
        ref = ragged_paged_attention_reference(**args)
        err = (out[valid].float() - ref[valid].float()).abs()
        max_err = float(err.max())
        tol = atol + rtol * ref[valid].float().abs()
        if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
            raise AssertionError(
                f"RPA kernel disagrees with its plain version in {dtype}: "
                f"max |err| {max_err} (atol {atol}, rtol {rtol})")
        if not bool((out[~valid] == 0).all()):
            raise AssertionError("RPA padding rows are not exactly 0")
        ms = cuda_ms(lambda: ragged_paged_attention(**args))
        plain_ms = cuda_ms(
            lambda: ragged_paged_attention_reference(**args))
        name = str(dtype).replace("torch.", "")
        log(f"rpa {name}: T={need['T']} live pages={need['pages']} "
            f"max|err|={max_err:.3e} (atol {atol}, rtol {rtol}) "
            f"padding rows exactly 0; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {need['bound_ms']:.4f} ms "
            f"({need['bound_by']}: {need['bytes']} B, {need['flops']} "
            f"flop)")
        records[dtype] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                              bound_ms=need["bound_ms"],
                              bound_by=need["bound_by"])
    return records[torch.bfloat16]


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted(((dev_us(e), e.key, e.count)
                   for e in prof.key_averages() if dev_us(e) > 0),
                  reverse=True)
    total = sum(us for us, _, _ in rows)
    if total == 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    rpa_us = sum(us for us, k, _ in rows if "rpa_kernel" in k)
    log(f"profile: {len(profiled_prompts)} requests x {new_tokens} tokens;"
        f" device time {total / 1e3:.3f} ms in {steps} steps (profiled);"
        f" wall {plain_us / 1e3:.3f} ms in {plain_steps} steps without the"
        f" profiler, {wall_us / 1e3:.3f} ms with it; device busy "
        f"{100 * total / plain_us:.1f}% of the un-profiled wall "
        f"({100 * total / wall_us:.1f}% of the profiled wall, a lower "
        f"bound); RPA kernel {100 * rpa_us / total:.1f}% of device time")
    for us, key, count in rows[:6]:
        log(f"  {100 * us / total:5.1f}%  {us / 1e3:10.3f} ms  "
            f"{count:6d}x  {key[:90]}")


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
    lens = [128, 384, 640, 896, 1280, 1664, 2048, 1536]
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
    del engine, model
    torch.cuda.empty_cache()
    return launches


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
    torch.cuda.empty_cache()


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
    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source="paddle_tpu_torch/ops/pallas/csrc/ragged_paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_paged_attention.py:159",
        launches=launches, library_ms=None, **rec)]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
