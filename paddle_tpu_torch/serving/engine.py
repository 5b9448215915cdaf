"""Continuous-batching serving engine over a block-paged KV cache — port
of ``paddle_tpu/serving/engine.py``.

``ServingEngine`` keeps a fixed ``max_batch``-slot layout and swaps
finished slots for queued requests between steps. Every iteration runs
one **unified step** over a token-packed ragged batch: a flat
``[1, step_tokens]`` axis holding all live decode slots (one token
each) plus as many prefill chunks as the budget covers, back to back.
Attention reads go through the ragged-paged-attention kernel
(``ops/pallas/ragged_paged_attention.py``) unless the engine is built
with ``attn_impl="gather"``.

Serving options of the reference (its engine :203-857):

* ``quantize="int8_wo"|"fp8_wo"`` — the projection weights and
  ``lm_head`` are quantized once, at construction
  (``quantization.weight_only``), and their 16/32-bit storage is freed;
  each quantized projection dequantizes its weight at use, in column
  chunks of at most :data:`DEQUANT_CHUNK` elements, and multiplies with
  ``torch.matmul`` (the reference's product is an XLA dot). The engine
  owns the model from then on: those layers hold no weight parameter.
* ``kv_dtype="int8"`` — int8 KV pools with f32 scale pools, read through
  the gather path (the RPA kernel reads unquantized pools, so the engine
  pins ``attn_impl="gather"`` with the reference's ``RuntimeWarning``).
* ``calibration=`` — a numerics summary dict, or a checkpoint path whose
  ``"numerics"`` entry gates which layers stay unquantized.
* ``warm_start_from=`` and :meth:`ServingEngine.load_weights` — weights
  from a checkpoint, behind the reference's dtype guard.
* LoRA tenant slots — a model prepared with ``tuning.apply_lora(
  n_slots=N)``; :meth:`ServingEngine.load_adapter`, ``unload_adapter``
  and ``submit(adapter_id=)``, with a per-slot load generation seeding
  the prefix-cache chain.
* ``mesh=`` — tensor-parallel serving over the mesh's ``mp`` axis
  (reference :284-331, :495-528), one process per rank. The model is
  built with ``tensor_parallel=True`` under that mesh, so each rank
  already holds its heads and FFN columns; ``mp`` must divide
  ``num_key_value_heads`` (``ValueError``), each rank's KV pools hold
  its ``n_kv/mp`` heads (allocated so from the start), a quantized
  projection is quantized whole and placed by
  ``quantization.shard_quantized``, and a checkpoint's full weights
  (``warm_start_from=``, :meth:`ServingEngine.load_weights`) are cut to
  each rank's blocks. A model built without ``tensor_parallel`` warns
  (``RuntimeWarning``) and is served whole, its weights and pools on
  every rank. **Every rank takes the same step**: group rank 0 of
  ``mp`` is the *driver* — it owns the scheduler, ``submit``,
  ``abort``, sampling and the run loop (``start()``, so ``Server`` runs
  on it unchanged) — and at each unified step it broadcasts over
  ``mp`` one packed int32 buffer: the step's tokens, block tables,
  ``cu``/``ctx``, sequence ids, positions, last-token indices, the RPA
  work lists and the copy-on-write pairs. The other ranks are
  *followers*: :meth:`ServingEngine.follow` (or ``run_until_idle``,
  ``start``/``shutdown``) runs ``_forward`` on each buffer with their
  shards and takes part in the row-parallel all-reduces and the logits
  gather; they never schedule or sample, and ``submit`` on one raises.
  The driver's ``shutdown`` (and the end of its ``run_until_idle``)
  reaches every rank. While the driver's run loop idles it sends a
  keep-alive word every :data:`KEEPALIVE_S` seconds (at most a quarter
  of the group's collective timeout), so a follower's wait for the next
  step never reaches that timeout. ``stats()["tensor_parallel"]`` is
  ``mp``.
  LoRA slots and the fleet's KV handoff are not ported under a mesh
  (``NotImplementedError``).

The model is any causal LM of the zoo that speaks the ``caches=``
protocol (``models.generation.decode_surfaces``): Llama, and the MoE LM,
whose gates' ``l_aux`` is cleared after every step. The q tile of the
RPA kernel is ``DEFAULT_TILE_Q``, or with ``FLAGS_use_autotune`` on the
card the winner of ``rpa_tile_q``'s sweep for the engine's signature.

Production telemetry, as the reference's: the ``serving_*`` metric
families (queue depth, running/waiting, TTFT, queue-wait, inter-token
and latency histograms, token, preemption and step counters, KV
headroom, block-seconds, prefix-cache counters); the per-request ledger
(``observability.requests``, armed unless ``request_ledger=False``);
the per-request span chain (``queue_wait`` -> ``prefill_chunk`` ->
``decode`` -> ``request_done``) into ``observability.trace`` when a
writer is armed, each span carrying the request's W3C trace id
(``submit(trace_id=)``); the device-memory ledger's owners (``kv_cache``,
``serving_params``) and :meth:`ServingEngine.memory_report`; the
``/healthz`` liveness stamp (``observability.fleet.note_step``); and
the fleet's KV handoff (:meth:`ServingEngine.export_kv_blocks`,
:meth:`ServingEngine.import_kv_blocks`).

What differs from the reference: PyTorch runs the step eagerly, so
there is no compiled executable and no trace counter — ``stats()``
reports the number of ``steps`` and the kernel's launches instead
(``rpa_launches`` process-wide, ``rpa_launches_engine`` this engine's
own: two engines may serve from one card); the KV pools are updated in
place rather than threaded through the step; ``memory_report()`` is
measured on a zero-work step, not read from a compiler; the
reference's ``PADDLE_TPU_QUANT_WEIGHTS``, ``PADDLE_TPU_QUANT_KV``,
``PADDLE_TPU_PREFIX_CACHE`` and ``PADDLE_TPU_REQUEST_LEDGER`` are not
read (the arguments carry them), nor is ``PADDLE_TPU_SERVING_MP`` (the
mesh is an argument); and the decode numerics sampling is not ported
yet.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import types
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.generation import decode_surfaces, sample_token
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.observability import fleet as obs_fleet
from paddle_tpu_torch.observability import memory as obs_memory
from paddle_tpu_torch.observability import requests as obs_requests
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa_mod
from paddle_tpu_torch.ops.paged_attention import RaggedLayerCache
from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
    DEFAULT_TILE_Q, build_step_maps, ragged_paged_attention, rpa_max_steps,
    rpa_tile_q)
from paddle_tpu_torch.quantization.weight_only import (
    WEIGHT_MODES, QuantizedLeaf, calibration_from_checkpoint,
    quantize_leaf, quantization_metrics, quantize_state, shard_quantized)
from paddle_tpu_torch.tuning import lora

from .kv_cache import PagedKVCache, chain_hash
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingEngine", "RequestHandle", "serving_metrics",
           "DEQUANT_CHUNK"]

#: elements of a quantized weight dequantized at once: a projection's
#: product runs over column chunks of at most this many elements, so the
#: dequantized copy never outgrows one chunk (at Llama-3-8B's widths the
#: lm_head takes 16 chunks, the MLP projections 2, the attention's 1;
#: the f32 staging of a chunk is 128 MiB)
DEQUANT_CHUNK = 1 << 25

# what the driver of a tensor-parallel engine tells its followers, in the
# first word of the step buffer
_STOP, _STEP, _ZERO_WORK, _IDLE, _ALIVE = 0, 1, 2, 3, 4

#: the most seconds an idle tensor-parallel driver lets pass between two
#: words to its followers (each waits for the next in a broadcast, which
#: fails at the group's collective timeout: gloo's default is 30 minutes)
KEEPALIVE_S = 10.0

_serving_metrics_cache = None


def serving_metrics(registry=None) -> dict:
    """The ``serving_*`` metric families (created on first use) — one
    accessor shared by the engine, the HTTP server's shed path and the
    KV cache gauge. The default registry's dict is cached: the server's
    503 shed path calls this per rejection. The quantization gauges are
    ``quantization.weight_only.quantization_metrics``'."""
    global _serving_metrics_cache
    if registry is None and _serving_metrics_cache is not None:
        return _serving_metrics_cache
    from paddle_tpu_torch.observability import get_registry
    reg = registry if registry is not None else get_registry()
    d = _build_serving_metrics(reg)
    if registry is None:
        _serving_metrics_cache = d
    return d


def _build_serving_metrics(reg) -> dict:
    return {
        "requests": reg.counter(
            "serving_requests_total", "requests by final outcome"),
        "queue": reg.gauge(
            "serving_queue_depth", "requests waiting for a batch slot"),
        "running": reg.gauge(
            "serving_requests_running", "requests holding a batch slot"),
        "waiting": reg.gauge(
            "serving_requests_waiting", "requests queued (incl. preempted)"),
        "ttft": reg.histogram(
            "serving_ttft_seconds", "submit -> first generated token"),
        "queue_wait": reg.histogram(
            "serving_queue_wait_seconds",
            "submit -> first batch-slot admission (the TTFT share spent "
            "on queueing rather than prefill/compile)"),
        "itl": reg.histogram(
            "serving_inter_token_seconds", "gap between streamed tokens"),
        "latency": reg.histogram(
            "serving_request_latency_seconds", "submit -> request finished"),
        "tokens": reg.counter(
            "serving_tokens_total",
            "tokens processed, by kind (prompt incl. recompute/generated)"),
        "preemptions": reg.counter(
            "serving_preemptions_total", "sequences preempted (recompute)"),
        "steps": reg.counter(
            "serving_engine_steps_total", "compiled steps run, by kind"),
        "rejections": reg.counter(
            "serving_rejections_total",
            "requests shed by graceful degradation, by reason "
            "(queue_full / deadline / fleet_saturated)"),
        "in_flight": reg.gauge(
            "serving_requests_in_flight",
            "requests accepted but not yet finished (queued + running)"),
        "kv_block_seconds": reg.counter(
            "serving_kv_block_seconds_total",
            "pool occupancy integral: KV blocks held by live sequences "
            "x seconds held (the per-request cost ledger's denominator)"),
        "kv_blocks": reg.gauge(
            "serving_kv_blocks_in_use",
            "KV-cache blocks currently held by live sequences"),
        "kv_headroom": reg.gauge(
            "serving_kv_headroom",
            "fraction of KV-cache blocks allocatable (free + reclaimable "
            "prefix-cached — the pressure signal before "
            "preemption-by-recompute starts churning)"),
        "kv_reclaimable": reg.gauge(
            "serving_kv_reclaimable",
            "fraction of KV-cache blocks parked refcount-0 in the prefix "
            "cache's reclaimable LRU tier (cache capacity, not pressure)"),
        "step_compiles": reg.gauge(
            "serving_step_compiles",
            "compiles of the ONE unified step executable (>1 means the "
            "compile-once contract broke)"),
        "prefix_lookups": reg.counter(
            "serving_prefix_cache_lookups",
            "admissions that consulted the prefix-cache index"),
        "prefix_hits": reg.counter(
            "serving_prefix_cache_hits",
            "admissions that reused at least one cached KV block"),
        "prefix_evictions": reg.counter(
            "serving_prefix_cache_evictions",
            "reclaimable cached blocks repurposed by the allocator"),
        "prefix_token_fraction": reg.gauge(
            "serving_prefix_cached_token_fraction",
            "cumulative fraction of prompt tokens served from the prefix "
            "cache instead of being prefilled"),
        "adapter_slots": reg.gauge(
            "serving_adapter_slots",
            "LoRA tenant slots the engine was built with (0 = plain "
            "single-model engine)"),
        "adapter_slots_loaded": reg.gauge(
            "serving_adapter_slots_loaded",
            "tenant slots currently holding a loaded adapter"),
        "adapter_requests": reg.counter(
            "serving_adapter_requests_total",
            "requests dispatched to a non-base adapter slot, by adapter"),
        "adapter_loads": reg.counter(
            "serving_adapter_loads_total",
            "adapter installs via load_adapter (in-place slot writes)"),
    }


def _quantized_linear_forward(layer, x):
    """A quantized projection's forward: ``x @ dequantize(W) (+ b)``, the
    weight dequantized (f32 values x scales, then the logical dtype, as
    the reference's ``dequantize``) over column chunks of at most
    :data:`DEQUANT_CHUNK` elements, each multiplied and dropped before
    the next. A tensor-parallel projection multiplies its block and
    keeps its layer's collectives: a row-parallel product is summed
    over ``mp`` before the bias, a gathered column-parallel one is
    gathered after it."""
    from paddle_tpu_torch.distributed.fleet import mpu
    if isinstance(layer, mpu.RowParallelLinear) and layer.is_mp:
        if not layer.input_is_parallel:
            x = mpu._ScatterToGroup.apply(x, layer._group)
        out = mpu.reduce_from_group(_dequantized_product(layer._wq, x),
                                    layer._group)
        return out if layer.bias is None else out + layer.bias
    out = _dequantized_product(layer._wq, x)
    if layer.bias is not None:
        out = out + layer.bias
    if isinstance(layer, mpu.ColumnParallelLinear) and layer.is_mp and \
            layer.gather_output:
        out = mpu._GatherFromGroup.apply(out, layer._group)
    return out


def _dequantized_product(leaf, x):
    """``x @ dequantize(leaf)`` over column chunks (see
    :func:`_quantized_linear_forward`)."""
    q, scale = leaf.q, leaf.scale
    d_in, d_out = q.shape
    step = max(1, DEQUANT_CHUNK // d_in)
    parts = []
    for c0 in range(0, d_out, step):
        c1 = min(d_out, c0 + step)
        w = q[:, c0:c1].float().mul_(scale[c0:c1]).to(leaf.orig_dtype)
        parts.append(torch.matmul(x, w))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _read_checkpoint_state(path: str, step: Optional[int] = None) -> dict:
    """A checkpoint's model state on the CPU: a ``CheckpointManager``
    directory (latest or ``step``), one ``step_N`` directory, or a flat
    ``.pdparams`` file; a training checkpoint's ``{"model": ...}`` half.
    Values come back as tensors."""
    if os.path.isdir(path):
        from paddle_tpu_torch.checkpoint import load_state_dir
        state = load_state_dir(path, step=step, device="cpu")
    else:
        from paddle_tpu_torch.framework.io import load
        state = load(path, device="cpu")
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    return {k: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for k, v in state.items()}


class RequestHandle:
    """Caller-side view of a submitted request (thread-safe wait)."""

    def __init__(self, req: Request):
        self._req = req
        self._done = threading.Event()

    @property
    def req_id(self) -> int:
        return self._req.req_id

    @property
    def trace_id(self) -> Optional[str]:
        return self._req.trace_id

    @property
    def token_ids(self) -> List[int]:
        return list(self._req.generated)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until finished; raises on request failure/timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self._req.req_id} not finished in {timeout}s")
        r = self._req
        if r.state is RequestState.FAILED:
            raise RuntimeError(f"request {r.req_id} failed: {r.error}")
        return {
            "request_id": r.req_id,
            "trace_id": r.trace_id,
            "token_ids": list(r.generated),
            "num_generated": len(r.generated),
            "prompt_len": len(r.prompt_tokens),
            "finish_reason": r.finish_reason,
            "preemptions": r.preemptions,
            "ttft_s": r.ttft(),
            "latency_s": r.latency(),
        }


class ServingEngine:
    """Continuous-batching inference over a causal LM that speaks the
    ragged ``caches=`` protocol (Llama and the MoE LM). Runs on the card
    unless ``device="cpu"``; the model must already live on that
    device. ``mesh=`` serves a tensor-parallel model from one process per
    rank, rank 0 of ``mp`` driving (module docstring); the other options
    are the reference's.
    ``request_ledger=False`` builds an engine whose request-ledger hooks
    are one attribute read (the reference's
    ``PADDLE_TPU_REQUEST_LEDGER=0``)."""

    def __init__(self, model, max_batch: int = 8, max_blocks: int = 64,
                 block_size: int = 16, prefill_chunk: int = 16,
                 max_blocks_per_seq: Optional[int] = None,
                 warm_start_from: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 mesh=None, quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None, calibration=None,
                 request_ledger: bool = True, device=None):
        if quantize is not None and quantize not in WEIGHT_MODES:
            raise ValueError(f"quantize={quantize!r} (want one of "
                             f"{sorted(WEIGHT_MODES)})")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype={kv_dtype!r} (want None or 'int8')")
        self.device = resolve_device(device)
        model_dev = next(iter(model.parameters())).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(
                f"model lives on {model_dev} but the engine runs on "
                f"{self.device}; build the model on the engine's device")
        model.eval()
        self.model = model
        cfg = model.cfg
        self._setup_mesh(mesh, cfg)
        if warm_start_from is not None:
            self._set_state(_read_checkpoint_state(warm_start_from))
        self._backbone, self._project, dtype = decode_surfaces(model)
        # weight-only quantization: the projection weights become
        # (values, scales) pairs, dequantized one projection at a time
        if isinstance(calibration, str):
            calibration = calibration_from_checkpoint(calibration)
        self._calibration = calibration
        self.quantize = quantize
        #: {parameter name: QuantizedLeaf} of the quantized projections
        self._qleaves = self._quantize_model() if quantize else {}
        self._weight_dtype = WEIGHT_MODES[quantize][0] if quantize \
            else dtype_name(dtype)
        # multi-tenant LoRA slots: a model prepared with
        # tuning.apply_lora(n_slots=N) carries [N + 1, ...] stacks; each
        # token dispatches by its slot id, row 0 = the base model
        self.n_adapter_slots = int(getattr(model, "_lora_slots", 0) or 0)
        self._lora_stacks = {
            n: p for n, p in model.named_parameters()
            if n.rsplit(".", 1)[-1].startswith("lora_")}
        if self.n_adapter_slots and (not self._lora_stacks or any(
                p.dim() != 3 or p.shape[0] != self.n_adapter_slots + 1
                for p in self._lora_stacks.values())):
            raise ValueError(
                f"the model claims {self.n_adapter_slots} LoRA slots but "
                "has no [n_slots + 1, ...] adapter stacks: prepare it with "
                "tuning.apply_lora(model, cfg, n_slots=N)")
        self._adapters = {}  # slot -> adapter name
        # per-slot load generation: seeds the prefix-cache chain so KV
        # computed under one adapter (or one load of a slot) never
        # answers a request decoding under another
        self._adapter_gen = {}  # slot -> int

        nl = cfg.num_hidden_layers
        n_kv = cfg.num_key_value_heads
        hd = cfg.hidden_size // cfg.num_attention_heads
        # this rank's share of the heads (all of them when served whole)
        heads_per = self.tp if self._shard_heads else 1
        #: block-granular prefix-cache KV reuse — on by default;
        #: prefix_cache=False is the bit-parity oracle
        self.prefix_cache_enabled = True if prefix_cache is None \
            else bool(prefix_cache)
        # the position cap is the attention's RoPE table length; the MoE
        # config carries none of its own, its attention is built from
        # _attn_cfg() (reference :314-321)
        max_pos = getattr(cfg, "max_position_embeddings", None)
        if max_pos is None:
            max_pos = cfg._attn_cfg().max_position_embeddings
        if max_blocks_per_seq is None:
            max_blocks_per_seq = min(max_blocks, -(-max_pos // block_size))
        self.kv_dtype = kv_dtype
        self.cache = PagedKVCache(nl, max_blocks, block_size,
                                  n_kv // heads_per, hd,
                                  max_blocks_per_seq, dtype=dtype,
                                  device=self.device,
                                  prefix_cache=self.prefix_cache_enabled,
                                  kv_dtype=kv_dtype)
        if kv_dtype is not None:
            quantization_metrics()["kv_scale_bytes"].set(sum(
                t.numel() * t.element_size()
                for t in self.cache.k_scales + self.cache.v_scales))
        self.max_model_len = min(self.cache.max_seq_len, max_pos)
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        #: attention read path: the RPA kernel, or the gather path only
        #: when asked for by name
        self.attn_impl = "rpa" if attn_impl is None else attn_impl
        if self.attn_impl not in ("rpa", "gather"):
            raise ValueError(
                f"attn_impl {self.attn_impl!r} (want rpa|gather)")
        if kv_dtype is not None and self.attn_impl == "rpa":
            # the RPA kernel streams raw pages and knows nothing of the
            # scale pools: int8 KV rides the gather read path
            warnings.warn(
                "kv_dtype='int8' forces attn_impl='gather' (the RPA "
                "kernel reads unquantized pools)", RuntimeWarning)
            self.attn_impl = "gather"
        # unified-step geometry: the flat token budget covers every
        # decode slot plus one full prefill chunk, rounded up to the RPA
        # kernel's q-tile height (autotuned under FLAGS_use_autotune; a
        # gather-pinned engine never runs the kernel, so sweeps nothing);
        # max_steps is the static per-tile work-list bound
        self._tile_q = DEFAULT_TILE_Q if self.attn_impl == "gather" \
            else rpa_tile_q(
                self.max_batch + self.prefill_chunk,
                cfg.num_attention_heads // heads_per, n_kv // heads_per, hd,
                block_size,
                self.cache.max_blocks_per_seq, max_blocks,
                dtype=dtype_name(dtype), device=self.device,
                default=DEFAULT_TILE_Q)
        budget = self.max_batch + self.prefill_chunk
        self.step_tokens = -(-budget // self._tile_q) * self._tile_q
        self._max_steps = rpa_max_steps(
            self._tile_q, self.cache.max_blocks_per_seq, self.max_batch)
        # all-sentinel work lists for the gather path, which ignores them
        n_tiles = self.step_tokens // self._tile_q
        self._null_step_maps = (
            np.full((n_tiles, self._max_steps), self.max_batch, np.int32),
            np.zeros((n_tiles, self._max_steps), np.int32))
        self.scheduler = Scheduler(self.cache, self.max_batch,
                                   self.prefill_chunk,
                                   step_tokens=self.step_tokens)
        #: unified steps run so far
        self.steps = 0
        # temperature > 0 draws; greedy requests never touch it
        self._generator = torch.Generator().manual_seed(0)

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        # callers (submit, abort, ...) waiting for the lock: the run loop
        # steps back while there are any, or it would take the lock
        # again before a woken caller gets to run
        self._callers = 0
        self._callers_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._stopped_followers = False
        self._last_word = time.monotonic()
        self._keepalive_s = self._keepalive_interval()
        self._handles = {}  # req_id -> RequestHandle
        #: this engine's own RPA kernel launches (``rpa_launches`` in
        #: ``stats()`` is the process-wide count)
        self.rpa_launches = 0
        self._published_preemptions = 0
        # per-request cost ledger: the process ledger, or None (then the
        # hot path pays one attribute read on None)
        self._ledger = obs_requests.maybe_arm(bool(request_ledger))
        self._published_block_seconds = 0.0
        # prefix-cache counter cursors (registry counters are process-
        # global; publish per-engine deltas like preemptions do)
        self._published_prefix = {"lookups": 0, "hits": 0, "evictions": 0}
        self._prompt_tokens_prefilled = 0
        self._init_metrics()

    # -- tensor parallelism ------------------------------------------------
    def _setup_mesh(self, mesh, cfg):
        """The engine's place on ``mesh`` (None: one process): its
        model-parallel group, whether this rank drives, and whether the
        heads are split (the model was built tensor-parallel)."""
        self.mesh = mesh
        self.tp, self.tp_rank, self._tp_group = 1, 0, None
        self._mp_axis = None
        self._shard_heads = False
        if mesh is None:
            return
        if getattr(mesh, "mesh_dim_names", None) is None:
            raise TypeError("mesh= takes a device mesh "
                            "(paddle.distributed.init_mesh)")
        from paddle_tpu_torch.distributed import collective as C
        from paddle_tpu_torch.distributed.fleet.mpu import _mp_axis
        from paddle_tpu_torch.distributed.mesh import axis_size
        self._mp_axis = _mp_axis(mesh)
        mp = axis_size(mesh, self._mp_axis)
        n_kv = cfg.num_key_value_heads
        if mp > 1 and n_kv % mp:
            raise ValueError(
                f"tensor-parallel serving shards the KV pools over the "
                f"'{self._mp_axis}' axis: num_key_value_heads {n_kv} must "
                f"divide by its size {mp}")
        if mp == 1:
            return
        if getattr(self.model, "_lora_slots", 0):
            raise NotImplementedError(
                "LoRA tenant slots under ServingEngine(mesh=) are not "
                "ported to paddle_tpu_torch")
        if not getattr(cfg, "tensor_parallel", False):
            warnings.warn(
                "ServingEngine(mesh=) over a model built without "
                "tensor_parallel=True: its weights and KV pools stay whole "
                "on every rank", RuntimeWarning)
        self.tp = mp
        self._tp_group = C.Group((self._mp_axis,), mesh)
        self.tp_rank = self._tp_group.rank
        self._shard_heads = bool(getattr(cfg, "tensor_parallel", False))

    @property
    def is_driver(self) -> bool:
        """Whether this rank schedules and samples (always, without a
        mesh)."""
        return self.tp_rank == 0

    def _refuse_on_follower(self, what: str):
        if not self.is_driver:
            raise RuntimeError(
                f"{what} on a follower rank ({self.tp_rank} of "
                f"'{self._mp_axis}'): the driver (rank 0) schedules; "
                "followers run follow()")

    def _set_state(self, state: dict):
        """Load a full state into the model: a tensor-parallel block
        takes its part of a full tensor (``_shard_state``)."""
        self.model.set_state_dict(self._shard_state(state))

    def _shard_state(self, state: dict) -> dict:
        """``state`` with each full tensor of a split parameter cut to
        this rank's block (a block-shaped one is kept)."""
        if not self._shard_heads:
            return state
        from paddle_tpu_torch.distributed.mesh import local_block
        params = dict(self.model.named_parameters())
        out = {}
        for k, v in state.items():
            p = params.get(k)
            spec = getattr(p, "_sharding_spec", None)
            if spec is not None and tuple(v.shape) != tuple(p.shape):
                v = local_block(v, spec, p._sharding_mesh).contiguous()
            out[k] = v
        return out

    def _keepalive_interval(self) -> float:
        """Seconds between an idle driver's keep-alive words:
        :data:`KEEPALIVE_S`, or a quarter of the ``mp`` group's collective
        timeout where that is shorter."""
        if self._tp_group is None:
            return KEEPALIVE_S
        from paddle_tpu_torch.distributed import collective as C
        pg = C._resolve(self._tp_group)[0]
        try:
            timeout = pg._get_backend(
                torch.device(self.device)).options._timeout.total_seconds()
        except (AttributeError, RuntimeError):
            return KEEPALIVE_S
        return min(KEEPALIVE_S, timeout / 4)

    def _keep_followers(self):
        """Driver, idle: a keep-alive word once :attr:`_keepalive_s`
        has passed since the last word."""
        if self._tp_group is not None and \
                time.monotonic() - self._last_word >= self._keepalive_s:
            self._send_step(_ALIVE)

    def _send_step(self, flag: int, cow=(), arrays=()):
        """Driver: the step's word to the followers (one broadcast over
        ``mp``; a no-op without followers)."""
        if self._tp_group is None:
            return
        self._last_word = time.monotonic()
        buf = np.zeros(self._step_words(), np.int32)
        buf[0], buf[1] = flag, len(cow)
        for i, (src, dst) in enumerate(cow):
            buf[2 + 2 * i], buf[3 + 2 * i] = src, dst
        off = 2 + 2 * self.max_batch
        for a in arrays:
            buf[off:off + a.size] = a.reshape(-1)
            off += a.size
        from paddle_tpu_torch.distributed import collective as C
        C.broadcast(torch.from_numpy(buf).to(self.device), src=0,
                    group=self._tp_group)

    def _step_shapes(self):
        """The shapes of the arrays a step buffer carries, in order:
        tokens, block tables, cu, ctx, sequence ids, positions, last
        indices and the two RPA work lists."""
        T, S = self.step_tokens, self.max_batch
        tiles = self._null_step_maps[0].shape
        return [(1, T), (S + 1, self.cache.max_blocks_per_seq), (S + 2,),
                (S + 1,), (T,), (T,), (S,), tiles, tiles]

    def _step_words(self) -> int:
        return 2 + 2 * self.max_batch + sum(
            int(np.prod(sh)) for sh in self._step_shapes())

    def follow(self):
        """A follower's loop: take each step the driver broadcasts and run
        it on this rank's shards, until the driver's ``shutdown``.
        Returns at once on the driver and without a mesh."""
        self._follow(until_idle=False)

    def _follow(self, until_idle: bool):
        """:meth:`follow`; with ``until_idle`` it also returns at the end
        of the driver's ``run_until_idle``."""
        if self._tp_group is None or self.is_driver:
            return
        from paddle_tpu_torch.distributed import collective as C
        buf = torch.zeros(self._step_words(), dtype=torch.int32,
                          device=self.device)
        while True:
            C.broadcast(buf, src=0, group=self._tp_group)
            head = buf[:2 + 2 * self.max_batch].tolist()
            flag = head[0]
            if flag == _STOP or (until_idle and flag == _IDLE):
                return
            if flag == _ZERO_WORK:
                self._zero_work_step()
                continue
            if flag != _STEP:
                continue
            for i in range(head[1]):
                self.cache.copy_block(head[2 + 2 * i], head[3 + 2 * i])
            arrays, off = [], 2 + 2 * self.max_batch
            for sh in self._step_shapes():
                n = int(np.prod(sh))
                arrays.append(buf[off:off + n].reshape(sh).clone())
                off += n
            tokens, bt, cu, ctx, sid, pos, last_idx, ssq, sbk = arrays
            launches0 = rpa_mod.thread_launches()
            try:
                self._forward(tokens, self._caches(
                    [bt, cu, ctx, sid, pos, ssq, sbk]), last_idx,
                    contextlib.nullcontext())
            finally:
                self.rpa_launches += rpa_mod.thread_launches() - launches0
                self._clear_model_side_effects()
            self.steps += 1

    def _caches(self, meta):
        """One :class:`RaggedLayerCache` per layer over the step's
        device metadata."""
        c = self.cache
        scales = zip(c.k_scales, c.v_scales) if self.kv_dtype else \
            [(None, None)] * len(c.k_pools)
        return [RaggedLayerCache(kp, vp, *meta, ks, vs)
                for kp, vp, (ks, vs) in zip(c.k_pools, c.v_pools, scales)]

    # -- metrics -----------------------------------------------------------
    def _init_metrics(self):
        m = serving_metrics()
        self._m_requests = m["requests"]
        self._m_queue = m["queue"]
        self._m_running = m["running"]
        self._m_waiting = m["waiting"]
        self._m_ttft = m["ttft"]
        self._m_queue_wait = m["queue_wait"]
        self._m_itl = m["itl"]
        self._m_latency = m["latency"]
        self._m_tokens = m["tokens"]
        self._m_preempt = m["preemptions"]
        self._m_steps = m["steps"]
        self._m_in_flight = m["in_flight"]
        self._m_kv_block_seconds = m["kv_block_seconds"]
        self._m_kv_headroom = m["kv_headroom"]
        self._m_kv_reclaimable = m["kv_reclaimable"]
        self._m_step_compiles = m["step_compiles"]
        self._m_prefix_lookups = m["prefix_lookups"]
        self._m_prefix_hits = m["prefix_hits"]
        self._m_prefix_evictions = m["prefix_evictions"]
        self._m_prefix_token_fraction = m["prefix_token_fraction"]
        self._m_adapter_requests = m["adapter_requests"]
        m["adapter_slots"].set(self.n_adapter_slots)
        m["adapter_slots_loaded"].set(len(self._adapters))
        # the port compiles no step executable
        self._m_step_compiles.set(0)
        self.cache.gauge_in_use()
        self._register_memory_owners()

    def _register_memory_owners(self):
        """Register this engine's long-lived device-memory owners with
        the memory ledger: the KV pools (with int8 KV's scale pools) and
        the parameters the step reads (with the quantized leaves).
        Weakref closures, so a discarded engine unregisters itself; a
        second engine in the process takes over the names (the ledger
        keys by owner, latest registration wins)."""
        import weakref
        wself = weakref.ref(self)

        def _kv_pools():
            eng = wself()
            if eng is None:
                return None
            return (eng.cache.k_pools, eng.cache.v_pools,
                    eng.cache.k_scales, eng.cache.v_scales)

        def _model_state():
            eng = wself()
            if eng is None:
                return None
            return (list(eng.model.parameters()),
                    [b for b in eng.model.buffers()],
                    list(eng._qleaves.values()))

        obs_memory.register("kv_cache", _kv_pools)
        obs_memory.register("serving_params", _model_state)

    def _update_gauges(self):
        # queue depth = never-started arrivals; waiting also counts
        # preempted sequences awaiting readmission
        fresh = sum(1 for r in self.scheduler.waiting
                    if r.preemptions == 0)
        self._m_queue.set(fresh)
        self._m_waiting.set(self.scheduler.num_waiting)
        self._m_running.set(self.scheduler.num_running)
        self.cache.gauge_in_use()
        # preemptions happen inside the scheduler; publish the delta
        # against a per-engine cursor (the registry counter is process-
        # global and may aggregate several engines)
        new = self.scheduler.num_preemptions - self._published_preemptions
        if new > 0:
            self._m_preempt.inc(new)
            self._published_preemptions += new
        # headroom splits free vs reclaimable: cached refcount-0 blocks
        # are evictable capacity, not pressure
        alloc = self.cache.allocator
        cap = max(alloc.capacity, 1)
        reclaim = alloc.num_reclaimable()
        self._m_kv_headroom.set((alloc.num_free() + reclaim) / cap)
        self._m_kv_reclaimable.set(reclaim / cap)
        pc = self.cache.prefix_cache
        if pc is not None:
            for key, counter in (("lookups", self._m_prefix_lookups),
                                 ("hits", self._m_prefix_hits),
                                 ("evictions", self._m_prefix_evictions)):
                new = getattr(pc, key) - self._published_prefix[key]
                if new > 0:
                    counter.inc(new)
                    self._published_prefix[key] += new
            seen = pc.hit_tokens + self._prompt_tokens_prefilled
            if seen:
                self._m_prefix_token_fraction.set(pc.hit_tokens / seen)
        self._m_in_flight.set(len(self._handles))
        # pool-occupancy cost: the allocator's exact integral, published
        # as a counter delta against a per-engine cursor
        bs_total = alloc.block_seconds_total()
        d = bs_total - self._published_block_seconds
        if d > 0:
            self._m_kv_block_seconds.inc(d)
            self._published_block_seconds = bs_total
        # per-iteration device-memory poll: the ledger-backed hbm_* gauges
        try:
            obs_memory.publish()
        except Exception:  # noqa: BLE001
            pass  # the memory instrument must never fail a step

    @contextlib.contextmanager
    def _caller_lock(self):
        """The engine lock, taken by a caller thread ahead of the run
        loop's next step."""
        with self._callers_lock:
            self._callers += 1
        try:
            self._lock.acquire()
        finally:
            with self._callers_lock:
                self._callers -= 1
        try:
            yield
        finally:
            self._lock.release()

    # -- weights -----------------------------------------------------------
    def _quantize_model(self) -> dict:
        """Quantize the model's projection weights in place of their
        parameters: each selected ``Linear`` loses its ``weight``
        parameter (its storage is freed once nothing else holds it),
        keeps the :class:`QuantizedLeaf` as ``_wq`` and computes through
        :func:`_quantized_linear_forward`."""
        params = dict(self.model.named_parameters())
        qstate = quantize_state(
            params, self.quantize, calibration=self._calibration,
            quantize=self._quantize_block if self._shard_heads else None)
        leaves = {k: v for k, v in qstate.items()
                  if isinstance(v, QuantizedLeaf)}
        del params, qstate
        #: the partition specs of the quantized projections' weights
        self._qspecs = {
            name: getattr(self.model.get_submodule(
                name.rsplit(".", 1)[0]).weight, "_sharding_spec", None)
            for name in leaves}
        for name, leaf in leaves.items():
            layer = self.model.get_submodule(name.rsplit(".", 1)[0])
            del layer.weight
            layer._wq = leaf
            layer.forward = types.MethodType(_quantized_linear_forward,
                                             layer)
        return leaves

    def _quantize_block(self, name, p):
        """One projection of a tensor-parallel model quantized as the
        reference does: the full weight (gathered over ``mp``) is
        quantized, and :func:`shard_quantized` keeps this rank's block
        of the values and of the scales."""
        spec = getattr(p, "_sharding_spec", None)
        if spec is None:
            return quantize_leaf(p, self.quantize)
        from paddle_tpu_torch.distributed.collective import gather_block
        full = gather_block(p.detach().contiguous(), spec, p._sharding_mesh)
        return shard_quantized(quantize_leaf(full, self.quantize),
                               p._sharding_mesh, spec)

    def load_weights(self, path: str, step: Optional[int] = None):
        """Swap in weights from a checkpoint: a training
        ``CheckpointManager`` directory (latest or ``step``), one
        ``step_N`` directory, or a flat ``.pdparams`` file.

        Refuses while requests are in flight: their KV was computed under
        the old weights. The dtype guard (reference :416-500): every
        incoming leaf must have the dtype the engine serves it in (a
        quantized leaf's logical dtype). A floating mismatch is cast
        loudly (``RuntimeWarning`` naming the leaf); anything else is
        refused with a ``ValueError`` naming the leaf, before any weight
        changes. Quantized leaves are quantized again from the fresh
        weights (the same set as at construction). Under a mesh every
        rank calls it, and each keeps its blocks of the full weights."""
        with self._caller_lock():
            active = self.scheduler.num_running + self.scheduler.num_waiting
            if active:
                raise RuntimeError(
                    f"cannot swap weights with {active} request(s) in "
                    f"flight (their KV cache predates the new weights); "
                    f"drain() the engine first")
            raw = _read_checkpoint_state(path, step)
            own = dict(self.model.state_dict())
            checked = {}
            for k, v in raw.items():
                exp = self._qleaves.get(k, own.get(k))
                if exp is not None and v.dtype != exp.dtype:
                    if v.is_floating_point() and exp.dtype.is_floating_point:
                        warnings.warn(
                            f"load_weights: casting leaf '{k}' "
                            f"{dtype_name(v.dtype)} -> "
                            f"{dtype_name(exp.dtype)} to match the "
                            f"engine", RuntimeWarning)
                        v = v.to(exp.dtype)
                    else:
                        raise ValueError(
                            f"load_weights: leaf '{k}' is "
                            f"{dtype_name(v.dtype)} but the engine serves "
                            f"it as {dtype_name(exp.dtype)} — refusing the "
                            f"checkpoint")
                checked[k] = v
            plain = {k: v for k, v in checked.items()
                     if k not in self._qleaves}
            self._set_state(plain)
            for k, v in checked.items():
                if k in self._qleaves:
                    leaf = quantize_leaf(v.to(self.device), self.quantize)
                    spec = self._qspecs.get(k)
                    if spec is not None and \
                            tuple(v.shape) != tuple(self._qleaves[k].shape):
                        leaf = shard_quantized(leaf, self.mesh, spec)
                    self._qleaves[k] = leaf
                    self.model.get_submodule(k.rsplit(".", 1)[0])._wq = leaf

    # -- multi-tenant LoRA slots -------------------------------------------
    def _busy_slot(self, slot: int):
        busy = [r.req_id for r in list(self.scheduler.slotted())
                + list(self.scheduler.waiting) if r.adapter_id == slot]
        if busy:
            raise RuntimeError(
                f"adapter slot {slot} has {len(busy)} request(s) in "
                f"flight; drain or abort them first")

    @torch.no_grad()
    def load_adapter(self, slot: int, state: dict,
                     name: Optional[str] = None):
        """Install a trained adapter (``tuning.load_adapter_state``'s
        ``{param name: tensor}``, 2-D leaves) into tenant ``slot``
        (1..n_slots), in place in the stacks. Refuses while a request of
        that slot is in flight, and names an unknown leaf or a wrong
        shape before writing anything."""
        if not self.n_adapter_slots:
            raise RuntimeError(
                "engine has no adapter slots — build the model with "
                "tuning.apply_lora(model, cfg, n_slots=N)")
        if not 1 <= int(slot) <= self.n_adapter_slots:
            raise ValueError(
                f"adapter slot {slot} out of range 1.."
                f"{self.n_adapter_slots}")
        slot = int(slot)
        with self._caller_lock():
            self._busy_slot(slot)
            unknown = [k for k in state if k not in self._lora_stacks]
            if unknown:
                raise KeyError(
                    f"adapter state names unknown to this model: "
                    f"{sorted(unknown)[:3]}")
            rows = {}
            for k, v in state.items():
                tgt = self._lora_stacks[k]
                v = v if isinstance(v, torch.Tensor) else \
                    torch.as_tensor(np.asarray(v))
                if tuple(v.shape) != tuple(tgt.shape[1:]):
                    raise ValueError(
                        f"adapter leaf '{k}' has shape {tuple(v.shape)}, "
                        f"slot expects {tuple(tgt.shape[1:])}")
                rows[k] = v
            for k, v in rows.items():
                tgt = self._lora_stacks[k]
                tgt[slot].copy_(v.to(tgt.device, tgt.dtype))
            self._adapters[slot] = name or f"adapter-{slot}"
            # new slot contents -> new prefix-cache namespace: blocks
            # registered under the previous occupant can never match
            self._adapter_gen[slot] = self._adapter_gen.get(slot, 0) + 1
        m = serving_metrics()
        m["adapter_loads"].inc()
        m["adapter_slots_loaded"].set(len(self._adapters))

    @torch.no_grad()
    def unload_adapter(self, slot: int):
        """Zero tenant ``slot``'s rows (delta back to exactly 0) and free
        the slot."""
        slot = int(slot)
        with self._caller_lock():
            self._busy_slot(slot)
            for p in self._lora_stacks.values():
                p[slot].zero_()
            self._adapters.pop(slot, None)
            self._adapter_gen[slot] = self._adapter_gen.get(slot, 0) + 1
        serving_metrics()["adapter_slots_loaded"].set(len(self._adapters))

    # -- submission --------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               trace_id: Optional[str] = None,
               adapter_id: int = 0) -> RequestHandle:
        """Enqueue a request; returns immediately with a handle. Tokens
        stream through ``on_token(request, token_id)`` as they decode.
        ``trace_id`` carries a client-supplied W3C trace id (the server's
        ``traceparent`` parse); absent, the engine mints one — either
        way every span and response of the request carries it.
        ``adapter_id`` picks the tenant's LoRA slot (0 = base model)."""
        self._refuse_on_follower("submit")
        prompt_tokens = list(prompt_tokens)
        if not prompt_tokens:
            raise ValueError("empty prompt")
        adapter_id = int(adapter_id)
        if adapter_id:
            if not 1 <= adapter_id <= self.n_adapter_slots:
                raise ValueError(
                    f"adapter_id {adapter_id} out of range (engine has "
                    f"{self.n_adapter_slots} slots)")
            if adapter_id not in self._adapters:
                raise ValueError(
                    f"adapter slot {adapter_id} is empty — load_adapter "
                    f"first")
        # an id outside the vocabulary would reach the embedding lookup,
        # whose device-side assert on the card ends every request
        vocab = self.model.cfg.vocab_size
        bad = [t for t in prompt_tokens if not 0 <= t < vocab]
        if bad:
            raise ValueError(f"prompt ids must lie in [0, {vocab}), got "
                             f"{bad[:4]}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt_tokens) + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds the engine's "
                f"max sequence length {self.max_model_len}")
        need = self.cache.blocks_for(total)
        if need > min(self.cache.allocator.capacity,
                      self.cache.max_blocks_per_seq):
            raise ValueError(
                f"request needs {need} KV blocks but the engine has "
                f"{self.cache.allocator.capacity} (table width "
                f"{self.cache.max_blocks_per_seq}) — raise max_blocks or "
                "shorten the request")
        # non-base tenants hash their KV blocks under a seed of (slot,
        # load generation): identical prompts under different adapters
        # give different KV, so they never share prefix-cache entries
        seed = (chain_hash(None,
                           [adapter_id, self._adapter_gen[adapter_id]])
                if adapter_id else None)
        req = Request(prompt_tokens=prompt_tokens,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), eos_token_id=eos_token_id,
                      on_token=on_token,
                      trace_id=trace_id or obs_requests.new_trace_id(),
                      adapter_id=adapter_id,
                      cache_seed=seed, committed_hash=seed)
        if adapter_id:
            self._m_adapter_requests.inc(adapter=self._adapters[adapter_id])
        handle = RequestHandle(req)
        with self._caller_lock():
            if self._shutdown:
                raise RuntimeError("engine is shut down")
            self._handles[req.req_id] = handle
            self.scheduler.add(req)
            if self._ledger is not None:
                self._ledger.admit(req)
            self._m_requests.inc(outcome="accepted")
            self._update_gauges()
            self._cv.notify_all()
        return handle

    # -- one engine iteration ----------------------------------------------
    def step(self) -> bool:
        """Plan + run one unified token-packed step (all live decode
        slots + the packed prefill chunks). Returns whether any work
        happened."""
        with self._lock:
            plan = self.scheduler.schedule()
            if self._ledger is not None:
                # step-boundary occupancy sample: bill each slotted
                # request's previous holding level for the elapsed
                # interval (preempt/finish tick before freeing)
                self._ledger.note_occupancy_many(self.scheduler.slotted())
            # never act on a sequence that lost its slot/blocks during
            # planning (a later allocation in the same plan may have
            # preempted it)
            decode = [s for s in plan.decode
                      if s.slot is not None
                      and s.state is RequestState.RUNNING]
            prefills = [(s, n) for (s, n) in plan.prefills
                        if s.slot is not None
                        and s.state is RequestState.PREFILL]
            if decode or prefills:
                self._run_unified(decode, prefills)
                # /healthz liveness stamp: a wedged-but-listening server
                # shows a growing last_step_age_seconds
                obs_fleet.note_step()
            self._update_gauges()
            return bool(decode or prefills)

    def _run_unified(self, decode: List[Request],
                     prefills: List[tuple]):
        """Pack the planned work into the flat token budget, build the
        step's ragged metadata (token->sequence map, per-token positions,
        the RPA kernel's work lists) host-side, run the model once, and
        harvest per-sequence results."""
        for seq, _ in prefills:
            if seq.prefill_pos == 0 and seq.slot_time is not None \
                    and not getattr(seq, "_queue_wait_observed", False):
                # queue-wait ends at FIRST admission, observed once per
                # request (slot_time never resets, so a recompute after
                # preemption still reports the original wait)
                seq._queue_wait_observed = True
                self._m_queue_wait.observe(
                    seq.slot_time - seq.arrival_time)

        # copy-on-write divergence: a fully-cached aligned prompt's last
        # matched block is copied into the sequence's private block
        # BEFORE the step, so the final-token write lands in owned
        # storage and the shared block stays immutable
        cow = []
        for seq, _ in prefills:
            if seq.cow_src is not None and seq.cow_index is not None \
                    and seq.cow_index < len(seq.block_ids):
                cow.append((seq.cow_src, seq.block_ids[seq.cow_index]))
                self.cache.copy_block(*cow[-1])
                self.scheduler._release_cow(seq)

        entries = [(seq, 1, False) for seq in decode] + \
                  [(seq, n, True) for seq, n in prefills]
        T, S = self.step_tokens, self.max_batch
        if len(entries) > S or sum(n for _, n, _ in entries) > T:
            raise RuntimeError("scheduler over-packed the step")
        tokens = np.zeros((1, T), np.int32)
        bt = np.zeros((S + 1, self.cache.max_blocks_per_seq), np.int32)
        cu = np.zeros((S + 2,), np.int32)
        ctx = np.zeros((S + 1,), np.int32)
        sid = np.full((T,), S, np.int32)   # sentinel = padding
        pos = np.zeros((T,), np.int32)
        last_idx = np.zeros((S,), np.int32)
        aid = np.zeros((T,), np.int32)     # padding -> slot 0 (base)
        kv_lens = []
        off = 0
        for i, (seq, n, is_prefill) in enumerate(entries):
            if is_prefill:
                tokens[0, off:off + n] = seq.pending_tokens[
                    seq.prefill_pos:seq.prefill_pos + n]
                c = seq.prefill_pos
            else:
                tokens[0, off] = seq.last_token()
                c = seq.num_cached
            bt[i] = self.cache.pad_block_table(seq.block_ids)
            ctx[i] = c
            sid[off:off + n] = i
            pos[off:off + n] = c + np.arange(n)
            aid[off:off + n] = seq.adapter_id
            cu[i + 1] = off + n
            last_idx[i] = off + n - 1
            kv_lens.append(c + n)
            off += n
        cu[len(entries) + 1:] = off
        if self.attn_impl == "rpa":
            ssq, sbk = build_step_maps(
                cu[:len(entries) + 1], kv_lens, total_tokens=T,
                tile_q=self._tile_q, block_size=self.cache.block_size,
                max_steps=self._max_steps, max_seqs=S)
        else:
            ssq, sbk = self._null_step_maps
        self._send_step(_STEP, cow, (tokens, bt, cu, ctx, sid, pos,
                                     last_idx, ssq, sbk))

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        caches = self._caches([dev(a) for a in (bt, cu, ctx, sid, pos, ssq,
                                                sbk)])
        # per-token LoRA dispatch: this step's token -> slot ids, on the
        # model's device, for the adapter hooks
        adapters = (lora.adapter_ids(dev(aid)) if self.n_adapter_slots
                    else contextlib.nullcontext())
        t0 = time.perf_counter_ns()
        launches0 = rpa_mod.thread_launches()
        try:
            logits = self._forward(dev(tokens), caches, dev(last_idx),
                                   adapters)
            arr = logits.cpu().numpy()
        except Exception as e:
            # out of device memory: one postmortem (the ledger's owners
            # and the step's memory report) before re-raising into the
            # run loop's fail-all-handles path
            obs_memory.handle_oom(e, source="serving_step",
                                  report_fn=self.memory_report)
            raise
        finally:
            self.rpa_launches += rpa_mod.thread_launches() - launches0
            self._clear_model_side_effects()
        t1 = time.perf_counter_ns()
        self.steps += 1
        self._m_steps.inc(kind="unified")

        for i, (seq, n, is_prefill) in enumerate(entries):
            if is_prefill:
                if trace.active() is not None:
                    # the port compiles nothing: compiles is always 0
                    trace.span("serving", "prefill_chunk", t0, t1,
                               args={"req": seq.req_id,
                                     "trace": seq.trace_id, "tokens": n,
                                     "pos": seq.prefill_pos,
                                     "compiles": 0,
                                     "preemptions": seq.preemptions})
                if self._ledger is not None:
                    self._ledger.note_prefill(seq, n, 0)
                seq.prefill_pos += n
                seq.num_cached += n
                seq.prefilled_tokens += n
                self._prompt_tokens_prefilled += n
                self._m_tokens.inc(n, kind="prompt")
                self._commit_cached_blocks(seq)
                if seq.prefill_pos == len(seq.pending_tokens):
                    # prompt fully cached: sample the continuation (the
                    # request's first token — or, after preemption, the
                    # next)
                    tok = self._sample(arr[i], seq)
                    seq.state = RequestState.RUNNING
                    self._emit_token(seq, tok)
            else:
                seq.num_cached += 1
                self._commit_cached_blocks(seq)
                tok = self._sample(arr[i], seq)
                self._emit_token(seq, tok)

    def _forward(self, tokens, caches, last_idx, adapters):
        """The model over one packed step: the logits ``[max_batch, V]``
        (f32) at each sequence's LAST packed token (rows of empty
        metadata slots gather token 0 and are discarded)."""
        with torch.no_grad(), adapters, \
                pa.mesh_override(self.mesh if self._shard_heads else None):
            h, _ = self._backbone(tokens, caches=caches,
                                  attn_impl=self.attn_impl)
            hsel = h[0][last_idx.long()][:, None, :]
            return self._project(hsel)[:, 0].float()

    def memory_report(self):
        """The measured memory accounting of the unified step
        (``observability.memory.MemoryReport``; the serving twin of
        ``TrainStep.memory_report``). ``argument_bytes`` are the
        registered owners' bytes (parameters and KV pools),
        ``alias_bytes`` the KV pools the step updates in place,
        ``output_bytes`` the step's f32 logits, and ``temp_bytes`` the
        step's allocation peak above what was allocated before it.

        On the card that peak is measured on a zero-work step through
        the engine's own read path: every token is padding, so the KV
        writes land in the null block and no request, pool row or
        generator changes — but the allocator's peak counter is reset
        (read a window's ``max_memory_allocated`` before calling this),
        and the RPA kernel launches once per layer (counted in the
        process-wide count, not in this engine's). On the CPU,
        ``temp_bytes`` is 0: nothing reports it."""
        pools = self.cache.pool_bytes()
        params = obs_memory.tree_bytes((list(self.model.parameters()),
                                        list(self.model.buffers()),
                                        list(self._qleaves.values())))
        temp = 0
        if self.device.type == "cuda":
            with self._caller_lock():
                torch.cuda.synchronize(self.device)
                before = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
                self._zero_work_step()
                torch.cuda.synchronize(self.device)
                temp = max(torch.cuda.max_memory_allocated(self.device)
                           - before, 0)
        return obs_memory.MemoryReport(
            argument_bytes=params + pools,
            output_bytes=4 * self.max_batch * self.model.cfg.vocab_size,
            temp_bytes=temp, alias_bytes=pools, source="serving_step")

    def _zero_work_step(self):
        """One step of padding only: every token's sequence id is the
        sentinel, so the KV writes land in the null block and nothing is
        sampled. The driver of a mesh has its followers take it too."""
        if self.is_driver:
            self._send_step(_ZERO_WORK)
        T, S = self.step_tokens, self.max_batch
        # the work lists of a step with no sequence: every step dead
        ssq, sbk = self._null_step_maps

        def dev(a):
            return torch.from_numpy(a).to(self.device)
        meta = [dev(a) for a in (
            np.zeros((S + 1, self.cache.max_blocks_per_seq), np.int32),
            np.zeros((S + 2,), np.int32),
            np.zeros((S + 1,), np.int32), np.full((T,), S, np.int32),
            np.zeros((T,), np.int32), ssq, sbk)]
        caches = self._caches(meta)
        adapters = (lora.adapter_ids(dev(np.zeros((T,), np.int32)))
                    if self.n_adapter_slots else contextlib.nullcontext())
        try:
            self._forward(dev(np.zeros((1, T), np.int32)), caches,
                          dev(np.zeros((S,), np.int32)), adapters)
        finally:
            self._clear_model_side_effects()

    def _clear_model_side_effects(self):
        """Drop the MoE gates' ``l_aux`` a step left behind (reference
        :1263-1268), so ``aux_loss()`` is ``None`` after serving."""
        clear = getattr(self.model, "clear_decode_side_effects", None)
        if clear is not None:
            clear()

    def _commit_cached_blocks(self, seq: Request):
        """Register every newly-completed full block in the prefix
        index, right after a step advanced ``num_cached`` and before the
        sampled token can finish the request. Committed blocks are never
        written again, so the index entry is immutable."""
        pc = self.cache.prefix_cache
        if pc is None:
            return
        bs = self.cache.block_size
        full = seq.num_cached // bs
        if full <= seq.committed_blocks:
            return
        stream = seq.prompt_tokens + seq.generated
        for i in range(seq.committed_blocks, full):
            d = chain_hash(seq.committed_hash,
                           stream[i * bs:(i + 1) * bs])
            pc.register(d, seq.block_ids[i])
            seq.committed_hash = d
        seq.committed_blocks = full

    def _sample(self, logits_row: np.ndarray, seq: Request) -> int:
        if seq.temperature == 0:
            return int(np.argmax(logits_row))
        tok = sample_token(torch.from_numpy(logits_row)[None, :],
                           seq.temperature, seq.top_k, seq.top_p,
                           generator=self._generator)
        return int(tok[0])

    def _emit_token(self, seq: Request, tok: int):
        now = time.perf_counter()
        itl = None
        if seq.first_token_time is None:
            seq.first_token_time = now
            self._m_ttft.observe(now - seq.arrival_time)
        elif seq.last_token_time is not None:
            itl = now - seq.last_token_time
            self._m_itl.observe(itl)
        if self._ledger is not None:
            self._ledger.note_token(seq, itl)
        seq.last_token_time = now
        seq.generated.append(int(tok))
        self._m_tokens.inc(kind="generated")
        if seq.on_token is not None:
            try:
                seq.on_token(seq, int(tok))
            except Exception:  # noqa: BLE001
                pass  # a broken stream consumer must not kill the batch
        if seq.eos_token_id is not None and tok == seq.eos_token_id:
            self._finish(seq, "eos")
        elif len(seq.generated) >= seq.max_new_tokens:
            self._finish(seq, "length")

    def _finish(self, seq: Request, reason: str,
                state: RequestState = RequestState.FINISHED):
        self.scheduler.finish(seq, state, reason)
        self._m_requests.inc(
            outcome="completed" if state is RequestState.FINISHED
            else "failed")
        if seq.latency() is not None:
            self._m_latency.observe(seq.latency())
        rec = (self._ledger.complete(seq)
               if self._ledger is not None else None)
        self._emit_request_chain(seq, reason, rec)
        handle = self._handles.pop(seq.req_id, None)
        if handle is not None:
            handle._done.set()
        with self._cv:
            self._cv.notify_all()

    def _emit_request_chain(self, seq: Request, reason: str, rec=None):
        """The per-request span chain: queue_wait -> [prefill_chunk
        spans emitted live] -> decode -> request_done. The retrospective
        spans use the request's recorded timestamps, so a slow TTFT
        decomposes into admission wait vs prefill vs preemption
        recompute in the merged trace. Every span carries the W3C trace
        id, so ``trace merge --requests`` can stitch the chain across
        processes; ``rec`` (the completed ledger record, when armed)
        enriches ``request_done`` with the cost summary."""
        if trace.active() is None:
            return

        def ns(t):
            return int(t * 1e9)  # perf_counter -> perf_counter_ns clock

        rid, tid = seq.req_id, seq.trace_id
        admitted = seq.slot_time
        if admitted is not None:
            trace.span("serving", "queue_wait", ns(seq.arrival_time),
                       ns(admitted), args={"req": rid, "trace": tid})
        if seq.first_token_time is not None:
            end = seq.finish_time or seq.last_token_time \
                or seq.first_token_time
            trace.span("serving", "decode", ns(seq.first_token_time),
                       ns(end),
                       args={"req": rid, "trace": tid,
                             "tokens": len(seq.generated)})
        args = {"req": rid, "trace": tid, "finish_reason": reason,
                "prompt_len": len(seq.prompt_tokens),
                "generated": len(seq.generated),
                "preemptions": seq.preemptions}
        if seq.ttft() is not None:
            args["ttft_s"] = round(seq.ttft(), 6)
        if seq.latency() is not None:
            args["latency_s"] = round(seq.latency(), 6)
        if rec is not None:
            args["prefilled_tokens"] = rec.prefilled_tokens
            args["cached_tokens"] = rec.cached_tokens
            args["decode_tokens"] = rec.decode_tokens
            args["kv_block_seconds"] = round(rec.kv_block_seconds, 6)
            p50, p99 = (rec.itl_percentile(0.5), rec.itl_percentile(0.99))
            if p50 is not None:
                args["itl_p50_ms"] = round(p50 * 1e3, 3)
                args["itl_p99_ms"] = round(p99 * 1e3, 3)
        trace.mark("serving", "request_done",
                   ts_ns=ns(seq.finish_time or time.perf_counter()),
                   args=args)

    def abort(self, req_id: int, reason: str = "aborted") -> bool:
        """Cancel a queued or in-flight request, releasing its batch slot
        and KV blocks (a waiting request simply leaves the queue). The
        graceful-degradation seam: the HTTP server aborts requests that
        blew their deadline, so abandoned work stops holding capacity.
        Under the engine lock, so no step is in flight: a request
        aborted mid-prefill registered in the prefix index only blocks
        whose every token a finished step wrote. Returns False when the
        request is unknown or already finished."""
        self._refuse_on_follower("abort")
        with self._caller_lock():
            handle = self._handles.get(req_id)
            if handle is None:
                return False
            seq = handle._req
            if seq.done:
                return False
            if seq in self.scheduler.waiting:
                self.scheduler.waiting.remove(seq)
            seq.error = reason
            # _finish records the request outcome (no extra count here)
            self._finish(seq, "aborted", RequestState.FAILED)
            self._update_gauges()
            return True

    # -- run loop ----------------------------------------------------------
    def has_pending(self) -> bool:
        with self._caller_lock():
            return self.scheduler.has_work()

    def run_until_idle(self):
        """Synchronous loop (tests / batch jobs): step until every
        submitted request has finished. Under a mesh every rank calls
        it: the driver steps, then tells the followers it is idle; a
        follower runs the driver's steps until then."""
        if not self.is_driver:
            self._follow(until_idle=True)
            return
        while True:
            did = self.step()
            if not did and not self.has_pending():
                self._send_step(_IDLE)
                return
            if not did:
                raise RuntimeError(
                    "engine stalled with pending work — KV pool "
                    "undersized for the admitted requests")

    def start(self):
        """Background step loop (the server front-end's mode); on a
        follower, :meth:`follow` in the background."""
        with self._lock:
            if self._thread is not None:
                return
            self._shutdown = False
            self._thread = threading.Thread(
                target=self._run_loop if self.is_driver else self.follow,
                name="pt-torch-serving-engine", daemon=True)
            self._thread.start()

    def _run_loop(self):
        while True:
            while self._callers:
                time.sleep(1e-4)  # let a waiting caller take the lock
            with self._cv:
                if self._shutdown and not self.scheduler.has_work():
                    return
                if not self.scheduler.has_work():
                    self._cv.wait(timeout=0.1)
                    self._keep_followers()
                    continue
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — loop must not die silently
                # a failed step would strand every pending handle: fail
                # them all loudly, stop the loop, and re-raise
                with self._cv:
                    for seq in (list(self.scheduler.slotted())
                                + list(self.scheduler.waiting)):
                        seq.error = f"engine step failed: {e!r}"
                        self._finish(seq, "error", RequestState.FAILED)
                    self.scheduler.waiting.clear()
                    self._shutdown = True
                    self._cv.notify_all()
                raise

    def drain(self, timeout: Optional[float] = None):
        """Block until every accepted request has finished."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while self.has_pending():
            if self._thread is None:
                self.run_until_idle()
                break
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError("engine drain timed out")
            with self._caller_lock():
                if self.scheduler.has_work():
                    self._cv.wait(timeout=0.1)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Graceful stop: optionally finish in-flight work, then stop the
        loop thread. New submissions are rejected once shut down. The
        driver of a mesh then stops its followers; a follower's
        ``shutdown`` follows the driver's steps until that stop."""
        if not self.is_driver:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            elif not self._shutdown:
                self.follow()
            self._shutdown = True
            return
        if drain:
            self.drain(timeout)
        with self._caller_lock():
            self._shutdown = True
            if not drain:
                for seq in (list(self.scheduler.slotted())
                            + list(self.scheduler.waiting)):
                    seq.error = "engine shut down"
                    self._finish(seq, "aborted", RequestState.FAILED)
                self.scheduler.waiting.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._tp_group is not None and not self._stopped_followers:
            self._stopped_followers = True
            self._send_step(_STOP)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Lock-free snapshot for ``/healthz``."""
        alloc = self.cache.allocator
        cap = max(alloc.capacity, 1)
        free = alloc.num_free()
        reclaim = alloc.num_reclaimable()
        pc = self.cache.prefix_cache
        out = {
            "running": self.scheduler.num_running,
            "waiting": self.scheduler.num_waiting,
            "kv_blocks_in_use": alloc.blocks_in_use(),
            "kv_blocks_free": free,
            "kv_blocks_reclaimable": reclaim,
            "preemptions": self.scheduler.num_preemptions,
            "requests_in_flight": len(self._handles),
            "kv_block_seconds_total": round(
                alloc.block_seconds_total(), 4),
            "steps": self.steps,
            # compiled executables of the unified step (the reference's
            # count is 1): the port runs the step eagerly and compiles none
            "step_compiles": 0,
            # process-wide count of RPA kernel launches (CPU tensors run
            # the plain version and count none)
            "rpa_launches": ragged_paged_attention.launches,
            # this engine's own launches (two engines may share a card)
            "rpa_launches_engine": self.rpa_launches,
            "attn_impl": self.attn_impl,
            "device": str(self.device),
            "step_tokens": self.step_tokens,
            "kv_headroom": round((free + reclaim) / cap, 4),
            "kv_free_fraction": round(free / cap, 4),
            "kv_reclaimable_fraction": round(reclaim / cap, 4),
            "max_batch": self.max_batch,
            "max_model_len": self.max_model_len,
            # ranks the model-parallel axis splits the heads over
            "tensor_parallel": self.tp,
            "block_size": self.cache.block_size,
            # what the weights and the KV actually serve in, and which
            # tenant sits in which slot
            "kv_dtype": self.kv_dtype or dtype_name(self.cache.dtype),
            "quantize": self.quantize,
            "weight_dtype": self._weight_dtype,
            "adapter_slots": self.n_adapter_slots,
            "adapters": {
                "slots": self.n_adapter_slots,
                "loaded": len(self._adapters),
                "occupancy": {str(k): v for k, v in
                              sorted(self._adapters.items())}},
            "prefix_cache": None,
        }
        if pc is not None:
            s = pc.stats()
            s["hit_rate"] = round(s["hits"] / max(s["lookups"], 1), 4)
            # the fleet router's affinity signal: truncated digests of
            # every registered block
            s["sketch"] = pc.sketch()
            out["prefix_cache"] = s
        return out

    # -- cross-replica KV handoff (fleet disaggregation) -------------------
    def _refuse_handoff(self):
        if self._tp_group is not None:
            raise NotImplementedError(
                "the KV handoff of ServingEngine(mesh=) is not ported to "
                "paddle_tpu_torch: each rank holds only its heads")

    def export_kv_blocks(self, digests: Sequence[bytes]) -> List[tuple]:
        """The KV contents of the registered blocks behind ``digests``
        (the chain hashes of a prefilled prompt's full blocks, in chain
        order), as ``[(digest, k, v), ...]`` records for
        :meth:`import_kv_blocks` on a peer replica; ``k`` and ``v`` are
        copies on this engine's device in the compute dtype. Every block
        is claimed through ``reuse_cached`` while the rows are copied —
        an eviction cannot hand it to a new sequence mid-copy, and the
        copy is ordered on the stream before any later write — and
        released after. Stops at the first miss (a chained digest after
        a miss could never be admitted anyway)."""
        self._refuse_handoff()
        pc = self.cache.prefix_cache
        if pc is None:
            return []
        alloc = self.cache.allocator
        claimed: List[tuple] = []
        for d in digests:
            b = pc.lookup(d)
            if b is None or not alloc.reuse_cached(b):
                break
            claimed.append((d, b))
        if not claimed:
            return []
        try:
            k, v = self.cache.export_blocks([b for _, b in claimed])
        finally:
            alloc.free([b for _, b in claimed])
        return [(d, k[i], v[i]) for i, (d, _) in enumerate(claimed)]

    def import_kv_blocks(self, records: Sequence[tuple]) -> int:
        """Adopt KV blocks exported by a peer replica: allocate a
        physical block per new record, write the rows, register the
        chain digests in the prefix index, and park the blocks
        reclaimable — the next admission sharing the prefix claims them
        like any local cache hit (tail-only prefill). Already-known
        digests are skipped (first writer wins, as ``register``); a full
        pool stops the import early. Returns the number of blocks
        resident afterwards."""
        self._refuse_handoff()
        pc = self.cache.prefix_cache
        if pc is None:
            return 0
        alloc = self.cache.allocator
        n = 0
        with self._caller_lock():
            new = []
            for rec in records:
                if pc.lookup(rec[0]) is not None:
                    n += 1  # prefix already resident here
                    continue
                try:
                    (b,) = alloc.allocate(1)
                except MemoryError:
                    break
                new.append((b, rec))
                n += 1
            if new:
                self.cache.import_blocks(
                    [b for b, _ in new],
                    torch.stack([torch.as_tensor(r[1]) for _, r in new]),
                    torch.stack([torch.as_tensor(r[2]) for _, r in new]))
                for b, (d, _, _) in new:
                    pc.register(d, b)
                alloc.free([b for b, _ in new])  # parks reclaimable
        return n
