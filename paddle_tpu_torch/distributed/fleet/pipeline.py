"""Pipeline parallelism — port of ``paddle_tpu/distributed/fleet/pipeline.py``:
``PipelineLayer`` and the chunk-granular 1F1B engine with the virtual
pipeline interleave (``PipelineParallel``).

Each process is one rank. Stage ``s`` is the rank at coordinate ``s`` of
the mesh's ``pp`` axis, and chunk ``c`` goes to stage ``c % S`` (the
round-robin placement of the reference, :218-291). Differences from the
reference, where one process drives every stage's device:

* **each rank builds only its own chunks** — which is what
  :class:`LayerDesc` is for (reference :78-80); a ready ``Layer`` given
  for another stage is dropped. Without a ``pp`` axis (or with one of
  size 1) every chunk is this process's: a one-process pipeline, the
  reference's run on one device. The local chunks go to the card unless
  the caller asks for the CPU (``device=``, or ``set_device("cpu")``).
* **:class:`SharedLayerDesc`** — in the reference the stages share one
  object (:91-110). Here each stage holding the key builds it; the first
  holder broadcasts its weights at build time, and
  :meth:`PipelineLayer.allreduce_shared_weight_gradients` (Paddle's own
  name) sums their gradients over the holders before the optimizer
  steps, which ``train_batch`` does.
* **activations between stages** go by ``send``/``recv`` to the
  neighbouring stage's rank after a shape and dtype handshake (Paddle's
  p2p meta): every rank walks the one global order of units; the
  producing rank sends (asynchronously) at its unit, and the consuming
  rank takes the message at the same place of the order, so every pair
  of ranks sends and receives in one order and the blocking receives
  cannot deadlock. Gradients flow back the same way.
* **the loss** is computed on the last stage and broadcast over ``pp``.
* **another mesh axis** of size above 1 is refused by
  ``PipelineParallel`` (``NotImplementedError``): the reference runs
  each stage on its first device only (:286-291).

The schedules (:meth:`PipelineParallel._greedy_schedule` and
:meth:`PipelineParallel._interleave_schedule`) are the reference's pure
Python, so ``last_schedule_stats`` equals its dict key for key; the peak
of in-flight activation sets is counted over the global order as the
reference counts it. Spans ``pp_fwd_m{m}_c{c}``, ``pp_bwd_m{m}_c{c}`` and
``pp_loss_m{m}`` go through ``paddle_tpu_torch.profiler`` (reference
:590-614). ``recompute_interval = k`` runs every ``k`` consecutive layers
of a chunk under ``fleet.utils.recompute`` (reference :113-128).
"""
from __future__ import annotations

import contextlib
import pickle
import re
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.tensor import Tensor, unwrap, wrap
from paddle_tpu_torch.nn.layer_base import Layer

from .. import collective as C
from ..mesh import axis_index, axis_size, get_mesh, mesh_shape

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


def _tree_map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, t) for t in x)
    return fn(x)


def _tree_leaves(x) -> List:
    if isinstance(x, (tuple, list)):
        out = []
        for t in x:
            out.extend(_tree_leaves(t))
        return out
    return [x]


def _tree_def(x):
    """The nesting of ``x`` with its leaves left out (picklable)."""
    if isinstance(x, (tuple, list)):
        return (type(x) is list, tuple(_tree_def(t) for t in x))
    return None


def _tree_build(defn, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        is_list, kids = d
        out = [build(k) for k in kids]
        return out if is_list else tuple(out)
    return build(defn)


def _call_layer(layer, x):
    """Tuple activations unpack as positional arguments (reference)."""
    return layer(*x) if isinstance(x, (tuple, list)) else layer(x)


@contextlib.contextmanager
def _building_on(dev):
    """Layers built in the block take ``dev`` as their default device."""
    prev = _device._chosen[0]
    _device._chosen[0] = dev
    try:
        yield
    finally:
        _device._chosen[0] = prev


class LayerDesc:
    """A layer's constructor and arguments (reference :57): a stage builds
    only the layers placed on it."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self, registry=None) -> Layer:
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer tied across its positions by ``key`` (reference :77): one
    object within a stage; across stages, copies kept equal by a
    broadcast at build time and a gradient all-reduce over the holders
    (:meth:`PipelineLayer.allreduce_shared_weight_gradients`)."""

    def __init__(self, key, layer_cls, *args, forward_func=None, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key
        self.forward_func = forward_func

    def build(self, registry=None) -> Layer:
        if registry is None:
            registry = {}
        if self.key not in registry:
            registry[self.key] = super().build(registry)
        return registry[self.key]


class _RecomputeGroup(Layer):
    """A run of existing layers run as one under ``recompute``."""

    def __init__(self, layers):
        super().__init__()
        from paddle_tpu_torch.nn import LayerList
        self.seq = LayerList(layers)

    def forward(self, *xs):
        x = xs if len(xs) > 1 else xs[0]
        for layer in self.seq:
            x = _call_layer(layer, x)
        return x


class _Positions(Layer):
    """The local layers under their global positions (``"3"``, ...), so
    state-dict keys read ``layers.{i}.{name}`` as in the reference."""

    def __init__(self, items):
        super().__init__()
        for i, layer in items:
            self.add_module(str(i), layer)


def _layer_name(item) -> str:
    return item.layer_cls.__name__ if isinstance(item, LayerDesc) \
        else type(item).__name__


def _pp_groups(mesh, stages):
    """Rank lists, one for each coordinate off the ``pp`` axis, of the
    ranks at ``pp`` coordinates ``stages``."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.cpu().numpy()
    k = names.index("pp")
    arr = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
    return [[int(row[s]) for s in stages] for row in arr]


class PipelineLayer(Layer):
    """A layer sequence segmented into ``num_stages *
    num_virtual_pipeline_stages`` chunks (reference :209), chunk ``c`` on
    stage ``c % num_stages``. ``layers`` holds ``Layer``s and
    ``LayerDesc``s. ``num_stages`` is the mesh's ``pp`` size; a process
    without a ``pp`` axis holds every stage."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 loss_fn: Optional[Callable] = None, topology=None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 num_virtual_pipeline_stages: int = 1, mesh=None,
                 device=None):
        super().__init__()
        self._mesh = mesh or get_mesh()
        pp = axis_size(self._mesh, "pp") if self._mesh is not None else 1
        self.num_stages = num_stages or pp
        if pp > 1 and self.num_stages != pp:
            raise ValueError(f"{self.num_stages} stages on a mesh whose pp "
                             f"axis has {pp} ranks")
        #: this rank's stage (None: every stage is local)
        self.stage_id = axis_index(self._mesh, "pp") if pp > 1 else None
        self._group = C.Group(("pp",), self._mesh) if pp > 1 else None
        self._device = _device.resolve_device(device)
        self._loss_fn = loss_fn
        if num_virtual_pipeline_stages < 1:
            raise ValueError("num_virtual_pipeline_stages must be >= 1")
        self.num_virtual_stages = num_virtual_pipeline_stages
        self.num_chunks = self.num_stages * self.num_virtual_stages
        self.recompute_interval = recompute_interval
        items = list(layers)
        for item in items:
            if not isinstance(item, (LayerDesc, Layer)):
                raise TypeError(f"unsupported pipeline item {item!r}")
        if len(items) < self.num_chunks:
            raise ValueError(
                f"{len(items)} layers cannot fill {self.num_chunks} chunks "
                f"({self.num_stages} stages x {self.num_virtual_stages} "
                "virtual)")
        bounds = self._segment(items, self.num_chunks, seg_method)
        self._bounds = bounds
        chunk_of = {i: c for c in range(self.num_chunks)
                    for i in range(bounds[c], bounds[c + 1])}
        registry: dict = {}
        local = []
        with _building_on(self._device):
            for i, item in enumerate(items):
                if not self.is_local(chunk_of[i]):
                    continue
                layer = item.build(registry) \
                    if isinstance(item, LayerDesc) else item
                local.append((i, layer.to(self._device)))
        built = dict(local)
        self._chunk_layers: List[List[Layer]] = [
            [built[i] for i in range(bounds[c], bounds[c + 1])]
            if self.is_local(c) else [] for c in range(self.num_chunks)]
        self.layers = _Positions(local)
        if recompute_interval > 0:
            k = recompute_interval
            self.__dict__["_recompute_groups"] = [
                [_RecomputeGroup(seg[i:i + k])
                 for i in range(0, len(seg), k)]
                for seg in self._chunk_layers]
        self._shared = self._tie_shared(items, chunk_of, registry)

    # -- placement ---------------------------------------------------------
    def chunk_stage(self, c: int) -> int:
        return c % self.num_stages

    def is_local(self, c: int) -> bool:
        return self.stage_id is None or self.chunk_stage(c) == self.stage_id

    def _tie_shared(self, items, chunk_of, registry):
        """``[(process group, parameters)]`` of each shared key held on
        more than one stage: the first holder's weights broadcast now,
        the gradients summed by :meth:`allreduce_shared_weight_gradients`."""
        if self.stage_id is None:
            return []
        holders: dict = {}
        for i, item in enumerate(items):
            if isinstance(item, SharedLayerDesc):
                st = self.chunk_stage(chunk_of[i])
                holders.setdefault(item.key, [])
                if st not in holders[item.key]:
                    holders[item.key].append(st)
        out = []
        for key in sorted(holders, key=str):
            stages = sorted(holders[key])
            if len(stages) < 2:
                continue
            # every rank makes every group, in one order (torch's rule)
            pg, _ = dist.new_subgroups_by_enumeration(
                _pp_groups(self._mesh, stages))
            if self.stage_id not in stages:
                continue
            params = list(registry[key].parameters())
            src = dist.get_global_rank(pg, 0)
            with torch.no_grad():
                for p in params:
                    dist.broadcast(p.data, src=src, group=pg)
            out.append((pg, params))
        return out

    def allreduce_shared_weight_gradients(self):
        """Sum the gradients of each shared layer over the stages that
        hold it (Paddle's ``allreduce_shared_weight_gradients``)."""
        for pg, params in self._shared:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, group=pg)

    @staticmethod
    def _segment(items, n_stages: int, method: str) -> List[int]:
        """Chunk boundaries (reference :233-291): ``"uniform"`` (equal
        counts), ``"layer:REGEX"`` (equal shares of layers whose class
        name matches) and ``"uniform_params"`` (parameter counts
        balanced; a ``LayerDesc`` is built on the CPU to be counted)."""
        n_layers = len(items)
        if method == "uniform":
            base, rem = divmod(n_layers, n_stages)
            bounds = [0]
            for s in range(n_stages):
                bounds.append(bounds[-1] + base + (1 if s < rem else 0))
            return bounds
        if method.startswith("layer:"):
            pat = re.compile(method.split(":", 1)[1], re.IGNORECASE)
            weights = [1 if pat.search(_layer_name(l)) else 0
                       for l in items]
            total = sum(weights)
            if total == 0:
                raise ValueError(
                    f"seg_method {method!r} matched no layer "
                    f"({sorted({_layer_name(l) for l in items})})")
            if total % n_stages:
                raise ValueError(
                    f"{total} layers matching {method!r} cannot split "
                    f"evenly into {n_stages} chunks")
            share = total // n_stages
            bounds, acc = [0], 0
            for idx, wgt in enumerate(weights):
                acc += wgt
                if acc == share and len(bounds) < n_stages:
                    bounds.append(idx + 1)
                    acc = 0
            bounds.append(n_layers)
            return bounds
        if method == "uniform_params":
            def count(item):
                if isinstance(item, LayerDesc):
                    with _building_on(torch.device("cpu")):
                        item = LayerDesc.build(item)
                return sum(int(np.prod(p.shape)) for p in item.parameters())
            weights = [max(count(l), 1) for l in items]
            csum = np.cumsum(weights, dtype=np.float64)
            total = float(csum[-1])
            bounds = [0]
            for j in range(1, n_stages):
                pos = int(np.searchsorted(csum, total * j / n_stages)) + 1
                lo = bounds[-1] + 1
                hi = n_layers - (n_stages - j)
                bounds.append(min(max(pos, lo), hi))
            bounds.append(n_layers)
            return bounds
        raise NotImplementedError(
            f"seg_method {method!r}; use 'uniform', 'layer:REGEX', or "
            "'uniform_params'")

    @property
    def _stage_layers(self):
        if self.num_virtual_stages != 1:
            raise AttributeError(
                "_stage_layers is undefined under interleave; use "
                "_chunk_layers")
        return self._chunk_layers

    # -- running -----------------------------------------------------------
    def chunk_forward(self, c: int, x):
        """Chunk ``c`` (a local one) on ``x``; with a
        ``recompute_interval`` every run of k layers recomputes in the
        backward."""
        if not self.is_local(c):
            raise ValueError(f"chunk {c} lives on stage "
                             f"{self.chunk_stage(c)}, not this rank's")
        if self.recompute_interval <= 0 or not self.training:
            for layer in self._chunk_layers[c]:
                x = _call_layer(layer, x)
            return x
        from .utils import recompute
        for group in self.__dict__["_recompute_groups"][c]:
            x = recompute(group, *x) if isinstance(x, (tuple, list)) \
                else recompute(group, x)
        return x

    def _to_device(self, x):
        return _tree_map(lambda t: unwrap(t).to(self._device)
                         if isinstance(t, torch.Tensor) else t, x)

    def forward(self, x):
        """The sequential run, chunk after chunk (reference :342-352). With
        stages on several ranks each runs its chunks and passes the
        activation on; the last stage's output is broadcast over ``pp``,
        so every rank returns it. Gradients do not cross ranks here:
        train through :class:`PipelineParallel`."""
        x = self._to_device(x)
        p2p = _P2P(self, _signature(x))
        for c in range(self.num_chunks):
            if c > 0:
                x = p2p.move(x, c - 1, c)
            if self.is_local(c):
                x = self.chunk_forward(c, x)
        return p2p.broadcast_last(x, self.num_chunks - 1)


def _signature(x):
    """The nesting, shapes and dtypes of ``x``'s tensors: what a
    boundary's handshake is keyed by (every rank has the batch)."""
    return (_tree_def(x), tuple(
        (tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
        else None for t in _tree_leaves(x)))


class _P2P:
    """Moves activation trees between the stages of chunks: a pass within
    the process, or a send (asynchronous, its handle kept) and a blocking
    receive. The tree's nesting, shapes and dtypes go ahead of its
    tensors (a pickled handshake) the first time a boundary carries them
    for a micro-batch of a given signature; both ends keep them on the
    layer, keyed by ``(from, to, signature)``, and later crossings send
    the tensors alone, as Paddle's p2p meta is sent once and cached. A
    boundary whose shapes change for the same micro-batch signature
    raises on its sending rank."""

    def __init__(self, layer: PipelineLayer, sig=None):
        self.l = layer
        self.sig = sig
        self.pending = []
        self.metas = layer.__dict__.setdefault("_p2p_metas", {})

    def _local(self, c):
        return self.l.is_local(c)

    def _send(self, tree, dst_stage, key):
        g = self.l._group
        leaves = [unwrap(t).detach().contiguous() for t in _tree_leaves(tree)]
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                raise TypeError("pipeline activations crossing stages must "
                                f"be tensors, got {type(t).__name__}")
        meta = (_tree_def(tree), [(tuple(t.shape), str(t.dtype)[6:])
                                  for t in leaves])
        known = self.metas.get(key)
        if known is None:
            dev = self.l._device
            blob = torch.frombuffer(bytearray(pickle.dumps(meta)),
                                    dtype=torch.uint8).to(dev)
            n = torch.tensor([blob.numel()], dtype=torch.int64, device=dev)
            self.pending += [C.send(t, dst=dst_stage, group=g, sync_op=False)
                             for t in (n, blob)]
            self.metas[key] = meta
        elif known != meta:
            raise RuntimeError(
                f"pipeline boundary {key[:2]}: {meta} where an earlier "
                f"micro-batch of the same shapes sent {known}; a stage's "
                f"output shapes must follow from its input's")
        for t in leaves:
            self.pending.append(C.send(t, dst=dst_stage, group=g,
                                       sync_op=False))

    def _recv(self, src_stage, key):
        g = self.l._group
        dev = self.l._device
        meta = self.metas.get(key)
        if meta is None:
            n = torch.zeros(1, dtype=torch.int64, device=dev)
            C.recv(n, src=src_stage, group=g)
            blob = torch.empty(int(n[0]), dtype=torch.uint8, device=dev)
            C.recv(blob, src=src_stage, group=g)
            meta = self.metas[key] = pickle.loads(
                blob.cpu().numpy().tobytes())
        defn, specs = meta
        leaves = []
        for shape, dt in specs:
            t = torch.empty(shape, dtype=getattr(torch, dt), device=dev)
            C.recv(t, src=src_stage, group=g)
            leaves.append(t)
        return _tree_build(defn, leaves)

    def move(self, x, c_from, c_to):
        """Chunk ``c_from``'s output ``x`` (where it is local) to chunk
        ``c_to``'s rank; returns it there (and ``x`` elsewhere)."""
        src, dst = self.l.chunk_stage(c_from), self.l.chunk_stage(c_to)
        if self.l.stage_id is None or src == dst:
            return x
        if self.l.stage_id == src:
            self._send(x, dst, (c_from, c_to, self.sig))
            return x
        if self.l.stage_id == dst:
            return self._recv(src, (c_from, c_to, self.sig))
        return x

    def broadcast_last(self, x, c_last):
        """The last chunk's output on every stage's rank."""
        if self.l.stage_id is None:
            return x
        last = self.l.chunk_stage(c_last)
        if self.l.stage_id == last:
            for d in range(self.l.num_stages):
                if d != last:
                    self._send(x, d, ("out", d, self.sig))
        else:
            x = self._recv(last, ("out", self.l.stage_id, self.sig))
        self.wait()
        return x

    def wait(self):
        for t in self.pending:
            t.wait()
        self.pending = []


class PipelineParallel(Layer):
    """The chunk-granular 1F1B micro-batch engine (reference :295-673).
    ``train_batch((inputs, labels), optimizer)`` splits the batch into
    ``accumulate_steps`` micro-batches, walks the one global order of
    ``("f"|"b", micro, chunk)`` units and runs this rank's, steps the
    optimizer and returns the mean loss on every rank;
    ``last_schedule_stats`` then holds the schedule's accounting."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 accumulate_steps: Optional[int] = None):
        super().__init__()
        mesh = layers._mesh
        if mesh is not None:
            other = {a: n for a, n in mesh_shape(mesh).items()
                     if a != "pp" and n > 1}
            if other:
                raise NotImplementedError(
                    f"PipelineParallel runs each stage on one rank (the "
                    f"reference on each stage's first device); the mesh's "
                    f"other axes {other} are not taken")
        self._layers = layers
        self.accumulate_steps = accumulate_steps or layers.num_stages
        self._loss_fn = layers._loss_fn
        self.last_schedule_stats: dict = {}
        self._schedule_cache: dict = {}

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def forward(self, x):
        return self._layers(x)

    # -- the schedule: the reference's pure Python -------------------------
    def _build_schedule(self, n_micro: int):
        if self._layers.num_virtual_stages > 1:
            return self._interleave_schedule(n_micro)
        return self._greedy_schedule(n_micro)

    def _greedy_schedule(self, n_micro: int):
        S = self._layers.num_stages
        C = self._layers.num_chunks
        v = self._layers.num_virtual_stages
        done_f = set()
        done_b = set()
        live = {s: 0 for s in range(S)}
        cap = {s: (S - s) + (v - 1) * S for s in range(S)}
        order = []
        clock = {s: 0.0 for s in range(S)}
        busy = {s: 0.0 for s in range(S)}
        finish_f = {}
        finish_b = {}

        def ready_f(m, c):
            return (m, c) not in done_f and (
                c == 0 or (m, c - 1) in done_f)

        def ready_b(m, c):
            return (m, c) not in done_b and (m, c) in done_f and (
                c == C - 1 or (m, c + 1) in done_b)

        total_units = 2 * n_micro * C
        while len(done_f) + len(done_b) < total_units:
            progressed = False
            for s in range(S):
                chunks = [c for c in range(C)
                          if self._layers.chunk_stage(c) == s]
                cand_b = sorted((m, c) for c in chunks
                                for m in range(n_micro) if ready_b(m, c))
                cand_f = sorted((m, c) for c in chunks
                                for m in range(n_micro) if ready_f(m, c))
                unit = None
                if cand_b:
                    unit = ("b",) + cand_b[0]
                elif cand_f and live[s] < cap[s]:
                    unit = ("f",) + cand_f[0]
                elif cand_f and not cand_b:
                    unit = ("f",) + cand_f[0]
                if unit is None:
                    continue
                kind, m, c = unit
                if kind == "f":
                    dep = finish_f.get((m, c - 1), 0.0) if c else 0.0
                    t0 = max(clock[s], dep)
                    clock[s] = t0 + 1.0
                    busy[s] += 1.0
                    finish_f[(m, c)] = clock[s]
                    done_f.add((m, c))
                    live[s] += 1
                else:
                    dep = (finish_b.get((m, c + 1), 0.0)
                           if c < C - 1 else finish_f.get((m, c), 0.0))
                    t0 = max(clock[s], dep)
                    clock[s] = t0 + 2.0
                    busy[s] += 2.0
                    finish_b[(m, c)] = clock[s]
                    done_b.add((m, c))
                    live[s] -= 1
                order.append(unit)
                progressed = True
            if not progressed:
                raise RuntimeError("pipeline schedule deadlocked")
        span = max(clock.values())
        stats = {
            "slots_span": span,
            "busy": dict(busy),
            "bubble_fraction": round(
                1.0 - sum(busy.values()) / (span * S), 4) if span else 0.0,
        }
        return order, stats

    def _interleave_schedule(self, n_micro: int):
        """The reference/Megatron interleaved 1F1B (reference :450-565);
        needs ``n_micro % S == 0``."""
        S = self._layers.num_stages
        v = self._layers.num_virtual_stages
        C = self._layers.num_chunks
        if n_micro % S:
            raise ValueError(
                f"interleaved pipeline needs accumulate_steps divisible by "
                f"num_stages (got {n_micro} micro-batches, {S} stages)")
        mv = n_micro * v
        pv = S * v

        def unit(r, k, forward):
            group, ing = divmod(k, pv)
            local_chunk = ing // S
            if not forward:
                local_chunk = v - 1 - local_chunk
            micro = group * S + ing % S
            return micro, local_chunk * S + r

        local = {}
        for r in range(S):
            w = min(2 * (S - r - 1) + (v - 1) * S, mv)
            seq = [("f", k) for k in range(w)]
            fi, bi = w, 0
            while fi < mv:
                seq.append(("f", fi))
                fi += 1
                seq.append(("b", bi))
                bi += 1
            while bi < mv:
                seq.append(("b", bi))
                bi += 1
            local[r] = seq

        f_dur, b_dur = 1.0 / v, 2.0 / v
        pos = {r: 0 for r in range(S)}
        clock = {r: 0.0 for r in range(S)}
        busy = {r: 0.0 for r in range(S)}
        finish_f, finish_b = {}, {}
        events = []
        remaining = sum(len(s) for s in local.values())
        while remaining:
            progressed = False
            for r in range(S):
                while pos[r] < len(local[r]):
                    kind, k = local[r][pos[r]]
                    m, c = unit(r, k, kind == "f")
                    if kind == "f":
                        if c > 0 and (m, c - 1) not in finish_f:
                            break
                        dep = finish_f.get((m, c - 1), 0.0)
                        dur = f_dur
                    else:
                        if (m, c) not in finish_f:
                            break
                        if c < C - 1 and (m, c + 1) not in finish_b:
                            break
                        dep = (finish_b.get((m, c + 1), 0.0)
                               if c < C - 1 else finish_f[(m, c)])
                        dur = b_dur
                    start = max(clock[r], dep)
                    clock[r] = start + dur
                    busy[r] += dur
                    (finish_f if kind == "f" else finish_b)[(m, c)] = \
                        clock[r]
                    events.append((start, r, kind, m, c))
                    pos[r] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                raise RuntimeError("interleaved schedule deadlocked")
        events.sort(key=lambda e: (e[0], e[1]))
        order = [(kind, m, c) for _, _, kind, m, c in events]
        span = max(clock.values())
        stats = {
            "slots_span": span,
            "busy": dict(busy),
            "bubble_fraction": round(
                1.0 - sum(busy.values()) / (span * S), 4) if span else 0.0,
        }
        return order, stats

    @staticmethod
    def _peak_in_flight(order) -> int:
        """The most forward results held for their backward at once, over
        every stage (what the reference's one process counts)."""
        live = peak = 0
        for kind, _, _ in order:
            live += 1 if kind == "f" else -1
            peak = max(peak, live)
        return peak

    # -- one batch ---------------------------------------------------------
    def _micro(self, inputs, labels, n_micro):
        L = self._layers
        inputs, labels = L._to_device(inputs), L._to_device(labels)
        if isinstance(inputs, (tuple, list)):
            parts = [torch.chunk(t, n_micro, dim=0) for t in inputs]
            micro_x = [tuple(p[m] for p in parts) for m in range(n_micro)]
        else:
            micro_x = list(torch.chunk(inputs, n_micro, dim=0))
        micro_y = list(torch.chunk(labels, n_micro, dim=0))
        if len(micro_x) != n_micro or len(micro_y) != n_micro:
            raise ValueError(f"a batch of {len(micro_y)} rows cannot make "
                             f"{n_micro} micro-batches")
        return micro_x, micro_y

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        from paddle_tpu_torch.profiler import RecordEvent

        inputs, labels = data
        had = any(type(t) is Tensor for t in _tree_leaves(data))
        n_micro = self.accumulate_steps
        L = self._layers
        C_ = L.num_chunks
        micro_x, micro_y = self._micro(inputs, labels, n_micro)
        if n_micro not in self._schedule_cache:
            self._schedule_cache[n_micro] = self._build_schedule(n_micro)
        order, stats = self._schedule_cache[n_micro]
        p2p = _P2P(L)
        sigs = [_signature(x) for x in micro_x]
        fwd_out = {}    # (m, c) -> (output or loss, input tree)
        cot = {}        # (m, c) -> cotangent tree of chunk c's output
        acts = {}       # (m, c) -> chunk c's input tree, on its rank
        losses = []

        def boundary(tree):
            return _tree_map(lambda t: t.detach().requires_grad_(
                t.is_floating_point()), tree)

        def run_fwd(m, c):
            x = micro_x[m] if c == 0 else boundary(acts.pop((m, c)))
            with RecordEvent(f"pp_fwd_m{m}_c{c}"):
                out = L.chunk_forward(c, x)
            fwd_out[(m, c)] = (out, x)
            if c == C_ - 1:
                with RecordEvent(f"pp_loss_m{m}"):
                    loss = self._loss_fn(out, micro_y[m])
                losses.append(loss.detach())
                fwd_out[(m, c)] = (loss, x)

        def run_bwd(m, c):
            out, x_in = fwd_out.pop((m, c))
            with RecordEvent(f"pp_bwd_m{m}_c{c}"):
                if c == C_ - 1:
                    out.backward(torch.full_like(out, 1.0 / n_micro))
                else:
                    roots, cots = [], []
                    for o, g in zip(_tree_leaves(out),
                                    _tree_leaves(cot.pop((m, c)))):
                        if isinstance(o, torch.Tensor) and o.requires_grad:
                            roots.append(o)
                            cots.append(g)
                    torch.autograd.backward(roots, cots)
            if c > 0:
                cot[(m, c - 1)] = _tree_map(
                    lambda t: t.grad if t.grad is not None
                    else torch.zeros_like(t), x_in)

        for kind, m, c in order:
            if L.is_local(c):
                (run_fwd if kind == "f" else run_bwd)(m, c)
            # the unit's result to the rank that takes it next, at this
            # place of the order on both ranks
            p2p.sig = sigs[m]
            if kind == "f" and c < C_ - 1:
                got = p2p.move(fwd_out[(m, c)][0] if L.is_local(c) else None,
                               c, c + 1)
                if L.is_local(c + 1):
                    acts[(m, c + 1)] = got
            elif kind == "b" and c > 0:
                got = p2p.move(cot.get((m, c - 1)) if L.is_local(c) else None,
                               c, c - 1)
                if L.is_local(c - 1):
                    cot[(m, c - 1)] = got
                else:
                    cot.pop((m, c - 1), None)
        p2p.wait()
        stats = dict(stats)
        stats["peak_in_flight_activations"] = self._peak_in_flight(order)
        stats["n_micro"] = n_micro
        stats["n_chunks"] = C_
        self.last_schedule_stats = stats

        L.allreduce_shared_weight_gradients()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            self._step(optimizer)
        optimizer.clear_grad(set_to_zero=False)
        if lr_scheduler is not None:
            lr_scheduler.step()
        last = L.chunk_stage(C_ - 1)
        if L.stage_id is None or L.stage_id == last:
            total = torch.stack(losses).sum() / float(n_micro)
        else:
            total = torch.zeros((), dtype=torch.float32, device=L._device)
        if L._group is not None:
            total = C.broadcast(total.float().contiguous(), src=last,
                                group=L._group)
        return wrap(total) if had else total

    def _step(self, optimizer):
        """``optimizer.step()``; a global-norm clip sums the squares over
        the stages (a shared layer counted once, on its first holder)."""
        from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
        clip = getattr(optimizer, "_grad_clip", None)
        L = self._layers
        if L._group is None or not isinstance(clip, ClipGradByGlobalNorm):
            optimizer.step()
            return
        repeats = {id(p) for pg, ps in L._shared
                   if dist.get_rank(pg) != 0 for p in ps}
        pairs = [(p, p.grad) for p in L.parameters() if p.grad is not None]

        def reduce_sq(params, sq):
            local = sum((s for p, s in zip(params, sq)
                         if id(p) not in repeats),
                        torch.zeros((), device=L._device))
            return C.all_reduce(local.float().clone(), group=L._group)
        clipped, _ = clip._clip_with_norm(pairs, reduce_sq=reduce_sq)
        for p, g in clipped:
            p.grad = g
        optimizer._grad_clip = None
        try:
            optimizer.step()
        finally:
            optimizer._grad_clip = clip

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        out = self._layers(inputs)
        if compute_loss and self._loss_fn is not None:
            out = self._loss_fn(out, self._layers._to_device(labels))
        return out
