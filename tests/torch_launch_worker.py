"""A trainer the port's launcher starts in the job-lifecycle tests (run by
``python -m paddle_tpu_torch.distributed.launch``, not by pytest):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --max_restarts 1 tests/torch_launch_worker.py MODE OUTDIR KEY=VALUE...

Every attempt joins the launcher's job (``init_parallel_env(backend=
"gloo")``), builds the tiny Llama of ``torch_dist_worker.TINY`` from its
numpy weights at data parallelism over the whole world
(``fleet.distributed_model``), and fits ``steps`` global batches of
``torch_dist_worker.llama_batches`` through ``hapi.Model.fit`` under
``FitResilience`` with a synchronous ``CheckpointManager`` in
``OUTDIR/ckpt`` (a save every step), resuming from its latest step.

MODE ``lifecycle``: ``kill_rank``/``kill_step`` arm the chaos harness's
SIGKILL after that fit step on that rank (once a job, ``OUTDIR/marks``);
``preempt_rank``/``preempt_step`` send that rank SIGUSR1 as that global
step begins (once a job). MODE ``elastic``: ``resize_step`` has rank 0
ask for a resize to world 1 at that step; rank 1 departs (exit 83), and
rank 0 continues in place on the exchanged state to ``steps``.

Each attempt of each rank writes ``OUTDIR/rank<r>.e<epoch>.json``: the
restored step and the digest of the state it restored, the losses by
global step, the goodput bins, how fit ended and, in ``elastic``, rank 0's ``/fleetz``
rollup after the resize. MODEs ``save`` and ``place`` (see
:func:`save_or_place`) write a step from every rank and place a step and
batches onto a dp x mp mesh. This file imports neither ``jax`` nor
``paddle_tpu``.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch_dist_worker as W  # noqa: E402


def state_digest(state) -> str:
    """sha256 over a state tree's tensors and arrays, in key order (the
    tests recompute it from a committed step)."""
    from paddle_tpu_torch.checkpoint.layout import flatten_state
    _, leaves = flatten_state(state)
    h = hashlib.sha256()
    for key in sorted(leaves):
        value = leaves[key][0]
        h.update(key.encode())
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().contiguous()
            h.update(str(value.dtype).encode())
            h.update(value.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(value).tobytes())
    return h.hexdigest()


def global_batches(steps):
    return [{"input_ids": torch.from_numpy(ids),
             "labels": torch.from_numpy(labels)}
            for ids, labels in W.llama_batches(W.TINY["vocab_size"],
                                               n=steps)]


def build(cfg_kw=W.TINY):
    """fleet -> the data-parallel Llama -> ``hapi.Model`` with AdamW."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    fleet.init(is_collective=True)
    net = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
    load_numpy_state(net, W.llama_state(cfg_kw))
    opt = AdamW(learning_rate=W.LR, parameters=net.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model = hapi.Model(fleet.distributed_model(net))
    model.prepare(fleet.distributed_optimizer(opt), loss=None)
    return model


def _once(marks, what) -> bool:
    """True the first time in a job (a marker file outlives the process)."""
    path = os.path.join(marks, what)
    if os.path.exists(path):
        return False
    open(path, "w").close()
    return True


def seams(fr, rank, opts, marks, listener, dump):
    """A callback recording each global step's loss (``dump`` writes the
    record after each step, so a killed attempt leaves its losses too),
    sending SIGUSR1 and asking for the resize where ``opts`` say;
    returns (it, the losses)."""
    from paddle_tpu_torch.hapi.model import Callback
    losses = {}
    preempt_at = int(opts["preempt_step"]) \
        if rank == int(opts.get("preempt_rank", -1)) else None
    resize_at = int(opts["resize_step"]) \
        if listener is not None and rank == 0 else None

    class Seams(Callback):
        def on_train_batch_begin(self, step, logs=None):
            gs = fr._step0 + step
            if gs == preempt_at and _once(marks, "preempt"):
                os.kill(os.getpid(), signal.SIGUSR1)
            if gs == resize_at:
                listener.request(1, "test")

        def on_train_batch_end(self, step, logs=None):
            losses[str(fr._step0 + step)] = logs["loss"]
            dump()
    return Seams(), losses


def main(mode, out, opts):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience import (ElasticResizeListener,
                                             FitResilience, chaos)
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo")
    rank, epoch = dist.get_rank(), os.environ["PADDLE_RESTART_EPOCH"]
    steps = int(opts["steps"])
    marks = os.path.join(out, "marks")
    os.makedirs(marks, exist_ok=True)
    model = build()
    listener = ElasticResizeListener() if mode == "elastic" else None
    fr = FitResilience(manager=CheckpointManager(os.path.join(out, "ckpt"),
                                                 async_=False),
                       save_every_steps=1, elastic_listener=listener)
    fr.set_model(model)
    restored = fr.restore(model)
    res = {"rank": rank, "epoch": epoch, "restored": restored,
           "digest": None if restored is None else state_digest(
               fr.manager.restore(restored, device="cpu")),
           "live_digest": state_digest(fr._state())}

    def dump():
        from paddle_tpu_torch.observability import goodput
        snap = goodput.snapshot()
        with open(os.path.join(out, f"rank{rank}.e{epoch}.json"), "w") as f:
            json.dump(dict(res, losses=losses, goodput=None if snap is None
                           else snap["bins"]), f)
    seam, losses = seams(fr, rank, opts, marks, listener, dump)
    if rank == int(opts.get("kill_rank", -1)):
        chaos.configure(kill_at_step=int(opts["kill_step"]), mark_dir=marks)
    from paddle_tpu_torch.hapi import StepTelemetry
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    callbacks = [fr, seam, StepTelemetry(registry=MetricsRegistry(), peak=0)]
    batches = global_batches(steps)
    start = restored or 0
    model.fit(batches[start:], callbacks=callbacks, verbose=0)
    res["ended"] = "preempted" if fr.preempted else \
        "resized" if fr.resized else "done"
    if fr.resized:
        res["boundary"] = fr.resize_boundary_step
        dump()  # a departing rank exits inside complete_resize
        new_world = fr.complete_resize()
        res.update(new_world=new_world, world_after=dist.get_world_size())
        # the exchanged state on one rank: the inner model, no wrapper
        from paddle_tpu_torch import hapi
        net = model.network._layers
        single = hapi.Model(net)
        single.prepare(model._optimizer, loss=None)
        single.fit(batches[fr._step0:], callbacks=callbacks, verbose=0)
        from paddle_tpu_torch.observability import fleet
        res["fleetz"] = fleet.fleetz_snapshot()
    dump()
    dist.destroy_process_group()
    fr.exit_if_preempted()


# -- saves from several processes and placement onto a mesh -----------------
def save_state(seed=0) -> dict:
    """The numpy leaves the ``save`` mode writes (the tests write the same
    state through the JAX package)."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 4).astype(np.float32),
            "v": rng.randn(5).astype(np.float32),
            "h": rng.randn(8, 2).astype(np.float32),
            "ids": np.arange(12, dtype=np.int32).reshape(3, 4)}


def as_port_state(arrays) -> dict:
    return {"model": {k: torch.from_numpy(v.copy()) for k, v in
                      arrays.items() if k != "ids"},
            "optimizer": {"h16": torch.from_numpy(arrays["h"]).to(
                torch.bfloat16), "@step_count": 2},
            "ids": arrays["ids"]}


class Pairs:
    """A map dataset of (x [3] float32, y int64) pairs."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.float32([i, i + 0.5, -i]), np.int64(i)


def save_or_place(mode, out, opts):
    """``save``: every rank saves one state (``CheckpointManager``, the
    process group's rank and size, the mesh's topology). ``place``: on a
    ``{"dp": 2, "mp": 2}`` mesh, restore ``ckpt=`` onto the mesh and
    (``ckpt=``) and prefetch ``Pairs`` with ``sharding="auto"``, on
    ``(("dp", "mp"),)`` and on ``(None, "mp")`` (``batches=1``); each rank
    pickles its blocks and specs."""
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.checkpoint import CheckpointManager
    torch.set_num_threads(1)
    if mode == "save":
        dist.init_parallel_env(backend="gloo")
        CheckpointManager(os.path.join(out, "ckpt"), async_=False).save(
            1, as_port_state(save_state()), metadata={"global_step": 1})
        dist.destroy_process_group()
        return
    from paddle_tpu_torch.data import DataPipeline
    dist.init_parallel_env({"dp": 2, "mp": 2}, backend="gloo")
    mesh = dist.get_mesh()
    res = {"restored": {}, "batches": {}}
    if "ckpt" in opts:
        state = CheckpointManager(opts["ckpt"]).restore(mesh=mesh,
                                                        device="cpu")
        for k, v in state["model"].items():
            res["restored"][k] = (v.to_local().numpy(),
                                  tuple(v._sharding_spec), tuple(v.shape))
    for name, sharding in (("auto", "auto"),
                           ("dpmp", dist.named_sharding((("dp", "mp"),))),
                           ("mp", dist.named_sharding((None, "mp"))))[
            :3 if "batches" in opts else 0]:
        # every rank reads the whole stream: the global batch, which
        # the sharding cuts
        pipe = DataPipeline(Pairs(), batch_size=4, shard_index=0,
                            num_shards=1, device_prefetch=1, device="cpu",
                            sharding=sharding)
        res["batches"][name] = [
            [(leaf.to_local().numpy(), tuple(leaf._sharding_spec))
             if hasattr(leaf, "to_local") else (leaf.numpy(), None)
             for leaf in batch] for batch in pipe]
    with open(os.path.join(out, f"place.rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, out = sys.argv[1], sys.argv[2]
    opts = dict(a.split("=", 1) for a in sys.argv[3:])
    if mode in ("save", "place"):
        save_or_place(mode, out, opts)
    else:
        main(mode, out, opts)
