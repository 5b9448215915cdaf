"""hapi Model — port of ``paddle_tpu/hapi/model.py``.

The Keras-style training entry point: ``Model(net).prepare(optimizer,
loss)`` then ``fit``/``evaluate``/``predict``, with the callbacks of the
reference (``Callback``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``). The train step is the port's
``jit.TrainStep`` (the fused update by default). ``loss=None`` takes the
self-supervised path: the network computes its own loss, and a dict
batch — a packed ``DataPipeline`` batch — goes in as keyword arguments
(``LlamaForCausalLM(input_ids=…, labels=…, attention_mask=…,
position_ids=…)``).

Batches move to the device of the network's first parameter (numpy
leaves through ``torch.from_numpy``); a batch already there, as
``DataPipeline(device_prefetch=N)`` delivers it, is used as it is. Like
the reference, ``train_batch`` returns the step's loss as a Python
float, which waits for the step to finish on the card every step.

Not ported yet, raising ``NotImplementedError``: ``StepTelemetry`` and
``VisualDL``, ``prepare(amp_configs=…)`` (amp), ``fit``'s
``accumulate_grad_batches`` other than 1 (which the reference accepts
and ignores), and the env-armed chaos (``PADDLE_TPU_CHAOS_*``) and
profiler (``PADDLE_TPU_PROFILE_AT_STEP``) windows of ``fit``.
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

__all__ = ["Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
           "VisualDL", "EarlyStopping", "LRScheduler", "StepTelemetry",
           "set_network_state"]


class Callback:
    """Reference: hapi/callbacks.py Callback."""

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        """``logs`` carries ``data_time`` (seconds the fit loop spent
        fetching this batch) and ``batch_size`` when determinable."""
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


def _fmt(logs):
    return ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                     else f"{k}: {v}" for k, v in (logs or {}).items())


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            print(f"step {step} - {_fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"epoch {epoch} - {_fmt(logs)}")


class ModelCheckpoint(Callback):
    """Epoch-end checkpoint through ``paddle_tpu_torch.checkpoint``:
    model and optimizer state commit as one step (async by default, the
    loop paying the snapshot); ``keep_last_k`` bounds disk use. Resume
    with ``model.load(save_dir)``."""

    def __init__(self, save_freq=1, save_dir="checkpoint", async_=True,
                 keep_last_k=None):
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.async_ = async_
        self.keep_last_k = keep_last_k
        self._mgr = None

    def manager(self):
        if self._mgr is None:
            from paddle_tpu_torch.checkpoint import CheckpointManager
            self._mgr = CheckpointManager(self.save_dir,
                                          keep_last_k=self.keep_last_k,
                                          async_=self.async_)
        return self._mgr

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.save_freq == 0:
            state = {"model": self.model.network.state_dict()}
            if self.model._optimizer is not None:
                state["optimizer"] = self.model._optimizer.state_dict()
            # overwrite: a restarted fit saves the same epoch ids again
            self.manager().save(epoch, state, metadata={"epoch": epoch},
                                overwrite=True)

    def on_train_end(self, logs=None):
        if self._mgr is not None:
            self._mgr.wait_all()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0,
                 min_delta=0.0, baseline=None, save_best_model=False):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = baseline
        self.wait = 0
        self.stopped = False

    def _better(self, cur, best):
        if best is None:
            return True
        return cur < best - self.min_delta if self.mode == "min" \
            else cur > best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True
                self.model._stop_training = True


class VisualDL(Callback):
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "the VisualDL callback is not ported to paddle_tpu_torch yet")


class StepTelemetry(Callback):
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "the StepTelemetry callback (observability.StepTimer) is not "
            "ported to paddle_tpu_torch yet")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from paddle_tpu_torch.optimizer.lr import LRScheduler as S
        lr = getattr(self.model._optimizer, "_lr", None)
        return lr if isinstance(lr, S) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


@torch.no_grad()
def set_network_state(network: torch.nn.Module, state: dict):
    """Copy ``state`` ({name: tensor or array}) into ``network``'s
    parameters and persistent buffers by name, cast to each one's dtype
    as the reference's ``set_value`` does; a shape mismatch raises.
    Returns ``(missing, unexpected)`` names, like the reference's
    ``Layer.set_state_dict``."""
    own = network.state_dict()
    unexpected = []
    for name, value in state.items():
        tgt = own.get(name)
        if tgt is None:
            unexpected.append(name)
            continue
        v = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value, copy=True))
        if tuple(v.shape) != tuple(tgt.shape):
            raise ValueError(
                f"shape mismatch for {name}: checkpoint "
                f"{tuple(v.shape)} vs layer {tuple(tgt.shape)}")
        tgt.copy_(v)
    missing = [n for n in own if n not in state]
    return missing, unexpected


class Model:
    """Reference: hapi/model.py Model (fit:1036 / evaluate:1731)."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List = []
        self._train_step = None
        self._stop_training = False

    # -- setup ----------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``loss=None`` with an optimizer is the self-supervised path:
        ``net(*batch)`` (or ``net(**batch)`` for a dict batch) returns the
        loss or an ``(out, loss)`` pair."""
        if amp_configs is not None:
            raise NotImplementedError(
                "amp (prepare(amp_configs=...)) is not ported to "
                "paddle_tpu_torch yet")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        else:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        if optimizer is not None:
            from paddle_tpu_torch.jit import TrainStep

            if loss is not None:
                def loss_fn(net, x, y):
                    return self._loss(net(x), y)
            else:
                def loss_fn(net, *args, **kwargs):
                    out = net(*args, **kwargs)
                    return out[1] if isinstance(out, (tuple, list)) \
                        else out
            self._train_step = TrainStep(self.network, loss_fn, optimizer)
        return self

    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _as_tensor(self, x):
        dev = self._device()
        if isinstance(x, torch.Tensor):
            return x if x.device == dev else x.to(dev, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    @staticmethod
    def _first(x):
        return x[0] if isinstance(x, (list, tuple)) else x

    # -- core steps -----------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        if isinstance(inputs, dict):
            # packed-pipeline batches: the keys are the network's kwargs
            if self._train_step is None or self._loss is not None:
                raise RuntimeError(
                    "dict (packed-pipeline) batches require "
                    "prepare(optimizer, loss=None) — the network "
                    "computes its own loss from the batch kwargs")
            loss = self._train_step(
                **{k: self._as_tensor(v) for k, v in inputs.items()})
            return [float(loss)]
        loss = self._train_step(self._as_tensor(self._first(inputs)),
                                self._as_tensor(self._first(labels)))
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        if isinstance(inputs, dict):
            if self._loss is not None:
                raise RuntimeError(
                    "dict (packed-pipeline) batches require "
                    "prepare(..., loss=None) — the network computes "
                    "its own loss from the batch kwargs")
            out = self.network(
                **{k: self._as_tensor(v) for k, v in inputs.items()})
            loss = out[1] if isinstance(out, (tuple, list)) else out
            return [float(loss)]
        x = self._as_tensor(self._first(inputs))
        y = self._as_tensor(self._first(labels))
        out = self.network(x)
        loss = self._loss(out, y) if self._loss else None
        for m in self._metrics:
            res = m.compute(out, y)
            if not isinstance(res, tuple):
                res = (res,)
            m.update(*res)
        return [float(loss)] if loss is not None else []

    @torch.no_grad()
    def predict_batch(self, inputs):
        out = self.network(self._as_tensor(self._first(inputs)))
        return [out.cpu().numpy()]

    # -- loops ----------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=1,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        if os.environ.get("PADDLE_TPU_PROFILE_AT_STEP"):
            raise NotImplementedError(
                "PADDLE_TPU_PROFILE_AT_STEP: the fit loop's profiler "
                "window is not ported to paddle_tpu_torch yet")
        if any(k.startswith("PADDLE_TPU_CHAOS_") and v
               for k, v in os.environ.items()):
            raise NotImplementedError(
                "PADDLE_TPU_CHAOS_*: the chaos harness is not ported to "
                "paddle_tpu_torch yet")
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "accumulate_grad_batches is not ported to "
                "paddle_tpu_torch yet")
        loader = self._to_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        callbacks = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger)
                               for c in callbacks):
            callbacks.append(ProgBarLogger(log_freq, verbose))
        for cb in callbacks:
            cb.set_model(self)
        self._stop_training = False
        for cb in callbacks:
            cb.on_train_begin()
        try:
            return self._fit_epochs(loader, eval_data, batch_size, epochs,
                                    eval_freq, save_dir, save_freq,
                                    num_workers, callbacks, num_iters)
        finally:
            # on exceptions too: callbacks with teardown duties
            # (ModelCheckpoint draining async saves) must run
            for cb in callbacks:
                cb.on_train_end()

    def _fit_epochs(self, loader, eval_data, batch_size, epochs, eval_freq,
                    save_dir, save_freq, num_workers, callbacks, num_iters):
        history = {"loss": []}
        step = 0
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            self.network.train()
            epoch_losses = []
            t_fetch = time.perf_counter()
            for batch in loader:
                data_time = time.perf_counter() - t_fetch
                if isinstance(batch, dict):
                    x, y = batch, None
                    first = next(iter(batch.values()))
                else:
                    x, y = batch[0], batch[1]
                    first = self._first(x)
                shape = getattr(first, "shape", None)
                blogs = {"data_time": data_time,
                         "batch_size": int(shape[0]) if shape else None}
                for cb in callbacks:
                    cb.on_train_batch_begin(step + 1, blogs)
                loss = self.train_batch(x, y)[0]
                epoch_losses.append(loss)
                step += 1
                logs = {"loss": loss}
                gn = getattr(self._train_step, "last_grad_norm", None)
                if gn is not None:
                    logs["grad_norm"] = float(gn)
                for cb in callbacks:
                    cb.on_train_batch_end(step, logs)
                if self._stop_training:
                    # a mid-epoch stop (preemption, NaN guard, a user
                    # callback) leaves at a step boundary
                    break
                if num_iters is not None and step >= num_iters:
                    break
                t_fetch = time.perf_counter()
            if epoch_losses:
                logs = {"loss": float(np.mean(epoch_losses))}
                history["loss"].append(logs["loss"])
            else:
                # a resumed epoch can deliver no batch: no NaN mean
                logs = {}
            if eval_data is not None and not self._stop_training and \
                    (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size, verbose=0,
                                          num_workers=num_workers)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self._stop_training or (num_iters is not None and
                                       step >= num_iters):
                break
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            if isinstance(batch, dict):
                res = self.eval_batch(batch)
            else:
                res = self.eval_batch(batch[0], batch[1])
            if res:
                losses.append(res[0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name()
            vals = m.accumulate()
            if isinstance(names, list):
                logs.update(dict(zip(names, vals)))
            else:
                logs[names] = vals
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=0):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        self.network.eval()
        outs = [self.predict_batch(self._first(b))[0] for b in loader]
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    # -- persistence / introspection ------------------------------------------
    def save(self, path, training=True):
        from paddle_tpu_torch.framework.io import save
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from paddle_tpu_torch.framework.io import load
        dev = self._device()
        if os.path.isdir(path):
            # ModelCheckpoint layout: one committed step holding {"model",
            # "optimizer"}; a flat state dict loads as weights only
            state = load(path, device=dev)
            if isinstance(state.get("model"), dict):
                set_network_state(self.network, state["model"])
                if not reset_optimizer and self._optimizer is not None \
                        and "optimizer" in state:
                    self._optimizer.set_state_dict(state["optimizer"])
            else:
                set_network_state(self.network, state)
            return
        set_network_state(self.network, load(path + ".pdparams",
                                             device=dev))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(load(path + ".pdopt",
                                                device=dev))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        total = sum(p.numel() for p in self.network.parameters())
        trainable = sum(p.numel() for p in self.network.parameters()
                        if p.requires_grad)
        print("\n".join([repr(self.network), f"Total params: {total:,}",
                         f"Trainable params: {trainable:,}"]))
        return {"total_params": total, "trainable_params": trainable}

    @staticmethod
    def _to_loader(data, batch_size, shuffle, drop_last, num_workers):
        from paddle_tpu_torch.io import DataLoader, Dataset
        if data is None:
            raise ValueError("data must not be None")
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data  # a DataLoader, a DataPipeline or any batch iterable
