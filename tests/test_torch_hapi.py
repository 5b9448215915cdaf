"""The port's ``hapi.Model`` and ``framework.io`` against the JAX
package's: ``Model.fit`` of a tiny Llama over the packed pipeline on
bridged weights (AdamW with a global-norm clip, per-step losses at rtol
1e-5, parameters and AdamW moments at rtol 1e-4 and atol 1e-6 at lr 1e-4, the
tolerances of ``tests/test_torch_train.py``), ``evaluate`` on the same
batches, ``Model.save``/``load`` and ``framework.io`` files read across
the packages for f32 state, and bfloat16 in ``framework.io`` refused in
both directions with the checkpoint manager named as its route."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.data import DataPipeline as JPipe
from paddle_tpu.framework import io as jfio
from paddle_tpu_torch.data import DataPipeline
from paddle_tpu_torch.framework import io as tfio
from paddle_tpu_torch.hapi import (Callback, EarlyStopping, LRScheduler,
                                   Model, ModelCheckpoint, StepTelemetry,
                                   VisualDL)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.utils.bridge import optimizer_state_to_numpy

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import bridged, jax_tiny, state_dict_from_jax
from torch_io_samples import Docs

TOL = dict(rtol=1e-4, atol=1e-6)
PIPE = dict(batch_size=2, seq_len=32, pack=True, base_seed=1,
            drop_last=True)


def _docs():
    return Docs(40, vocab=256)


class _JLosses(pt.callbacks.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def jax_fit_model(seed, lr=1e-4):
    jm = jax_tiny(seed)
    jm.train()
    opt = pt.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    return jm, pt.hapi.Model(jm).prepare(opt, loss=None), opt


def port_fit_model(jm, lr=1e-4):
    tm = bridged(jm)
    opt = AdamW(learning_rate=lr, parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return tm, Model(tm).prepare(opt, loss=None), opt


def assert_same_training_state(jm, jopt, tm, topt):
    jstate = state_dict_from_jax(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jstate[n],
                                   err_msg=n, **TOL)
    jsd = {k: (v if isinstance(v, int) else np.asarray(v.data))
           for k, v in jopt.state_dict().items()}
    tsd = optimizer_state_to_numpy(topt)
    assert sorted(tsd) == sorted(jsd)
    assert tsd["@step_count"] == jsd["@step_count"]
    for key in jsd:
        if key != "@step_count":
            np.testing.assert_allclose(tsd[key], jsd[key], err_msg=key,
                                       **TOL)


def test_fit_over_the_packed_pipeline_matches_jax():
    jm, jmodel, jopt = jax_fit_model(31)
    tm, tmodel, topt = port_fit_model(jm)
    jrec, trec = _JLosses(), _Losses()
    jpipe, tpipe = JPipe(_docs(), **PIPE), DataPipeline(_docs(), **PIPE)
    jhist = jmodel.fit(jpipe, epochs=2, num_iters=6, verbose=0,
                       callbacks=[jrec])
    thist = tmodel.fit(tpipe, epochs=2, num_iters=6, verbose=0,
                       callbacks=[trec])
    assert len(trec.losses) == 6 and tpipe.step == jpipe.step == 6
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-5)
    assert_same_training_state(jm, jopt, tm, topt)
    # evaluate on packed batches: the network's own loss, no metrics
    ev = dict(PIPE, base_seed=2)
    jlogs = jmodel.evaluate(JPipe(Docs(12, vocab=256), **ev), verbose=0)
    tlogs = tmodel.evaluate(DataPipeline(Docs(12, vocab=256), **ev),
                            verbose=0)
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)


def test_model_save_and_load_across_packages(tmp_path):
    """f32 weights and AdamW state after two steps: the port's files load
    into the JAX package's Model and the JAX package's into the port's."""
    jm, jmodel, jopt = jax_fit_model(32)
    tm, tmodel, topt = port_fit_model(jm)
    jmodel.fit(JPipe(_docs(), **PIPE), num_iters=2, verbose=0)
    tmodel.fit(DataPipeline(_docs(), **PIPE), num_iters=2, verbose=0)
    tmodel.save(str(tmp_path / "port"))
    jmodel.save(str(tmp_path / "jax"))
    # the port's file into a fresh JAX model, and the JAX file into a
    # fresh port model: each holds its writer's state exactly
    jm2, jmodel2, jopt2 = jax_fit_model(40)
    jmodel2.load(str(tmp_path / "port"))
    tm2, tmodel2, topt2 = port_fit_model(jax_tiny(41))
    tmodel2.load(str(tmp_path / "jax"))
    for n, p in tm.named_parameters():
        assert np.array_equal(np.asarray(jm2.state_dict()[n].data),
                              p.detach().numpy()), n
    jstate = state_dict_from_jax(jm)
    for n, p in tm2.named_parameters():
        assert np.array_equal(p.detach().numpy(), jstate[n]), n
    ours = optimizer_state_to_numpy(topt2)
    for k, v in jopt.state_dict().items():
        want = v if isinstance(v, int) else np.asarray(v.data)
        assert np.array_equal(ours[k], want), k
    # framework.io directly: a nested object with tensors and scalars
    obj = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "meta": [1, "x", (torch.tensor([2], dtype=torch.int32),)]}
    tfio.save(obj, str(tmp_path / "obj.pdparams"))
    back = jfio.load(str(tmp_path / "obj.pdparams"))
    assert np.array_equal(np.asarray(back["w"].data), obj["w"].numpy())
    jfio.save(back, str(tmp_path / "obj2.pdparams"))
    again = tfio.load(str(tmp_path / "obj2.pdparams"), device="cpu")
    assert torch.equal(again["w"], obj["w"]) and again["meta"][:2] == [1, "x"]
    assert again["meta"][2][0].dtype == torch.int32


def test_bfloat16_in_framework_io_is_refused_both_ways(tmp_path):
    w = torch.ones(3, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="CheckpointManager"):
        tfio.save({"w": w}, str(tmp_path / "bf16.pdparams"))
    assert not (tmp_path / "bf16.pdparams").exists()
    jfio.save({"w": pt.to_tensor(np.asarray(jnp.ones(3, jnp.bfloat16)))},
              str(tmp_path / "jax_bf16.pdparams"))
    with pytest.raises(NotImplementedError, match="CheckpointManager"):
        tfio.load(str(tmp_path / "jax_bf16.pdparams"), device="cpu")


def test_callbacks_and_checkpoint_dir_resume(tmp_path):
    jm = jax_tiny(33)
    tm, tmodel, topt = port_fit_model(jm)
    sched = StepDecay(1e-3, step_size=2, gamma=0.5)
    topt.set_lr_scheduler(sched)
    ckpt = ModelCheckpoint(save_dir=str(tmp_path / "ck"), keep_last_k=1)
    stop = EarlyStopping(monitor="loss", patience=0, baseline=0.0)
    hist = tmodel.fit(DataPipeline(_docs(), **PIPE), epochs=3, verbose=0,
                      num_iters=4, callbacks=[ckpt, stop, LRScheduler()])
    # EarlyStopping: no epoch beats a baseline of 0, so the first ends it
    assert stop.stopped and len(hist["loss"]) == 1
    assert sched.last_epoch == 4  # stepped once per batch
    tm2, tmodel2, topt2 = port_fit_model(jax_tiny(34))
    tmodel2.load(str(tmp_path / "ck"))  # the latest committed epoch
    for (n, a), b in zip(tm.named_parameters(), tm2.parameters()):
        assert torch.equal(a, b), n
    assert topt2.state_dict()["@step_count"] == 4
    info = tmodel.summary()
    assert info["total_params"] == sum(p.numel() for p in tm.parameters())


def test_refusals(monkeypatch):
    tm, tmodel, _ = port_fit_model(jax_tiny(35))
    with pytest.raises(NotImplementedError, match="amp"):
        Model(tm).prepare(AdamW(parameters=tm.parameters()),
                          amp_configs={"level": "O1"})
    # StepTelemetry and VisualDL are ported: they construct
    assert StepTelemetry(peak=0).timer is None
    assert VisualDL is not None
    batch = {"input_ids": np.ones((2, 8), np.int32),
             "labels": np.ones((2, 8), np.int32)}
    lossy = Model(tm).prepare(AdamW(parameters=tm.parameters()),
                              loss=torch.nn.MSELoss())
    for call in (lossy.train_batch, lossy.eval_batch):
        with pytest.raises(RuntimeError, match="loss=None"):
            call(batch)
    # the reference's chaos variable is not read (resilience.chaos's
    # configure arms the harness): the fit runs its step
    monkeypatch.setenv("PADDLE_TPU_CHAOS_KILL_AT_STEP", "1")
    assert len(tmodel.fit([batch], verbose=0)["loss"]) == 1
