"""The port's checkpoint package against the JAX package's: a step
directory written by either restores in the other bit for bit (f32,
bf16 and int32 leaves, 0-d leaves, numpy leaves and a namedtuple), a
torn ``.tmp`` directory is ignored, a flipped shard byte raises
``CheckpointIntegrityError`` (or falls back to the previous step), the
keep-last-k GC and the async commit order hold, and the port's reader
refuses a ``paddle_tpu.*`` global other than the placeholder's."""
import collections
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.checkpoint import CheckpointManager as JManager
from paddle_tpu_torch.checkpoint import (CheckpointError,
                                         CheckpointIntegrityError,
                                         CheckpointManager, load_state_dir)
from paddle_tpu_torch.checkpoint.layout import dumps_skeleton, loads_skeleton

from test_torch_bridge import one_torch_thread  # noqa: F401

Pair = collections.namedtuple("Pair", "ids count")


def _leaves(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        f32=rng.randn(6, 5).astype(np.float32),
        bf16=np.asarray(jnp.asarray(rng.randn(4, 3)).astype(jnp.bfloat16)),
        i32=rng.randint(-50, 50, (9,)).astype(np.int32),
        scalar=np.float32(rng.randn()),
        carry=rng.randint(1, 99, (11,)).astype(np.int32))


def _jax_state(lv):
    return {"model": {"w": pt.to_tensor(lv["f32"]),
                      "w_bf16": pt.to_tensor(lv["bf16"]),
                      "step": pt.to_tensor(lv["scalar"])},
            "pair": Pair(pt.to_tensor(lv["i32"]), 3),
            "data": {"bins": [[lv["carry"]], []], "epoch": 2,
                     "seed": np.int64(7)}}


def _torch_state(lv):
    return {"model": {"w": torch.from_numpy(lv["f32"]),
                      "w_bf16": torch.from_numpy(
                          lv["bf16"].view(np.int16).copy()).view(
                              torch.bfloat16),
                      "step": torch.tensor(float(lv["scalar"]))},
            "pair": Pair(torch.from_numpy(lv["i32"]), 3),
            "data": {"bins": [[lv["carry"]], []], "epoch": 2,
                     "seed": np.int64(7)}}


def _bits(x):
    """The raw bytes and dtype name of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).replace("torch.", ""),
                x.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())
    a = np.asarray(getattr(x, "data", x))
    return str(a.dtype), np.ascontiguousarray(a).tobytes()


def _check(state, lv):
    m = state["model"]
    assert _bits(m["w"]) == ("float32", lv["f32"].tobytes())
    assert _bits(m["w_bf16"]) == ("bfloat16", lv["bf16"].tobytes())
    assert _bits(m["step"]) == ("float32", lv["scalar"].tobytes())
    assert tuple(np.shape(getattr(m["step"], "data", m["step"]))) == ()
    assert type(state["pair"]) is Pair and state["pair"].count == 3
    assert _bits(state["pair"].ids) == ("int32", lv["i32"].tobytes())
    carry = state["data"]["bins"][0][0]
    assert isinstance(carry, np.ndarray) and \
        carry.tobytes() == lv["carry"].tobytes()
    assert state["data"]["bins"][1] == [] and state["data"]["epoch"] == 2
    assert state["data"]["seed"] == 7


@pytest.mark.parametrize("topology", [None, {"dp": 2, "mp": 3}],
                         ids=["one_shard", "sharded"])
def test_a_jax_step_restores_in_the_port_bit_for_bit(tmp_path, topology):
    """One shard a tensor, and shard grids written for a 2 x 3 mesh (the
    reader pastes the shards by offset)."""
    lv = _leaves(1)
    JManager(str(tmp_path), async_=False, topology=topology).save(
        4, _jax_state(lv), metadata={"global_step": 4})
    if topology:
        idx = json.loads((tmp_path / "step_4" / "index.json").read_text())
        assert max(len(e["shards"]) for e in idx["tensors"].values()) > 1
    mgr = CheckpointManager(str(tmp_path))
    state = mgr.restore(device="cpu")
    _check(state, lv)
    assert isinstance(state["model"]["w_bf16"], torch.Tensor)
    assert mgr.last_restored_step == 4 and mgr.metadata(4) == {
        "global_step": 4}
    _check(load_state_dir(str(tmp_path / "step_4"), device="cpu"), lv)


@pytest.mark.parametrize("topology", [None, {"dp": 2, "mp": 3}],
                         ids=["one_shard", "sharded"])
def test_a_port_step_restores_in_the_jax_package_bit_for_bit(tmp_path,
                                                             topology):
    lv = _leaves(2)
    CheckpointManager(str(tmp_path), async_=False, topology=topology).save(
        6, _torch_state(lv), metadata={"global_step": 6})
    mgr = JManager(str(tmp_path))
    state = mgr.restore()
    _check(state, lv)
    assert mgr.metadata(6) == {"global_step": 6}
    # and back through the port
    _check(CheckpointManager(str(tmp_path)).restore(device="cpu"), lv)


def test_torn_and_corrupt_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_=False)
    lv = _leaves(3)
    mgr.save(1, _torch_state(lv))
    mgr.save(2, _torch_state(_leaves(4)))

    def boom(phase):
        if phase == "before_commit":
            raise RuntimeError("killed")
    torn = CheckpointManager(str(tmp_path), async_=False, fault_hook=boom)
    with pytest.raises(RuntimeError, match="killed"), \
            pytest.warns(RuntimeWarning):
        torn.save(3, _torch_state(lv))
    assert (tmp_path / "step_3.tmp").is_dir()
    assert mgr.all_steps() == [1, 2]
    # flip one byte of a shard of step 2
    idx = json.loads((tmp_path / "step_2" / "index.json").read_text())
    shard = next(e for e in idx["tensors"].values()
                 if e["dtype"] == "float32")["shards"][0]["file"]
    path = tmp_path / "step_2" / shard
    raw = bytearray(path.read_bytes())
    raw[3] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(CheckpointIntegrityError, match="checksum"), \
            pytest.warns(RuntimeWarning, match="CORRUPT"):
        mgr.restore(step=2, device="cpu")
    with pytest.warns(RuntimeWarning, match="falling back"):
        _check(mgr.restore(device="cpu"), lv)
    assert mgr.last_restored_step == 1
    with pytest.raises(CheckpointError, match="already committed"), \
            pytest.warns(RuntimeWarning):
        mgr.save(1, {"x": torch.zeros(2)})


def test_keep_last_k_and_async_commit_order(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    w = torch.zeros(4)
    futs = []
    for step in range(1, 6):
        w.fill_(step)
        futs.append(mgr.save(step, {"w": w}))
        # the snapshot is the caller's: later writes do not reach it
    mgr.wait_all()
    assert [f.wait() for f in futs] == [str(tmp_path / f"step_{s}")
                                       for s in range(1, 6)]
    assert mgr.all_steps() == [4, 5]
    assert mgr.restore(device="cpu")["w"].tolist() == [5.0] * 4
    assert mgr.restore(step=4, device="cpu")["w"].tolist() == [4.0] * 4
    (tmp_path / "step_2.tmp").mkdir()  # residue of an aborted save
    mgr.save(6, {"w": w}, async_=False)
    assert not (tmp_path / "step_2.tmp").exists()
    assert mgr.all_steps() == [5, 6]


def test_the_reader_refuses_a_foreign_jax_package_global(tmp_path):
    skel = dumps_skeleton({"a": 1})
    assert loads_skeleton(skel) == {"a": 1}
    # the reference's placeholder name is mapped, any other refused
    bad = pickle.dumps(pt.core.dtype.convert_dtype, protocol=2)
    with pytest.raises(CheckpointError, match="JAX package"):
        loads_skeleton(bad)
    CheckpointManager(str(tmp_path), async_=False).save(
        1, {"w": torch.ones(2)})
    step = tmp_path / "step_1"
    (step / "aux.pkl").write_bytes(bad)
    idx = json.loads((step / "index.json").read_text())
    import zlib
    idx["aux"]["crc32"] = zlib.crc32(bad) & 0xFFFFFFFF
    (step / "index.json").write_text(json.dumps(idx))
    with pytest.raises(CheckpointError, match="JAX package"):
        CheckpointManager(str(tmp_path)).restore(device="cpu")


def test_restore_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    mgr = CheckpointManager(str(tmp_path), async_=False)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_state_dir(str(tmp_path))
    with pytest.raises(NotImplementedError, match="mesh"):
        mgr.restore(mesh=object(), device="cpu")
    assert os.path.isdir(mgr.step_dir(1))
