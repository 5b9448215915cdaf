"""The port's data package (stream, packer, pipeline, prefetch) against
the JAX package's on the same documents: batches int for int, the
iterator state key for key at every step of a short epoch (so a state
written by either package resumes in the other), the exactly-once and
resume cases of ``tests/test_data.py`` (including the epoch-tail carry
of a ``pack=True, drop_last=False`` pipeline), and ``reshard_state``.
Prefetch runs on the CPU here (``device="cpu"``)."""
import hashlib
import itertools
import time

import numpy as np
import pytest
import torch

from paddle_tpu.data import DataPipeline as JPipe
from paddle_tpu.data import SequencePacker as JPacker
from paddle_tpu.data import ShardedStream as JStream
from paddle_tpu_torch.data import (DataPipeline, DevicePrefetcher,
                                   SequencePacker, ShardedStream, to_device)

from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_io_samples import Docs, LongDocs, Pairs


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def digest(batch) -> str:
    h = hashlib.sha256()
    parts = [batch[k] for k in sorted(batch)] if isinstance(batch, dict) \
        else list(batch)
    for p in parts:
        a = np.ascontiguousarray(_np(p))
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _digests(pipe, epochs=2):
    return [digest(b) for _ in range(epochs) for b in pipe]


def _same_state(a, b):
    """Two pipeline/stream states equal key for key, arrays by value."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_state(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("kw", [
    dict(base_seed=3), dict(base_seed=3, num_shards=3, shard_index=2),
    dict(shuffle=False, num_shards=4, shard_index=1, drop_remainder=False),
], ids=["shuffled", "shard_2_of_3", "wrapped_remainder"])
def test_stream_equals_the_reference(kw):
    ref, ours = JStream(Docs(23), **kw), ShardedStream(Docs(23), **kw)
    for _ in range(3):
        want = [digest([s]) for s in ref]
        assert [digest([s]) for s in ours] == want
        _same_state(ref.state_dict(), ours.state_dict())
    assert len(ours) == len(ref)
    for e in range(3):
        assert np.array_equal(ours.epoch_order(e), ref.epoch_order(e))


def test_packer_layout_and_carry_equal_the_reference():
    ref, ours = JPacker(64, 3), SequencePacker(64, 3)
    docs = Docs(30, lo=5, hi=90)
    for i in range(len(docs)):
        a, b = ref.add(docs[i]), ours.add(docs[i])
        assert [digest(x) for x in b] == [digest(x) for x in a]
        _same_state(ref.state_dict(), ours.state_dict())
    assert digest(ours.flush()) == digest(ref.flush())
    assert ours.efficiency_stats() == ref.efficiency_stats()
    p = SequencePacker(64, 3)
    p.add(np.arange(1, 11, dtype=np.int32))
    state = p.state_dict()
    q = SequencePacker(64, 3)
    q.load_state_dict(state)
    assert digest(q.flush()) == digest(p.flush())
    with pytest.raises(ValueError, match="geometry"):
        SequencePacker(32, 3).load_state_dict(state)


PIPES = {
    "packed_drop_last": dict(batch_size=2, seq_len=64, pack=True,
                             base_seed=7, drop_last=True),
    "packed_tail": dict(batch_size=2, seq_len=64, pack=True, base_seed=7,
                        drop_last=False),
    "plain": dict(batch_size=4, shuffle=True, base_seed=5, drop_last=True),
}


def _dataset(name):
    return Pairs() if name == "plain" else Docs(13, lo=36, hi=61)


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_batches_and_states_equal_the_reference(name):
    """Two epochs int for int, and after every delivered batch the state
    equals the reference's key for key."""
    ref = JPipe(_dataset(name), **PIPES[name])
    ours = DataPipeline(_dataset(name), **PIPES[name])
    for _ in range(2):
        for a, b in itertools.zip_longest(ref, ours):
            assert digest(b) == digest(a)
            _same_state(ref.state_dict(), ours.state_dict())
        assert ours.epoch == ref.epoch and ours.step == ref.step


@pytest.mark.parametrize("name", sorted(PIPES))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_round_trip_at_every_step(name, writer):
    """Cut a two-epoch run after every batch, resume a fresh pipeline of
    the other package from the state, and finish: the batches equal the
    uninterrupted run's."""
    make = {"jax": JPipe, "torch": DataPipeline}
    reader = "torch" if writer == "jax" else "jax"
    ref = _digests(DataPipeline(_dataset(name), **PIPES[name]))
    for cut in range(1, len(ref)):
        p1 = make[writer](_dataset(name), **PIPES[name])
        got = []
        while len(got) < cut:
            for b in p1:
                got.append(digest(b))
                if len(got) == cut:
                    break
        p2 = make[reader](_dataset(name), **PIPES[name])
        p2.load_state_dict(p1.state_dict())
        while len(got) < len(ref):
            before = len(got)
            for b in p2:
                got.append(digest(b))
                if len(got) == len(ref):
                    break
            assert len(got) > before
        assert got == ref, f"diverged after a cut at batch {cut}"


@pytest.mark.parametrize("drop_last", [True, False])
def test_checkpoint_between_multi_batch_flush(drop_last):
    """One long document flushes several batches from one ``add``; a cut
    between them resumes them from ``pending`` (and, with drop_last=False,
    the epoch-tail flush after them)."""
    kw = dict(batch_size=2, seq_len=8, pack=True, shuffle=False,
              drop_last=drop_last)
    ref = [digest(b) for b in DataPipeline(LongDocs(), **kw)]
    assert ref == [digest(b) for b in JPipe(LongDocs(), **kw)]
    assert len(ref) > len(LongDocs())
    for cut in range(1, len(ref)):
        p1 = DataPipeline(LongDocs(), **kw)
        it = iter(p1)
        got = [digest(next(it)) for _ in range(cut)]
        p2 = DataPipeline(LongDocs(), **kw)
        p2.load_state_dict(p1.state_dict())
        got += [digest(b) for b in p2]
        assert got == ref, f"diverged after a cut at batch {cut}"


def test_epoch_owes_its_tail_on_resume():
    """A state restored at an epoch's tail (stream at the next epoch,
    carry unflushed) still reports the finished epoch, and its next
    ``__iter__`` delivers just the tail batch."""
    kw = PIPES["packed_tail"]
    ds = _dataset("packed_tail")
    ref = [digest(b) for b in DataPipeline(ds, **kw)]
    p1 = DataPipeline(ds, **kw)
    it = iter(p1)
    for _ in range(len(ref) - 1):
        next(it)
    p2 = DataPipeline(ds, **kw)
    p2.load_state_dict(p1.state_dict())
    assert p2.epoch == 0
    assert [digest(b) for b in p2] == ref[-1:]
    assert p2.epoch == 1


def test_mismatched_states_are_refused():
    kw = dict(batch_size=2, seq_len=64, pack=True, base_seed=1)
    p1 = DataPipeline(Docs(8), drop_last=True, **kw)
    with pytest.raises(ValueError, match="drop_last"):
        DataPipeline(Docs(8), drop_last=False, **kw).load_state_dict(
            p1.state_dict())
    with pytest.raises(ValueError, match="pack=True"):
        DataPipeline(Docs(8), batch_size=2, base_seed=1).load_state_dict(
            DataPipeline(Docs(8), **kw).state_dict())
    with pytest.raises(ValueError, match="num_shards"):
        ShardedStream(Docs(8), num_shards=2, shard_index=0).load_state_dict(
            ShardedStream(Docs(8)).state_dict())
    with pytest.raises(ValueError, match="dataset"):
        ShardedStream(Docs(9)).load_state_dict(
            ShardedStream(Docs(8)).state_dict())


@pytest.mark.parametrize("new_world", [1, 2, 5])
def test_reshard_state_equals_the_reference(new_world):
    """Three shards stopped mid-epoch remap onto a new world size as the
    reference remaps them (stream and packed pipeline states)."""
    kw = dict(batch_size=2, seq_len=64, pack=True, base_seed=4,
              num_shards=3)
    pipes = [DataPipeline(Docs(120), shard_index=k, **kw)
             for k in range(3)]
    for k, p in enumerate(pipes):
        it = iter(p)
        for _ in range(k + 1):
            next(it)
    states = [p.state_dict() for p in pipes]
    ours = DataPipeline.reshard_state(states, new_world)
    ref = JPipe.reshard_state(states, new_world)
    _same_state(ref, ours)
    streams = [s["stream"] for s in states]
    _same_state(JStream.reshard_state(streams, new_world),
                ShardedStream.reshard_state(streams, new_world))


def test_prefetch_keeps_order_and_commits_at_delivery():
    kw = dict(batch_size=4, shuffle=True, base_seed=3, drop_last=True)
    sync = [digest(b) for b in DataPipeline(Pairs(), **kw)]
    pipe = DataPipeline(Pairs(), device_prefetch=3, device="cpu", **kw)
    it = iter(pipe)
    got = [digest(next(it)), digest(next(it))]
    time.sleep(0.1)  # let the producer run ahead into the buffer
    assert pipe.state_dict()["step"] == 2  # delivered, not produced
    assert pipe.epoch == 0
    got += [digest(b) for b in it]
    assert got == sync and pipe.step == len(sync) and pipe.epoch == 1


def test_prefetch_early_break_replays_buffered_batches():
    kw = dict(batch_size=4, shuffle=True, base_seed=3, drop_last=True)
    ref = [digest(b) for b in DataPipeline(Pairs(), **kw)]
    pipe = DataPipeline(Pairs(), device_prefetch=4, device="cpu", **kw)
    it = iter(pipe)
    got = [digest(next(it))]
    time.sleep(0.1)
    it.close()  # the consumer leaves; the producer is joined
    got += [digest(b) for b in pipe]
    assert got == ref


def test_prefetched_batches_are_tensors_on_the_device():
    pipe = DataPipeline(Docs(20), batch_size=2, seq_len=32, pack=True,
                        device_prefetch=2, device="cpu")
    b = next(iter(pipe))
    assert sorted(b) == ["attention_mask", "input_ids", "labels",
                         "position_ids"]
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.int32
               for v in b.values())
    out = to_device({"a": np.arange(3), "b": (torch.ones(2),)},
                    device="cpu")
    assert out["a"].tolist() == [0, 1, 2] and out["b"][0].tolist() == [1, 1]
    loader = [(np.float32([i]),) for i in range(5)]
    assert [float(b[0][0]) for b in DevicePrefetcher(
        loader, device="cpu")] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="device_prefetch"):
        DevicePrefetcher(pipe, device="cpu")
    for call in (lambda: DataPipeline(Docs(4), 2, sharding="auto"),
                 lambda: to_device({}, device="cpu", sharding="auto"),
                 lambda: DevicePrefetcher(loader, sharding="auto",
                                          device="cpu")):
        with pytest.raises(NotImplementedError, match="mesh"):
            call()


def test_bad_samples_spend_the_loader_budget():
    class Broken(Pairs):
        def __getitem__(self, i):
            raise IOError("all gone")

    pipe = DataPipeline(Broken(6), batch_size=2, shuffle=False,
                        max_bad_samples=2)
    with pytest.raises(RuntimeError, match="budget exhausted"), \
            pytest.warns(RuntimeWarning):
        list(pipe)
