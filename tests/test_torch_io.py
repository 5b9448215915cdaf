"""The port's ``io`` (samplers, datasets, DataLoader) against the JAX
package's on the same inputs: every sampler's index order and
``epoch_seed`` over several seeds and epochs, the datasets' items and
the DataLoader's batches (threads, and two worker processes), and the
bad-sample budget. The port collates into host torch tensors where the
reference collates into numpy; the values must be equal."""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io.sampler import epoch_seed

from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_io_samples import Squares


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    """Nested batches equal, numpy (reference) against torch (port)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        x, y = _np(a), _np(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 5, 7, 2 ** 40 + 3])
def test_epoch_seed_equals_the_reference(seed):
    from paddle_tpu.io.sampler import epoch_seed as ref
    for epoch in range(6):
        assert epoch_seed(seed, epoch) == ref(seed, epoch)


SAMPLERS = {
    "sequence": lambda m, ds: m.SequenceSampler(ds),
    "random_base_seed": lambda m, ds: m.RandomSampler(ds, base_seed=11),
    "random_int_generator": lambda m, ds: m.RandomSampler(
        ds, generator=3, num_samples=9),
    "random_replacement": lambda m, ds: m.RandomSampler(
        ds, replacement=True, generator=np.random.RandomState(4)),
    "subset_random": lambda m, ds: m.SubsetRandomSampler(
        [1, 4, 9, 16, 2], generator=np.random.RandomState(6)),
    "weighted": lambda m, ds: m.WeightedRandomSampler(
        np.arange(1, 21), 12, replacement=True),
    "batch_shuffle_drop_last": lambda m, ds: m.BatchSampler(
        ds, shuffle=True, batch_size=3, drop_last=True, base_seed=2),
    "batch_of_a_sampler": lambda m, ds: m.BatchSampler(
        sampler=m.RandomSampler(ds, base_seed=9), batch_size=4),
    "distributed_rank1_of3": lambda m, ds: m.DistributedBatchSampler(
        ds, batch_size=2, num_replicas=3, rank=1, shuffle=True,
        base_seed=8),
    "distributed_uneven_pad": lambda m, ds: m.DistributedBatchSampler(
        Squares(7), batch_size=2, num_replicas=3, rank=2),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_order_equals_the_reference(name):
    """Three epochs (``__iter__`` calls, with ``set_epoch`` where the
    sampler has it) give the reference's indices, batch for batch."""
    ds = Squares(20)
    ref, ours = SAMPLERS[name](jio, ds), SAMPLERS[name](tio, ds)
    for epoch in range(3):
        for s in (ref, ours):
            if hasattr(s, "set_epoch") and "distributed" in name:
                s.set_epoch(epoch)
        np.random.seed(epoch)  # the weighted sampler draws from it
        want = list(ref)
        np.random.seed(epoch)
        assert list(ours) == want, epoch
    assert len(ours) == len(ref)


def test_datasets_equal_the_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    for i in range(6):
        _same(jio.TensorDataset([a, b])[i], tio.TensorDataset([a, b])[i])
    assert tio.TensorDataset([torch.from_numpy(a), b])[2][0].tolist() == \
        [4.0, 5.0]
    with pytest.raises(ValueError, match="dim 0"):
        tio.TensorDataset([a, b[:4]])
    for m in (jio, tio):
        cat = m.ConcatDataset([Squares(3), Squares(4)])
        assert len(cat) == 7 and float(cat[5][0][0]) == 2.0
        assert float(cat[-1][0][0]) == 3.0
        sub = m.Subset(Squares(5), [4, 0])
        assert [float(sub[i][0][0]) for i in range(2)] == [4.0, 0.0]
        assert len(m.ComposeDataset([Squares(4), Squares(4)])[1]) == 4
    ref = jio.random_split(Squares(10), [0.3, 0.7], generator=5)
    ours = tio.random_split(Squares(10), [0.3, 0.7], generator=5)
    assert [p.indices for p in ours] == [p.indices for p in ref]
    with pytest.raises(ValueError, match="sum of lengths"):
        tio.random_split(Squares(10), [3, 3])


class _Stream(tio.IterableDataset):
    def __iter__(self):
        for i in range(10):
            yield np.float32([i]), np.int64(i)


class _JStream(jio.IterableDataset):
    def __iter__(self):
        for i in range(10):
            yield np.float32([i]), np.int64(i)


class _DictSquares(Squares):
    def __getitem__(self, i):
        x, y = super().__getitem__(i)
        return {"x": x, "y": y, "i": i}


LOADERS = {
    "serial": dict(batch_size=3, shuffle=True, base_seed=4),
    "threads": dict(batch_size=4, shuffle=True, base_seed=4,
                    num_workers=3, drop_last=True),
    "unbuffered": dict(batch_size=5, use_buffer_reader=False),
    "unbatched": dict(batch_size=None, shuffle=True, base_seed=1),
    "process_workers": dict(batch_size=3, shuffle=True, base_seed=2,
                            num_workers=2, use_process_workers=True),
}


@pytest.mark.parametrize("mode", sorted(LOADERS) + ["iterable", "dict"])
def test_dataloader_batches_equal_the_reference(mode):
    kw = LOADERS.get(mode, dict(batch_size=4, drop_last=mode == "iterable"))
    if mode == "iterable":
        ref_ds, ds = _JStream(), _Stream()
    elif mode == "dict":
        ref_ds = ds = _DictSquares(11)
    else:
        ref_ds = ds = Squares(17)
    ref = list(jio.DataLoader(ref_ds, **kw))
    ours = list(tio.DataLoader(ds, **kw))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ref, ours):
        _same(a, b)
    if mode not in ("iterable", "unbatched"):
        assert isinstance(ours[0], dict if mode == "dict" else tuple)
        first = ours[0]["x"] if mode == "dict" else ours[0][0]
        assert isinstance(first, torch.Tensor) and first.device.type == "cpu"


class _Flaky(Squares):
    """Samples 3 and 7 always fail; the rest load."""

    def __getitem__(self, i):
        if i in (3, 7):
            raise IOError(f"bad sample {i}")
        return super().__getitem__(i)


def test_bad_sample_budget_skips_then_raises():
    with pytest.warns(RuntimeWarning, match="skipping bad fetch"):
        got = list(tio.DataLoader(_Flaky(10), batch_size=4,
                                  max_bad_samples=2))
    ref = list(jio.DataLoader(_Flaky(10), batch_size=4, max_bad_samples=2))
    for a, b in zip(ref, got):
        _same(a, b)
    assert [len(b[0]) for b in got] == [3, 3, 2]
    with pytest.raises(RuntimeError, match="budget exhausted"), \
            pytest.warns(RuntimeWarning):
        list(tio.DataLoader(_Flaky(10), batch_size=4, max_bad_samples=1))
    # off by default: the failure propagates unchanged
    with pytest.raises(IOError, match="bad sample 3"):
        list(tio.DataLoader(_Flaky(10), batch_size=4))


def test_process_workers_refuse_what_they_cannot_serve():
    with pytest.raises(ValueError, match="map-style"):
        tio.DataLoader(_Stream(), num_workers=2, use_process_workers=True)
    with pytest.raises(ValueError, match="num_workers >= 1"):
        tio.DataLoader(Squares(4), use_process_workers=True)
