"""``paddle.batch`` — port of ``paddle_tpu/batch.py``: the reader
decorator that groups a sample generator into batches."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size: int, drop_last: bool = False):
    """Wrap a sample-yielding callable into a batch-yielding callable."""
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batch_reader
