"""``paddle.batch`` (the counterpart of ``paddle_tpu/batch.py``): a
reader of samples wrapped into a reader of lists of samples."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """A reader yielding lists of ``batch_size`` samples of ``reader()``
    (the last one shorter unless ``drop_last``)."""
    if batch_size <= 0:
        raise ValueError(
            f"batch_size should be a positive integer, got {batch_size}")

    def batch_reader():
        buf = []
        for instance in reader():
            buf.append(instance)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
