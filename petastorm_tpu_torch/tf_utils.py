"""TensorFlow adapter: ``make_petastorm_dataset`` (tf.data) over a Reader.

The port's copy of ``petastorm_tpu/tf_utils.py``, over the port's readers.
TensorFlow is imported when a function is called, never when the module
is: the card machine has no TensorFlow, and ``petastorm_tpu_torch`` imports
no TensorFlow at package import.

Parity: reference ``petastorm/tf_utils.py`` — ``make_petastorm_dataset``
(``Dataset.from_generator`` + namedtuple map + static shapes,
``tf_utils.py:348-402``), dtype sanitization (Decimal->str, uint16->int32,
uint32->int64, datetime->ns-epoch int64, ``:58-97``), np->tf dtype map
(``:27-44``), and the graph-mode ``tf_tensors`` feed (``:289-338``) —
``py_func`` dequeue + optional ``RandomShuffleQueue`` decorrelation stage —
available under ``tf.compat.v1`` graphs (its TF1 contract is unchanged; in
eager/TF2 use ``make_petastorm_dataset``).
"""

import datetime
import decimal

import numpy as np

tf = None


def _require_tf():
    """Import TensorFlow on first use (into the module's ``tf``)."""
    global tf
    if tf is None:
        try:
            import tensorflow
        except ImportError as e:
            raise RuntimeError('petastorm_tpu_torch.tf_utils requires tensorflow: {}'.format(e))
        tf = tensorflow


_NUMPY_TO_TF_DTYPE = None


def _np_to_tf_dtype(np_dtype):
    """Parity: reference ``tf_utils.py:27-44``."""
    global _NUMPY_TO_TF_DTYPE
    if _NUMPY_TO_TF_DTYPE is None:
        _NUMPY_TO_TF_DTYPE = {
            np.dtype('bool'): tf.bool,
            np.dtype('int8'): tf.int8,
            np.dtype('uint8'): tf.uint8,
            np.dtype('int16'): tf.int16,
            np.dtype('uint16'): tf.int32,   # promoted
            np.dtype('int32'): tf.int32,
            np.dtype('uint32'): tf.int64,   # promoted
            np.dtype('int64'): tf.int64,
            np.dtype('float16'): tf.float16,
            np.dtype('float32'): tf.float32,
            np.dtype('float64'): tf.float64,
        }
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind in ('U', 'S', 'O'):
        return tf.string
    if np_dtype.kind == 'M':
        return tf.int64
    if np_dtype not in _NUMPY_TO_TF_DTYPE:
        raise ValueError('Unsupported dtype for TF: {}'.format(np_dtype))
    return _NUMPY_TO_TF_DTYPE[np_dtype]


def _sanitize_field_tf_types(sample_dict):
    """Value fixes before handing to TF (parity: ``tf_utils.py:58-97``)."""
    out = {}
    for name, value in sample_dict.items():
        if value is None:
            raise RuntimeError('Field {} is None; TF cannot represent null scalars. '
                               'Filter nulls with a predicate or TransformSpec'.format(name))
        if isinstance(value, decimal.Decimal):
            value = str(value)
        elif isinstance(value, np.ndarray) and value.dtype.kind == 'M':
            value = value.astype('datetime64[ns]').astype(np.int64)
        elif isinstance(value, (np.datetime64, datetime.date, datetime.datetime)):
            value = np.datetime64(value, 'ns').astype(np.int64)
        elif isinstance(value, np.ndarray) and value.dtype == np.uint16:
            value = value.astype(np.int32)
        elif isinstance(value, np.ndarray) and value.dtype == np.uint32:
            value = value.astype(np.int64)
        elif isinstance(value, np.uint16):
            value = np.int32(value)
        elif isinstance(value, np.uint32):
            value = np.int64(value)
        out[name] = value
    return out


#: Well-known graph-node name for the shuffling queue size (parity:
#: reference ``tf_utils.py:48,207-209`` exposes it for monitoring).
RANDOM_SHUFFLING_QUEUE_SIZE = 'random_shuffling_queue_size'


def tf_tensors(reader, shuffling_queue_capacity=0, min_after_dequeue=0):
    """Graph-mode sample feed: tensors that dequeue one sample per
    ``session.run``.

    Parity: reference ``tf_utils.py:289-338``. Requires a ``tf.compat.v1``
    graph (eager raises — use :func:`make_petastorm_dataset` on TF2);
    ``shuffling_queue_capacity`` inserts a ``RandomShuffleQueue`` +
    ``QueueRunner`` decorrelation stage; shuffling is forbidden for batched
    readers (``:327-331``); NGram readers yield a per-offset dict of
    namedtuples (``:254-286``).
    """
    _require_tf()
    if tf.executing_eagerly():
        raise RuntimeError('tf_tensors builds a TF1 graph feed; with eager '
                           'execution use make_petastorm_dataset(reader) instead')
    if reader.batched_output and shuffling_queue_capacity > 0:
        raise ValueError('shuffling_queue_capacity is not supported with batched '
                         'readers: row-group batches would be shuffled as units '
                         '(parity: reference tf_utils.py:327-331)')

    schema = reader.transformed_schema
    if reader.ngram is not None:
        timesteps = sorted(reader.ngram.fields)
        flat_fields = []
        for ts in timesteps:
            ts_schema = reader.ngram.get_schema_at_timestep(schema, ts)
            flat_fields.extend((ts, f) for f in ts_schema.fields.values())
        dtypes = [_np_to_tf_dtype(f.numpy_dtype) for _, f in flat_fields]
        shapes = [list(f.shape) for _, f in flat_fields]

        def _dequeue():
            window = next(reader)
            sanitized = {ts: _sanitize_field_tf_types(window[ts]._asdict())
                         for ts in timesteps}
            return [sanitized[ts][f.name] for ts, f in flat_fields]
    else:
        fields = list(schema.fields.values())
        dtypes = [_np_to_tf_dtype(f.numpy_dtype) for f in fields]
        if reader.batched_output:
            shapes = [[None] + list(f.shape) for f in fields]
        else:
            shapes = [list(f.shape) for f in fields]

        def _dequeue():
            sample = next(reader)
            sanitized = _sanitize_field_tf_types(sample._asdict())
            return [sanitized[f.name] for f in fields]

    v1 = tf.compat.v1
    tensors = v1.py_func(_dequeue, [], dtypes, name='pstt_dequeue')
    for tensor, shape in zip(tensors, shapes):
        if all(d is not None for d in shape):
            tensor.set_shape(shape)

    if shuffling_queue_capacity > 0:
        # Decorrelation stage (parity: reference tf_utils.py:201-219).
        shuffle_queue = tf.queue.RandomShuffleQueue(
            capacity=shuffling_queue_capacity,
            min_after_dequeue=min_after_dequeue,
            dtypes=dtypes)
        v1.summary.scalar(RANDOM_SHUFFLING_QUEUE_SIZE, shuffle_queue.size())
        tf.identity(shuffle_queue.size(), name=RANDOM_SHUFFLING_QUEUE_SIZE)
        enqueue_op = shuffle_queue.enqueue(tensors)
        v1.train.add_queue_runner(v1.train.QueueRunner(shuffle_queue, [enqueue_op]))
        tensors = shuffle_queue.dequeue()
        if not isinstance(tensors, (list, tuple)):
            tensors = [tensors]  # single-field queues dequeue a bare Tensor
        for tensor, shape in zip(tensors, shapes):
            if all(d is not None for d in shape):
                tensor.set_shape(shape)

    if reader.ngram is not None:
        out = {}
        idx = 0
        for ts in timesteps:
            ts_schema = reader.ngram.get_schema_at_timestep(schema, ts)
            n = len(ts_schema.fields)
            out[ts] = ts_schema.make_namedtuple(
                **{f.name: tensors[idx + j]
                   for j, f in enumerate(ts_schema.fields.values())})
            idx += n
        return out
    return schema.namedtuple_type()(*tensors)


def make_petastorm_dataset(reader):
    """``tf.data.Dataset`` over a Reader (row or batch flavor).

    Parity: reference ``tf_utils.py:348-402``. NGram readers are not supported
    (``:402``). The dataset ends with the reader's epochs; construct the
    Reader with ``num_epochs=None`` for an infinite dataset instead of
    ``.repeat()`` (``:386-392``).
    """
    _require_tf()
    if reader.ngram is not None:
        raise NotImplementedError('make_petastorm_dataset does not support NGram readers')

    schema = reader.transformed_schema
    fields = list(schema.fields.values())
    nt_type = schema.namedtuple_type()

    output_types = tuple(_np_to_tf_dtype(f.numpy_dtype) for f in fields)
    if reader.batched_output:
        shapes = tuple(tf.TensorShape([None] + [d for d in f.shape]) for f in fields)
    else:
        shapes = tuple(tf.TensorShape(list(f.shape)) for f in fields)

    def generator():
        for sample in reader:
            sanitized = _sanitize_field_tf_types(sample._asdict())
            yield tuple(sanitized[f.name] for f in fields)

    dataset = tf.data.Dataset.from_generator(generator, output_types=output_types,
                                             output_shapes=shapes)
    return dataset.map(lambda *args: nt_type(*args))
